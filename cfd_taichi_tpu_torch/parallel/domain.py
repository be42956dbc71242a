"""Slab decomposition over torch.distributed: one rank a slab, a 2h ghost
band traded with the ring neighbours, slab-crossers migrated.

Counterpart of `cfd_taichi_tpu/parallel/domain.py`, its dense route, for
all five solvers, with Akinci walls or the clamp boundary, on fluid-only
scenes and on scenes with a rigid body coupled both ways:

* 1-D slabs along the box's longest axis; rank r owns the particles of
  slab r, held in fixed-capacity (cap,) blocks with a validity mask, so
  that every message of a run has one shape;
* each step, the rows within 2h of a slab face go to the neighbour on that
  side (`_halo_exchange`): 2h deep, so that every neighbour of an owned
  row, and every neighbour of those, is on the rank. The trade's pack
  indices (`BandPlan`) are kept for the step, and each later value
  exchange lands in the same halo slots;
* the owned and halo rows that hold a particle are compacted and
  cell-sorted. The port's kernels assume that every row below n is a
  particle of the cell table, so the padding slots are left out before
  the sort instead of being given a sentinel cell (JAX's choice,
  `cfd_taichi_tpu/parallel/domain.py:500, 649`): the compaction reads one
  count a step, and no kernel walks a padding row;
* on that set each physics callback (`_dfsph_physics` ...) runs its
  model's own step (`models/<solver>.solve`) with the rank's hooks
  (`base.Shard`): a value that the loops apply reaches the ghost rows
  from their owners (one trade an iteration), the residual averages and
  the CFL velocity are taken over the ranks, and ghosts within h of the
  slab get exact redundant updates (their neighbourhoods lie inside the
  2h band);
* after integration, the owned rows are kept, particles that left the
  slab go to the neighbour (`_migrate`) and the blocks are packed again.
  Every row that a capacity drops (halo, migration, cap) is counted in
  `overflow`, the max over the ranks; none is lost silently;
* a rigid body (a few thousand particles against the fluid's millions) is
  held whole on every rank (`ShardedState.rigid`). Each rank's step
  walks it against its own rows with the model's coupled code; the
  rank's owned rows charge the body's reaction, which is summed over the
  ranks once a step (`base.reaction_total`), as is the table of the
  solid viscosity's rho quirk (`base.rho_quirk`). The body's speed joins
  the CFL velocity after the max over the ranks, so every rank takes one
  dt. The body then steps on every rank alike, with no collective
  (`make_sharded_rigid_step`): a frame is `iter_cnt` sharded fluid steps,
  then `iter_cnt` rigid steps (runner.Simulation.frame). PBF, as on one
  device, steps the fluid as if the body were not there.

The loops run through ops/loops.while_loop_unrolled with the trades and
the all-reduces inside the trip. Where the rank's collectives can be
captured (NCCL on a card) the trips after the first replay a CUDA graph
that holds them; gloo stages its messages through host memory, which a
graph cannot hold, so there the step asks for eager trips. The stop flag
of a trip is all-reduced before the host reads it (`Comm.agree`), so that
every rank leaves a loop on the same trip.

Not ported: JAX's compact route and its TPU capacity ladder.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from cfd_taichi_tpu_torch.models import base, dfsph, iisph, pbf, pcisph, wcsph
from cfd_taichi_tpu_torch.models import rigid as rigid_mod
from cfd_taichi_tpu_torch.ops import neighbors as nb
from cfd_taichi_tpu_torch.ops.smoothing import f32
from cfd_taichi_tpu_torch.parallel.multihost import Ring
from cfd_taichi_tpu_torch.scene import Scene
from cfd_taichi_tpu_torch.utils import io


@dataclasses.dataclass(frozen=True)
class ShardSpec:
    """Static decomposition metadata."""
    ndev: int
    cap: int            # per-rank particle capacity
    hcap: int           # per-side halo capacity
    axis: int           # decomposition axis (longest box extent)
    slab_w: float       # slab width along `axis`
    lo: float           # box_min along `axis`


class ShardedFluid(NamedTuple):
    """One rank's block of the fluid: (cap,) slots, `mask` the valid ones."""
    pos: torch.Tensor        # (cap, 3) f32
    vel: torch.Tensor        # (cap, 3) f32
    mask: torch.Tensor       # (cap,) bool
    # () int32 max over ranks of the rows the last step dropped (halo,
    # migration, capacity); None before the first step
    overflow: torch.Tensor | None = None
    oid: torch.Tensor | None = None  # (cap,) int32 seeding-order id, -1 empty


class ShardedState(NamedTuple):
    """Cross-step state of a sharded solver on one rank."""
    fluid: ShardedFluid
    extras: tuple            # (cap,) per-particle scalars riding migration
    dt: torch.Tensor         # () the same on every rank
    t: torch.Tensor
    diag: torch.Tensor       # (4,) solver telemetry
    overflow: torch.Tensor | None = None
    # The body, the same on every rank (an empty one on a fluid-only
    # scene); the fluid step leaves the fluid's force on it, and
    # make_sharded_rigid_step moves it.
    rigid: base.RigidBodyState | None = None


_N_EXTRAS = {"dfsph": 1, "pcisph": 0, "iisph": 1, "pbf": 0, "wcsph": 0}


def make_spec(scene: Scene, n_devices: int, slack: float = 1.7) -> ShardSpec:
    """Slabs, capacity and halo capacity of `scene` over `n_devices` ranks
    (`cfd_taichi_tpu/parallel/domain.py:97-114`)."""
    ext = np.asarray(scene.box_max) - np.asarray(scene.box_min)
    axis = int(np.argmax(ext))
    slab_w = float(ext[axis]) / n_devices
    if slab_w < 2.0 * scene.h:
        raise ValueError(
            f"Slabs ({slab_w:.3f}) thinner than the 2h ghost band "
            f"({2 * scene.h:.3f}); use fewer devices for this scene.")
    cap = int(np.ceil(scene.n_fluid / n_devices * slack))
    cap = max((cap + 7) // 8 * 8, 8)
    # The band is 2h deep; bound its occupancy by a dense-packing estimate.
    d = 2.0 * scene.particle_radius
    band_particles = (2.0 * scene.h / d + 2) * \
        (ext[(axis + 1) % 3] / d + 2) * (ext[(axis + 2) % 3] / d + 2)
    hcap = int(min(band_particles * 1.5, cap))
    hcap = max((hcap + 7) // 8 * 8, 8)
    return ShardSpec(ndev=n_devices, cap=cap, hcap=hcap, axis=axis,
                     slab_w=slab_w, lo=float(np.asarray(scene.box_min)[axis]))


def _host_rows(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.asarray(a, np.float32)


def shard_fluid(ring: Ring, spec: ShardSpec, pos, vel=None) -> ShardedFluid:
    """This rank's block of the host partition of (N, 3) `pos` / `vel`
    into slabs (`cfd_taichi_tpu/parallel/domain.py:117-151`); every rank
    computes the same partition and keeps its own (cap,) block."""
    pos = _host_rows(pos)
    vel = np.zeros_like(pos) if vel is None else _host_rows(vel)
    dev_of = np.clip(((pos[:, spec.axis] - spec.lo) // spec.slab_w)
                     .astype(np.int64), 0, spec.ndev - 1)
    for d in range(spec.ndev):
        n_d = int(np.count_nonzero(dev_of == d))
        if n_d > spec.cap:
            raise ValueError(f"Device {d} over capacity: {n_d} > {spec.cap}")
    idx = np.nonzero(dev_of == ring.rank)[0]
    n = idx.shape[0]
    pos_out = np.zeros((spec.cap, 3), np.float32)
    vel_out = np.zeros((spec.cap, 3), np.float32)
    oid_out = np.full((spec.cap,), -1, np.int32)
    pos_out[:n], vel_out[:n], oid_out[:n] = pos[idx], vel[idx], idx
    mask = np.zeros((spec.cap,), bool)
    mask[:n] = True
    dev = ring.device
    return ShardedFluid(
        pos=torch.from_numpy(pos_out).to(dev),
        vel=torch.from_numpy(vel_out).to(dev),
        mask=torch.from_numpy(mask).to(dev),
        oid=torch.from_numpy(oid_out).to(dev))


def unshard(ring: Ring, fluid: ShardedFluid, with_oid: bool = False):
    """The valid rows of every rank, on the host of every rank: (pos, vel)
    (N, 3) numpy, and the (N,) oid with `with_oid`. An all-gather."""
    comm = Comm(ring)
    oid = fluid.oid if fluid.oid is not None else torch.full_like(
        fluid.mask, -1, dtype=torch.int32)
    arrays = [fluid.pos, fluid.vel, oid, fluid.mask]
    parts = comm.all_gather(_columns(arrays))
    got = _split(torch.cat(parts, dim=1).cpu(), arrays)
    pos, vel, oid, mask = (t.numpy() for t in got)
    if with_oid:
        return pos[mask], vel[mask], oid[mask]
    return pos[mask], vel[mask]


# ---------------------------------------------------------------------------
# Collectives
# ---------------------------------------------------------------------------

class Comm:
    """A rank's collectives: the trade with its ring neighbours (JAX's
    `_ring_shift` both ways in one batch), the sums and maxima over the
    ranks (`psum`, `pmax`), and the all-gather. Without a process group
    (a world of one) each is the identity. gloo on a card stages every
    message through host memory."""

    def __init__(self, ring: Ring):
        self.ring = ring
        self.grouped = ring.backend is not None
        self.staged = ring.backend == "gloo" and ring.device.type == "cuda"

    @property
    def capturable(self) -> bool:
        """Whether a CUDA graph can hold this rank's collectives."""
        return self.ring.device.type == "cuda" and not self.staged

    def _out(self, t: torch.Tensor) -> torch.Tensor:
        return t.cpu() if self.staged else t.clone()

    def _back(self, t: torch.Tensor, device) -> torch.Tensor:
        return t.to(device) if self.staged else t

    def _all_reduce(self, t: torch.Tensor, op) -> torch.Tensor:
        if not self.grouped:
            return t
        buf = self._out(t)
        dist.all_reduce(buf, op=op)
        return self._back(buf, t.device)

    def sum(self, *xs: torch.Tensor) -> tuple[torch.Tensor, ...]:
        """Each 0-d tensor summed over the ranks, in one all-reduce (in
        f64, each sum rounded back to its tensor's dtype once)."""
        if not self.grouped:
            return xs
        packed = torch.stack([x.to(torch.float64) for x in xs])
        out = self._all_reduce(packed, dist.ReduceOp.SUM)
        return tuple(out[i].to(x.dtype) for i, x in enumerate(xs))

    def max(self, x: torch.Tensor) -> torch.Tensor:
        return self._all_reduce(x, dist.ReduceOp.MAX)

    def total(self, t: torch.Tensor) -> torch.Tensor:
        """`t` summed over the ranks element by element, in its dtype: one
        all-reduce of the whole tensor."""
        return self._all_reduce(t, dist.ReduceOp.SUM)

    def agree(self, flag: torch.Tensor) -> torch.Tensor:
        """A 0-d bool that is true on every rank where it is on any."""
        if not self.grouped:
            return flag
        return self.max(flag.to(torch.int32)) > 0

    def trade(self, to_right: torch.Tensor, to_left: torch.Tensor
              ) -> tuple[torch.Tensor, torch.Tensor]:
        """Send `to_right` to rank + 1 and `to_left` to rank - 1; returns
        (from_left, from_right), what they sent this way. The ring's
        wrap-around edges are masked off: rank 0 receives nothing from the
        left and the last rank nothing from the right (zeros), and nothing
        is sent over them. A world of one sends nothing; in a world of two
        both neighbours are the same rank, one message each way."""
        r, n = self.ring.rank, self.ring.world
        dev = to_right.device
        if n == 1:
            return torch.zeros_like(to_right), torch.zeros_like(to_left)
        send_r, send_l = (t.cpu() for t in (to_right, to_left)) \
            if self.staged else (to_right.contiguous(), to_left.contiguous())
        from_left = torch.zeros_like(send_r)
        from_right = torch.zeros_like(send_l)
        ops = []
        if r + 1 < n:   # tag 0: messages going right, 1: going left
            ops += [dist.P2POp(dist.isend, send_r, r + 1, tag=0),
                    dist.P2POp(dist.irecv, from_right, r + 1, tag=1)]
        if r > 0:
            ops += [dist.P2POp(dist.isend, send_l, r - 1, tag=1),
                    dist.P2POp(dist.irecv, from_left, r - 1, tag=0)]
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        return self._back(from_left, dev), self._back(from_right, dev)

    def all_gather(self, t: torch.Tensor) -> list[torch.Tensor]:
        if not self.grouped:
            return [t]
        buf = self._out(t)
        parts = [torch.empty_like(buf) for _ in range(self.ring.world)]
        dist.all_gather(parts, buf)
        return parts


# ---------------------------------------------------------------------------
# Fixed-capacity packing (no dynamic sizes in the messages)
# ---------------------------------------------------------------------------

def _pack_idx(select: torch.Tensor, out_cap: int):
    """Indices of the first `out_cap` selected rows, in row order, their
    validity, and the number of selected rows that did not fit (counted:
    every capacity drop surfaces as overflow). A cumsum and a scatter in
    which every row writes its own slot: a row that is not kept writes
    past out_cap, so that no two rows store to one address."""
    n = select.shape[0]
    dev = select.device
    csum = torch.cumsum(select, 0)
    total = csum[-1] if n else torch.zeros((), dtype=torch.int64,
                                           device=dev)
    rows = torch.arange(n, device=dev)
    slot = torch.where(select & (csum <= out_cap), csum - 1, out_cap + rows)
    idx = torch.zeros(out_cap + n, dtype=torch.int64, device=dev)
    idx.scatter_(0, slot, rows)
    got = torch.arange(out_cap, device=dev) < total
    dropped = torch.clamp(total - out_cap, min=0).to(torch.int32)
    return idx[:out_cap], got, dropped


def _pack_with(idx: torch.Tensor, got: torch.Tensor,
               payload: torch.Tensor) -> torch.Tensor:
    """The rows `idx` of the (C, N) `payload`, zero where not `got`."""
    return torch.where(got, payload[:, idx],
                       torch.zeros((), dtype=payload.dtype,
                                   device=payload.device))


def _columns(arrays: list[torch.Tensor]) -> torch.Tensor:
    """(C, N) f32 payload of (N,) / (N, k) arrays, one row a component
    (component-major: a pack gathers whole rows of N, where a gather of
    (N, 8) rows ran ~50x slower on the H100): f32 as is, int32 by its
    bits, bool as 0 / 1."""
    rows = []
    for a in arrays:
        if a.dtype == torch.int32:
            a = a.contiguous().view(torch.float32)
        elif a.dtype == torch.bool:
            a = a.to(torch.float32)
        rows.append(a.reshape(a.shape[0], -1).t())
    return torch.cat(rows)


def _split(payload: torch.Tensor, like: list[torch.Tensor]
           ) -> list[torch.Tensor]:
    """The inverse of `_columns`, for arrays shaped and typed as `like`."""
    out, c = [], 0
    for a in like:
        k = 1 if a.dim() == 1 else a.shape[1]
        rows = payload[c:c + k]
        c += k
        col = rows[0] if a.dim() == 1 else rows.t()
        if a.dtype == torch.int32:
            col = col.contiguous().view(torch.int32)
        elif a.dtype == torch.bool:
            col = col > 0.0
        out.append(col.contiguous())
    return out


def _slab(spec: ShardSpec, rank: int) -> tuple[np.float32, np.float32]:
    """The slab's faces in f32, as JAX forms them (lo + rank * slab_w)."""
    lo = np.float32(spec.lo) + np.float32(rank) * np.float32(spec.slab_w)
    return lo, lo + np.float32(spec.slab_w)


class BandPlan(NamedTuple):
    """Pack indices of each side's 2h ghost band, made once a step, so that
    every value exchange of the step lands in the halo slots of the
    positional halo."""
    idx_l: torch.Tensor
    got_l: torch.Tensor
    idx_r: torch.Tensor
    got_r: torch.Tensor
    dropped: torch.Tensor  # () int32 band rows beyond hcap (lost!)


def _band_plan(spec: ShardSpec, ring: Ring, pos: torch.Tensor,
               mask: torch.Tensor, h: float) -> BandPlan:
    x = pos[:, spec.axis]
    slab_lo, slab_hi = _slab(spec, ring.rank)
    band = np.float32(2.0 * h)
    send_left = mask & (x < float(slab_lo + band))
    send_right = mask & (x >= float(slab_hi - band))
    idx_l, got_l, drop_l = _pack_idx(send_left, spec.hcap)
    idx_r, got_r, drop_r = _pack_idx(send_right, spec.hcap)
    return BandPlan(idx_l, got_l, idx_r, got_r, drop_l + drop_r)


def _plan_exchange(comm: Comm, plan: BandPlan, vals: torch.Tensor,
                   with_mask: bool = False) -> torch.Tensor:
    """Trade the (cap,) or (cap, k) owned `vals` of the planned bands.
    Returns the (2 hcap, ...) halo values [from_left ++ from_right]; with
    `with_mask` the halo's validity rides as a last column."""
    arrays = [vals]
    payload = _columns(arrays)
    if with_mask:
        payload = torch.cat([payload, payload.new_ones(1, payload.shape[1])])
    if comm.ring.world == 1:      # no neighbour: an empty halo
        halo = payload.new_zeros(payload.shape[0], 2 * plan.idx_l.shape[0])
    else:
        from_left, from_right = comm.trade(
            _pack_with(plan.idx_r, plan.got_r, payload),
            _pack_with(plan.idx_l, plan.got_l, payload))
        halo = torch.cat([from_left, from_right], dim=1)
    if not with_mask:
        return _split(halo, arrays)[0]
    vals_h, mask_h = _split(halo, [vals, plan.got_l])
    return vals_h, mask_h


def _halo_exchange(spec: ShardSpec, comm: Comm, pos: torch.Tensor,
                   vel: torch.Tensor, mask: torch.Tensor, h: float):
    """Collect each side's 2h ghost band and trade it with the ring
    neighbours. Returns the halo's (pos, vel, mask, plan); the halo arrays
    have 2 hcap rows."""
    plan = _band_plan(spec, comm.ring, pos, mask, h)
    pv, halo_mask = _plan_exchange(comm, plan, torch.cat([pos, vel], dim=1),
                                   with_mask=True)
    return pv[:, :3].contiguous(), pv[:, 3:].contiguous(), halo_mask, plan


def _migrate(spec: ShardSpec, comm: Comm, arrays: list[torch.Tensor],
             mask: torch.Tensor):
    """Send the particles that left the slab to the ring neighbour on that
    side and pack the blocks again. `arrays[0]` is the (cap, 3) positions;
    the rest (velocity, oid, extras) ride along. Returns (arrays, mask,
    dropped): `dropped` counts the particles lost to hcap or cap."""
    rank = comm.ring.rank
    x = arrays[0][:, spec.axis]
    dev_of = torch.clamp(((x - f32(spec.lo)) / f32(spec.slab_w))
                         .to(torch.int32), 0, spec.ndev - 1)
    go_left = mask & (dev_of < rank)
    go_right = mask & (dev_of > rank)
    stay = mask & ~go_left & ~go_right
    payload = _columns(arrays)
    if comm.ring.world == 1:      # no neighbour, nobody leaves
        from_left = from_right = payload.new_zeros(payload.shape[0] + 1,
                                                   spec.hcap)
        drop_l = drop_r = 0
    else:
        idx_l, got_l, drop_l = _pack_idx(go_left, spec.hcap)
        idx_r, got_r, drop_r = _pack_idx(go_right, spec.hcap)
        with_got = [torch.cat([_pack_with(i, g, payload), _columns([g])])
                    for i, g in ((idx_l, got_l), (idx_r, got_r))]
        from_left, from_right = comm.trade(with_got[1], with_got[0])
    idx_s, got_s, drop_s = _pack_idx(stay, spec.cap)
    merged = torch.cat([_pack_with(idx_s, got_s, payload),
                        from_left[:-1], from_right[:-1]], dim=1)
    merged_mask = torch.cat([got_s, from_left[-1] > 0.0,
                             from_right[-1] > 0.0])
    idx_f, got_f, drop_m = _pack_idx(merged_mask, spec.cap)
    final = _split(_pack_with(idx_f, got_f, merged), arrays)
    return final, got_f, drop_l + drop_r + drop_s + drop_m


# ---------------------------------------------------------------------------
# The sharded step
# ---------------------------------------------------------------------------

class ShardCtx(NamedTuple):
    """What a sharded solver's physics callback needs: the rank's owned and
    halo particles, compacted and cell-sorted, and the hooks with which
    the models' steps run on them (`base.Shard`)."""
    scene: Scene
    pos: torch.Tensor        # (ns, 3) sorted local + halo positions
    starts: torch.Tensor     # (num_cells + 1,) int32 CSR offsets of `pos`
    oid: torch.Tensor        # (ns,) int32 seeding-order id, -1 on a ghost
    shard: base.Shard
    rigid: base.RigidBodyState   # the whole body; empty on a fluid-only scene


def init_sharded_solver(ring: Ring, spec: ShardSpec, scene: Scene, pos,
                        solver: str, vel=None,
                        rigid: base.RigidBodyState | None = None
                        ) -> ShardedState:
    """This rank's initial state of `solver` on the slab partition of
    (N, 3) `pos` (`cfd_taichi_tpu/parallel/domain.py:398-414`), with the
    body `rigid`, the same on every rank; by default the scene's as built
    (base.init_rigid_state: empty on a scene without a body)."""
    fluid = shard_fluid(ring, spec, pos, vel)
    dev = ring.device
    extras = tuple(torch.zeros(spec.cap, dtype=torch.float32, device=dev)
                   for _ in range(_N_EXTRAS[solver]))
    if rigid is None:
        rigid = base.init_rigid_state(scene)
    return ShardedState(
        fluid=fluid, extras=extras,
        dt=torch.tensor(scene.dt0, dtype=torch.float32, device=dev),
        t=torch.zeros((), dtype=torch.float32, device=dev),
        diag=torch.zeros(4, dtype=torch.float32, device=dev),
        rigid=base.RigidBodyState(*(a.to(dev) for a in rigid)))


def sharded_state_from_numpy(ring: Ring, spec: ShardSpec, solver: str,
                             leaves) -> ShardedState:
    """This rank's block of a sharded state given as the JAX package's
    `ShardedState` leaves (numpy, flatten order): pos.x, pos.y, pos.z,
    vel.x, vel.y, vel.z, mask, [fluid overflow], oid, the solver's extras,
    dt, t, diag, [overflow], [the body], with (ndev cap,) blocks. The two
    overflow leaves are there after a step and not before; the body's
    io.RIGID_LEAVES leaves on a coupled scene's state, whole on every
    rank. Without them the state holds an empty body."""
    leaves = [np.asarray(a) for a in leaves]
    n_extras = _N_EXTRAS[solver]
    base_n = 11 + n_extras
    counts = [base_n + s + r for r in (0, io.RIGID_LEAVES) for s in (0, 2)]
    if len(leaves) not in counts:
        raise ValueError(f"{solver}: want {' or '.join(map(str, counts))} "
                         f"sharded state leaves, got {len(leaves)}")
    if len(leaves) - base_n >= io.RIGID_LEAVES:
        body = io.rigid_from_numpy(leaves[-io.RIGID_LEAVES:], ring.device)
        leaves = leaves[:-io.RIGID_LEAVES]
    else:
        body = base.empty_rigid(ring.device)
    stepped = len(leaves) == base_n + 2
    dev = ring.device
    blk = slice(ring.rank * spec.cap, (ring.rank + 1) * spec.cap)

    def t(a, dtype=torch.float32):
        return torch.tensor(np.asarray(a), dtype=dtype, device=dev)

    def rows(i):
        return t(np.stack([leaves[i + c][blk] for c in range(3)], axis=-1))

    k = 8 if stepped else 7      # oid
    over = t(leaves[-1], torch.int32) if stepped else None
    e = k + 1
    return ShardedState(
        fluid=ShardedFluid(pos=rows(0), vel=rows(3),
                           mask=t(leaves[6][blk], torch.bool),
                           overflow=over,
                           oid=t(leaves[k][blk], torch.int32)),
        extras=tuple(t(a[blk]) for a in leaves[e:e + n_extras]),
        dt=t(leaves[e + n_extras]), t=t(leaves[e + n_extras + 1]),
        diag=t(leaves[e + n_extras + 2]), overflow=over, rigid=body)


def make_sharded_solver_step(scene: Scene, ring: Ring, spec: ShardSpec,
                             solver: str):
    """This rank's sharded step of `solver`: ShardedState -> ShardedState
    (`cfd_taichi_tpu/parallel/domain.py:417-780`, its dense route).

    The loops' trips after the first replay a CUDA graph where the rank's
    collectives can be captured (NCCL, or a world of one, on a card), and
    run eagerly where they cannot (gloo on a card stages its messages
    through the host; the CPU); the step's `loops` attribute says which,
    and the step passes it to every loop (ops/loops.while_loop_unrolled's
    `eager`). On a coupled scene the state carries the body
    (`ShardedState.rigid`), and the step returns it with the fluid's force
    on it, summed over the ranks; `make_sharded_rigid_step` then moves
    it."""
    physics = {"dfsph": _dfsph_physics, "iisph": _iisph_physics,
               "pbf": _pbf_physics, "wcsph": _wcsph_physics,
               "pcisph": _pcisph_physics}[solver]
    if solver == "pcisph":
        physics = functools.partial(physics, delta=pcisph.stiffness(scene))
    comm = Comm(ring)
    loop_kw = dict(agree=comm.agree, eager=not comm.capturable)
    empty = base.empty_rigid(ring.device)
    h, cap, grid = scene.h, spec.cap, scene.grid
    slab_lo, slab_hi = _slab(spec, ring.rank)
    band_lo = float(slab_lo - np.float32(h))
    band_hi = float(slab_hi + np.float32(h))

    def step(state: ShardedState) -> ShardedState:
        rigid = state.rigid if state.rigid is not None else empty
        if scene.coupled and rigid.pos.shape[0] != scene.n_rigid:
            raise ValueError(
                f"a coupled scene's sharded state carries its body of "
                f"{scene.n_rigid} particles, not {rigid.pos.shape[0]}")
        f = state.fluid
        pos, vel0, mask, oid = f.pos, f.vel, f.mask, f.oid
        halo_pos, halo_vel, halo_mask, plan = _halo_exchange(
            spec, comm, pos, vel0, mask, h)
        # --- compact and cell-sort the local set (module note) ----------
        valid = torch.cat([mask, halo_mask])
        rows = torch.nonzero(valid).squeeze(1)    # the step's count read
        scene.loop_graphs.reads += 1
        lpos = torch.cat([pos, halo_pos])[rows]
        scid, order = torch.sort(nb.cell_id(lpos, grid), stable=True)
        perm = rows[order]            # sorted row -> slot of [own ++ halo]
        spos = lpos[order]
        starts = nb.csr_starts(scid, grid.num_cells)
        ns = perm.shape[0]
        s_owned = perm < cap
        # Ghosts within h of the slab get locally exact redundant updates
        # (their neighbourhoods lie inside the 2h halo; their values in
        # each iteration arrive from the owner).
        xc = spos[:, spec.axis]
        s_upd = s_owned | ((xc > band_lo) & (xc < band_hi))
        inv = torch.zeros(valid.shape[0], dtype=torch.int64,
                          device=pos.device)
        inv[perm] = torch.arange(ns, device=pos.device)
        inv_own = inv[:cap]

        def sorted_rows(own, halo=0):
            """(cap, ...) owned slots -> (ns, ...) sorted rows, the ghost
            rows `halo`."""
            pad = own.new_full((2 * spec.hcap,) + tuple(own.shape[1:]), halo)
            return torch.cat([own, pad])[perm]

        def sync(vals):
            # a rank without rows trades all the same: its neighbours wait
            own = vals[inv_own] if ns else vals.new_zeros(
                (cap,) + tuple(vals.shape[1:]))
            return torch.cat([own, _plan_exchange(comm, plan, own)])[perm]

        def owned_max(x):
            # x >= 0, so the 0 that stands for the rows the rank does not
            # own (and for a rank without rows) changes no max
            x = torch.where(s_owned, x, torch.zeros_like(x))
            return comm.max(torch.cat([x, x.new_zeros(1)]).max())

        s_oid = sorted_rows(oid, -1)
        ctx = ShardCtx(scene=scene, pos=spos, starts=starts, oid=s_oid,
                       shard=base.Shard(sync=sync, owned=s_owned, upd=s_upd,
                                        sum=comm.sum, max=owned_max,
                                        loop=loop_kw, total=comm.total),
                       rigid=rigid)
        new_pos, new_vel, new_extras, dt, diag, force = physics(
            ctx, torch.cat([vel0, halo_vel])[perm],
            [sorted_rows(e) for e in state.extras], state.dt)

        # --- keep the owned rows, in the step's sorted order, + migrate --
        # Kept as the single-device state is: the next stable sort then
        # orders each cell as the single-device step does, and a world of
        # one steps as it does, bit for bit.
        kept = [new_pos, new_vel, s_oid, *new_extras]
        idx, own, _ = _pack_idx(s_owned, cap)
        if ns:
            kept = _split(_pack_with(idx, own, _columns(kept)), kept)
        else:              # no row: an empty block
            kept = [a.new_zeros((cap,) + tuple(a.shape[1:])) for a in kept]
        out, out_mask, mig_drop = _migrate(spec, comm, kept, own)
        overflow = comm.max(torch.maximum(plan.dropped, mig_drop))
        return ShardedState(
            fluid=ShardedFluid(pos=out[0], vel=out[1], mask=out_mask,
                               overflow=overflow, oid=out[2]),
            extras=tuple(out[3:]), dt=dt, t=state.t + dt, diag=diag,
            overflow=overflow, rigid=rigid._replace(force=force))

    step.loops = "eager" if loop_kw["eager"] else "graph"
    return step


def make_sharded_wcsph_step(scene: Scene, ring: Ring, spec: ShardSpec):
    """Sharded WCSPH as a ShardedFluid -> ShardedFluid step, for callers
    that carry no ShardedState (WCSPH has no extras and a fixed dt)."""
    inner = make_sharded_solver_step(scene, ring, spec, "wcsph")
    dev = ring.device
    dt0 = torch.tensor(scene.dt0, dtype=torch.float32, device=dev)
    zero4 = torch.zeros(4, dtype=torch.float32, device=dev)

    def step(fluid: ShardedFluid) -> ShardedFluid:
        state = ShardedState(fluid=fluid, extras=(), dt=dt0,
                             t=torch.zeros((), dtype=torch.float32,
                                           device=dev), diag=zero4)
        return inner(state).fluid

    return step


def init_sharded_dfsph(ring: Ring, spec: ShardSpec, scene: Scene, pos,
                       vel=None) -> ShardedState:
    return init_sharded_solver(ring, spec, scene, pos, "dfsph", vel=vel)


def make_sharded_dfsph_step(scene: Scene, ring: Ring, spec: ShardSpec):
    return make_sharded_solver_step(scene, ring, spec, "dfsph")


def make_sharded_rigid_step(scene: Scene):
    """The rigid half of a coupled sharded frame (`cfd_taichi_tpu/parallel/
    domain.py:783-798`): models/rigid.step on the body, which every rank
    holds whole, under the force the fluid step left on it (summed over
    the ranks) and with the state's dt, the same on every rank. It needs no
    collective: every rank computes the same body. The identity where no
    body takes part in the step."""
    if not scene.coupled:
        return lambda state: state

    def rstep(state: ShardedState) -> ShardedState:
        return state._replace(rigid=rigid_mod.step(scene, state.rigid,
                                                   state.dt))

    return rstep


# ---------------------------------------------------------------------------
# The physics callbacks: each runs its model's own step on the rank's
# sorted rows, with the rank's hooks (ShardCtx.shard), and returns the
# sorted rows' (positions, velocities, extras), dt, diag and the body's
# force.
# ---------------------------------------------------------------------------

def _dfsph_physics(ctx: ShardCtx, vel, extras, dt):
    """`cfd_taichi_tpu/parallel/domain.py:830-1036`: models/dfsph.solve."""
    pre = dfsph.prepare_sorted(ctx.scene, ctx.rigid, ctx.pos, ctx.starts,
                               vel, *extras, oid=ctx.oid, shard=ctx.shard)
    pos, vel, warm_k, dt, diag, force = dfsph.solve(ctx.scene, pre, dt,
                                                    ctx.rigid, ctx.shard)
    return pos, vel, [warm_k], dt, diag, force


def _pcisph_physics(ctx: ShardCtx, vel, extras, dt, delta):
    """`cfd_taichi_tpu/parallel/domain.py:1039-1194`: models/pcisph.solve
    with the stiffness `delta` of the global seed (pcisph.stiffness)."""
    pos, vel, diag, force = pcisph.solve(ctx.scene, ctx.pos, ctx.starts,
                                         vel, delta, dt, ctx.rigid, ctx.oid,
                                         ctx.shard)
    return pos, vel, [], dt, diag, force


def _iisph_physics(ctx: ShardCtx, vel, extras, dt):
    """`cfd_taichi_tpu/parallel/domain.py:1197-1304`: models/iisph.solve,
    its pressure carried as the extra p_past."""
    pos, vel, p, diag, force = iisph.solve(ctx.scene, ctx.pos, ctx.starts,
                                           vel, *extras, dt, ctx.rigid,
                                           ctx.oid, ctx.shard)
    return pos, vel, [p], dt, diag, force


def _wcsph_physics(ctx: ShardCtx, vel, extras, dt):
    """`cfd_taichi_tpu/parallel/domain.py:1307-1399`: models/wcsph.solve,
    which takes the hooks only for a body."""
    rho, bt = base.density(ctx.scene, ctx.pos, ctx.starts)
    pos, vel, _, force = wcsph.solve(ctx.scene, ctx.pos, ctx.starts, vel,
                                     rho, bt, dt, ctx.rigid, ctx.oid,
                                     ctx.shard)
    return pos, vel, [], dt, torch.zeros(4, dtype=torch.float32,
                                         device=pos.device), force


def _pbf_physics(ctx: ShardCtx, vel, extras, dt):
    """`cfd_taichi_tpu/parallel/domain.py:1402-1493`: models/pbf.solve,
    which ignores a body, as one device's does; diag[1] is the largest
    density constraint over the ranks (JAX's sharded telemetry)."""
    pos, vel, constraint = pbf.solve(ctx.scene, ctx.pos, ctx.starts, vel,
                                     dt, ctx.shard)
    cmax = ctx.shard.max(constraint)
    zero = torch.zeros_like(cmax)
    return (pos, vel, [], dt, torch.stack([zero, cmax, zero, zero]),
            ctx.rigid.force)
