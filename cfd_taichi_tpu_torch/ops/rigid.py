"""The fluid-rigid pair passes of a coupled step: the counterpart of
`cfd_taichi_tpu/ops/rigid_dense.py`.

A rigid body is a small particle set (10^2-10^4 voxels against 10^4-10^6
fluid particles) that moves, so every fluid step sorts it anew on the
fluid's grid (`rigid_table`: cell-sorted positions and volumes, their CSR
offsets, and `lid`, the original rigid index of each sorted slot). Four
passes walk it, each a hand-written CUDA kernel with a plain PyTorch
version and a wrapper, as in ops/stencil.py (whose note says how the three
fit together; the launch counts are rows of `stencil.KERNELS`):

* `rigid_terms` (csrc/rigid_terms.cu): each cell-sorted fluid query's
  step-constant solid sums over the rigid particles in its stencil,
  w_s = rho0 V_j, c the gradient factor:
      rho_s = sum w_s W,  S_s = sum w_s c x_ij,  qsum_s = sum (w_s c r)^2,
      g2_s = sum w_s c^2 r^2 (IISPH's; computed here so that IISPH's
      coupling reuses the pass);
* `rigid_contact_dot` (second entry of csrc/rigid_terms.cu): the solid
  velocity dot sum w_s c x_ij . v_r[lid_j] of a rigid per-particle
  velocity in original order, DFSPH's loop-constant C_s;
* `rigid_viscosity` (csrc/rigid_viscosity.cu): the solid branch of the
  Monaghan viscosity, the body's linear velocity on the rigid side and
  the neighbour density read through `lid` from a per-rigid table (the
  reference's rho quirk, models/dfsph.py says which);

  these two and `rigid_terms` walk the body only from warps with a query
  inside its gate (`stencil.make_body_box`, made once a step with the
  table, `models/base.body_terms`), which leaves every output bit as it
  is: a query outside the box has no pair;
* `rigid_side_force` (csrc/rigid_side_force.cu): the fluid's reaction on
  each rigid particle, in original order, over the cell-sorted fluid's CSR
  table: F_j += sum_i rho0 V_j c (x_i - x_j) u_i. JAX computes it from the
  rigid side, one pair once, with no scatter; so does the kernel, one
  thread a rigid particle and no atomics, so that a run repeats bit for
  bit and the card can be held to the CPU. It walks the fluid's stencil:
  the form of IISPH and WCSPH, which charge the reaction once a step;
* `rigid_side_rows`, `rigid_side_list` and `rigid_side_force_list` (the same
  source): the form of DFSPH's density loop and PCISPH's loop, which
  charge it once an iteration over the same start-of-step geometry. As
  JAX's build_rigid_side hoists the pair vectors, the list entry walks
  once a step, as the walk does, and stores each charged pair (`SideList`:
  the fluid index and g = rho0 V_j c (x_i - x_j)), in rows that
  `rigid_side_rows` sizes before it from the fluid's CSR offsets at the
  body's own cells (a warp's 32 rows interleaved, as PBF's pair list); the
  stream then adds g u_i over each row in walk order, bit for bit as the
  walk, with u_i = value_i scale formed at its gather (DFSPH hands in k /
  rho and m, as JAX forms k m at its gather) and 0 on the rows a rank does
  not own.

Pairs are those with r2 <= f32(h)^2 at the start-of-step positions, r =
sqrt(max(r2, 1e-24)) (`_geom0`, rigid_dense.py:118-127); the reaction
also needs r <= h, as JAX's list does (rigid_dense.py:272). W and c take
q = r * f32(1/h), the product XLA makes of JAX's jitted r / h
(smoothing.cubic_w, cubic_grad_coeff).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from cfd_taichi_tpu_torch.ops import neighbors as nb
from cfd_taichi_tpu_torch.ops.smoothing import (CubicConstants,
                                                cubic_grad_coeff, cubic_w,
                                                f32)
from cfd_taichi_tpu_torch.ops.stencil import (KERNELS, LIST_STRIDE, _check,
                                              _launch, _on_cuda,
                                              _pair_chunks, _params, _rowsum,
                                              _rowsum3, checked_slots,
                                              make_body_box, walk_offsets,
                                              warp_bases, warp_offsets)


class RigidTable(NamedTuple):
    """A rigid body cell-sorted on the fluid's grid."""
    pos: torch.Tensor     # (Nr, 3) f32 sorted positions
    vol: torch.Tensor     # (Nr,) f32 V_j, same order
    lid: torch.Tensor     # (Nr,) int32 original rigid index of each slot
    starts: torch.Tensor  # (num_cells + 1,) int32 CSR offsets


class RigidTerms(NamedTuple):
    """Step-constant solid sums of each cell-sorted fluid query."""
    rho: torch.Tensor    # (N,)  sum w_s W
    s: torch.Tensor      # (N, 3) sum w_s c x_ij
    qsum: torch.Tensor   # (N,)  sum (w_s c r)^2
    g2: torch.Tensor     # (N,)  sum w_s c^2 r^2


class SideList(NamedTuple):
    """The fluid-rigid pairs that the reaction charges, at the start-of-
    step positions: row j's t-th is rec[base[j] + LIST_STRIDE t], t <
    cnt[j], in walk order, (i, g_x, g_y, g_z) with i the cell-sorted fluid
    index and g = rho0 V_j c(r) (x_i - x_j) as f32 bit patterns. The slots
    of a row past cnt[j] are never written or read."""
    base: torch.Tensor  # (Nr,) int32
    cnt: torch.Tensor   # (Nr,) int32
    rec: torch.Tensor   # (slots, 4) int32


def rigid_table(grid: nb.GridSpec, pos: torch.Tensor,
                vol: torch.Tensor) -> RigidTable:
    """Stable sort of the body's (Nr, 3) `pos` by (clamped) cell id, with
    its volumes, `lid` and CSR offsets (rigid_dense.py:78, 94-102)."""
    table = nb.build_cell_table(pos, grid)
    return RigidTable(pos=pos[table.order], vol=vol[table.order],
                      lid=table.order.to(torch.int32), starts=table.starts)


def _check_table(t: RigidTable, grid: nb.GridSpec,
                 device: torch.device) -> int:
    nr = t.pos.shape[0]
    _check("rigid pos", t.pos, torch.float32, (nr, 3), device)
    _check("rigid vol", t.vol, torch.float32, (nr,), device)
    _check("rigid lid", t.lid, torch.int32, (nr,), device)
    _check("rigid starts", t.starts, torch.int32, (grid.num_cells + 1,),
           device)
    return nr


def _gate(body_box: torch.Tensor | None, pos: torch.Tensor,
          table: RigidTable, h: float) -> torch.Tensor | None:
    """The body's gate of a gated pass: `body_box` checked as (2, 3) f32
    on the queries' device, or on the card one made from the table where
    the caller has none (the plain versions compute every pair and take
    none)."""
    if body_box is not None:
        _check("body_box", body_box, torch.float32, (2, 3), pos.device)
    elif pos.is_cuda:
        body_box = make_body_box(table.pos, h)
    return body_box


def _rigid_viscosity_constants(h: float, c_s: float, alpha: float,
                               eps: float) -> tuple[float, float]:
    """nu = f32(2 alpha h c_s) and (f32(eps) h) h in f32, as
    rigid_dense.py:216, 224 form them."""
    hf = CubicConstants.of(h).h
    return f32(2.0 * alpha * h * c_s), f32(f32(f32(eps) * hf) * hf)


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------

def rigid_terms(pos: torch.Tensor, table: RigidTable, grid: nb.GridSpec,
                h: float, rho0: float,
                body_box: torch.Tensor | None = None) -> RigidTerms:
    """R1: the four solid sums of the cell-sorted fluid `pos` over the
    body's `table` (replaces rigid_dense.build_rigid_windows +
    rigid_terms). Only queries inside `body_box` walk the body, as in
    `rigid_contact_dot`."""
    body_box = _gate(body_box, pos, table, h)
    if not _on_cuda("rigid_terms", pos):
        return rigid_terms_plain(pos, table, grid, h, rho0)
    n = pos.shape[0]
    _check("pos", pos, torch.float32, (n, 3), pos.device)
    nr = _check_table(table, grid, pos.device)
    out = RigidTerms(rho=pos.new_empty(n), s=pos.new_empty(n, 3),
                     qsum=pos.new_empty(n), g2=pos.new_empty(n))
    _launch("rigid_terms", pos.device, pos, n, table.pos, table.vol,
            table.starts, nr, ctypes.byref(_params(grid, h)), f32(rho0),
            body_box, *out)
    return out


def rigid_contact_dot(pos: torch.Tensor, table: RigidTable,
                      grid: nb.GridSpec, h: float, rho0: float,
                      v_r: torch.Tensor,
                      body_box: torch.Tensor | None = None) -> torch.Tensor:
    """R2: (N,) sum_j w_s c x_ij . v_r[lid_j] of the (Nr, 3) rigid
    velocities `v_r` in original order (replaces rigid_dense.
    contact_dot_op). Only queries inside `body_box` walk the body
    (`stencil.make_body_box`; made here from the table where the caller
    has none)."""
    body_box = _gate(body_box, pos, table, h)
    if not _on_cuda("rigid_contact_dot", pos):
        return rigid_contact_dot_plain(pos, table, grid, h, rho0, v_r)
    n = pos.shape[0]
    _check("pos", pos, torch.float32, (n, 3), pos.device)
    nr = _check_table(table, grid, pos.device)
    _check("v_r", v_r, torch.float32, (nr, 3), pos.device)
    out = pos.new_empty(n)
    _launch("rigid_contact_dot", pos.device, pos, n, table.pos, table.vol,
            table.lid, table.starts, nr, ctypes.byref(_params(grid, h)),
            f32(rho0), v_r, body_box, out)
    return out


def rigid_viscosity(pos: torch.Tensor, table: RigidTable, grid: nb.GridSpec,
                    h: float, rho0: float, m: float, vel: torch.Tensor,
                    rho: torch.Tensor, rho_quirk: torch.Tensor,
                    body_vel: torch.Tensor, c_s: float, alpha: float,
                    eps: float = 0.01,
                    body_box: torch.Tensor | None = None) -> torch.Tensor:
    """R3: (N, 3) the solid branch of the Monaghan viscosity under
    compression, already scaled by m: the body's linear velocity
    `body_vel` (3,) on the rigid side and the neighbour density
    rho_quirk[lid_j] of the (Nr,) table in original order (replaces
    rigid_dense.viscosity_op). Only queries inside `body_box` walk the
    body, as in `rigid_contact_dot`."""
    body_box = _gate(body_box, pos, table, h)
    if not _on_cuda("rigid_viscosity", pos):
        return rigid_viscosity_plain(pos, table, grid, h, rho0, m, vel, rho,
                                     rho_quirk, body_vel, c_s, alpha, eps)
    n = pos.shape[0]
    _check("pos", pos, torch.float32, (n, 3), pos.device)
    nr = _check_table(table, grid, pos.device)
    _check("vel", vel, torch.float32, (n, 3), pos.device)
    _check("rho", rho, torch.float32, (n,), pos.device)
    _check("rho_quirk", rho_quirk, torch.float32, (nr,), pos.device)
    _check("body_vel", body_vel, torch.float32, (3,), pos.device)
    out = pos.new_empty(n, 3)
    _launch("rigid_viscosity", pos.device, pos, n, table.pos, table.vol,
            table.lid, table.starts, nr, ctypes.byref(_params(grid, h)),
            f32(rho0), f32(m),
            *_rigid_viscosity_constants(h, c_s, alpha, eps), vel, rho,
            rho_quirk, body_vel, body_box, out)
    return out


def rigid_side_force(rpos: torch.Tensor, rvol: torch.Tensor,
                     pos: torch.Tensor, starts: torch.Tensor,
                     grid: nb.GridSpec, h: float, rho0: float,
                     u: torch.Tensor, force: torch.Tensor) -> torch.Tensor:
    """R4: (Nr, 3) force + sum_i rho0 V_j c (x_i - x_j) u_i of each rigid
    particle j in original order (`rpos`, `rvol`) over the cell-sorted
    fluid `pos` with CSR `starts`, pairs with r <= h (replaces
    rigid_dense.build_rigid_side + rigid_side_force)."""
    if not _on_cuda("rigid_side_force", rpos):
        return rigid_side_force_plain(rpos, rvol, pos, starts, grid, h, rho0,
                                      u, force)
    nr, n = rpos.shape[0], pos.shape[0]
    _check("rigid pos", rpos, torch.float32, (nr, 3), rpos.device)
    _check("rigid vol", rvol, torch.float32, (nr,), rpos.device)
    _check("pos", pos, torch.float32, (n, 3), rpos.device)
    _check("starts", starts, torch.int32, (grid.num_cells + 1,), rpos.device)
    _check("u", u, torch.float32, (n,), rpos.device)
    _check("force", force, torch.float32, (nr, 3), rpos.device)
    out = torch.empty_like(force)
    _launch("rigid_side_force", rpos.device, rpos, rvol, nr, pos, starts, n,
            ctypes.byref(_params(grid, h)), f32(rho0), u, force,
            out)
    return out


def rigid_side_rows(rpos: torch.Tensor, starts: torch.Tensor,
              grid: nb.GridSpec) -> torch.Tensor:
    """R4, rows entry: the (warps + 1,) int64 warp offsets (stencil.
    warp_offsets) of the reaction list of the body's (Nr, 3) `rpos`, in
    original order, over the fluid's CSR table `starts`: each warp's room
    is its rows' largest fluid stencil count, read from `starts` at the
    body's own cells. No host read: the list's size is LIST_STRIDE
    offs[-1] (`list_slots`)."""
    if not _on_cuda("rigid_side_rows", rpos):
        return rigid_side_rows_plain(rpos, starts, grid)
    nr = rpos.shape[0]
    _check("rigid pos", rpos, torch.float32, (nr, 3), rpos.device)
    _check("starts", starts, torch.int32, (grid.num_cells + 1,), rpos.device)
    if nr == 0:
        return torch.zeros(1, dtype=torch.int64, device=rpos.device)
    # room[0] = 0 and each warp's room after it, written by the kernel
    room = torch.empty(-(-nr // LIST_STRIDE) + 1, dtype=torch.int64,
                       device=rpos.device)
    _launch("rigid_side_rows", rpos.device, rpos, nr, starts,
            ctypes.byref(_params(grid, grid.cell)), room)
    return torch.cumsum(room, 0)


def list_slots(offs: torch.Tensor) -> int:
    """The slots of the reaction list with warp offsets `offs`
    (`rigid_side_rows`), read on the host."""
    return LIST_STRIDE * int(offs[-1])


def _check_side(side: SideList, device: torch.device) -> int:
    nr = side.base.shape[0]
    _check("side.base", side.base, torch.int32, (nr,), device)
    _check("side.cnt", side.cnt, torch.int32, (nr,), device)
    _check("side.rec", side.rec, torch.int32, (side.rec.shape[0], 4),
           device)
    if side.rec.data_ptr() % 16:
        raise ValueError("side.rec: want 16-byte aligned records")
    return nr


def rigid_side_list(rpos: torch.Tensor, rvol: torch.Tensor,
                    pos: torch.Tensor, starts: torch.Tensor,
                    grid: nb.GridSpec, h: float, rho0: float,
                    offs: torch.Tensor, slots: int) -> SideList:
    """R4, list entry: the pairs that `rigid_side_force` charges, stored
    once a step in the rows of the warp offsets `offs` (`rigid_side_rows`;
    `slots` is their `list_slots`, read on the host) with their g = rho0
    V_j c (x_i - x_j) (replaces rigid_dense.build_rigid_side)."""
    nr = rpos.shape[0]
    slots = checked_slots(slots, nr)
    if not _on_cuda("rigid_side_list", rpos):
        return rigid_side_list_plain(rpos, rvol, pos, starts, grid, h, rho0,
                                     offs, slots)
    n = pos.shape[0]
    _check("rigid pos", rpos, torch.float32, (nr, 3), rpos.device)
    _check("rigid vol", rvol, torch.float32, (nr,), rpos.device)
    _check("pos", pos, torch.float32, (n, 3), rpos.device)
    _check("starts", starts, torch.int32, (grid.num_cells + 1,), rpos.device)
    _check("offs", offs, torch.int64, (-(-nr // LIST_STRIDE) + 1,),
           rpos.device)
    side = SideList(torch.empty(nr, dtype=torch.int32, device=rpos.device),
                    torch.empty(nr, dtype=torch.int32, device=rpos.device),
                    torch.empty(slots, 4, dtype=torch.int32,
                                device=rpos.device))
    _check_side(side, rpos.device)
    _launch("rigid_side_list", rpos.device, rpos, rvol, nr, pos, starts, n,
            ctypes.byref(_params(grid, h)), f32(rho0), offs, *side)
    return side


def rigid_side_force_list(side: SideList, value: torch.Tensor,
                          force: torch.Tensor, scale: float = 1.0,
                          owned: torch.Tensor | None = None) -> torch.Tensor:
    """R4, stream: (Nr, 3) force_j + sum_t g_jt u[i_jt] over the stored
    `side` (`rigid_side_list`), each row in walk order, u = `value` *
    f32(`scale`) formed at the gather (one f32 rounding, as torch's
    product) and 0 where the (N,) bool `owned` of a rank is False
    (replaces rigid_dense.rigid_side_force)."""
    if not _on_cuda("rigid_side_force_list", force):
        return rigid_side_force_list_plain(side, value, force, scale, owned)
    nr = _check_side(side, force.device)
    n = value.shape[0]
    _check("value", value, torch.float32, (n,), force.device)
    _check("force", force, torch.float32, (nr, 3), force.device)
    if owned is not None:
        _check("owned", owned, torch.bool, (n,), force.device)
    out = torch.empty_like(force)
    _launch("rigid_side_force_list", force.device, nr, *side, value,
            f32(scale), owned, force, out, entry="rigid_side_stream")
    return out


def rigid_counts(pos: torch.Tensor, table: RigidTable, grid: nb.GridSpec,
                 h: float) -> torch.Tensor:
    """(N,) int32 rigid particles within h of each cell-sorted fluid query,
    in plain PyTorch on either device: the neighbour colour view's
    (runner.Simulation.neighbor_counts), on no step's path."""
    out = torch.zeros(pos.shape[0], dtype=torch.int32, device=pos.device)
    for rows, pr in _pair_chunks(pos, table.pos, table.starts, grid, h,
                                 exclude_self=False):
        out[rows] = pr.valid.sum(dim=1, dtype=torch.int32)
    return out


# ---------------------------------------------------------------------------
# Plain PyTorch versions (ops/stencil.py's chunked candidates)
# ---------------------------------------------------------------------------

def _solid_pairs(pos: torch.Tensor, table: RigidTable, grid: nb.GridSpec,
                 h: float, rho0: float):
    """(rows, pairs, w_s, c) of each chunk of fluid queries against the
    sorted body."""
    for rows, pr in _pair_chunks(pos, table.pos, table.starts, grid, h,
                                 exclude_self=False):
        yield (rows, pr, f32(rho0) * table.vol[pr.slot],
               cubic_grad_coeff(pr.r, h))


def rigid_terms_plain(pos: torch.Tensor, table: RigidTable,
                      grid: nb.GridSpec, h: float,
                      rho0: float) -> RigidTerms:
    KERNELS["rigid_terms"].plain_calls += 1
    n = pos.shape[0]
    out = RigidTerms(rho=pos.new_zeros(n), s=pos.new_zeros(n, 3),
                     qsum=pos.new_zeros(n), g2=pos.new_zeros(n))
    for rows, pr, ws, gc in _solid_pairs(pos, table, grid, h, rho0):
        v = pr.valid
        wg = ws * gc
        wr = wg * pr.r
        out.rho[rows] = _rowsum(v, ws * cubic_w(pr.r, h))
        out.s[rows] = _rowsum3(v, pr, wg)
        out.qsum[rows] = _rowsum(v, wr * wr)
        out.g2[rows] = _rowsum(v, wg * gc * pr.r * pr.r)
    return out


def rigid_contact_dot_plain(pos: torch.Tensor, table: RigidTable,
                            grid: nb.GridSpec, h: float, rho0: float,
                            v_r: torch.Tensor) -> torch.Tensor:
    KERNELS["rigid_contact_dot"].plain_calls += 1
    out = pos.new_zeros(pos.shape[0])
    for rows, pr, ws, gc in _solid_pairs(pos, table, grid, h, rho0):
        vj = v_r[table.lid.long()[pr.slot]]
        dx, dy, dz = pr.d
        out[rows] = _rowsum(pr.valid, (ws * gc) * (
            dx * vj[..., 0] + dy * vj[..., 1] + dz * vj[..., 2]))
    return out


def rigid_viscosity_plain(pos: torch.Tensor, table: RigidTable,
                          grid: nb.GridSpec, h: float, rho0: float, m: float,
                          vel: torch.Tensor, rho: torch.Tensor,
                          rho_quirk: torch.Tensor, body_vel: torch.Tensor,
                          c_s: float, alpha: float,
                          eps: float = 0.01) -> torch.Tensor:
    KERNELS["rigid_viscosity"].plain_calls += 1
    nu_num, q2e_add = _rigid_viscosity_constants(h, c_s, alpha, eps)
    # A 0-d numerator: `float / tensor` would round as a reciprocal times
    # the float (ops/stencil.wcsph_forces_plain).
    nu = torch.full((), nu_num, dtype=torch.float32, device=pos.device)
    out = pos.new_zeros(pos.shape[0], 3)
    for rows, pr, ws, gc in _solid_pairs(pos, table, grid, h, rho0):
        dx, dy, dz = pr.d
        vi = vel[rows] - body_vel
        shear = (vi[:, 0, None] * dx + vi[:, 1, None] * dy
                 + vi[:, 2, None] * dz)
        rho_j = rho_quirk[table.lid.long()[pr.slot]]
        pi = -(nu / (rho[rows, None] + rho_j)) * shear \
            / (pr.r * pr.r + q2e_add)
        out[rows] = _rowsum3(pr.valid & (shear < 0.0), pr, -ws * pi * gc)
    return out * f32(m)


def rigid_side_force_plain(rpos: torch.Tensor, rvol: torch.Tensor,
                           pos: torch.Tensor, starts: torch.Tensor,
                           grid: nb.GridSpec, h: float, rho0: float,
                           u: torch.Tensor,
                           force: torch.Tensor) -> torch.Tensor:
    KERNELS["rigid_side_force"].plain_calls += 1
    out = force.clone()
    hf = CubicConstants.of(h).h
    for rows, pr in _pair_chunks(rpos, pos, starts, grid, h,
                                 exclude_self=False):
        coeff = (f32(rho0) * rvol[rows, None]) * cubic_grad_coeff(pr.r, h)
        ui = u[pr.slot]
        valid = pr.valid & (pr.r <= hf)
        # x_i - x_j: the chunks' d is query (rigid) minus source (fluid).
        out[rows] += torch.stack([_rowsum(valid, ((-d) * coeff) * ui)
                                  for d in pr.d], dim=1)
    return out


def rigid_side_rows_plain(rpos: torch.Tensor, starts: torch.Tensor,
                          grid: nb.GridSpec) -> torch.Tensor:
    """The warp offsets from the fluid's stencil count of every cell
    (`nb.stencil_counts`) at the body's cells."""
    KERNELS["rigid_side_rows"].plain_calls += 1
    return warp_offsets(nb.stencil_counts(starts, grid).index_select(
        0, nb.cell_id(rpos, grid)))


def rigid_side_list_plain(rpos: torch.Tensor, rvol: torch.Tensor,
                          pos: torch.Tensor, starts: torch.Tensor,
                          grid: nb.GridSpec, h: float, rho0: float,
                          offs: torch.Tensor, slots: int) -> SideList:
    """The pairs in the kernel's walk order, stored in the rows of `offs`
    as the kernel stores them (the slots past a row's count hold -1), so
    that each row's records compare exactly."""
    KERNELS["rigid_side_list"].plain_calls += 1
    nr = rpos.shape[0]
    side = SideList(warp_bases(offs, nr),
                    torch.zeros(nr, dtype=torch.int32, device=rpos.device),
                    torch.full((slots, 4), -1, dtype=torch.int32,
                               device=rpos.device))
    hf = CubicConstants.of(h).h
    for sl, pr in _pair_chunks(rpos, pos, starts, grid, h,
                               exclude_self=False,
                               offsets=walk_offsets(grid)):
        coeff = (f32(rho0) * rvol[sl, None]) * cubic_grad_coeff(pr.r, h)
        valid = pr.valid & (pr.r <= hf)
        side.cnt[sl] = valid.sum(dim=1, dtype=torch.int32)
        at = side.base[sl, None].long() \
            + LIST_STRIDE * (valid.cumsum(dim=1) - 1)
        # x_i - x_j: the chunks' d is query (rigid) minus source (fluid).
        g = torch.stack([(-d) * coeff for d in pr.d], dim=-1)
        side.rec[at[valid]] = torch.cat(
            [pr.slot[valid, None].to(torch.int32),
             g[valid].view(torch.int32)], dim=1)
    return side


def side_pairs(side: SideList
               ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(rows, fluid indices, g) of every stored pair, the first two int64,
    g (P, 3) f32, in pair order: row by row, each row's in walk order."""
    cnt = side.cnt.long()
    rows = torch.repeat_interleave(
        torch.arange(cnt.shape[0], device=cnt.device), cnt)
    first = torch.cumsum(cnt, 0) - cnt
    at = side.base.long()[rows] + LIST_STRIDE * (torch.arange(
        rows.shape[0], device=cnt.device) - first[rows])
    rec = side.rec[at]
    return rows, rec[:, 0].long(), rec[:, 1:].contiguous().view(torch.float32)


def rigid_side_force_list_plain(side: SideList, value: torch.Tensor,
                                force: torch.Tensor, scale: float = 1.0,
                                owned: torch.Tensor | None = None
                                ) -> torch.Tensor:
    """The stream form: u_i = value_i f32(scale) at each stored pair's
    fluid index i (0 where `owned` is False), its g u_i added into its row
    in pair order (index_add_), then to the force."""
    KERNELS["rigid_side_force_list"].plain_calls += 1
    rows, i, g = side_pairs(side)
    u = value[i] * f32(scale)
    if owned is not None:
        u = torch.where(owned[i], u, torch.zeros_like(u))
    return force + torch.zeros_like(force).index_add_(0, rows,
                                                      g * u[:, None])
