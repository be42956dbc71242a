"""Shared solver state and step plumbing.

Counterpart of `cfd_taichi_tpu/models/base.py` (reference solver_base.py):
the state tuples (a rigid body's among them), their initialization, the
per-step cell sort with its CSR offsets, and the small shared operators. Vectors are (N, 3) float32
tensors; the JAX package's component split (ops/vec.py) only served TPU
tiling. Fluid state is kept in cell-sorted order across steps, and `oid`
gives every particle its stable seeding-order identity.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from cfd_taichi_tpu_torch.ops import neighbors as nb
from cfd_taichi_tpu_torch.ops import rigid as rigid_ops
from cfd_taichi_tpu_torch.ops import stencil
from cfd_taichi_tpu_torch.ops.smoothing import f32
from cfd_taichi_tpu_torch.scene import RHO_0, Scene

ARTIFICIAL_FRICTION = 0.9999  # global velocity damping (solver_base.py:37)
V_DECAY = 0.5                 # clamp-boundary velocity decay (solver_base.py:18)
DENSITY_EPS = 0.001           # density seed (solver_base.py:44)


class FluidState(NamedTuple):
    pos: torch.Tensor   # (N, 3) f32
    vel: torch.Tensor   # (N, 3) f32
    acc: torch.Tensor   # (N, 3) f32
    oid: torch.Tensor   # (N,) int32 seeding-order id of each slot


class RigidBodyState(NamedTuple):
    """One rigid body (`cfd_taichi_tpu/models/base.py:64-80`): per-particle
    positions and the fluid's forces on them, in the voxels' original
    order, and the body's dynamics once (the reference replicates them per
    particle, rigid_solver.py:96-97, 128). Zero-sized without a body."""
    pos: torch.Tensor          # (Nr, 3) f32 particle positions, world frame
    vertices: torch.Tensor     # (V, 3) f32 mesh vertices, world frame
    vel: torch.Tensor          # (3,) linear velocity
    omega: torch.Tensor        # (3,) angular velocity
    alpha: torch.Tensor        # (3,) angular acceleration
    acc: torch.Tensor          # (3,) linear acceleration
    force: torch.Tensor        # (Nr, 3) fluid forces accumulated in a step
    centroid: torch.Tensor     # (3,)
    inertia_inv: torch.Tensor  # (3, 3)


class SimState(NamedTuple):
    fluid: FluidState
    rigid: RigidBodyState      # zero-sized tensors when there is no body
    dt: torch.Tensor          # () f32 on the device (adaptive in DFSPH)
    t: torch.Tensor           # () f32 simulated time
    step_count: torch.Tensor  # () int32
    extra: tuple              # per-solver warm-start state
    # [iters_a, residual_a, iters_b, residual_b] of the last step.
    diag: torch.Tensor
    # Dropped-pair count. The CSR stencil has no capacity, so it stays 0;
    # kept for the JAX state's layout and telemetry.
    overflow: torch.Tensor


class Shard(NamedTuple):
    """One rank's hooks into a solver step (parallel/domain.py), whose rows
    are then the rank's owned and ghost particles, compacted and
    cell-sorted. A single-device step passes None, and each hook is then
    the identity: every row is its own."""
    sync: Callable        # (n, ...) -> the same, each ghost row's values
    #                       replaced by its owner's (a trade with the ring
    #                       neighbours)
    owned: torch.Tensor   # (n,) bool: the rows the rank owns, which the
    #                       residual averages count
    upd: torch.Tensor     # (n,) bool: the rows DFSPH's loops update: owned,
    #                       or ghosts within h of the slab
    sum: Callable         # (0-d, ...) -> each summed over the ranks
    max: Callable         # (n,) >= 0 -> its max over every rank's owned rows
    loop: dict            # `agree` and `eager` of ops/loops.while_loop_unrolled
    total: Callable       # a tensor -> its elementwise sum over the ranks, in
    #                       its dtype (a body's reaction, the rho quirk's
    #                       table; never inside a loop's trip)


def synced(shard: Shard | None, x: torch.Tensor) -> torch.Tensor:
    """`x` with its ghost rows' values from their owners (module note of
    parallel/domain.py); `x` itself on one device."""
    return x if shard is None else shard.sync(x)


def empty_rigid(device) -> RigidBodyState:
    """The body of a scene without one (`empty_rigid` of the JAX package)."""
    z3 = torch.zeros(3, dtype=torch.float32, device=device)
    z0 = torch.zeros(0, 3, dtype=torch.float32, device=device)
    return RigidBodyState(pos=z0, vertices=z0.clone(), vel=z3,
                          omega=z3.clone(), alpha=z3.clone(), acc=z3.clone(),
                          force=z0.clone(), centroid=z3.clone(),
                          inertia_inv=torch.zeros(3, 3, dtype=torch.float32,
                                                  device=device))


def init_rigid_state(scene: Scene) -> RigidBodyState:
    """The body as built, at rest, with no force yet."""
    if scene.rigid0 is None:
        return empty_rigid(scene.device)
    r = scene.rigid0
    z3 = torch.zeros(3, dtype=torch.float32, device=scene.device)
    return RigidBodyState(
        pos=r.pos.clone(), vertices=r.vertices.clone(), vel=z3,
        omega=z3.clone(), alpha=z3.clone(), acc=z3.clone(),
        force=torch.zeros_like(r.pos), centroid=r.centroid.clone(),
        inertia_inv=r.inertia_inv.clone())


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a x b over the last axis of broadcastable (..., 3) tensors, each
    component the JAX package's expression (`ops/vec.py` V3.cross)."""
    ax, ay, az = a.unbind(dim=-1)
    bx, by, bz = b.unbind(dim=-1)
    return torch.stack([ay * bz - az * by, az * bx - ax * bz,
                        ax * by - ay * bx], dim=-1)


def rigid_contact_vel(rigid: RigidBodyState, dt: torch.Tensor,
                      include_alpha: bool,
                      include_acc: bool = True) -> torch.Tensor:
    """(Nr, 3) contact velocity v + a dt + (omega [+ alpha dt]) x (x_j -
    centroid) of each rigid particle (`cfd_taichi_tpu/models/base.py:
    494-506`; reference dfsph_solver.py:163-170, 288-294)."""
    om = rigid.omega + rigid.alpha * dt if include_alpha else rigid.omega
    lin = rigid.vel + rigid.acc * dt if include_acc else rigid.vel
    return lin + cross(om, rigid.pos - rigid.centroid)


def body_terms(scene: Scene, rigid: RigidBodyState, pos: torch.Tensor
               ) -> tuple[rigid_ops.RigidTable | None,
                          rigid_ops.RigidTerms | None]:
    """The body's cell table, sorted anew each step (the body moved in the
    last rigid step), and its solid sums at the cell-sorted fluid `pos`;
    (None, None) on a scene without a coupled body."""
    if not scene.coupled:
        return None, None
    table = rigid_ops.rigid_table(scene.grid, rigid.pos, scene.rigid_volume)
    return table, rigid_ops.rigid_terms(pos, table, scene.grid, scene.h,
                                        RHO_0)


def rho_quirk(rho: torch.Tensor, oid: torch.Tensor, n_rigid: int,
              shard: Shard | None = None,
              n_fluid: int | None = None) -> torch.Tensor:
    """(Nr,) the density the solid viscosity reads for rigid particle j:
    the reference's quirk (solver_base.py:187, 199), the fluid density at
    index j of the seeding order (through `oid`), j clipped to the fluid's
    last index (`cfd_taichi_tpu/models/dfsph.py:548-551`; ROADMAP.md
    section 3).

    On a rank of a sharded step (`shard`; `cfd_taichi_tpu/parallel/
    domain.py:592-604, 805-815`) the rows are the rank's owned and ghost
    ones, and `n_fluid` is the scene's fluid count: the owned rows with 0
    <= oid < n_quirk = min(n_rigid, n_fluid) write their rho into an
    (n_quirk,) table, which is summed over the ranks (each id is owned by
    one rank, so the sum is exact) and read at j clipped to n_quirk - 1.
    The rows without an entry write a spare last slot, which is dropped."""
    if shard is None:
        rho_orig = torch.zeros_like(rho).index_put_((oid.long(),), rho)
        return rho_orig[torch.arange(n_rigid, device=rho.device).clamp(
            max=rho.shape[0] - 1)]
    n_quirk = min(n_rigid, n_fluid)
    keep = shard.owned & (oid >= 0) & (oid < n_quirk)
    slot = torch.where(keep, oid.long(), n_quirk)
    table = rho.new_zeros(n_quirk + 1).index_put_((slot,), rho)[:n_quirk]
    return shard.total(table)[torch.arange(
        n_rigid, device=rho.device).clamp(max=n_quirk - 1)]


def solid_viscosity(scene: Scene, rigid: RigidBodyState,
                    table: rigid_ops.RigidTable, pos: torch.Tensor,
                    vel: torch.Tensor, rho: torch.Tensor, oid: torch.Tensor,
                    c_s: float, alpha: float,
                    shard: Shard | None = None) -> torch.Tensor:
    """(N, 3) the solid branch of the solver's viscosity: the body's
    linear velocity and the rho quirk on the rigid side (on a rank, its
    table summed over the ranks)."""
    return rigid_ops.rigid_viscosity(
        pos, table, scene.grid, scene.h, RHO_0, scene.particle_m, vel, rho,
        rho_quirk(rho, oid, scene.n_rigid, shard, scene.n_fluid), rigid.vel,
        c_s, alpha)


def body_reaction(scene: Scene, rigid: RigidBodyState, pos: torch.Tensor,
                  starts: torch.Tensor, u: torch.Tensor,
                  force: torch.Tensor,
                  shard: Shard | None = None) -> torch.Tensor:
    """The body's (Nr, 3) `force` plus the fluid's reaction of the per-fluid
    scalar `u` (already scaled by m), each fluid-rigid pair charged once
    from the rigid side. On a rank of a sharded step (`shard`) u is zeroed
    on the rows the rank does not own, so that each pair is charged by one
    rank (`cfd_taichi_tpu/parallel/domain.py:817-827`), and `force` is the
    rank's partial (`reaction_start`)."""
    if shard is not None:
        u = torch.where(shard.owned, u, torch.zeros_like(u))
    return rigid_ops.rigid_side_force(rigid.pos, scene.rigid_volume, pos,
                                      starts, scene.grid, scene.h, RHO_0, u,
                                      force)


def _partial(scene: Scene, shard: Shard | None) -> bool:
    """Whether a step's reactions go to a rank's partial: on a rank of a
    sharded step, on a scene whose fluid pushes a body back."""
    return shard is not None and scene.coupled and scene.fs_couple


def reaction_start(scene: Scene, rigid: RigidBodyState,
                   shard: Shard | None = None) -> torch.Tensor:
    """The (Nr, 3) force that a step's reactions (`body_reaction`) add to:
    the body's incoming force on one device; on a rank of a sharded step
    zeros, the rank's partial, which `reaction_total` sums over the ranks
    once the step's loop is done."""
    return (torch.zeros_like(rigid.force) if _partial(scene, shard)
            else rigid.force)


def reaction_total(scene: Scene, rigid: RigidBodyState, acc: torch.Tensor,
                   shard: Shard | None = None) -> torch.Tensor:
    """The body's force after a step that added its reactions to
    `reaction_start`'s tensor: that tensor on one device; on a rank the
    incoming force plus the partials summed over the ranks (one
    all-reduce, outside the loop's trips). The rigid step zeroes the
    force, so the incoming force is 0 and a world of one adds 0 to the
    single-device sum: the same bits."""
    return rigid.force + shard.total(acc) if _partial(scene, shard) else acc


def step_reaction(scene: Scene, rigid: RigidBodyState, pos: torch.Tensor,
                  starts: torch.Tensor, u: torch.Tensor,
                  shard: Shard | None = None) -> torch.Tensor:
    """The body's force after a step that charges the reaction of `u` once
    (IISPH, WCSPH): `body_reaction` between `reaction_start` and
    `reaction_total`."""
    acc = body_reaction(scene, rigid, pos, starts, u,
                        reaction_start(scene, rigid, shard), shard)
    return reaction_total(scene, rigid, acc, shard)


def init_sim_state(scene: Scene, extra: tuple = ()) -> SimState:
    n, dev = scene.n_fluid, scene.device
    vel0 = torch.tensor(scene.fluid_vel0, dtype=torch.float32,
                        device=dev).expand(n, 3).contiguous()
    return SimState(
        fluid=FluidState(
            pos=scene.fluid_pos0.clone(), vel=vel0,
            acc=torch.zeros(n, 3, dtype=torch.float32, device=dev),
            oid=torch.arange(n, dtype=torch.int32, device=dev)),
        rigid=init_rigid_state(scene),
        dt=torch.tensor(scene.dt0, dtype=torch.float32, device=dev),
        t=torch.zeros((), dtype=torch.float32, device=dev),
        step_count=torch.zeros((), dtype=torch.int32, device=dev),
        extra=extra,
        diag=torch.zeros(4, dtype=torch.float32, device=dev),
        overflow=torch.zeros((), dtype=torch.int32, device=dev))


def sort_by_cells(grid: nb.GridSpec, pos: torch.Tensor, extras: tuple = ()):
    """Stable sort on the cell id, gathering positions and the caller's
    per-particle `extras` by the permutation (`cfd_taichi_tpu/models/
    base.py:306-319`). Returns (sorted cell ids, perm, pos_s, extras_s)."""
    scid, perm = torch.sort(nb.cell_id(pos, grid), stable=True)
    return scid, perm, pos[perm], tuple(e[perm] for e in extras)


def one_shot_terms(scene: Scene, pos: torch.Tensor, starts: torch.Tensor
                   ) -> tuple[stencil.FluidTerms, stencil.BoundaryTerms | None]:
    """The one-shot fluid sums of the cell-sorted `pos` with CSR `starts`,
    and the Akinci boundary sums on a scene with walls (else None)."""
    grid, h = scene.grid, scene.h
    ft = stencil.fluid_terms(pos, starts, grid, h, scene.particle_m)
    bt = (stencil.boundary_terms(pos, scene.boundary_pos,
                                 scene.boundary_volume,
                                 scene.boundary_starts, grid, h, RHO_0,
                                 scene.boundary_near)
          if scene.akinci else None)
    return ft, bt


def walls(scene: Scene) -> stencil.Walls | None:
    """The scene's Akinci boundary set, or None on a clamp scene."""
    if not scene.akinci:
        return None
    return stencil.Walls(scene.boundary_pos, scene.boundary_volume,
                         scene.boundary_starts, scene.boundary_near)


def sorted_density(scene: Scene, pos: torch.Tensor):
    """Cell sort of `pos` and its density rho = 0.001 + sum_f m W +
    sum_b rho0 V_b W (reference solver_base.py:41-72), self excluded.
    Returns (perm, sorted pos, CSR starts, rho in sorted order, the
    boundary sums or None)."""
    scid, perm, pos_s, _ = sort_by_cells(scene.grid, pos)
    starts = nb.csr_starts(scid, scene.grid.num_cells)
    rho, bt = density(scene, pos_s, starts)
    return perm, pos_s, starts, rho, bt


def density(scene: Scene, pos: torch.Tensor, starts: torch.Tensor):
    """(rho, the boundary sums or None) of the cell-sorted `pos` with CSR
    `starts`, as `sorted_density` gives them."""
    ft, bt = one_shot_terms(scene, pos, starts)
    rho = f32(DENSITY_EPS) + ft.rho
    if bt is not None:
        rho = rho + bt.rho
    return rho, bt


def gravity_acc(scene: Scene) -> torch.Tensor:
    """(3,) a = g (0, -1, 0) (reference solver_base.py:131-134): the
    scene's tensor, made once at build_scene."""
    return scene.gravity_acc


def clamp_bounds(scene: Scene, margin: float
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """(lo, hi) (3,) f32: the box shrunk by `margin`, each bound rounded
    to f32 from the Python double f32(b +- margin). Made on the scene's
    device on first use of the margin, then reused."""
    got = scene.clamp_bounds.get(margin)
    if got is None:
        got = scene.clamp_bounds[margin] = tuple(
            torch.tensor([f32(b + sign * margin) for b in box],
                         dtype=torch.float32, device=scene.device)
            for sign, box in ((1.0, scene.box_min), (-1.0, scene.box_max)))
    return got


def clamp_to_box(scene: Scene, pos: torch.Tensor, vel: torch.Tensor,
                 margin: float, decay_mul: float):
    """Clamp-mode boundary: project positions into the box shrunk by
    `margin` and scale the offending velocity components by `decay_mul`
    (reference wcsph_solver.py:54-63)."""
    lo, hi = clamp_bounds(scene, margin)
    hits = (pos <= lo) | (pos >= hi)
    new_pos = torch.minimum(torch.maximum(pos, lo), hi)
    new_vel = torch.where(hits, vel * f32(decay_mul), vel)
    return new_pos, new_vel
