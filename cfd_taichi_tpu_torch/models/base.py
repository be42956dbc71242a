"""Shared solver state and step plumbing.

Counterpart of `cfd_taichi_tpu/models/base.py` (reference solver_base.py):
the state tuples, their initialization, the per-step cell sort with its CSR
offsets, and the small shared operators. Vectors are (N, 3) float32
tensors; the JAX package's component split (ops/vec.py) only served TPU
tiling. Fluid state is kept in cell-sorted order across steps, and `oid`
gives every particle its stable seeding-order identity.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from cfd_taichi_tpu_torch.ops import neighbors as nb
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


class SimState(NamedTuple):
    fluid: FluidState
    # Rigid body state. Rigid coupling is not ported yet (ROADMAP.md), so
    # this is always None; the field keeps the JAX state's layout.
    rigid: Optional[object]
    dt: torch.Tensor          # () f32 on the device (adaptive in DFSPH)
    t: torch.Tensor           # () f32 simulated time
    step_count: torch.Tensor  # () int32
    extra: tuple              # per-solver warm-start state
    # [iters_a, residual_a, iters_b, residual_b] of the last step.
    diag: torch.Tensor
    # Dropped-pair count. The CSR stencil has no capacity, so it stays 0;
    # kept for the JAX state's layout and telemetry.
    overflow: torch.Tensor


def init_sim_state(scene: Scene, extra: tuple = ()) -> SimState:
    n, dev = scene.n_fluid, scene.device
    vel0 = torch.tensor(scene.fluid_vel0, dtype=torch.float32,
                        device=dev).expand(n, 3).contiguous()
    return SimState(
        fluid=FluidState(
            pos=scene.fluid_pos0.clone(), vel=vel0,
            acc=torch.zeros(n, 3, dtype=torch.float32, device=dev),
            oid=torch.arange(n, dtype=torch.int32, device=dev)),
        rigid=None,
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
    ft, bt = one_shot_terms(scene, pos_s, starts)
    rho = f32(DENSITY_EPS) + ft.rho
    if bt is not None:
        rho = rho + bt.rho
    return perm, pos_s, starts, rho, bt


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
