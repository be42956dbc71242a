"""Scene assembly, physics part: config -> particle counts, grid, boundary
shell with its volumes, and the initial fluid block.

Counterpart of `cfd_taichi_tpu/scene.py:205-467` (reference
ParticleSystem.py:31-127, 225-247) without the capacity ladder: the port's
pair passes walk the CSR stencil (ops/stencil.py) and need no capacities.
The boundary shell is static, so it is stored once in cell-sorted order
together with its CSR offsets.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from cfd_taichi_tpu_torch import geometry as geo
from cfd_taichi_tpu_torch.config import SimConfig
from cfd_taichi_tpu_torch.ops import neighbors as nb

RHO_0 = 1000.0  # fluid rest density (reference solver_base.py:19)


@dataclasses.dataclass(frozen=True)
class Scene:
    n_fluid: int
    n_boundary: int
    particle_radius: float
    h: float                  # support radius = 4r (ParticleSystem.py:82)
    particle_m: float         # 1000 (2r)^3 (ParticleSystem.py:83)
    gravity: float
    box_min: tuple[float, float, float]
    box_max: tuple[float, float, float]
    grid: nb.GridSpec
    akinci: bool              # boundary_handle: Akinci walls vs clamp
    dt0: float
    fluid_pos0: torch.Tensor        # (Nf, 3) f32 seed lattice
    fluid_vel0: tuple[float, float, float]
    boundary_pos: torch.Tensor      # (Nb, 3) f32, cell-sorted
    boundary_volume: torch.Tensor   # (Nb,) f32 V_b, same order
    boundary_starts: torch.Tensor   # (num_cells + 1,) int32 CSR offsets

    @property
    def device(self) -> torch.device:
        return self.fluid_pos0.device


def build_scene(cfg: SimConfig, device="cuda") -> Scene:
    """Build the fluid-only scene of `cfg` with its tensors on `device`."""
    sc, sv, fl = cfg.scene, cfg.solver, cfg.fluid
    if cfg.solid is not None:
        raise NotImplementedError(
            "rigid bodies (config 'solid' section) are not ported yet: "
            "ROADMAP.md, queue 1, 'Two-way rigid coupling'")
    r = sc.particle_radius
    h = cfg.support_radius
    grid = nb.grid_for_box(sc.box_min, sc.box_max, h)

    # A block seeded outside the box would be cell-clamped into edge cells
    # (same check as the JAX package).
    for ax in range(3):
        if (fl.start_pos[ax] < sc.box_min[ax] - 1e-6
                or fl.start_pos[ax] + fl.water_size[ax]
                > sc.box_max[ax] + 1e-6):
            raise ValueError(
                f"fluid block [{fl.start_pos[ax]:.3f}, "
                f"{fl.start_pos[ax] + fl.water_size[ax]:.3f}] exceeds the "
                f"box [{sc.box_min[ax]:.3f}, {sc.box_max[ax]:.3f}] on axis "
                f"{ax}")

    fluid_pos = geo.seed_fluid_block(fl.water_size, fl.start_pos, r)
    boundary_pos = geo.seed_boundary_shell(sc.box_min, sc.box_max, r)
    # V_b = 1 / sum_{k != b} W_bk (ParticleSystem.py:309-320).
    bvol = torch.as_tensor(_inverse_kernel_sum_np(boundary_pos, grid, h),
                           device=device)
    bpos = torch.as_tensor(boundary_pos, device=device)
    btable = nb.build_cell_table(bpos, grid)

    return Scene(
        n_fluid=fluid_pos.shape[0], n_boundary=boundary_pos.shape[0],
        particle_radius=r, h=h, particle_m=cfg.particle_mass,
        gravity=sc.gravity, box_min=sc.box_min, box_max=sc.box_max,
        grid=grid, akinci=sv.boundary_handle, dt0=sv.delta_time,
        fluid_pos0=torch.as_tensor(fluid_pos, device=device),
        fluid_vel0=tuple(float(c) for c in fl.initial_velocity),
        boundary_pos=bpos[btable.order],
        boundary_volume=bvol[btable.order],
        boundary_starts=btable.starts)


def _kernel_sum_np(pos_rows: np.ndarray, grid: nb.GridSpec,
                   h: float) -> np.ndarray:
    """sum_{j != i} W(|x_i - x_j|, h) of a static particle set against
    itself, host numpy in double, cell-bucketed (as
    `cfd_taichi_tpu/scene.py:770-841`)."""
    n = pos_rows.shape[0]
    if n == 0:
        return np.zeros((0,), np.float32)
    pos = np.asarray(pos_rows, np.float64)
    cells = nb.cell_id_np(pos_rows, grid)
    order = np.argsort(cells, kind="stable")
    sc = cells[order]
    occ = np.bincount(cells, minlength=grid.num_cells)
    cap = int(occ.max())
    # Dense (num_cells, cap) bucket of sorted indices (-1 = empty slot).
    rank = np.arange(n) - np.searchsorted(sc, sc, side="left")
    dense = np.full((grid.num_cells, cap), -1, np.int64)
    dense[sc, rank] = order
    dmask = dense >= 0
    dpos = pos[np.clip(dense, 0, n - 1)]          # (C, cap, 3)

    occ_cells = np.nonzero(occ)[0]
    gx, gy, gz = grid.dims
    sx, sy, sz = grid.strides
    # Decode each occupied cell's coordinates from the linear id (exact;
    # re-deriving them from positions hits f32-vs-f64 floor mismatches).
    axes = np.argsort(grid.strides)[::-1]
    rem = occ_cells.copy()
    coord = [None, None, None]
    for a in axes:
        coord[a] = rem // grid.strides[a]
        rem = rem - coord[a] * grid.strides[a]
    cx, cy, cz = coord

    qpos = dpos[occ_cells]                        # (M, cap, 3)
    qmask = dmask[occ_cells]
    qidx = dense[occ_cells]
    acc = np.zeros(qpos.shape[:2], np.float64)
    h2 = h * h
    k8 = 8.0 / (np.pi * h ** 3)
    for ox in (-1, 0, 1):
        for oy in (-1, 0, 1):
            for oz in (-1, 0, 1):
                nx, ny, nz = cx + ox, cy + oy, cz + oz
                ok = ((nx >= 0) & (nx < gx) & (ny >= 0) & (ny < gy)
                      & (nz >= 0) & (nz < gz))
                ncid = np.clip(nx * sx + ny * sy + nz * sz, 0,
                               grid.num_cells - 1)
                spos = dpos[ncid]
                smask = dmask[ncid] & ok[:, None]
                d2 = ((qpos[:, :, None, :] - spos[:, None, :, :]) ** 2
                      ).sum(axis=3)               # (M, cap, cap)
                q = np.sqrt(d2) / h
                w = np.where(q <= 0.5, k8 * (6.0 * (q ** 3 - q ** 2) + 1.0),
                             2.0 * k8 * (1.0 - q) ** 3)
                # d2 > 0 excludes self (static sets have no duplicates).
                w = np.where((d2 <= h2) & (d2 > 0.0), w, 0.0)
                w = np.where(smask[:, None, :], w, 0.0)
                acc += w.sum(axis=2)
    out = np.zeros((n,), np.float64)
    out[qidx[qmask]] = acc[qmask]
    return out.astype(np.float32)


def _inverse_kernel_sum_np(pos_rows: np.ndarray, grid: nb.GridSpec,
                           h: float) -> np.ndarray:
    s = _kernel_sum_np(pos_rows, grid, h)
    return 1.0 / s  # reference divides unguarded (ParticleSystem.py:314)
