"""Scene assembly, physics part: config -> particle counts, grid, boundary
shell with its volumes, the initial fluid block, and a rigid body's voxels
with their volumes and the body's mass properties.

Counterpart of `cfd_taichi_tpu/scene.py:175-467` (reference
ParticleSystem.py:31-127, 225-263) without the capacity ladder: the port's
pair passes walk the CSR stencil (ops/stencil.py, ops/rigid.py) and need
no capacities. The boundary shell is static, so it is stored once in
cell-sorted order together with its CSR offsets and the per-cell count of
boundary particles near, which lets an interior query skip the boundary
walk. A rigid body moves, so its cell table is made every step
(ops/rigid.rigid_table).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from cfd_taichi_tpu_torch import geometry as geo
from cfd_taichi_tpu_torch.config import SimConfig, resolve_mesh_path
from cfd_taichi_tpu_torch.ops import neighbors as nb
from cfd_taichi_tpu_torch.ops.loops import GraphPool
from cfd_taichi_tpu_torch.ops.smoothing import f32

RHO_0 = 1000.0  # fluid rest density (reference solver_base.py:19)


class RigidInit(NamedTuple):
    """The rigid body as built: the initial state's pieces (models/base.
    init_rigid_state) and the mesh for export."""
    pos: torch.Tensor          # (Nr, 3) f32 voxel centres, world frame
    vertices: torch.Tensor     # (V, 3) f32 mesh vertices, world frame
    faces: np.ndarray          # (F, 3) int32, host side
    centroid: torch.Tensor     # (3,)
    inertia_inv: torch.Tensor  # (3, 3)
    inertia: torch.Tensor      # (3, 3)


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
    # (num_cells,) int32: boundary particles in each cell's 27-cell stencil
    # (0: a query of the cell has no boundary candidate).
    boundary_near: torch.Tensor
    # (3,) f32 g (0, -1, 0) on the device, made once: a tensor made from a
    # list each step is a host-to-device copy that waits for the card.
    gravity_acc: torch.Tensor
    # --- the rigid body (config 'solid' section), if any -------------------
    n_rigid: int = 0
    has_rigid: bool = False     # a body was built
    rigid_active: bool = False  # it takes part in the step (solid.active)
    fs_couple: bool = True      # two-way coupling: the fluid pushes back
    rigid_rho: float = 0.0
    rigid_volume: Optional[torch.Tensor] = None  # (Nr,) V_i = 1 / sum W
    rigid_mass: Optional[torch.Tensor] = None    # (Nr,) rho_rigid V_i
    rigid_mass_total: Optional[torch.Tensor] = None  # () sum of masses
    rigid0: Optional[RigidInit] = None
    # (lo, hi) (3,) f32: the box shrunk by one diameter, f32(box) +- f32(2r)
    # as JAX forms it, where the body's collision response acts.
    rigid_box: Optional[tuple] = None
    # {margin: (lo, hi)} (3,) f32 bounds of the clamp boundary, made on
    # first use of each margin (models/base.clamp_to_box). Not an argument:
    # a scene made with dataclasses.replace starts with an empty one.
    clamp_bounds: dict = dataclasses.field(
        default_factory=dict, init=False, repr=False, compare=False)
    # The memory pool that the solver loops' trip graphs share, and its
    # counts of trips and captures (ops/loops.py). Not an argument either.
    loop_graphs: GraphPool = dataclasses.field(
        default_factory=GraphPool, init=False, repr=False, compare=False)

    @property
    def device(self) -> torch.device:
        return self.fluid_pos0.device

    @property
    def coupled(self) -> bool:
        """A rigid body takes part in the fluid step."""
        return self.rigid_active and self.n_rigid > 0


def build_scene(cfg: SimConfig, device="cuda") -> Scene:
    """Build the scene of `cfg` with its tensors on `device`."""
    sc, sv, fl = cfg.scene, cfg.solver, cfg.fluid
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
    rigid = (_build_rigid(cfg, grid, h, device)
             if cfg.solid is not None else {})

    return Scene(
        n_fluid=fluid_pos.shape[0], n_boundary=boundary_pos.shape[0],
        particle_radius=r, h=h, particle_m=cfg.particle_mass,
        gravity=sc.gravity, box_min=sc.box_min, box_max=sc.box_max,
        grid=grid, akinci=sv.boundary_handle, dt0=sv.delta_time,
        fluid_pos0=torch.as_tensor(fluid_pos, device=device),
        fluid_vel0=tuple(float(c) for c in fl.initial_velocity),
        boundary_pos=bpos[btable.order],
        boundary_volume=bvol[btable.order],
        boundary_starts=btable.starts,
        boundary_near=nb.stencil_counts(btable.starts, grid),
        gravity_acc=torch.tensor([0.0, -sc.gravity, 0.0],
                                 dtype=torch.float32, device=device),
        **rigid)


def _rotation3d_swapped(att_rad: np.ndarray) -> np.ndarray:
    """The reference's attitude rotation `ti.math.rotation3d(att.x, att.z,
    att.y)`, with its swapped (x, z, y) arguments (ParticleSystem.py:200,
    rigid_solver.py:132): Rz(att.y) @ Ry(att.z) @ Rx(att.x), in double and
    rounded to f32, as `cfd_taichi_tpu/scene.py:175-188`."""
    ax, ay, az = float(att_rad[0]), float(att_rad[2]), float(att_rad[1])
    cx, sx = np.cos(ax), np.sin(ax)
    cy, sy = np.cos(ay), np.sin(ay)
    cz, sz = np.cos(az), np.sin(az)
    rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
    return (rz @ ry @ rx).astype(np.float32)


def rotation3d_swapped(att_rad: torch.Tensor) -> torch.Tensor:
    """`_rotation3d_swapped` of a (3,) f32 tensor, in f32 on its device:
    the per-step rotation of models/rigid.step."""
    ax, ay, az = att_rad[0], att_rad[2], att_rad[1]
    cx, sx = torch.cos(ax), torch.sin(ax)
    cy, sy = torch.cos(ay), torch.sin(ay)
    cz, sz = torch.cos(az), torch.sin(az)
    one, zero = torch.ones_like(ax), torch.zeros_like(ax)
    rx = torch.stack([torch.stack([one, zero, zero]),
                      torch.stack([zero, cx, -sx]),
                      torch.stack([zero, sx, cx])])
    ry = torch.stack([torch.stack([cy, zero, sy]),
                      torch.stack([zero, one, zero]),
                      torch.stack([-sy, zero, cy])])
    rz = torch.stack([torch.stack([cz, -sz, zero]),
                      torch.stack([sz, cz, zero]),
                      torch.stack([zero, zero, one])])
    return rz @ ry @ rx


def _build_rigid(cfg: SimConfig, grid: nb.GridSpec, h: float,
                 device) -> dict:
    """The rigid body of `cfg.solid` as Scene fields
    (`cfd_taichi_tpu/scene.py:249-298`): the mesh voxelized at pitch 2
    voxel_radius, rotated and offset in f32; V_i = 1 / sum_{j != i} W_ij
    over the body, 0 where the sum underflows 1e-6 (ParticleSystem.py:
    252-259); masses rho_rigid V_i, the centroid, the inertia tensor and
    its inverse. The mass properties are f32 sums made on the CPU, so a
    scene on the card holds the same values as one on the CPU."""
    so, sc = cfg.solid, cfg.scene
    verts, faces = geo.load_mesh(resolve_mesh_path(so.mesh, cfg.base_dir),
                                 scale=so.scale)
    vox = geo.voxelize_mesh(verts, faces, pitch=2 * so.voxel_radius,
                            fill=so.fill)
    att = np.asarray(so.attitude_offset, np.float64) / 180.0 * np.pi
    rot = _rotation3d_swapped(att)
    off = np.asarray(so.pos_offset, np.float32)
    vox = np.ascontiguousarray((vox @ rot.T + off).astype(np.float32))
    verts_w = np.ascontiguousarray((verts @ rot.T + off).astype(np.float32))

    inv_w = torch.from_numpy(_kernel_sum_np(vox, grid, h))
    eps = f32(1e-6)
    rvol = torch.where(inv_w < eps, torch.zeros_like(inv_w),
                       1.0 / torch.clamp(inv_w, min=eps))
    rmass = rvol * f32(so.rho_0)
    msum = rmass.sum()
    rpos = torch.from_numpy(vox)
    centroid = (rpos * rmass[:, None]).sum(dim=0) / msum
    x, y, z = (rpos - centroid).unbind(dim=1)
    m = rmass
    ixx = (m * (y * y + z * z)).sum()
    iyy = (m * (x * x + z * z)).sum()
    izz = (m * (x * x + y * y)).sum()
    ixy = -(m * x * y).sum()
    ixz = -(m * x * z).sum()
    iyz = -(m * z * y).sum()
    inertia = torch.stack([torch.stack([ixx, ixy, ixz]),
                           torch.stack([ixy, iyy, iyz]),
                           torch.stack([ixz, iyz, izz])])
    margin = f32(2.0 * sc.particle_radius)

    def dev(t):
        return t.to(device)

    return dict(
        n_rigid=vox.shape[0], has_rigid=True, rigid_active=bool(so.active),
        fs_couple=bool(cfg.solver.fs_couple), rigid_rho=float(so.rho_0),
        rigid_volume=dev(rvol), rigid_mass=dev(rmass),
        rigid_mass_total=dev(msum),
        rigid0=RigidInit(pos=dev(rpos), vertices=dev(torch.from_numpy(
            verts_w)), faces=faces, centroid=dev(centroid),
            inertia_inv=dev(torch.linalg.inv(inertia)),
            inertia=dev(inertia)),
        rigid_box=tuple(dev(torch.tensor(b, dtype=torch.float32) + sign
                            * margin) for sign, b in ((1.0, sc.box_min),
                                                      (-1.0, sc.box_max))))


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
