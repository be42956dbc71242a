"""Seeded inputs of the kernel checks and measurements: the jittered seed
lattice of a config, a clustered cloud for the stencil walk's edge cases,
a ragged CSR engine of the coef contraction, a rigid body in a fluid
block for the fluid-rigid passes, a compressed start state, the
half-immersed variant of configs/torus_flush.json, and the loop engine of
DFSPH and IISPH and the pressure loops' iterations a trip pinned for a
run."""

from __future__ import annotations

import contextlib
import dataclasses
from pathlib import Path

import numpy as np
import torch

from cfd_taichi_tpu_torch.config import SimConfig, read_config
from cfd_taichi_tpu_torch.ops import coef

CONFIGS = Path(__file__).resolve().parents[2] / "configs"

# Row lengths of the ragged engine: empty rows, single pairs, one below and
# one above every candidate lane-group width (4, 8, 16, 32), and rows of
# 100+ pairs, mixed with lattice-like rows of 20-40 pairs.
RAGGED_LENGTHS = (0, 1, 3, 5, 7, 9, 15, 17, 31, 33, 100, 141,
                  *range(20, 41))


def solver_config(name: str, solver: str = "dfsph") -> SimConfig:
    """configs/<name> with the given solver."""
    cfg = read_config(str(CONFIGS / name))
    return dataclasses.replace(cfg, solver=dataclasses.replace(
        cfg.solver, name=solver))


SQUEEZE = 0.85


def squeezed(state):
    """`state` with the fluid block scaled by SQUEEZE about its centre:
    from rest the self-excluded density sits under rho0, and squeezed so
    the block's interior sits above it, so that pressure acts."""
    pos = state.fluid.pos
    mid = (pos.min(dim=0).values + pos.max(dim=0).values) / 2
    return state._replace(fluid=state.fluid._replace(
        pos=mid + SQUEEZE * (pos - mid)))


SHIFT = 0.3   # the shifted positions' displacement, in particle radii


def shifted(pos: torch.Tensor, r: float, rng) -> torch.Tensor:
    """`pos` moved by a numpy-seeded displacement of ~SHIFT r (normal, SHIFT
    r / sqrt(3) an axis): the predicted positions of PCISPH and the updated
    ones of PBF's XSPH, whose pairs, pinned at `pos`, then cross r = h in
    both directions."""
    d = rng.standard_normal(tuple(pos.shape)) * (SHIFT * r / np.sqrt(3.0))
    return pos + torch.from_numpy(d.astype(np.float32)).to(pos.device)


def lattice_inputs(cfg_name: str, seed: int, device="cuda") -> dict:
    """The config's seed lattice with a 0.1 r jitter, cell-sorted, and
    random k, v, rho and positive p' (WCSPH's p / rho^2, `pr`), then the
    shifted positions (`shifted`) and a negative lambda (PBF's, `lam`),
    made with numpy from `seed` in that order."""
    from cfd_taichi_tpu_torch import build_scene
    from cfd_taichi_tpu_torch.models import base
    from cfd_taichi_tpu_torch.ops import neighbors as nb

    def dev(a):
        return torch.from_numpy(a.astype(np.float32)).to(device)

    sc = build_scene(solver_config(cfg_name), device=device)
    rng = np.random.default_rng(seed)
    n, r = sc.n_fluid, sc.particle_radius
    pos = sc.fluid_pos0.cpu().numpy() + rng.uniform(
        -0.1 * r, 0.1 * r, (n, 3)).astype(np.float32)
    scid, _, p, _ = base.sort_by_cells(sc.grid, dev(pos))
    x = dict(sc=sc, p=p, st=nb.csr_starts(scid, sc.grid.num_cells),
             k=dev(rng.uniform(0.0, 2.0, n)),
             v=dev(rng.standard_normal((n, 3))),
             rho=dev(rng.uniform(900.0, 1100.0, n)),
             pr=dev(rng.uniform(0.0, 0.05, n)))
    x["shifted"] = shifted(p, r, rng)
    x["lam"] = dev(rng.uniform(-1e-4, 0.0, n))
    return x


# builtin:cube1 scale of the body in each config's block: ~3,200 voxels
# at 30k (coupling_demo's body, configs/coupling_demo.json), ~40k at 1M.
BODY_SCALE = {"breaking_dam_30k.json": 1.0, "breaking_dam_1m.json": 2.3}
BODY_RHO = 5000.0   # coupling_demo's body density


def body_scene(cfg_name: str, device="cuda"):
    """The config's scene as DFSPH with a builtin:cube1 body of
    BODY_SCALE[cfg_name] (voxelized at the scene's pitch 2r, density
    BODY_RHO) centred in the fluid block, and the seed lattice's fluid in
    the body's voxel cubes taken out (`Scene.n_fluid` and `fluid_pos0` are
    what is left), so that the body starts in water it does not overlap."""
    from cfd_taichi_tpu_torch import build_scene
    from cfd_taichi_tpu_torch import geometry as geo
    from cfd_taichi_tpu_torch.config import SolidConfig

    cfg = solver_config(cfg_name)
    r = cfg.scene.particle_radius
    pitch = np.float32(2.0 * r)
    scale = BODY_SCALE[cfg_name]
    vox = geo.voxelize_mesh(*geo.load_mesh("builtin:cube1", scale=scale),
                            pitch=float(pitch))
    centre = (np.asarray(cfg.fluid.start_pos, np.float32)
              + np.asarray(cfg.fluid.water_size, np.float32) / 2)
    offset = centre - (vox.min(axis=0) + vox.max(axis=0)) / 2
    cfg = dataclasses.replace(cfg, solid=SolidConfig(
        mesh="builtin:cube1", voxel_radius=r, rho_0=BODY_RHO, scale=scale,
        pos_offset=tuple(float(c) for c in offset), active=True))
    sc = build_scene(cfg, device=device)
    vox = sc.rigid0.pos.cpu().numpy()
    fluid = sc.fluid_pos0.cpu().numpy()
    lo = vox.min(axis=0) - pitch / 2
    dims = np.rint((vox.max(axis=0) - vox.min(axis=0)) / pitch).astype(
        np.int64) + 1
    occ = np.zeros(tuple(dims), bool)
    occ[tuple(np.rint((vox - lo) / pitch - 0.5).astype(np.int64).T)] = True
    cell = np.floor((fluid - lo) / pitch).astype(np.int64)
    inb = ((cell >= 0) & (cell < dims)).all(axis=1)
    inside = np.zeros(len(fluid), bool)
    inside[inb] = occ[tuple(cell[inb].T)]
    keep = torch.from_numpy(~inside).to(sc.fluid_pos0.device)
    return dataclasses.replace(sc, n_fluid=int(keep.sum()),
                               fluid_pos0=sc.fluid_pos0[keep])


def body_inputs(cfg_name: str, seed: int, device="cuda") -> dict:
    """`coupled_inputs` of `body_scene`: its fluid with a 0.1 r jitter and
    its body as built."""
    return coupled_inputs(body_scene(cfg_name, device), seed, device)


def coupled_inputs(sc, seed: int, device="cuda") -> dict:
    """Inputs of the fluid-rigid passes on coupled scene `sc`: its fluid
    with a 0.1 r jitter, cell-sorted (`p`, `st`), its body as built in
    original order (`rpos`, `rvol`) and cell-sorted (`table`), and, made
    with numpy from `seed` in this order after the jitter, random rigid
    velocities `v_r`, fluid velocities `v`, densities `rho`, the quirk's
    densities `rho_quirk`, a body velocity `body_vel`, the reaction's `u`
    (k / rho m of a density iteration's size), a start force `force`,
    predicted positions `shifted` (PCISPH's, for its walk over the body)
    and the density loop's k / rho `k` (u's size over m: the value that
    DFSPH's loop hands the reaction's stream with the scale m)."""
    from cfd_taichi_tpu_torch.models import base
    from cfd_taichi_tpu_torch.ops import neighbors as nb
    from cfd_taichi_tpu_torch.ops import rigid

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(
            device)

    rng = np.random.default_rng(seed)
    n, nr, r = sc.n_fluid, sc.n_rigid, sc.particle_radius
    fluid = sc.fluid_pos0.cpu().numpy() + rng.uniform(
        -0.1 * r, 0.1 * r, (n, 3)).astype(np.float32)
    scid, _, p, _ = base.sort_by_cells(sc.grid, dev(fluid))
    x = dict(sc=sc, grid=sc.grid, h=sc.h, m=sc.particle_m, p=p,
             st=nb.csr_starts(scid, sc.grid.num_cells),
             rpos=sc.rigid0.pos.contiguous(), rvol=sc.rigid_volume)
    x["table"] = rigid.rigid_table(sc.grid, x["rpos"], x["rvol"])
    x.update(v_r=dev(rng.standard_normal((nr, 3))),
             v=dev(rng.standard_normal((n, 3))),
             rho=dev(rng.uniform(900.0, 1100.0, n)),
             rho_quirk=dev(rng.uniform(900.0, 1100.0, nr)),
             body_vel=dev(rng.standard_normal(3)),
             u=dev(rng.standard_normal(n) * 1e-4),
             force=dev(rng.standard_normal((nr, 3))))
    x["shifted"] = shifted(p, r, rng)
    x["k"] = dev(rng.standard_normal(n) * (1e-4 / sc.particle_m))
    return x


def torus_inputs(seed: int, device="cuda") -> dict:
    """`coupled_inputs` of the half-immersed torus scene
    (`torus_immersed`): its seed lattice with a 0.1 r jitter and its body
    as built."""
    from cfd_taichi_tpu_torch import build_scene

    return coupled_inputs(build_scene(torus_immersed(), device=device), seed,
                          device)


# The torus's offset in `torus_immersed`: its middle height at the water
# surface (y 1.3) and its width inside the block, which the torus of
# configs/torus_flush.json (pos_offset [1.25, 0.1, 0.35]) starts beside.
TORUS_IMMERSED_OFFSET = (0.114, 1.204, 0.164)


def torus_immersed() -> SimConfig:
    """configs/torus_flush.json with the torus moved to start half immersed
    in the water block (TORUS_IMMERSED_OFFSET), so that the coupling acts
    from the first steps."""
    cfg = read_config(str(CONFIGS / "torus_flush.json"))
    return dataclasses.replace(cfg, solid=dataclasses.replace(
        cfg.solid, pos_offset=TORUS_IMMERSED_OFFSET))


def ragged_engine(n: int, dtype: torch.dtype, seed: int = 3,
                  device="cuda") -> tuple[coef.CoefEngine, torch.Tensor,
                                          torch.Tensor, torch.Tensor]:
    """(engine, pos, k, v): `n` rows whose lengths cycle through
    RAGGED_LENGTHS in a shuffled order, with the last row empty; random
    source rows (not in walk order), random signed w stored as `dtype`,
    positions in a 10 m box, k in [0, 2) and normal v."""
    rng = np.random.default_rng(seed)
    lengths = rng.permutation(np.resize(np.asarray(RAGGED_LENGTHS), n))
    lengths[-1] = 0
    offsets = np.zeros(n + 1, np.int32)
    offsets[1:] = np.cumsum(lengths)
    p = int(offsets[-1])
    eng = coef.CoefEngine(
        torch.from_numpy(offsets).to(device),
        torch.from_numpy(rng.integers(0, n, p).astype(np.int32)).to(device),
        torch.from_numpy(rng.standard_normal(p).astype(np.float32))
        .to(dtype).to(device))
    pos, k, v = (torch.from_numpy(a.astype(np.float32)).to(device) for a in (
        rng.uniform(0.0, 10.0, (n, 3)), rng.uniform(0.0, 2.0, n),
        rng.standard_normal((n, 3))))
    return eng, pos, k, v


CLUSTER_H = 0.125        # support radius and cell edge: a power of two
CLUSTER_BLOB_OCC = 200   # particles per cell inside the dense blob
CLUSTER_WALL_OCC = 50    # boundary particles per cell of the dense patch


def clustered_inputs(n: int, seed: int, device="cuda") -> dict:
    """A numpy-seeded cloud of about `n` particles that the seed lattices
    do not exercise, cell-sorted, with random k, v and rho:

    * a dense blob, a fifth of the particles at ~CLUSTER_BLOB_OCC a cell;
    * a lattice of spacing h / 2 from a cell face: h is a power of two,
      so its particles lie exactly on cell faces and its pairs two steps
      apart sit at exactly r2 = h2 in f32;
    * a sparse uniform rest of about one particle a cell: many cells stay
      empty;
    * eight particles outside the grid's box, in pairs within h of each
      other, which clamp into edge cells.

    Beside it a boundary cloud, cell-sorted on the same grid, with random
    volumes, for the two-table walk of boundary_terms:

    * a wall sheet one cell below the face lattice, on the same spacing:
      it lies on cell faces, and its pairs with the lattice's lowest layer
      sit at exactly r2 = h2;
    * a dense patch of ~CLUSTER_WALL_OCC a cell, two cells thick, that
      straddles the blob's lower face;
    * four boundary particles outside the box, each within h of a fluid
      particle outside, which clamp into edge cells;
    * none elsewhere: most cells have no boundary particle near.

    Returns {grid, h, m, p, st, k, v, rho, pr, shifted, lam} in the keys
    of `lattice_inputs`, with the grid, h and m in place of a scene (the
    particle radius is h / 4), and the boundary cloud {bp, bvol, bst,
    bnear}. The boundary cloud draws from a generator of its own: the fluid
    cloud of a seed does not depend on it."""
    from cfd_taichi_tpu_torch.models import base
    from cfd_taichi_tpu_torch.ops import neighbors as nb

    h = CLUSTER_H
    rng = np.random.default_rng(seed)
    n_blob = n // 5
    side = round((n // 5) ** (1.0 / 3.0))
    n_uniform = max(n - n_blob - side**3 - 8, 0)
    blob = h * (n_blob / CLUSTER_BLOB_OCC) ** (1.0 / 3.0)
    # The box's shortest side (0.8 edge) holds the blob or the lattice with
    # a margin; the uniform rest fills it at about one particle a cell.
    edge = max(h * n_uniform ** (1.0 / 3.0), (blob + 3 * h) / 0.8,
               (3 * h + side * h / 2) / 0.8)
    box = np.array([1.25 * edge, edge, 0.8 * edge])
    corner = rng.uniform(h, box - blob - h)
    lattice = np.stack(np.meshgrid(*[np.arange(side)] * 3, indexing="ij"),
                       -1).reshape(-1, 3) * (h / 2) + 2 * h
    # Below the grid in x and z, above it in y and z (the grid reaches one
    # cell past the box), each beside a partner within h.
    anchors = rng.uniform(0.0, box, (4, 3))
    anchors[0, 0], anchors[1, 2] = -3 * h, -0.5 * h
    anchors[2, 1], anchors[3, 2] = box[1] + 6 * h, box[2] + 3 * h
    outside = np.concatenate([anchors, anchors + h * np.array(
        [[0.5, 0.3, 0.0], [0.0, 0.4, -0.2], [0.6, 0.0, 0.0],
         [0.0, 0.0, 0.7]])])
    pos = np.concatenate([
        corner + rng.uniform(0.0, blob, (n_blob, 3)), lattice, outside,
        rng.uniform(0.0, box, (n_uniform, 3))]).astype(np.float32)
    grid = nb.grid_for_box((0.0, 0.0, 0.0), tuple(box), h)
    m = 1000.0 * (h / 4) ** 3 * 8.0
    scid, _, p, _ = base.sort_by_cells(
        grid, torch.from_numpy(pos).to(device))
    total = pos.shape[0]

    def dev(a):
        return torch.from_numpy(a.astype(np.float32)).to(device)

    brng = np.random.default_rng([seed, 1])
    sheet = lattice[lattice[:, 2] == 2 * h] - np.array([0.0, 0.0, h])
    n_patch = int(CLUSTER_WALL_OCC * 2 * (blob / h) ** 2)
    patch = corner - np.array([0.0, 0.0, h]) + brng.uniform(
        0.0, 1.0, (n_patch, 3)) * np.array([blob, blob, 2 * h])
    bpos = dev(np.concatenate([
        sheet, patch, anchors + h * brng.uniform(-0.3, 0.3, (4, 3))]))
    btable = nb.build_cell_table(bpos, grid)
    bvol = dev(brng.uniform(0.5, 1.5, bpos.shape[0]) * m / 1000.0)

    x = dict(grid=grid, h=h, m=m, p=p,
             st=nb.csr_starts(scid, grid.num_cells),
             bp=bpos[btable.order], bvol=bvol[btable.order],
             bst=btable.starts, bnear=nb.stencil_counts(btable.starts, grid),
             k=dev(rng.uniform(0.0, 2.0, total)),
             v=dev(rng.standard_normal((total, 3))),
             rho=dev(rng.uniform(900.0, 1100.0, total)),
             pr=dev(rng.uniform(0.0, 0.05, total)))
    x["shifted"] = shifted(p, h / 4, rng)
    x["lam"] = dev(rng.uniform(-1e-4, 0.0, total))
    return x


@contextlib.contextmanager
def engine(budget: float | None = None, dtype: torch.dtype | None = None):
    """Pin the loop engine of DFSPH and IISPH: the coef byte budget (0
    selects the recompute kernels) and storage dtype of models/dfsph.py,
    restored on exit."""
    from cfd_taichi_tpu_torch.models import dfsph

    saved = dfsph.COEF_BYTE_BUDGET, dfsph.COEF_DTYPE
    if budget is not None:
        dfsph.COEF_BYTE_BUDGET = budget
    if dtype is not None:
        dfsph.COEF_DTYPE = dtype
    try:
        yield
    finally:
        dfsph.COEF_BYTE_BUDGET, dfsph.COEF_DTYPE = saved


@contextlib.contextmanager
def loop_mode(unroll: int | None = None, eager: bool = False):
    """Pin the pressure loops of DFSPH, IISPH and PCISPH: `unroll`
    iterations a trip (models/dfsph.loop_unroll) and, with `eager`, every
    trip launched from Python (ops/loops.ALL_EAGER, on any device),
    restored on exit."""
    from cfd_taichi_tpu_torch.models import dfsph
    from cfd_taichi_tpu_torch.ops import loops

    saved = dfsph.loop_unroll, loops.ALL_EAGER
    if unroll is not None:
        dfsph.loop_unroll = lambda scene: unroll
    loops.ALL_EAGER = eager
    try:
        yield
    finally:
        dfsph.loop_unroll, loops.ALL_EAGER = saved
