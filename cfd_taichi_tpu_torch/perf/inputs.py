"""Seeded inputs of the kernel checks and measurements: the jittered seed
lattice of a config, a clustered cloud for the stencil walk's edge cases,
a ragged CSR engine of the coef contraction, a compressed start state,
and the loop engine of DFSPH and IISPH pinned for a run."""

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


def lattice_inputs(cfg_name: str, seed: int, device="cuda") -> dict:
    """The config's seed lattice with a 0.1 r jitter, cell-sorted, and
    random k, v, rho and positive p' (WCSPH's p / rho^2, `pr`), made with
    numpy from `seed`."""
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
    return dict(sc=sc, p=p, st=nb.csr_starts(scid, sc.grid.num_cells),
                k=dev(rng.uniform(0.0, 2.0, n)),
                v=dev(rng.standard_normal((n, 3))),
                rho=dev(rng.uniform(900.0, 1100.0, n)),
                pr=dev(rng.uniform(0.0, 0.05, n)))


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

    Returns {grid, h, m, p, st, k, v, rho, pr} in the keys of
    `lattice_inputs`, with the grid, h and m in place of a scene, and the
    boundary cloud {bp, bvol, bst}. The boundary cloud draws from a
    generator of its own: the fluid cloud of a seed does not depend on
    it."""
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

    return dict(grid=grid, h=h, m=m, p=p,
                st=nb.csr_starts(scid, grid.num_cells),
                bp=bpos[btable.order], bvol=bvol[btable.order],
                bst=btable.starts,
                k=dev(rng.uniform(0.0, 2.0, total)),
                v=dev(rng.standard_normal((total, 3))),
                rho=dev(rng.uniform(900.0, 1100.0, total)),
                pr=dev(rng.uniform(0.0, 0.05, total)))


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
