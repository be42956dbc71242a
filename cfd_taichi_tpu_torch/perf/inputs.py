"""Seeded inputs of the kernel checks and measurements: the jittered seed
lattice of a config, a ragged CSR engine of the coef contraction, and the
DFSPH loop engine pinned for a run."""

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


def dfsph_config(name: str) -> SimConfig:
    """configs/<name> with the DFSPH solver."""
    cfg = read_config(str(CONFIGS / name))
    return dataclasses.replace(cfg, solver=dataclasses.replace(
        cfg.solver, name="dfsph"))


def lattice_inputs(cfg_name: str, seed: int, device="cuda") -> dict:
    """The config's seed lattice with a 0.1 r jitter, cell-sorted, and
    random k, v and rho, made with numpy from `seed`."""
    from cfd_taichi_tpu_torch import build_scene
    from cfd_taichi_tpu_torch.models import base
    from cfd_taichi_tpu_torch.ops import neighbors as nb

    def dev(a):
        return torch.from_numpy(a.astype(np.float32)).to(device)

    sc = build_scene(dfsph_config(cfg_name), device=device)
    rng = np.random.default_rng(seed)
    n, r = sc.n_fluid, sc.particle_radius
    pos = sc.fluid_pos0.cpu().numpy() + rng.uniform(
        -0.1 * r, 0.1 * r, (n, 3)).astype(np.float32)
    scid, _, p, _ = base.sort_by_cells(sc.grid, dev(pos))
    return dict(sc=sc, p=p, st=nb.csr_starts(scid, sc.grid.num_cells),
                k=dev(rng.uniform(0.0, 2.0, n)),
                v=dev(rng.standard_normal((n, 3))),
                rho=dev(rng.uniform(900.0, 1100.0, n)))


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


@contextlib.contextmanager
def engine(budget: float | None = None, dtype: torch.dtype | None = None):
    """Pin the DFSPH loop engine: the coef byte budget (0 selects the
    recompute kernels) and storage dtype of models/dfsph.py, restored on
    exit."""
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
