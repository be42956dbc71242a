"""The fluid rows that the predicted density's walk of the body takes, on
the coupled inputs of perf/inputs.py (the 30k and 1M blocks with a body
at their centre, the half-immersed torus), counted on the CPU:

    python -m cfd_taichi_tpu_torch.perf.body_rows [--cases 30k torus 1m]

For each: the warps (32 cell-sorted rows) with a row inside the body's
gate (`stencil.make_body_box_plain`), the rows inside it that each such
warp holds (quartiles, and how many warps hold 1-2, 3-16 and 17-32), and
each such row's candidates (the body particles in its 27 cells) and pairs
(those within h). Lane groups that take a warp's rows a few at a time
pay where warps hold one or two such rows; the queued walk takes all 32
at once.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from cfd_taichi_tpu_torch.ops import neighbors as nb
from cfd_taichi_tpu_torch.ops import stencil
from cfd_taichi_tpu_torch.perf import inputs

WARP = 32
CASES = {"30k": lambda: inputs.body_inputs("breaking_dam_30k.json", 3,
                                           device="cpu"),
         "torus": lambda: inputs.torus_inputs(3, device="cpu"),
         "1m": lambda: inputs.body_inputs("breaking_dam_1m.json", 3,
                                          device="cpu")}


def rows(x: dict) -> dict:
    """The counts of the module's docstring for coupled inputs `x`."""
    p, t, grid = x["p"], x["table"], x["grid"]
    near = stencil.in_body_box(p, stencil.make_body_box_plain(
        t.pos, x["h"])).numpy()
    n = near.shape[0]
    per_warp = np.add.reduceat(near.astype(np.int64), np.arange(0, n, WARP))
    held = per_warp[per_warp > 0]
    q = p[torch.from_numpy(near)]
    pairs = np.zeros(q.shape[0], np.int64)
    for rws, pr in stencil._pair_chunks(q, t.pos, t.starts, grid, x["h"],
                                        exclude_self=False):
        pairs[rws] = pr.valid.sum(dim=1).numpy()
    nc = nb.cell_coords(q, grid)[:, None, :].long() + torch.tensor(
        stencil.walk_offsets(grid), dtype=torch.int64)
    inside = ((nc >= 0) & (nc < torch.tensor(grid.dims))).all(dim=-1)
    cid = (nc * torch.tensor(grid.strides)).sum(dim=-1).clamp(
        0, grid.num_cells - 1)
    cand = torch.where(inside, t.starts[cid + 1] - t.starts[cid], 0).sum(
        dim=1).numpy()
    return dict(rows=n, near_rows=int(near.sum()), warps=len(per_warp),
                near_warps=len(held),
                held_quartiles=np.percentile(held, [25, 50, 75]).tolist(),
                held_1_2=int((held <= 2).sum()),
                held_3_16=int(((held > 2) & (held <= 16)).sum()),
                held_17_32=int((held > 16).sum()),
                candidates_mean=float(cand.mean()), candidates_max=int(
                    cand.max()), pairs_mean=float(pairs.mean()),
                pairs_max=int(pairs.max()))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cases", nargs="+", default=list(CASES),
                    choices=list(CASES))
    args = ap.parse_args()
    torch.set_num_threads(1)
    for case in args.cases:
        print(f"[body_rows] {case}: {rows(CASES[case]())}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
