"""Roofline bounds of the hand-written kernels: the least time an H100
could take for the work one call does on its inputs.

A call's work is the bytes it must move (each input read once, each
output written once) and the f32 operations it must do. The bound is the
larger of bytes / HBM rate and operations / f32 rate, with the published
peaks of an H100 SXM at a 700 W power limit (NVIDIA's data sheet: 3.35
TB/s, 67 TFLOP/s in f32 outside the tensor cores).

Operations are counted on the data of the call, for the pairs the
function needs:

* a stencil kernel's pair within h costs its distance test (3
  subtractions, 3 multiplies, 2 adds and a compare) and its pair term,
  each add, multiply, compare, square root and divide one operation
  (`PAIR_OPS`, read off csrc/*.cu);
* the coef contraction forms its lanes once per source particle and does
  a multiply and an add per lane per stored pair.

`Work.walk_ops` adds the distance tests of the other candidates of the
27-cell walk: work the kernels' algorithm does, not work the function
needs, so it is reported beside the bound and never sets it. Where a
kernel does more work than counted (viscosity evaluates its force only on
compressive pairs, which are not counted), the bound is lower than the
least time, never higher.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from cfd_taichi_tpu_torch.ops.neighbors import GridSpec, cell_coords
from cfd_taichi_tpu_torch.ops.stencil import count_pairs

HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

# f32 operations of one candidate's distance test r2 <= h2.
CANDIDATE_OPS = 9
# f32 operations of one pair term (r2 <= h2), beyond the distance test.
PAIR_OPS = {
    "fluid_terms": 49,     # r, m gc, W, count, rho, s (3), qsum, tvec (3)
    "boundary_terms": 46,  # r, w_b, W, gc, rho, s (3), qsum, g2
    "matvec": 27,          # r, m gc, three multiply-adds of x_ij k_j
    "matvec_dot": 27,      # r, m gc, three multiply-adds of x_ij v_j
    "viscosity": 9,        # the shear x_ij . v_ij and its sign test
    "coef_build": 18,      # r, m gc
}


class Work(NamedTuple):
    bytes: int
    ops: int            # what the function needs: sets the bound
    walk_ops: int = 0   # ops plus the walk's other candidates, or 0

    def bound(self) -> tuple[float, str]:
        """(least seconds, "bytes" or "operations", whichever bounds)."""
        t_bytes = self.bytes / HBM_BYTES_PER_S
        t_ops = self.ops / F32_OPS_PER_S
        return (t_bytes, "bytes") if t_bytes >= t_ops else \
            (t_ops, "operations")


def candidates(qpos: torch.Tensor, starts: torch.Tensor,
               grid: GridSpec) -> int:
    """Source slots in the 27-cell stencils of all queries: the distance
    tests of a stencil walk over the CSR table `starts`."""
    fast, mid, slow = grid.axes_by_stride
    occ = (starts[1:] - starts[:-1]).to(torch.int64)
    occ = occ.reshape(grid.dims[slow], grid.dims[mid], grid.dims[fast])
    pad = torch.nn.functional.pad(occ, (1, 1, 1, 1, 1, 1))
    a, b, c = occ.shape
    box = sum(pad[i:i + a, j:j + b, k:k + c]
              for i in range(3) for j in range(3) for k in range(3))
    cc = cell_coords(qpos, grid).to(torch.int64)
    return int(box[cc[:, slow], cc[:, mid], cc[:, fast]].sum())


def _pair_work(name: str, nbytes: int, cand: int, pairs: int) -> Work:
    ops = (CANDIDATE_OPS + PAIR_OPS[name]) * pairs
    return Work(nbytes, ops, ops + CANDIDATE_OPS * (cand - pairs))


def stencil_work(name: str, n: int, n_cells: int, cand: int, pairs: int,
                 n_sources: int = 0) -> Work:
    """Work of one stencil kernel call over `n` queries, `cand` candidates
    and `pairs` pairs within h; `n_sources` boundary particles for
    boundary_terms."""
    starts = 4 * (n_cells + 1)
    f = 4 * n
    nbytes = {
        # pos, starts; rho, count, s, qsum, tvec
        "fluid_terms": 3 * f + starts + 9 * f,
        # pos; boundary pos, volume and starts; rho, s, qsum, g2
        "boundary_terms": 3 * f + 16 * n_sources + starts + 6 * f,
        # pos, starts, k; out
        "matvec": 3 * f + starts + f + 3 * f,
        # pos, starts, v; out
        "matvec_dot": 3 * f + starts + 3 * f + f,
        # pos, starts, vel, rho; out
        "viscosity": 3 * f + starts + 3 * f + f + 3 * f,
    }[name]
    return _pair_work(name, nbytes, cand, pairs)


def coef_build_work(n: int, n_cells: int, cand: int, pairs: int,
                    w_bytes: int) -> Work:
    """pos, starts and offsets in; nbr and w (`w_bytes` a slot) out."""
    nbytes = 12 * n + 4 * (n_cells + 1) + 4 * (n + 1) + (4 + w_bytes) * pairs
    return _pair_work("coef_build", nbytes, cand, pairs)


def coef_contraction_work(dot: bool, n: int, pairs: int, w_bytes: int,
                          lane_sums: bool = False) -> Work:
    """coef_matvec (`dot` False) or coef_matvec_dot over a CSR engine of
    `n` rows and `pairs` stored pairs: offsets, nbr and w, pos and k (or
    v) in; (N, 3) or (N,) out, or (N, 4) lane sums."""
    src = 12 if dot else 4
    out = 16 if lane_sums else (4 if dot else 12)
    nbytes = 4 * (n + 1) + (4 + w_bytes) * pairs + (12 + src) * n + out * n
    lane_ops = 5 if dot else 3      # x . v, or x k, y k, z k
    finish = 0 if lane_sums else 6  # x_i s0 - s, or x_i . s - s3
    ops = 8 * pairs + (lane_ops + finish) * n
    return Work(nbytes, ops, ops)


def scene_work(sc, pos: torch.Tensor, starts: torch.Tensor,
               pairs: int) -> dict[str, Work]:
    """Work of every kernel's call on the cell-sorted fluid `pos` of scene
    `sc` with CSR `starts` and `pairs` fluid pairs (fluid_terms' count),
    by kernel name; the coef kernels at f32 and, with a `_bf16` suffix,
    bf16 storage."""
    g, n, cells = sc.grid, pos.shape[0], sc.grid.num_cells
    cand = candidates(pos, starts, g)
    bstarts = sc.boundary_starts
    out = {name: stencil_work(name, n, cells, cand, pairs)
           for name in ("fluid_terms", "matvec", "matvec_dot", "viscosity")}
    out["boundary_terms"] = stencil_work(
        "boundary_terms", n, cells, candidates(pos, bstarts, g),
        count_pairs(pos, sc.boundary_pos, bstarts, g, sc.h,
                    exclude_self=False), sc.boundary_pos.shape[0])
    for sfx, wb in (("", 4), ("_bf16", 2)):
        out["coef_build" + sfx] = coef_build_work(n, cells, cand, pairs, wb)
        out["coef_matvec" + sfx] = coef_contraction_work(False, n, pairs, wb)
        out["coef_matvec_dot" + sfx] = coef_contraction_work(True, n, pairs,
                                                             wb)
    return out
