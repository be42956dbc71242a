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

from cfd_taichi_tpu_torch.ops.neighbors import (GridSpec, cell_id,
                                                  stencil_counts)
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
    # r, gc, W, the shear and its sign test, the pressure and cohesion
    # coefficients, three multiply-adds; not the viscosity term, which
    # only compressive pairs need
    "wcsph_forces": 53,
    "coef_build": 18,      # r, m gc
    # the predicted distance (8), r, q, W, the sum; on the boundary also
    # rho0 V_b and its product
    "pcisph_predict_rho": 25,
    "pcisph_predict_rho_walls": 27,
    # r, spiky_c, poly6, s, s^2, s_corr, r spiky_c, the ten terms and sums;
    # on the boundary also rho0 V_b
    "pbf_terms": 40,
    "pbf_boundary_terms": 41,
    "pbf_lambda": 18,      # r, spiky_c, lambda_j spiky_c, three products
    # the updated distance (8), r, poly6, three products, four sums
    "pbf_xsph": 24,
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
    box = stencil_counts(starts, grid)
    return int(box[cell_id(qpos, grid).long()].sum(dtype=torch.int64))


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
        # pos; boundary pos, volume, starts and the per-cell table of
        # boundary particles near; rho, s, qsum, g2
        "boundary_terms": (3 * f + 16 * n_sources + starts + 4 * n_cells
                           + 6 * f),
        # pos, starts, k; out
        "matvec": 3 * f + starts + f + 3 * f,
        # pos, starts, v; out
        "matvec_dot": 3 * f + starts + 3 * f + f,
        # pos, starts, vel, rho; out
        "viscosity": 3 * f + starts + 3 * f + f + 3 * f,
        # pos, starts, vel, rho, p'; out (the records that the wrapper
        # packs them into are its own layout, not the function's work)
        "wcsph_forces": 3 * f + starts + 3 * f + f + f + 3 * f,
        # pos, starts, predicted pos; out
        "pcisph_predict_rho": 3 * f + starts + 3 * f + f,
        # pos, starts; rho, gsum, around, ssum
        "pbf_terms": 3 * f + starts + 8 * f,
        # pos, starts, lambda; out
        "pbf_lambda": 3 * f + starts + f + 3 * f,
        # pos, starts, updated pos and vel; out
        "pbf_xsph": 3 * f + starts + 3 * f + 3 * f + 3 * f,
    }[name]
    return _pair_work(name, nbytes, cand, pairs)


def walls_work(name: str, n: int, n_cells: int, cand: int, pairs: int,
               n_sources: int) -> Work:
    """The boundary walk of pcisph_predict_rho (`name` ..._walls: the
    boundary set and tables; pos and out are the fluid walk's) or the
    boundary entry of pbf_terms (pbf_boundary_terms: pos in, four sums
    out)."""
    nbytes = 16 * n_sources + 4 * (n_cells + 1) + 4 * n_cells
    if name == "pbf_boundary_terms":
        nbytes += 12 * n + 32 * n
    return _pair_work(name, nbytes, cand, pairs)


def combined(*works: Work) -> Work:
    """The work of calls made together, as one."""
    return Work(*(sum(w[i] for w in works) for i in range(3)))


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
           for name in ("fluid_terms", "matvec", "matvec_dot", "viscosity",
                        "wcsph_forces", "pbf_lambda", "pbf_xsph")}
    nb, bcand = sc.boundary_pos.shape[0], candidates(pos, bstarts, g)
    bpairs = count_pairs(pos, sc.boundary_pos, bstarts, g, sc.h,
                         exclude_self=False)
    out["boundary_terms"] = stencil_work("boundary_terms", n, cells, bcand,
                                         bpairs, nb)
    # With walls, as the steps call them: the predicted density's two walks
    # in one launch, pbf_terms' fluid and boundary entries.
    for name, wname in (("pcisph_predict_rho", "pcisph_predict_rho_walls"),
                        ("pbf_terms", "pbf_boundary_terms")):
        out[name] = combined(stencil_work(name, n, cells, cand, pairs),
                             walls_work(wname, n, cells, bcand, bpairs, nb))
    for sfx, wb in (("", 4), ("_bf16", 2)):
        out["coef_build" + sfx] = coef_build_work(n, cells, cand, pairs, wb)
        out["coef_matvec" + sfx] = coef_contraction_work(False, n, pairs, wb)
        out["coef_matvec_dot" + sfx] = coef_contraction_work(True, n, pairs,
                                                             wb)
    return out
