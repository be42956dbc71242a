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
needs, so it is reported beside the bound and never sets it. So is
`Work.stream_bytes`, the bytes a kernel that streams a stored pair list
(pcisph_predict_rho_list, pbf_lambda, pbf_xsph, rigid_side_force_list)
must read, or that pbf_terms (PBF's constraint pass) moves with the list
it stores: the list is
the design's, not the function's input or output (rigid_side_list, whose
function is to list the pairs, writes it as its output). Where a
kernel does more work than counted (viscosity evaluates its force only on
compressive pairs, which are not counted), the bound is lower than the
least time, never higher.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from cfd_taichi_tpu_torch.ops.neighbors import (GridSpec, cell_coords,
                                                  cell_id, stencil_counts)
from cfd_taichi_tpu_torch.ops.stencil import (LIST_STRIDE, _pair_chunks,
                                              count_pairs)

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
    # on the walls also rho0 V_b
    "pbf_terms": 40,
    "pbf_walls": 41,
    "pbf_lambda": 18,      # r, spiky_c, lambda_j spiky_c, three products
    # the updated distance (8), r, poly6, three products, four sums
    "pbf_xsph": 24,
    # r, w_s, W, gc, w_s gc, its r and c^2 r^2 products, rho, s (3), qsum,
    # g2
    "rigid_terms": 47,
    # r, gc, w_s gc, x_ij . v_r, the product and the sum
    "rigid_contact_dot": 26,
    # the shear (v_i - v_body) . x_ij and its sign test; not the viscosity
    # term, which only compressive pairs need (as "viscosity")
    "rigid_viscosity": 6,
    # r, rho0 V_j gc, the r <= h test, three products and sums
    "rigid_side_force": 29,
    # r, rho0 V_j gc, the r <= h test, the three products of g
    "rigid_side_list": 23,
    # the predicted distance (8), r, q, W, rho0 V_s and its product, the
    # sum (as the boundary walk)
    "pcisph_predict_rho_rigid": 27,
}


# f32 operations of a row of PBF's constraint pass beyond its pair terms:
# rho_seed + m S_f (2), the walls' eight sums added (8), the constraint (3),
# g' (3), |g'|^2 (5), around / rho0^2 and the two sums (3), the negation,
# division and select of lambda (4).
PBF_ROW_OPS = 28


class Work(NamedTuple):
    bytes: int
    ops: int            # what the function needs: sets the bound
    walk_ops: int = 0   # ops plus the walk's other candidates, or 0
    stream_bytes: int = 0  # the bytes with the design's pair list, or 0

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


def walls_work(name: str, n_cells: int, cand: int, pairs: int,
               n_sources: int) -> Work:
    """The walls' walk of pcisph_predict_rho or of PBF's constraint pass
    (`name` pcisph_predict_rho_walls, pbf_walls): the boundary set and
    tables; pos and out are the fluid walk's."""
    nbytes = 16 * n_sources + 4 * (n_cells + 1) + 4 * n_cells
    return _pair_work(name, nbytes, cand, pairs)


def pbf_constraint_work(fluid: Work, walls: Work, n: int, pairs: int) -> Work:
    """PBF's constraint pass in one launch: its `fluid` walk (pos and starts
    in, 32 bytes a row out: constraint, lambda, gsum, ssum) and `walls`
    walk (pbf_walls), PBF_ROW_OPS a row, and, beside them (stream_bytes),
    the pair list its fluid walk stores: each row's base read, its count
    and nbr (4 B a pair) written."""
    rows = Work(0, PBF_ROW_OPS * n, PBF_ROW_OPS * n)
    out = combined(fluid, walls, rows)
    return out._replace(stream_bytes=out.bytes + 8 * n + 4 * pairs)


def stencil_cells(qpos: torch.Tensor, grid: GridSpec) -> int:
    """Distinct cells in the union of the queries' 27-cell stencils: the
    CSR offsets a walk from these queries needs."""
    off = torch.tensor([(a, b, c) for a in (-1, 0, 1) for b in (-1, 0, 1)
                        for c in (-1, 0, 1)], dtype=torch.int32,
                       device=qpos.device)
    cells = cell_coords(qpos, grid)[:, None, :] + off
    dims = torch.tensor(grid.dims, dtype=torch.int32, device=qpos.device)
    strides = torch.tensor(grid.strides, dtype=torch.int32,
                           device=qpos.device)
    inb = ((cells >= 0) & (cells < dims)).all(dim=-1)
    return int(torch.unique((cells * strides).sum(dim=-1)[inb]).numel())


def rigid_work(x: dict) -> dict[str, Work]:
    """Work of the fluid-rigid kernels on coupled inputs `x`
    (perf/inputs.coupled_inputs): n cell-sorted fluid queries against the
    body's table for three of them (the solid viscosity reading the
    velocity and density of only the queries within h of the body), and
    the body's Nr particles against the fluid's table for the reaction,
    whose function needs only the fluid rows within h of the body (their
    positions and u) and the offsets of the cells its stencils cover; and
    PCISPH's predicted density as the
    coupled step launches it, its fluid and wall walks (`scene_work`'s)
    with the body's walk: the body's table and its pairs' terms beside the
    bytes of x~ and the output that the fluid walk counts; under
    pcisph_predict_rho_rigid with the stream form's bytes (`streamed`),
    under pcisph_predict_rho without.

    The bounds count what each function needs, so how a kernel walks does
    not move them: the body's gate of the solid sums, the contact dot and
    the solid viscosity, and the reaction walk's group of lanes a body
    particle, leave their work as it is. Only the walks' candidate counts
    (`Work.walk_ops`, never a bound) count more than a gated kernel tests:
    every fluid query's stencil, where a gated kernel tests the stencils
    of the warps with a query inside the gate."""
    g, p, t = x["grid"], x["p"], x["table"]
    n, nr, cells = p.shape[0], t.pos.shape[0], g.num_cells
    pairs = count_pairs(p, t.pos, t.starts, g, x["h"], exclude_self=False)
    cand = candidates(p, t.starts, g)
    # The fluid queries with a body pair: the rows whose inputs beyond
    # their positions the function reads.
    partners = torch.zeros(n, dtype=torch.bool, device=p.device)
    for _, pr in _pair_chunks(x["rpos"], p, x["st"], g, x["h"],
                              exclude_self=False):
        partners[pr.slot[pr.valid]] = True
    partners = int(partners.sum())
    table = 16 * nr + 4 * (cells + 1)     # sorted pos and V_j, offsets
    f = 4 * n
    # Every query's position is read (whether a query has a body pair
    # depends on it) and every output written (it is the function's); the
    # contact dot reads nothing else a query. The solid viscosity's other
    # inputs, vel and rho, enter only the pair terms, so the least work
    # reads them for the partners alone, as the gated kernel does.
    nbytes = {
        # pos; rho, s, qsum, g2
        "rigid_terms": 3 * f + table + 6 * f,
        # pos, lid, v_r; out
        "rigid_contact_dot": 3 * f + table + 4 * nr + 12 * nr + f,
        # pos, lid, the partners' vel and rho, rho_q, the body's velocity;
        # out
        "rigid_viscosity": (3 * f + table + 4 * nr + 16 * partners
                            + 4 * nr + 12 + 3 * f),
    }
    out = {name: _pair_work(name, b, cand, pairs)
           for name, b in nbytes.items()}
    # the body's pos, V_j and force in, force out; the partners' pos and
    # u; the offsets of the cells of the body's stencils
    cells_side = 8 * stencil_cells(x["rpos"], g)
    side = 40 * nr + 16 * partners + cells_side
    side_cand = candidates(x["rpos"], x["st"], g)
    out["rigid_side_force"] = walk = _pair_work("rigid_side_force", side,
                                                side_cand, pairs)
    # the list's rows: the body's pos and the offsets in, a warp's room
    # out; a row's nine run lengths and their sum
    warps = -(-nr // LIST_STRIDE)
    out["rigid_side_rows"] = Work(12 * nr + cells_side + 8 * (warps + 1),
                                  18 * nr, 18 * nr)
    # the list: the body's pos and V_j, the partners' pos, the offsets and
    # the warps' offsets in; each row's base and count and a 16-byte
    # record a pair out
    out["rigid_side_list"] = _pair_work(
        "rigid_side_list", 24 * nr + 12 * partners + cells_side
        + 8 * (warps + 1) + 16 * pairs, side_cand, pairs)
    # the stream: the reaction's function (the walk's), and the bytes it
    # moves with the list: each row's base and count, its records, the
    # partners' u, the force in and out
    out["rigid_side_force_list"] = Work(
        walk.bytes, walk.ops, walk.ops,
        8 * nr + 16 * pairs + 4 * partners + 24 * nr)
    # the body's gate: its positions in, the box out; a min and a max a
    # coordinate, and a multiply, an add, a max, two abs and the two
    # corners' add or subtract an axis
    box_ops = 6 * nr + 18
    out["body_box"] = Work(12 * nr + 24, box_ops, box_ops)
    sc, st = x["sc"], x["st"]
    pairs_f = count_pairs(p, p, st, g, x["h"], exclude_self=True)
    walks = [stencil_work("pcisph_predict_rho", n, cells,
                          candidates(p, st, g), pairs_f),
             _pair_work("pcisph_predict_rho_rigid", table, cand, pairs)]
    if sc.akinci:
        bst, nb = sc.boundary_starts, sc.boundary_pos.shape[0]
        walks.append(walls_work(
            "pcisph_predict_rho_walls", cells, candidates(p, bst, g),
            count_pairs(p, sc.boundary_pos, bst, g, x["h"],
                        exclude_self=False), nb))
    # the stream form (perf/cases.py's pcisph_predict_rho_rigid case) and
    # the stencil form with the body: one function, one bound
    out["pcisph_predict_rho_rigid"] = streamed(walks[0], n, pairs_f,
                                               *walks[1:])
    out["pcisph_predict_rho"] = combined(*walks)
    return out


def combined(*works: Work) -> Work:
    """The work of calls made together, as one."""
    return Work(*(sum(w[i] for w in works) for i in range(len(Work._fields))))


def streamed(fluid: Work, n: int, pairs: int, *solids: Work) -> Work:
    """pcisph_predict_rho_list's work beside the stencil form's: the same
    function (`fluid`, the stencil form's fluid walk, and the `solids`
    walks), with no candidate tests in its fluid sum, and the bytes it
    streams: offsets and nbr (4 B a pair) of the pair list, x (the walls'
    and body's gates), x~ and the output, plus what the solid walks
    read."""
    own = 4 * (n + 1) + 4 * pairs + 12 * n + 12 * n + 4 * n
    out = combined(Work(fluid.bytes, fluid.ops, fluid.ops, own), *solids)
    return out._replace(stream_bytes=own + sum(w.bytes for w in solids))


def pbf_listed(work: Work, n: int, pairs: int, row_bytes: int) -> Work:
    """pbf_lambda's or pbf_xsph's work as a stream over pbf_terms' pair
    list: the function's `work` with no candidate tests, and the bytes the
    stream moves: each row's base and count, nbr (4 B a pair), and
    `row_bytes` a row of the kernel's own inputs and output."""
    return Work(work.bytes, work.ops, work.ops,
                8 * n + 4 * pairs + row_bytes * n)


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


def dfsph_kick_work(n: int, pairs: int, w_bytes: int, wk: bool = False,
                    upd: bool = False) -> Work:
    """dfsph_kick over a CSR engine: coef_matvec's contraction, whose (N,
    3) matvec stays in registers, plus v and S in and v_out out (36 B a
    row); with `wk` also wk, dr and alpha in and wk_out out (16 B), with
    `upd` the mask (1 B). Per row S k + mv, its product with dt and the
    difference (12 operations), and wk + dr alpha (2)."""
    c = coef_contraction_work(False, n, pairs, w_bytes)
    nbytes = c.bytes + (24 + 16 * wk + upd) * n
    ops = c.ops + (12 + 2 * wk) * n
    return Work(nbytes, ops, ops)


def dfsph_rate_work(n: int, pairs: int, w_bytes: int, divergence: bool,
                    c_s: bool = False, owned: bool = False) -> Work:
    """dfsph_rate over a CSR engine: coef_matvec_dot's contraction, whose
    (N,) matvec_dot stays in registers, plus S, alpha and rho in and k,
    the masked value and sel out (29 B a row); in the divergence mode also
    counts in and dr out (8 B), with `c_s` the contact dot (4 B), with
    `owned` the mask (1 B). Per row v . S and d (6 operations, 7 with
    c_s), then the divergence clamp, k and the selection (7) or the
    predicted density, k and the selection (9)."""
    c = coef_contraction_work(True, n, pairs, w_bytes)
    nbytes = c.bytes + (25 + 8 * divergence + 4 * c_s + owned) * n
    ops = c.ops + (6 + c_s + (7 if divergence else 9)) * n
    return Work(nbytes, ops, ops)


def dfsph_pack_work(n: int) -> Work:
    """dfsph_pack: pos and v in (24 B a row), the record out (16 B); x . v
    (5 operations a row)."""
    return Work(40 * n, 5 * n, 5 * n)


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
                        "wcsph_forces")}
    # x, lambda and the output; x', v' and the output
    for name, row_bytes in (("pbf_lambda", 28), ("pbf_xsph", 36)):
        out[name] = pbf_listed(stencil_work(name, n, cells, cand, pairs), n,
                               pairs, row_bytes)
    nb, bcand = sc.boundary_pos.shape[0], candidates(pos, bstarts, g)
    bpairs = count_pairs(pos, sc.boundary_pos, bstarts, g, sc.h,
                         exclude_self=False)
    out["boundary_terms"] = stencil_work("boundary_terms", n, cells, bcand,
                                         bpairs, nb)
    # With walls, as the steps call them: the predicted density's two walks
    # in one launch, and PBF's constraint pass (pbf_terms' one launch).
    out["pcisph_predict_rho"] = combined(
        stencil_work("pcisph_predict_rho", n, cells, cand, pairs),
        walls_work("pcisph_predict_rho_walls", cells, bcand, bpairs, nb))
    out["pbf_terms"] = pbf_constraint_work(
        stencil_work("pbf_terms", n, cells, cand, pairs),
        walls_work("pbf_walls", cells, bcand, bpairs, nb), n, pairs)
    out["pcisph_predict_rho_list"] = streamed(
        stencil_work("pcisph_predict_rho", n, cells, cand, pairs), n, pairs,
        walls_work("pcisph_predict_rho_walls", cells, bcand, bpairs, nb))
    for sfx, wb in (("", 4), ("_bf16", 2)):
        out["coef_build" + sfx] = coef_build_work(n, cells, cand, pairs, wb)
        out["coef_matvec" + sfx] = coef_contraction_work(False, n, pairs, wb)
        out["coef_matvec_dot" + sfx] = coef_contraction_work(True, n, pairs,
                                                             wb)
    out["dfsph_pack"] = dfsph_pack_work(n)
    return out
