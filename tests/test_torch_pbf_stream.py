"""PBF's pair list and its two stream forms, held on the CPU:

* the pair list that PBF's constraint pass stores (`stencil.
  pbf_constraint`, kernel pbf_terms; plain version `pbf_constraint_plain`,
  which the CPU runs): each row's count and sources in
  the kernels' walk order, equal to the pair store that
  `coef.build_coef_plain` builds from `_pair_chunks` (its rows in walk
  order) and to the brute-force pair set, never more pairs than its
  walk's candidates (its cell's stencil count), and the rows' slots
  (`stencil.pair_rows`: a warp's 32 rows interleaved, room for the
  warp's largest count) disjoint and inside the list, on TINY's block as
  tests/test_torch_pbf.py sets it and on the clustered cloud of
  `perf/inputs.clustered_inputs`;
* `pbf_lambda` and `pbf_xsph` in their stream forms (plain versions
  `pbf_lambda_list_plain` and `pbf_xsph_list_plain`, which the CPU runs)
  over that list, against JAX's `bandmat.dense_pbf_ops` `lam_mv` and
  `xsph` on TINY's block (run as tests/test_torch_pbf.py runs them) to
  1e-5 of the output's largest magnitude, and against the walking plain
  versions (`pbf_lambda_plain`, `pbf_xsph_plain`) to 1e-6 of it: the same
  f32 pair terms summed in another order;
* a hypothesis test of lattices on cell faces whose pairs sit at exactly
  r = h (h a power of two, so that r2 = h2 in f32), with particles
  clamped into edge cells: the list against the brute-force pair set and
  the walk order, the streams against the walking forms;
* the list's size past what int32 offsets address raises.

JAX runs once a module (the fixture of tests/test_torch_pbf.py), torch on
one thread.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import example, given, settings
from hypothesis import strategies as hst

from cfd_taichi_tpu.ops.vec import V3
from cfd_taichi_tpu_torch.models import base, pbf
from cfd_taichi_tpu_torch.ops import coef
from cfd_taichi_tpu_torch.ops import neighbors as nb
from cfd_taichi_tpu_torch.ops import stencil
from cfd_taichi_tpu_torch.perf import inputs
from test_torch_pbf import _jax_ops, close, pair_case  # noqa: F401

# h = 2^-3: lattice coordinates k h and their differences are exact in f32
FACE_H = 0.125
FACE_GRID = nb.grid_for_box([0.0, 0.0, 0.0], [1.0, 1.0, 0.5], FACE_H)
# 7 pairs at exactly h, three across the grid's faces to clamped points
FACE_EXAMPLE = [(-1, 0, 0), (0, 0, 0), (1, 0, 0), (2, 0, 0), (3, 3, 1),
                (3, 3, 2), (8, 8, 4), (9, 8, 4), (8, 9, 4), (8, 8, 5)]


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def cloud():
    """The clustered cloud: a blob of ~200 a cell, empty cells, pairs at
    exactly r = h on cell faces, particles clamped into edge cells."""
    return inputs.clustered_inputs(1500, seed=5, device="cpu")


def _list(pos, starts, grid, h, m=1.0):
    return stencil.pbf_constraint(pos, starts, grid, h, m, pbf.w_ref(h),
                                  pbf.TENSION_K, None, None,
                                  *pbf.ROW_CONSTANTS)[1]


def _assert_list_is_the_walk(pos, starts, grid, h):
    """The stored list against coef's pair store (rows in walk order) and
    the brute-force pair set; each row within its room."""
    rows = stencil.pair_rows(starts, grid, nb.cell_id(pos, grid))
    pl = _list(pos, starts, grid, h)
    mask, count = nb.brute_force_neighbors(pos, pos, h, exclude_self=True)
    np.testing.assert_array_equal(pl.cnt.numpy(), count.numpy())
    eng = coef.build_coef_plain(pos, starts, grid, h, 1.0,
                                coef.csr_offsets(count))
    got_rows, got = stencil.stored_pairs(pl)
    np.testing.assert_array_equal(got.numpy(), eng.nbr.numpy())
    assert bool(mask[got_rows, got].all())
    room = nb.stencil_counts(starts, grid)[nb.cell_id(pos, grid).long()]
    assert bool((pl.cnt <= room).all())
    assert torch.equal(pl.base, rows.base)
    # every row's room, at stride LIST_STRIDE: disjoint, inside the list
    slots = torch.cat([b + stencil.LIST_STRIDE * torch.arange(r) for b, r in
                       zip(rows.base.long().tolist(), room.tolist())])
    assert slots.unique().numel() == slots.numel()
    assert slots.numel() == 0 or 0 <= int(slots.min()) <= int(slots.max()) \
        < rows.size
    return pl


def _assert_streams_are_the_walks(pos, starts, grid, h, pl, lam, new_pos,
                                  new_vel, rel=1e-6):
    for got, want in (
            (stencil.pbf_lambda_list_plain(pl, pos, h, lam),
             stencil.pbf_lambda_plain(pos, starts, grid, h, lam)),
            (stencil.pbf_xsph_list_plain(pl, h, new_pos, new_vel),
             stencil.pbf_xsph_plain(pos, starts, grid, h, new_pos,
                                    new_vel))):
        close(got, want, scale_rtol=rel)


def test_pair_list_on_tiny_is_the_walk(pair_case):  # noqa: F811
    c, sc = pair_case, pair_case["sc"]
    pl = _assert_list_is_the_walk(c["pos_s"], c["starts"], sc.grid, sc.h)
    assert int(pl.cnt.min()) > 0


def test_pair_list_on_the_clustered_cloud_is_the_walk(cloud):
    x = cloud
    pl = _assert_list_is_the_walk(x["p"], x["st"], x["grid"], x["h"])
    assert int(pl.cnt.max()) > 100      # the blob's rows


def test_stream_forms_match_jax(pair_case):  # noqa: F811
    c, sc = pair_case, pair_case["sc"]
    _, lam_mv, xsph = _jax_ops(c)
    pl = _list(c["pos_s"], c["starts"], sc.grid, sc.h, sc.particle_m)
    lam = torch.from_numpy(c["lam"])
    p1, v1 = (torch.from_numpy(c[k]) for k in ("new_pos", "new_vel"))
    stencil.reset_counts()
    got_lam = stencil.pbf_lambda(c["pos_s"], pl, sc.h, lam)
    got_xsph = stencil.pbf_xsph(pl, sc.h, p1, v1)
    k = stencil.KERNELS
    assert (k["pbf_lambda"].plain_calls, k["pbf_xsph"].plain_calls) == (1, 1)
    assert torch.equal(got_lam,
                       stencil.pbf_lambda_list_plain(pl, c["pos_s"], sc.h,
                                                     lam))
    close(got_lam, lam_mv(jnp.asarray(c["lam"])).to_numpy())
    close(got_xsph, xsph(V3.from_rows(c["new_pos"]),
                         V3.from_rows(c["new_vel"])).to_numpy())


def test_stream_forms_match_the_walking_forms(pair_case, cloud):  # noqa: F811
    c, sc = pair_case, pair_case["sc"]
    pl = _list(c["pos_s"], c["starts"], sc.grid, sc.h)
    _assert_streams_are_the_walks(
        c["pos_s"], c["starts"], sc.grid, sc.h, pl,
        torch.from_numpy(c["lam"]), torch.from_numpy(c["new_pos"]),
        torch.from_numpy(c["new_vel"]))
    x = cloud
    pl = _list(x["p"], x["st"], x["grid"], x["h"])
    _assert_streams_are_the_walks(x["p"], x["st"], x["grid"], x["h"], pl,
                                  x["lam"], x["shifted"], x["v"])


@settings(max_examples=25, deadline=None)
@given(cells=hst.lists(hst.tuples(hst.integers(-1, 9), hst.integers(-1, 9),
                                  hst.integers(-1, 5)),
                       min_size=2, max_size=80, unique=True),
       seed=hst.integers(0, 2**16))
@example(cells=FACE_EXAMPLE, seed=1)
def test_pairs_at_exactly_h_across_cell_faces(cells, seed):
    """Lattice points k h on cell faces (pairs along an axis at exactly
    r2 = h2), some outside the grid and clamped into its edge cells, and a
    few seeded points between them; velocities, lambda and updated
    positions from the seed."""
    rng = np.random.default_rng(seed)
    lattice = np.asarray(cells, np.float32) * np.float32(FACE_H)
    loose = rng.uniform(-0.1, 1.1, (int(rng.integers(0, 8)), 3))
    pos0 = torch.from_numpy(np.concatenate([lattice, loose * [1, 1, 0.5]])
                            .astype(np.float32))
    n = pos0.shape[0]
    scid, _, pos, _ = base.sort_by_cells(FACE_GRID, pos0)
    starts = nb.csr_starts(scid, FACE_GRID.num_cells)
    pl = _assert_list_is_the_walk(pos, starts, FACE_GRID, FACE_H)
    if cells == FACE_EXAMPLE:
        assert int(pl.cnt.sum()) >= 14
    new_pos = pos + torch.from_numpy(
        rng.normal(0.0, 0.3 * FACE_H, (n, 3)).astype(np.float32))
    new_vel, lam = (torch.from_numpy(a.astype(np.float32)) for a in
                    (rng.standard_normal((n, 3)), rng.uniform(-1e-4, 0, n)))
    if int(pl.cnt.sum()):
        _assert_streams_are_the_walks(pos, starts, FACE_GRID, FACE_H, pl,
                                      lam, new_pos, new_vel)


def test_a_list_past_int32_offsets_raises():
    """50,000 particles in one cell: 50,000^2 slots, more than int32
    offsets address. The rows' size raises before anything is stored."""
    grid = nb.grid_for_box([0.0, 0.0, 0.0], [1.0, 1.0, 1.0], 0.1)
    pos0 = torch.from_numpy(np.random.default_rng(3).uniform(
        0.0, 0.09, (50_000, 3)).astype(np.float32))
    scid, _, pos, _ = base.sort_by_cells(grid, pos0)
    starts = nb.csr_starts(scid, grid.num_cells)
    with pytest.raises(ValueError, match="int32 offsets"):
        stencil.pair_rows(starts, grid, scid)
    stencil.reset_counts()
    with pytest.raises(ValueError, match="int32 offsets"):
        stencil.pbf_constraint(pos, starts, grid, 0.1, 1.0, pbf.w_ref(0.1),
                               pbf.TENSION_K, None, None,
                               *pbf.ROW_CONSTANTS)
    assert stencil.KERNELS["pbf_terms"].plain_calls == 0
