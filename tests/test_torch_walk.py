"""The stencil walk's edge cases on the clustered cloud of
`cfd_taichi_tpu_torch.perf.inputs.clustered_inputs`, on the CPU:

* a dense blob of ~200 particles a cell (rows of hundreds of pairs);
* empty cells;
* a lattice on cell faces whose pairs sit at exactly r2 = h2 in f32;
* particles outside the grid's box, clamped into edge cells, in pairs.

and of its boundary cloud: a wall sheet on cell faces whose pairs with the
fluid lattice sit at exactly r2 = h2, a dense patch beside the blob,
boundary particles clamped into edge cells, and none anywhere else.

The seed lattices of the scenes have none of these. The plain versions of
the walk kernels (coef_build, viscosity, fluid_terms, boundary_terms,
wcsph_forces) and of the recompute engine's two products (matvec,
matvec_dot) are held to O(N^2) references: `build_coef_plain`'s pair set
to the brute-force pair mask (and its row counts to the JAX package's
brute force), its rows to the kernels' walk order, its w,
`viscosity_plain`, `fluid_terms_plain`, `matvec_plain`,
`matvec_dot_plain`, `wcsph_forces_plain` and `boundary_terms_plain` to
numpy sums over all pairs (the pair count
exactly), and the per-cell table that lets boundary_terms skip interior
queries to a direct count. The CUDA kernels are held to these plain
versions on the same cloud in tests/test_torch_cuda.py and chip_smoke.py.

Tolerances: the numpy references take the f32 pair test of the kernels
(r2 <= f32(h)^2) and sum their terms in f64, so the f32 plain sums agree
to 1e-5 of the output's largest value; pair sets and slots compare
exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfd_taichi_tpu.ops import neighbors as jnb
from cfd_taichi_tpu.ops.vec import V3
from cfd_taichi_tpu_torch.ops import coef
from cfd_taichi_tpu_torch.ops import neighbors as nb
from cfd_taichi_tpu_torch.ops import stencil
from cfd_taichi_tpu_torch.ops.smoothing import CubicConstants
from cfd_taichi_tpu_torch.perf import inputs

VISC = dict(c_s=13.0, alpha=0.08, eps=0.01)
WCSPH = dict(c_s=10.0, alpha=0.08, tension_k=0.2)
CLOUDS = {"n1500": (1500, 5), "n2400": (2400, 11)}


@pytest.fixture(scope="module", params=sorted(CLOUDS))
def cloud(request):
    n, seed = CLOUDS[request.param]
    x = inputs.clustered_inputs(n, seed=seed, device="cpu")
    off = coef.csr_offsets(stencil.fluid_terms(
        x["p"], x["st"], x["grid"], x["h"], x["m"]).count)
    return dict(x, off=off, pos=x["p"].numpy())


def _engine(c, dtype=torch.float32):
    return coef.build_coef_plain(c["p"], c["st"], c["grid"], c["h"], c["m"],
                                 c["off"], dtype)


def _rows(eng):
    return np.repeat(np.arange(eng.n), np.diff(eng.offsets.numpy()))


def _pair_blocks(pos, h, rows=256):
    """(row slice, x_ij (Q, N, 3) f32, r2 (Q, N) f32, pair mask) over
    blocks of query rows: the kernels' pair test, j != i."""
    h32 = np.float32(h)
    n = pos.shape[0]
    for lo in range(0, n, rows):
        d = pos[lo:lo + rows, None, :] - pos[None, :, :]
        r2 = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] \
            + d[..., 2] * d[..., 2]
        mask = r2 <= h32 * h32
        q = np.arange(lo, lo + d.shape[0])
        mask[np.arange(d.shape[0]), q] = False
        yield slice(lo, lo + d.shape[0]), d, r2, mask


def _grad_coeff(r2, h):
    """c(r) of grad W = c(r) x_ij in f64, with the kernels' q guards."""
    c = CubicConstants.of(h)
    r = np.sqrt(np.maximum(r2.astype(np.float64), 1e-24))
    q = r / c.h
    coeff = np.where(q <= 0.5, c.kg6 * (3.0 * q * q - 2.0 * q),
                     c.kgm6 * (1.0 - q) ** 2)
    coeff = np.where((q > 1e-5) & (q <= 1.0), coeff, 0.0)
    return coeff / (c.h * np.maximum(r, 1e-12))


def test_clustered_cloud_has_the_edge_cases(cloud):
    grid, st, pos, h = cloud["grid"], cloud["st"], cloud["pos"], cloud["h"]
    occ = (st[1:] - st[:-1]).numpy()
    assert occ.max() > 100
    assert (occ == 0).mean() > 0.3
    raw = np.floor(pos * np.float32(1.0 / h))
    outside = ((raw < 0) | (raw >= np.asarray(grid.dims))).any(axis=1)
    assert outside.sum() == 8
    on_face = (raw == pos * np.float32(1.0 / h)).all(axis=1)
    assert on_face.sum() >= 27
    exact = 0
    for rows, _, r2, mask in _pair_blocks(pos, h):
        exact += int((mask & (r2 == np.float32(h) ** 2)).sum())
        # every particle outside the grid has a partner within h
        assert mask[outside[rows]].any(axis=1).all()
    assert exact > 100


def test_build_coef_pair_set_matches_brute_force(cloud):
    eng = _engine(cloud)
    rows, nbr = _rows(eng), eng.nbr.numpy()
    order = np.lexsort((nbr, rows))
    mask, count = nb.brute_force_neighbors(cloud["p"], cloud["p"],
                                           cloud["h"], exclude_self=True)
    want_rows, want_nbr = np.nonzero(mask.numpy())
    np.testing.assert_array_equal(rows[order], want_rows)
    np.testing.assert_array_equal(nbr[order], want_nbr)
    n = cloud["pos"].shape[0]
    jpos = V3.from_rows(cloud["pos"])
    jax_count = jnb.brute_force_neighbors(jpos, jnp.arange(n), jpos,
                                          cloud["h"], K=1,
                                          exclude_self=True).count
    np.testing.assert_array_equal(np.diff(eng.offsets.numpy()),
                                  np.asarray(jax_count))
    np.testing.assert_array_equal(count.numpy(), np.asarray(jax_count))


def test_build_coef_walk_order_on_the_clustered_cloud(cloud):
    """Every row lists its pairs as the kernels' walk does: stencil runs in
    walk order (mid axis outer, slow inner), ascending slots in a run."""
    eng = _engine(cloud)
    grid = cloud["grid"]
    fast, mid, slow = grid.axes_by_stride
    rows, nbr = _rows(eng), eng.nbr.numpy().astype(np.int64)
    cells = nb.cell_coords(cloud["p"], grid).numpy()
    src = cells[nbr] - cells[rows]
    assert np.abs(src).max() <= 1
    run = (src[:, mid] + 1) * 3 + (src[:, slow] + 1)
    n = cloud["pos"].shape[0]
    key = (rows.astype(np.int64) * 9 + run) * n + nbr
    assert np.all(np.diff(key) > 0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_build_coef_w_matches_numpy_reference(cloud, dtype):
    eng = _engine(cloud, dtype)
    pos, h, m = cloud["pos"], cloud["h"], cloud["m"]
    d = pos[_rows(eng)] - pos[eng.nbr.numpy()]
    r2 = d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1] + d[:, 2] * d[:, 2]
    want = np.float32(m) * _grad_coeff(r2, h)
    # The f32 bar, 1e-5 of scale, and bf16's rounding on top: half an ulp
    # of each value, 2^-8 relative.
    rtol = 0.0 if dtype == torch.float32 else 2.0**-8
    np.testing.assert_allclose(eng.w.float().numpy(), want, rtol=rtol,
                               atol=1e-5 * np.abs(want).max())


def test_viscosity_plain_matches_numpy_reference(cloud):
    pos, h, m = cloud["pos"], cloud["h"], cloud["m"]
    vel, rho = cloud["v"].numpy(), cloud["rho"].numpy()
    nu, q2e = stencil._viscosity_constants(h, VISC["c_s"], VISC["alpha"],
                                           VISC["eps"])
    want = np.zeros(pos.shape, np.float64)
    for rows, d, r2, mask in _pair_blocks(pos, h):
        shear = (d.astype(np.float64)
                 * (vel[rows, None, :] - vel[None, :, :])).sum(axis=-1)
        pi = -(nu / (rho[rows, None] + rho[None, :]).astype(np.float64)) \
            * shear / (r2 + q2e)
        term = np.where(mask & (shear < 0.0),
                        -m * pi * _grad_coeff(r2, h), 0.0)
        want[rows] = m * (term[..., None] * d).sum(axis=1)
    got = stencil.viscosity_plain(cloud["p"], cloud["st"], cloud["grid"], h,
                                  m, cloud["v"], cloud["rho"], **VISC)
    assert np.abs(want).max() > 0.0
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


def _cubic_w(r2, h):
    """W(r) in f64, with the kernels' q branches."""
    c = CubicConstants.of(h)
    q = np.sqrt(np.maximum(r2.astype(np.float64), 1e-24)) / c.h
    w = np.where(q <= 0.5, c.kw * (6.0 * (q**3 - q**2) + 1.0),
                 c.kw2 * (1.0 - q) ** 3)
    return np.where(q <= 1.0, w, 0.0)


def _assert_sums(got, want):
    """Each float output to 1e-5 of the reference's largest value."""
    for name, w in want.items():
        assert np.abs(w).max() > 0.0, name
        np.testing.assert_allclose(getattr(got, name).numpy(), w, rtol=0,
                                   atol=1e-5 * np.abs(w).max(),
                                   err_msg=name)


def test_fluid_terms_plain_matches_numpy_reference(cloud):
    pos, h, m = cloud["pos"], cloud["h"], cloud["m"]
    n = pos.shape[0]
    want = dict(rho=np.zeros(n), s=np.zeros((n, 3)), qsum=np.zeros(n),
                tvec=np.zeros((n, 3)))
    count = np.zeros(n, np.int32)
    for rows, d, r2, mask in _pair_blocks(pos, h):
        r = np.sqrt(np.maximum(r2.astype(np.float64), 1e-24))
        w = np.where(mask, _cubic_w(r2, h), 0.0)
        g = np.where(mask, m * _grad_coeff(r2, h), 0.0)
        count[rows] = mask.sum(axis=1)
        want["rho"][rows] = m * w.sum(axis=1)
        want["s"][rows] = (g[..., None] * d).sum(axis=1)
        want["qsum"][rows] = ((g * r) ** 2).sum(axis=1)
        want["tvec"][rows] = (w[..., None] * d).sum(axis=1)
    got = stencil.fluid_terms_plain(cloud["p"], cloud["st"], cloud["grid"],
                                    h, m)
    np.testing.assert_array_equal(got.count.numpy(), count)
    _assert_sums(got, want)


def _matvec_reference(cloud, op):
    """f64 sums over all pairs: matvec's sum_j m gc x_ij k_j (N, 3) or
    matvec_dot's sum_j m gc x_ij . v_j (N,)."""
    pos, h, m = cloud["pos"], cloud["h"], cloud["m"]
    k, v = cloud["k"].numpy().astype(np.float64), cloud["v"].numpy()
    n = pos.shape[0]
    want = np.zeros((n, 3) if op == "matvec" else n)
    for rows, d, r2, mask in _pair_blocks(pos, h):
        a = np.where(mask, m * _grad_coeff(r2, h), 0.0)[..., None] * d
        want[rows] = (a * k[None, :, None]).sum(axis=1) if op == "matvec" \
            else (a * v[None, :, :]).sum(axis=(1, 2))
    return want


@pytest.mark.parametrize("op", ["matvec", "matvec_dot"])
def test_recompute_products_plain_match_numpy_reference(cloud, op):
    """The recompute engine's operators on rows of hundreds of pairs, empty
    cells, pairs at r = h and an n that is no multiple of a block."""
    want = _matvec_reference(cloud, op)
    assert cloud["pos"].shape[0] % 128 != 0 and np.abs(want).max() > 0.0
    args = (cloud["p"], cloud["st"], cloud["grid"], cloud["h"], cloud["m"])
    got = stencil.matvec_plain(*args, cloud["k"]) if op == "matvec" \
        else stencil.matvec_dot_plain(*args, cloud["v"])
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


def test_wcsph_forces_plain_matches_numpy_reference(cloud):
    """WCSPH's three pair terms in one coefficient: the pressure gradient
    (positive p' from the cloud's k), viscosity under compression and
    cohesion, summed in f64 over all pairs."""
    pos, h, m = cloud["pos"], cloud["h"], cloud["m"]
    vel, rho = cloud["v"].numpy(), cloud["rho"].numpy().astype(np.float64)
    pr = 0.01 * cloud["k"]
    prn = pr.numpy().astype(np.float64)
    nu, q2e = stencil._viscosity_constants(h, WCSPH["c_s"], WCSPH["alpha"],
                                           0.01)
    want = np.zeros(pos.shape, np.float64)
    for rows, d, r2, mask in _pair_blocks(pos, h):
        d64 = d.astype(np.float64)
        shear = (d64 * (vel[rows, None, :] - vel[None, :, :])).sum(axis=-1)
        gc = _grad_coeff(r2, h)
        pi = -(nu / (rho[rows, None] + rho[None, :])) * shear / (r2 + q2e)
        coeff = (-m * (prn[rows, None] + prn[None, :]) * gc
                 + np.where(shear < 0.0, -m * m * pi * gc, 0.0)
                 - WCSPH["tension_k"] * m * _cubic_w(r2, h))
        want[rows] = (np.where(mask, coeff, 0.0)[..., None] * d64).sum(axis=1)
    got = stencil.wcsph_forces_plain(cloud["p"], cloud["st"], cloud["grid"],
                                     h, m, cloud["v"], cloud["rho"], pr,
                                     **WCSPH)
    assert np.abs(want).max() > 0.0
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


def _boundary_blocks(cloud, rows=256):
    """(row slice, x_ib (Q, Nb, 3) f32, r2 f32, pair mask) of the fluid
    queries against the boundary cloud: the kernels' pair test."""
    pos, bp = cloud["pos"], cloud["bp"].numpy()
    h32 = np.float32(cloud["h"])
    for lo in range(0, pos.shape[0], rows):
        d = pos[lo:lo + rows, None, :] - bp[None, :, :]
        r2 = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] \
            + d[..., 2] * d[..., 2]
        yield slice(lo, lo + d.shape[0]), d, r2, r2 <= h32 * h32


def test_boundary_cloud_has_the_edge_cases(cloud):
    grid, h = cloud["grid"], cloud["h"]
    bp = cloud["bp"].numpy()
    occ = (cloud["bst"][1:] - cloud["bst"][:-1]).numpy()
    assert occ.max() >= 30
    assert (occ == 0).mean() > 0.8
    raw = np.floor(bp * np.float32(1.0 / h))
    outside = ((raw < 0) | (raw >= np.asarray(grid.dims))).any(axis=1)
    assert outside.sum() == 4
    exact, partners = 0, np.zeros(bp.shape[0], np.int64)
    for _, _, r2, mask in _boundary_blocks(cloud):
        exact += int((mask & (r2 == np.float32(h) ** 2)).sum())
        partners += mask.sum(axis=0)
    assert exact >= 25
    # every boundary particle outside the grid has a fluid partner within h
    assert (partners[outside] > 0).all()


def test_boundary_terms_plain_matches_numpy_reference(cloud):
    pos, h = cloud["pos"], cloud["h"]
    rho0, n = 1000.0, pos.shape[0]
    wb = rho0 * cloud["bvol"].numpy().astype(np.float64)
    want = dict(rho=np.zeros(n), s=np.zeros((n, 3)), qsum=np.zeros(n),
                g2=np.zeros(n))
    for rows, d, r2, mask in _boundary_blocks(cloud):
        r = np.sqrt(np.maximum(r2.astype(np.float64), 1e-24))
        gc = np.where(mask, _grad_coeff(r2, h), 0.0)
        w = np.where(mask, _cubic_w(r2, h), 0.0)
        want["rho"][rows] = (wb * w).sum(axis=1)
        want["s"][rows] = ((wb * gc)[..., None] * d).sum(axis=1)
        want["qsum"][rows] = ((wb * gc * r) ** 2).sum(axis=1)
        want["g2"][rows] = (wb * gc * gc * r2).sum(axis=1)
    got = stencil.boundary_terms_plain(
        cloud["p"], cloud["bp"], cloud["bvol"], cloud["bst"], cloud["grid"],
        h, rho0)
    _assert_sums(got, want)


def test_boundary_near_table_matches_direct_count(cloud):
    """`stencil_counts` of the boundary table: per cell, the boundary
    particles whose cell lies within one cell on every axis; no query
    within h of a boundary particle sits in a cell that holds 0."""
    grid = cloud["grid"]
    near = nb.stencil_counts(cloud["bst"], grid).numpy()
    assert near.dtype == np.int32 and near.shape == (grid.num_cells,)
    bcell = nb.cell_coords(cloud["bp"], grid).numpy()
    cells = np.stack(np.meshgrid(*[np.arange(d) for d in grid.dims],
                                 indexing="ij"), -1).reshape(-1, 3)
    direct = (np.abs(cells[:, None, :] - bcell[None, :, :]).max(axis=2)
              <= 1).sum(axis=1)
    np.testing.assert_array_equal(near[cells @ np.asarray(grid.strides)],
                                  direct)
    assert (near == 0).mean() > 0.5
    qnear = near[nb.cell_id(cloud["p"], grid).numpy()]
    for rows, _, _, mask in _boundary_blocks(cloud):
        assert (qnear[rows][mask.any(axis=1)] > 0).all()
    assert (qnear == 0).any() and (qnear > 0).any()
