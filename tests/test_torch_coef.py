"""The port's stored-coefficient engine (cfd_taichi_tpu_torch/ops/coef.py)
held against the JAX package, on the CPU:

(a) the three Pallas contraction kernels of tools/perf_r5_mv3.py, run in
    TPU interpret mode on a JAX `CoefEngine`, against the port's plain
    contraction over `coef_from_blocks` of the same engine;
(b) the port's pair store and contraction against `bandmat.
    build_coef_engine` + `coef_matvec_ops` on a random cloud;
(c) DFSPH steps on TINY (tests/test_solvers.py:14-23) with the port's coef
    engine against the JAX coef engine (`BAND_BYTE_BUDGET = 0`);
(d) the engine choice;
(e) the contraction on ragged CSR engines against a numpy per-row loop,
    and the byte and operation counts of the kernels' bounds.

Tolerances. The contraction's lane sums are the same f32 products summed
in another order: 1e-5 of each lane's largest magnitude. The final form
x_i s0 - s cancels, so it is compared to 1e-5 of the largest |x_i| |s_i|,
not of the largest output. bf16 engines round w and the lanes the same way
on both sides, so the lane sums keep the f32 bar; against exact f32 sums
they are held to JAX's own bf16 envelopes (tests/test_bandmat.py:209,
257). Stepped positions: f32 to the repo's engine-equivalence bar
(tests/test_bandmat.py:289-304, atol 1e-5, equal iteration counts); bf16 to
tests/test_solvers.py:311-325 (atol 2.5e-4, divergence iterations within
one).
"""

import copy
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import cfd_taichi_tpu.models.dfsph as jdfsph
from cfd_taichi_tpu.config import parse_config as jparse_config
from cfd_taichi_tpu.ops import bandmat
from cfd_taichi_tpu.ops import neighbors as jnb
from cfd_taichi_tpu.ops.vec import V3
from cfd_taichi_tpu.runner import Simulation as JaxSimulation
from cfd_taichi_tpu_torch import Simulation
from cfd_taichi_tpu_torch.config import parse_config
from cfd_taichi_tpu_torch.models import base
from cfd_taichi_tpu_torch.models import dfsph
from cfd_taichi_tpu_torch.ops import coef
from cfd_taichi_tpu_torch.ops import neighbors as nb
from cfd_taichi_tpu_torch.ops import stencil
from cfd_taichi_tpu_torch.perf import bounds, inputs

ROOT = Path(__file__).resolve().parents[1]
TINY = {
    "scene": {"box_min": [0.0, 0.0, 0.0], "box_max": [0.6, 0.8, 0.6],
              "particle_radius": 0.025, "gravity": 9.8},
    "solver": {"name": "dfsph", "delta_time": 4e-4, "iter_cnt": 1},
    "fluid": {"start_pos": [0.15, 0.1, 0.15], "water_size": [0.3, 0.3, 0.3]},
}
H, M = 0.1, 1.3e-4
B = 8
N = 512           # QB = 64 groups: a multiple of every Qg below
BOX = (0.42, 0.42, 0.42)
STEPS = 6
# bf16 divergence iterations are held within one for the first three
# steps only. The divergence loop stops on a threshold or a stall of the
# average positive density rate, and under bf16 that average jumps as
# particles cross dr = 0 (measured on TINY: 18 -> 85 -> 81 -> 0 in one
# step). Sums that agree to 1e-7 of scale (test (b)) then end the loop a
# few iterations apart: from identical positions at step 3 JAX takes 4
# and the port 5, and JAX's own bf16 run differs from its f32 run by up
# to 4 a step. Summation order alone does it: the port's bf16 run with
# its lane sums accumulated in f64 instead of f32 takes [1, 2, 5, 6, 4,
# 6, 3, 5] divergence iterations over steps 1-8 against [1, 2, 5, 4, 5,
# 4, 4, 7], while the f32 engine's counts do not move. The density
# iterations and the positions stay held.
BF16_DIV_STEPS = 3
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(scope="module")
def probe():
    """tools/perf_r5_mv3.py, the probe that holds the Pallas kernels."""
    spec = importlib.util.spec_from_file_location(
        "perf_r5_mv3", ROOT / "tools" / "perf_r5_mv3.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def cloud():
    """A cell-sorted random cloud, the same in both packages, with the JAX
    block plan of tests/test_bandmat.py:153-168."""
    rng = np.random.default_rng(20261016)
    raw = (rng.uniform(0.0, 1.0, (N, 3)) * np.asarray(BOX)).astype(np.float32)
    grid = nb.grid_for_box((0, 0, 0), BOX, H)
    scid, _, pos, _ = base.sort_by_cells(grid, torch.from_numpy(raw))
    jgrid = jnb.grid_for_box((0, 0, 0), BOX, H)
    order = np.asarray(jnp.argsort(jnb.cell_id(V3.from_rows(raw), jgrid),
                                   stable=True))
    pos_s = V3.from_rows(raw[order])
    np.testing.assert_array_equal(pos.numpy(), pos_s.to_numpy())
    table = jnb.build_cell_table(pos_s, jgrid)
    gl, plan = jnb.find_neighbors_grouped(
        pos_s, jnp.arange(N, dtype=jnp.int32), pos_s, table, jgrid, K=64,
        nbcap=16, B=B, exclude_self=True)
    assert int(np.asarray(gl.dropped)) == 0
    return dict(pos=pos, pos_s=pos_s, plan=plan, grid=grid,
                starts=nb.csr_starts(scid, grid.num_cells),
                k=rng.uniform(0.0, 2.0, N).astype(np.float32),
                v=rng.standard_normal((N, 3)).astype(np.float32))


@pytest.fixture(scope="module")
def jax_engines(cloud):
    return {name: bandmat.build_coef_engine(
        cloud["pos_s"], h=H, m=M, plan=cloud["plan"], B=B, dtype=jdt)
        for name, (jdt, _) in DTYPES.items()}


def _planes(eng, lanes):
    """(4, nblocks, BLOCK) product table of four (N,) lanes, rounded to w's
    dtype as bandmat.py:913-914 and 958-959 round it, held in f32."""
    nblocks = eng.tbx.shape[0]
    tab = jnp.stack([jnp.pad(a, (0, nblocks * bandmat.BLOCK - N)).reshape(
        nblocks, bandmat.BLOCK) for a in lanes], axis=0)
    return tab.astype(eng.w.dtype).astype(jnp.float32)


def _jax_lanes(eng, cloud, op):
    pos = eng.tbx, eng.tby, eng.tbz
    x, y, z = (a.reshape(-1)[:N] for a in pos)
    if op == "matvec":
        k = jnp.asarray(cloud["k"])
        return k, x * k, y * k, z * k
    v = V3.from_rows(cloud["v"])
    return v.x, v.y, v.z, x * v.x + y * v.y + z * v.z


def _finish(q, s, op):
    """The probe's final form (tools/perf_r5_mv3.py:225-226) from (4, ...)
    lane sums and (3, ...) query positions."""
    if op == "matvec":
        return jnp.stack([q[c] * s[0] - s[1 + c] for c in range(3)])
    return q[0] * s[0] + q[1] * s[1] + q[2] * s[2] - s[3]


def _port(eng, cloud, op, lane_sums):
    fn = coef.coef_matvec_plain if op == "matvec" else \
        coef.coef_matvec_dot_plain
    arg = cloud["k"] if op == "matvec" else cloud["v"]
    return fn(eng, cloud["pos"], torch.from_numpy(arg), lane_sums).numpy()


def _cancel_scale(pos, sums, op):
    """Largest |x_i| |s_i|: the magnitude that cancels in the final form."""
    s = sums[:, :1] if op == "matvec" else sums[:, :3]
    return float((np.linalg.norm(pos, axis=1)
                  * np.linalg.norm(s, axis=1)).max())


def _close_lanes(got, want):
    for r in range(4):
        np.testing.assert_allclose(
            got[:, r], want[:, r], rtol=0,
            atol=1e-5 * float(np.abs(want[:, r]).max()))


# ---------------------------------------------------------------------------
# (a) the three Pallas kernels
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("op", ["matvec", "matvec_dot"])
@pytest.mark.parametrize("kernel", ["vpu", "mxu", "fused"])
def test_contraction_matches_pallas_kernels(kernel, op, dtype, cloud,
                                            jax_engines, probe):
    eng = jax_engines[dtype]
    QB, _, W = eng.w.shape
    nbcap, nblocks = eng.blkq.shape[1], eng.tbx.shape[0]
    tab4 = _planes(eng, _jax_lanes(eng, cloud, op))
    with pltpu.force_tpu_interpret_mode():
        if kernel == "fused":
            call = probe.make_fused(QB, B, W, nbcap, nblocks, 8)
            out = call(eng.blkq, eng.w, tab4)
        else:
            kern, qg = {"vpu": (probe.contract_vpu_kernel, 8),
                        "mxu": (probe.contract_mxu_kernel, 16)}[kernel]
            p = tab4[:, eng.blkq].reshape(4, QB, W)
            out = probe.make_contract(QB, B, W, qg, kern)(eng.w, p)
        final = _finish((eng.qx, eng.qy, eng.qz), out, op)
    lanes = np.asarray(out).reshape(4, -1)[:, :N].T
    final = np.asarray(final)
    final = final.reshape(3, -1)[:, :N].T if op == "matvec" else \
        final.reshape(-1)[:N]

    port_eng = coef.coef_from_blocks(np.asarray(eng.blkq), np.asarray(eng.w),
                                     N, B, bandmat.BLOCK)
    assert port_eng.w.dtype == DTYPES[dtype][1]
    assert int(port_eng.offsets[-1]) > 20 * N   # ~22 pairs per row
    got = _port(port_eng, cloud, op, lane_sums=True)
    _close_lanes(got, lanes)
    scale = _cancel_scale(cloud["pos"].numpy(), got, op)
    np.testing.assert_allclose(_port(port_eng, cloud, op, False), final,
                               rtol=0, atol=1e-5 * scale)


# ---------------------------------------------------------------------------
# (b) the pair store and the contraction against the JAX engine
# ---------------------------------------------------------------------------

def _port_engine(cloud, dtype):
    ft = stencil.fluid_terms_plain(cloud["pos"], cloud["starts"],
                                   cloud["grid"], H, M)
    return coef.build_coef_plain(cloud["pos"], cloud["starts"], cloud["grid"],
                                 H, M, coef.csr_offsets(ft.count), dtype)


def _pairs(eng):
    """(row, nbr, w) of every nonzero pair, sorted by (row, nbr)."""
    rows = np.repeat(np.arange(eng.n), np.diff(eng.offsets.numpy()))
    nbr, w = eng.nbr.numpy(), eng.w.float().numpy()
    keep = w != 0.0
    order = np.lexsort((nbr[keep], rows[keep]))
    return rows[keep][order], nbr[keep][order], w[keep][order]


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_build_coef_matches_build_coef_engine(dtype, cloud, jax_engines):
    eng = _port_engine(cloud, DTYPES[dtype][1])
    jeng = jax_engines[dtype]
    want = coef.coef_from_blocks(np.asarray(jeng.blkq), np.asarray(jeng.w),
                                 N, B, bandmat.BLOCK)
    got_rows, got_nbr, got_w = _pairs(eng)
    want_rows, want_nbr, want_w = _pairs(want)
    np.testing.assert_array_equal(got_rows, want_rows)
    np.testing.assert_array_equal(got_nbr, want_nbr)
    # The same f32 expression per pair, but XLA may round r2 differently
    # (w ~ (1 - q)^2 is steep near r = h): 1e-6 of the largest |w|.
    np.testing.assert_allclose(got_w, want_w, rtol=0,
                               atol=1e-6 * float(np.abs(want_w).max()))


def test_build_coef_walk_order(cloud):
    """Each row lists its pairs as the kernel's walk does: per stencil run,
    ascending slots, with runs in walk order; and the row's pair count is
    fluid_terms' count."""
    eng = _port_engine(cloud, torch.float32)
    ft = stencil.fluid_terms_plain(cloud["pos"], cloud["starts"],
                                   cloud["grid"], H, M)
    np.testing.assert_array_equal(np.diff(eng.offsets.numpy()),
                                  ft.count.numpy())
    grid = cloud["grid"]
    fast, mid, slow = grid.axes_by_stride
    cells = nb.cell_coords(cloud["pos"], grid).numpy()
    off, nbr = eng.offsets.numpy(), eng.nbr.numpy()
    for i in range(0, N, 37):
        src = cells[nbr[off[i]:off[i + 1]]] - cells[i]
        run = (src[:, mid] + 1) * 3 + (src[:, slow] + 1)
        key = run.astype(np.int64) * N + nbr[off[i]:off[i + 1]]
        assert np.all(np.diff(key) > 0), i


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_contraction_matches_coef_matvec_ops(dtype, cloud, jax_engines):
    jeng = jax_engines[dtype]
    mv, mvd = bandmat.coef_matvec_ops(jeng, N, B)
    want_mv = mv(jnp.asarray(cloud["k"])).to_numpy()
    want_dot = np.asarray(mvd(V3.from_rows(cloud["v"])))
    eng = _port_engine(cloud, DTYPES[dtype][1])
    got_mv = _port(eng, cloud, "matvec", False)
    got_dot = _port(eng, cloud, "matvec_dot", False)
    pos = cloud["pos"].numpy()
    if dtype == "f32":
        for op, got, want in (("matvec", got_mv, want_mv),
                              ("matvec_dot", got_dot, want_dot)):
            scale = _cancel_scale(pos, _port(eng, cloud, op, True), op)
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * scale)
        return
    # bf16 against the exact f32 loop operators, S k + matvec(k) and
    # v . S - matvec_dot(v), in JAX's own envelopes: 2 % of the first's and
    # 7.5 % of the second's largest magnitude.
    S = stencil.fluid_terms_plain(cloud["pos"], cloud["starts"],
                                  cloud["grid"], H, M).s.numpy()
    k, v = cloud["k"], cloud["v"]
    exact = _port_engine(cloud, torch.float32)
    ref_mv = S * k[:, None] + _port(exact, cloud, "matvec", False)
    ref_dot = (v * S).sum(axis=1) - _port(exact, cloud, "matvec_dot", False)
    for got in (got_mv, want_mv):
        err = np.abs(S * k[:, None] + got - ref_mv).max()
        assert err < 0.02 * np.abs(ref_mv).max()
    for got in (got_dot, want_dot):
        err = np.abs((v * S).sum(axis=1) - got - ref_dot).max()
        assert err < 0.075 * np.abs(ref_dot).max()


def test_coef_matvec_matches_recompute_matvec(cloud):
    """The stored engine and the recompute stencil pass are the same
    linear map (f32)."""
    eng = _port_engine(cloud, torch.float32)
    k, v = torch.from_numpy(cloud["k"]), torch.from_numpy(cloud["v"])
    args = (cloud["pos"], cloud["starts"], cloud["grid"], H, M)
    pos = cloud["pos"].numpy()
    for op, got, want in (
            ("matvec", coef.coef_matvec(eng, cloud["pos"], k),
             stencil.matvec(*args, k)),
            ("matvec_dot", coef.coef_matvec_dot(eng, cloud["pos"], v),
             stencil.matvec_dot(*args, v))):
        scale = _cancel_scale(pos, _port(eng, cloud, op, True), op)
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                                   atol=1e-5 * scale)


def test_wrappers_reject_other_devices():
    meta = torch.empty((4, 3), device="meta")
    eng = coef.CoefEngine(torch.zeros(5, dtype=torch.int32, device="meta"),
                          torch.zeros(0, dtype=torch.int32, device="meta"),
                          torch.zeros(0, device="meta"))
    with pytest.raises(ValueError, match="no kernel for device"):
        coef.coef_matvec(eng, meta, torch.empty(4, device="meta"))
    with pytest.raises(ValueError, match="storage dtype"):
        coef.build_coef(meta, None, None, H, M, None, torch.float16)


# ---------------------------------------------------------------------------
# (c) DFSPH steps against the JAX coef engine, (d) the engine choice
# ---------------------------------------------------------------------------

def _pos_by_oid(pos, oid):
    pos, oid = np.asarray(pos), np.asarray(oid)
    return pos[np.argsort(oid)]


@pytest.fixture(scope="module")
def jax_coef_runs():
    """JAX TINY steps on the stored-coefficient engine (band budget 0), in
    f32 and in its default bf16."""
    runs = {}
    for name, (jdt, _) in DTYPES.items():
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jdfsph, "BAND_BYTE_BUDGET", 0)
            mp.setattr(jdfsph, "BAND_DTYPE", jdt)
            jax.clear_caches()
            sim = JaxSimulation(jparse_config(copy.deepcopy(TINY)))
            st = sim.scene.static
            # The plain coef engine carries the step: not the band engine,
            # and no split buckets on a small scene.
            assert jdfsph.dense_eligible(st)
            assert not jdfsph.use_band_engine(st.n_fluid, st.band_nb)
            assert st.coef_nbA == 0
            snaps = []
            for _ in range(STEPS):
                sim.step()
                s = sim.state
                snaps.append(dict(
                    pos=_pos_by_oid(s.fluid.pos.to_numpy(), s.fluid.oid),
                    dt=float(s.dt), diag=np.asarray(s.diag).copy(),
                    overflow=int(s.overflow)))
            runs[name] = snaps
    jax.clear_caches()
    return runs


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_dfsph_coef_steps_match_jax_coef_engine(dtype, jax_coef_runs,
                                                monkeypatch):
    monkeypatch.setattr(dfsph, "COEF_DTYPE", DTYPES[dtype][1])
    sim = Simulation(parse_config(copy.deepcopy(TINY)), device="cpu")
    stencil.reset_counts()
    for step, snap in enumerate(jax_coef_runs[dtype], start=1):
        sim.step()
        got = _pos_by_oid(sim.state.fluid.pos.numpy(),
                          sim.state.fluid.oid.numpy())
        diag = sim.state.diag.numpy()
        print(f"parity dfsph coef {dtype} step {step}: pos err "
              f"{np.abs(got - snap['pos']).max():.3e}")
        assert snap["overflow"] == 0
        if dtype == "f32":
            np.testing.assert_allclose(got, snap["pos"], atol=1e-5)
            np.testing.assert_allclose(float(sim.state.dt), snap["dt"],
                                       rtol=1e-5)
            assert (diag[0], diag[2]) == (snap["diag"][0], snap["diag"][2])
        else:
            np.testing.assert_allclose(got, snap["pos"], atol=2.5e-4)
            assert diag[2] == snap["diag"][2]
            if step <= BF16_DIV_STEPS:
                assert abs(diag[0] - snap["diag"][0]) <= 1
    assert stencil.KERNELS["coef_matvec"].plain_calls > 0
    assert stencil.KERNELS["matvec"].plain_calls == 0
    assert sim.telemetry()["nan_particles"] == 0


@pytest.mark.parametrize("budget", ["default", "zero"])
def test_engine_choice(budget, monkeypatch):
    if budget == "zero":
        monkeypatch.setattr(dfsph, "COEF_BYTE_BUDGET", 0)
    sim = Simulation(parse_config(copy.deepcopy(TINY)), device="cpu")
    stencil.reset_counts()
    sim.step()
    k = stencil.KERNELS
    # DFSPH's dot on the stored engine: the rate over the source record
    stored = (k["coef_build"].plain_calls, k["coef_matvec"].plain_calls,
              k["dfsph_rate"].plain_calls)
    recomputed = (k["matvec"].plain_calls, k["matvec_dot"].plain_calls)
    if budget == "default":
        assert stored[0] == 1 and min(stored) > 0 and recomputed == (0, 0)
    else:
        assert stored == (0, 0, 0) and min(recomputed) > 0


# ---------------------------------------------------------------------------
# (e) ragged CSR engines and the bound counts
# ---------------------------------------------------------------------------

def _numpy_contraction(eng, pos, x, op):
    """(N, 4) lane sums by a per-row loop in f64 over f32 lanes, rounded to
    the storage dtype first as `_contract_plain` rounds them."""
    pos, x = pos.numpy(), x.numpy()
    if op == "matvec":
        lanes = np.stack([x, pos[:, 0] * x, pos[:, 1] * x, pos[:, 2] * x], 1)
    else:
        xv = pos[:, 0] * x[:, 0] + pos[:, 1] * x[:, 1] + pos[:, 2] * x[:, 2]
        lanes = np.concatenate([x, xv[:, None]], axis=1)
    lanes = torch.from_numpy(lanes).to(eng.w.dtype).double().numpy()
    off, nbr = eng.offsets.numpy(), eng.nbr.numpy()
    w = eng.w.double().numpy()
    sums = np.zeros((eng.n, 4))
    for i in range(eng.n):
        p = slice(off[i], off[i + 1])
        sums[i] = w[p] @ lanes[nbr[p]]
    return sums


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("op", ["matvec", "matvec_dot"])
def test_contraction_on_ragged_engine(op, dtype):
    """Rows of 0, 1, G-1, G+1 and 100+ pairs for every lane-group width G
    in 4-32, random (not walk-order) sources, 1000 rows."""
    eng, pos, k, v = inputs.ragged_engine(1000, DTYPES[dtype][1],
                                          device="cpu")
    lengths = set(np.diff(eng.offsets.numpy()).tolist())
    assert {0, 1, 3, 5, 7, 9, 15, 17, 31, 33}.issubset(lengths)
    assert max(lengths) >= 100
    fn = coef.coef_matvec if op == "matvec" else coef.coef_matvec_dot
    x = k if op == "matvec" else v
    want = _numpy_contraction(eng, pos, x, op)
    got = fn(eng, pos, x, lane_sums=True).numpy()
    _close_lanes(got, want)
    p = pos.numpy().astype(np.float64)
    final = p * want[:, :1] - want[:, 1:] if op == "matvec" else \
        (p * want[:, :3]).sum(axis=1) - want[:, 3]
    np.testing.assert_allclose(fn(eng, pos, x).numpy(), final, rtol=0,
                               atol=1e-5 * _cancel_scale(p, want, op))


@pytest.mark.parametrize("op", ["matvec", "matvec_dot"])
def test_contraction_bound_counts_each_array_once(op):
    dot = op == "matvec_dot"
    for dtype, w_bytes in ((torch.float32, 4), (torch.bfloat16, 2)):
        eng, pos, k, v = inputs.ragged_engine(1003, dtype, device="cpu")
        fn = coef.coef_matvec_dot if dot else coef.coef_matvec
        x = v if dot else k
        for lane_sums in (False, True):
            out = fn(eng, pos, x, lane_sums=lane_sums)
            arrays = (*eng, pos, x, out)
            work = bounds.coef_contraction_work(dot, eng.n, eng.nbr.numel(),
                                                w_bytes, lane_sums)
            assert work.bytes == sum(a.numel() * a.element_size()
                                     for a in arrays)
            # a multiply and an add per lane and pair, plus the lanes
            assert work.ops > 8 * eng.nbr.numel()
    assert bounds.Work(int(3.35e12), 0).bound() == (1.0, "bytes")
    assert bounds.Work(0, int(67e12)).bound() == (1.0, "operations")


def test_stencil_candidates_match_brute_force(cloud):
    """`candidates` counts the sources in each query's 27 clamped cells."""
    cells = nb.cell_coords(cloud["pos"], cloud["grid"]).numpy()
    near = np.abs(cells[:, None, :] - cells[None, :, :]).max(axis=2) <= 1
    assert bounds.candidates(cloud["pos"], cloud["starts"],
                             cloud["grid"]) == int(near.sum())


def test_stencil_bound_counts_pairs_and_walk(cloud):
    """A stencil kernel's bound counts the pairs within h (brute force), a
    distance test and a pair term each; the walk's other candidates count
    only in `walk_ops`."""
    pos = cloud["pos"].double()
    d2 = ((pos[:, None, :] - pos[None, :, :]) ** 2).sum(-1)
    pairs = stencil.count_pairs(cloud["pos"], cloud["pos"], cloud["starts"],
                                cloud["grid"], H, exclude_self=True)
    near = int((d2 <= H * H).sum()) - N
    assert abs(pairs - near) <= 1e-3 * near     # f32 r2 against f64 at r = h
    cand = bounds.candidates(cloud["pos"], cloud["starts"], cloud["grid"])
    work = bounds.stencil_work("fluid_terms", N, cloud["grid"].num_cells,
                               cand, pairs)
    per_pair = bounds.CANDIDATE_OPS + bounds.PAIR_OPS["fluid_terms"]
    assert work.ops == per_pair * pairs
    assert work.walk_ops == work.ops + bounds.CANDIDATE_OPS * (cand - pairs)
    assert work.bound()[0] == max(work.bytes / bounds.HBM_BYTES_PER_S,
                                  work.ops / bounds.F32_OPS_PER_S)
