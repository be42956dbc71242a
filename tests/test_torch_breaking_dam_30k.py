"""configs/breaking_dam_30k.json (29,120 fluid and 21,602 boundary
particles, Akinci walls) held to the JAX package step for step, both
packages on the CPU, from rest:

* DFSPH: JAX with its loop coefficients in f32 (`BAND_DTYPE`, as
  tests/test_torch_dfsph.py does), the port on its default engine
  (stored coefficients, f32);
* WCSPH.

The bars are the repo's engine-equivalence bars (tests/test_solvers.py:
228-271): positions through `oid` to atol 5e-6, dt to rtol 1e-5, equal
iteration counts; for WCSPH also the density through `density_error` to
rtol 1e-5 (every 10 steps and the last).

What holds, as run on the CPU (ROADMAP.md section 3 logs the rest):

* WCSPH, all 300 steps: every bar; positions within 2.4e-7, density
  errors within 2.6e-7 relative.
* DFSPH: positions within 5e-6 for steps 1-2 only (5.5e-6 at step 3,
  1.4e-4 at step 10, 2.9e-3 at step 30, 0.21 at step 200). From step 2
  on the divergence solve stops at its 15-iteration cap every step
  without reaching its threshold, so the two packages' f32 sum orders
  are not damped out and the trajectories part. dt holds for steps 1-30
  and the iteration counts for steps 1-31; over all 200 steps the
  divergence counts stay equal, the density counts differ by at most one,
  and both packages keep the density residual at or under 1.0 (0.1 %
  rho0), the loop's contract. The test asserts these.

Two checks of that DFSPH mismatch, 30 steps each: JAX's own band and
compact engines against each other, and the port's recompute engine
against JAX's band engine (ROADMAP.md section 3 reads both).

Marked `slow`: tier-1 (`-m 'not slow'`) skips it. Run it with

    JAX_PLATFORMS=cpu python -m pytest -m slow \\
        tests/test_torch_breaking_dam_30k.py

On an 8-core x86 host, alone, one run of each package took ~7.5 min
(JAX) and ~7 min (port) for DFSPH's 200 steps and ~2 and ~4 min for
WCSPH's 300 steps; the file ran in 34 min (DFSPH 22.4, WCSPH 11.4) with
other work on the host. The two 30-step checks took 255 s and 309 s.
"""

import copy
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import cfd_taichi_tpu.models.dfsph as jdfsph
import cfd_taichi_tpu.models.wcsph as jwcsph
from cfd_taichi_tpu.config import parse_config as jparse_config
from cfd_taichi_tpu.runner import Simulation as JaxSimulation
from cfd_taichi_tpu_torch import Simulation
from cfd_taichi_tpu_torch.config import parse_config
from cfd_taichi_tpu_torch.models import dfsph, wcsph

CONFIG = Path(__file__).resolve().parents[1] / "configs" / \
    "breaking_dam_30k.json"
STEPS = {"dfsph": 200, "wcsph": 300}
DENSITY_EVERY = 10
# DFSPH: the last step at which each bar holds (module docstring).
DFSPH_POS_UNTIL, DFSPH_DT_UNTIL, DFSPH_ITERS_UNTIL = 2, 30, 31


def _raw(solver):
    raw = json.loads(CONFIG.read_text())
    raw["solver"]["name"] = solver
    return raw


def _pos_by_oid(pos, oid):
    pos, oid = np.asarray(pos), np.asarray(oid)
    return pos[np.argsort(oid)]


def _run_both(solver, steps=None):
    """Step both packages in turn (`steps`, default STEPS[solver]); a row
    per step: the largest position difference, both dts, both diags and,
    every DENSITY_EVERY steps and at the last, both density errors."""
    rows = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jdfsph, "BAND_DTYPE", jnp.float32)
        # The dtype is read at trace time: drop traces made with bf16, and
        # (after the context) the f32 ones, so no other test reuses them.
        jax.clear_caches()
        jsim = JaxSimulation(jparse_config(copy.deepcopy(_raw(solver))))
        sim = Simulation(parse_config(_raw(solver)), device="cpu")
        steps = steps or STEPS[solver]
        for k in range(1, steps + 1):
            jsim.step()
            sim.step()
            js, ps = jsim.state, sim.state
            got = _pos_by_oid(ps.fluid.pos.numpy(), ps.fluid.oid.numpy())
            want = _pos_by_oid(js.fluid.pos.to_numpy(), js.fluid.oid)
            row = dict(step=k, err=float(np.abs(got - want).max()),
                       finite=bool(np.isfinite(got).all()),
                       dt=(float(ps.dt), float(js.dt)),
                       diag=(ps.diag.numpy().copy(), np.asarray(js.diag)))
            if solver == "wcsph" and (k % DENSITY_EVERY == 0
                                      or k == steps):
                row["density_error"] = (
                    float(wcsph.density_error(sim.scene, ps)),
                    float(jwcsph.density_error(jsim.scene.static,
                                               jsim.scene.arrays, js)))
            rows.append(row)
    jax.clear_caches()
    return rows


@pytest.mark.slow
def test_wcsph_30k_matches_jax_step_for_step():
    rows = _run_both("wcsph")
    for r in rows:
        assert r["finite"], r["step"]
        assert r["err"] <= 5e-6, (r["step"], r["err"])
        assert r["dt"][0] == pytest.approx(r["dt"][1], rel=1e-5), r
        if "density_error" in r:
            got, want = r["density_error"]
            assert want > 0.0
            assert got == pytest.approx(want, rel=1e-5), r
    assert sum("density_error" in r for r in rows) == 30


@pytest.mark.slow
def test_dfsph_30k_matches_jax_step_for_step():
    rows = _run_both("dfsph")
    for r in rows:
        k, (got, want) = r["step"], r["diag"]
        assert r["finite"], k
        if k <= DFSPH_POS_UNTIL:
            assert r["err"] <= 5e-6, (k, r["err"])
        if k <= DFSPH_DT_UNTIL:
            assert r["dt"][0] == pytest.approx(r["dt"][1], rel=1e-5), r
        if k <= DFSPH_ITERS_UNTIL:
            assert (got[0], got[2]) == (want[0], want[2]), r
        assert got[0] == want[0], r
        assert abs(got[2] - want[2]) <= 1, r
        assert got[3] <= 1.0 and want[3] <= 1.0, r


ENGINE_STEPS = 30
ENGINE_OVERFLOW_FROM = 9


def _run_jax_engine(dense):
    """JAX DFSPH on breaking_dam_30k from rest for ENGINE_STEPS steps, f32
    loop coefficients, on its dense (band) path or, with `dense` False,
    its compact (N, K) path: per step the positions through `oid`, the dt
    and the diag."""
    rows = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jdfsph, "BAND_DTYPE", jnp.float32)
        mp.setattr(jdfsph, "DENSE_FLUID", dense)
        # Both flags are read at trace time (tests/test_solvers.py:
        # test_dense_mode_matches_compact).
        jax.clear_caches()
        jsim = JaxSimulation(jparse_config(copy.deepcopy(_raw("dfsph"))))
        st = jsim.scene.static
        assert jdfsph.dense_eligible(st) == dense
        assert jdfsph.use_band_engine(st.n_fluid, st.band_nb)
        for _ in range(ENGINE_STEPS):
            jsim.step()
            js = jsim.state
            rows.append(dict(pos=_pos_by_oid(js.fluid.pos.to_numpy(),
                                             js.fluid.oid),
                             dt=float(js.dt), diag=np.asarray(js.diag),
                             overflow=int(js.overflow)))
    jax.clear_caches()
    return rows


def _assert_engines_agree(k, err, dts, diags):
    """What two engines of this scene hold through ENGINE_STEPS steps:
    equal iteration counts every step, dt to rtol 1e-5 before the last
    step, positions to 5e-6 before JAX's engines first drop pairs."""
    (got, want) = diags
    assert (got[0], got[2]) == (want[0], want[2]), (k, got, want)
    if k < ENGINE_STEPS:
        assert dts[0] == pytest.approx(dts[1], rel=1e-5), (k, dts)
    if k < ENGINE_OVERFLOW_FROM:
        assert err <= 5e-6, (k, err)


@pytest.mark.slow
def test_jax_dense_and_compact_engines_part_on_dfsph_30k():
    """The DFSPH mismatch of the port against JAX on this scene, put to
    JAX's own two engines: the band engine and the compact path sum the
    same pairs in other orders. Prints, every step, the largest position
    difference through `oid` beside the dt, the diags and JAX's dropped-
    pair counts; ROADMAP.md section 3 reads it. As run on the CPU: 0,
    6.0e-8, 2.4e-7 at steps 1-3 (the port against JAX: 0, 2.4e-7, 5.5e-6),
    1.1e-5 at step 10 and 9.7e-4 at step 30; equal iteration counts
    throughout; both engines drop 1-10 pairs a step from step 9 on."""
    band = _run_jax_engine(dense=True)
    compact = _run_jax_engine(dense=False)
    for k, (a, b) in enumerate(zip(band, compact, strict=True), start=1):
        err = float(np.abs(a["pos"] - b["pos"]).max())
        print(f"step {k}: band vs compact pos err {err:.3e}  dt "
              f"{a['dt']:.6e} / {b['dt']:.6e}  diag {a['diag'].tolist()}"
              f" / {b['diag'].tolist()}  overflow {a['overflow']} / "
              f"{b['overflow']}")
        assert np.isfinite(a["pos"]).all() and np.isfinite(b["pos"]).all()
        assert a["diag"][3] <= 1.0 and b["diag"][3] <= 1.0, k
        _assert_engines_agree(k, err, (a["dt"], b["dt"]),
                              (a["diag"], b["diag"]))
        if k < ENGINE_OVERFLOW_FROM:
            assert a["overflow"] == b["overflow"] == 0, k


@pytest.mark.slow
def test_dfsph_30k_recompute_engine_against_jax(monkeypatch):
    """The port's recompute engine (`COEF_BYTE_BUDGET = 0`: the products in
    JAX's band arithmetic, (w dx) k_j, not the stored engine's absolute-
    coordinate split) against JAX's band engine, through the steps of
    the engine check above; prints every step. ROADMAP.md section 3 reads
    it beside the stored engine's run. As run on the CPU: 0, 1.2e-7,
    1.2e-7 at steps 1-3, 2.4e-7 through step 8, as close as JAX's two
    engines are to each other; 2.0e-6 at step 9, where JAX begins to drop
    pairs, 3.1e-5 at step 10 and 2.9e-3 at step 30."""
    monkeypatch.setattr(dfsph, "COEF_BYTE_BUDGET", 0)
    rows = _run_both("dfsph", steps=ENGINE_STEPS)
    for r in rows:
        got, want = r["diag"]
        print(f"step {r['step']}: pos err {r['err']:.3e}  dt {r['dt'][0]:.6e}"
              f" / {r['dt'][1]:.6e}  diag {got.tolist()} / {want.tolist()}")
        assert r["finite"], r["step"]
        assert got[3] <= 1.0 and want[3] <= 1.0, r
        _assert_engines_agree(r["step"], r["err"], r["dt"], r["diag"])
