"""The port's PCISPH (cfd_taichi_tpu_torch/models/pcisph.py) held against
the JAX package on the TINY scene of tests/test_solvers.py:14-23 (216 fluid
particles), both on the CPU:

* the predicted-density pass: `pcisph_predict_rho_plain` against
  `bandmat.predicted_rho_op` + `boundary_predict_op` on TINY's block with a
  0.1 r jitter, moved next to the walls so that boundary pairs exist, and
  predicted positions shifted by a seeded ~0.3 r displacement, so that
  pairs cross r = h in both directions;
* the stiffness delta of `init_state` against JAX's (rtol 1e-6): the
  lattice has many particles tied for the most neighbours, and both take
  the first in cell-sorted order;
* steps: 6 from a compressed state (TINY's block scaled by 0.85 about its
  centre, so the block's interior sits above rho0 and the loop iterates),
  with Akinci walls and with the clamp boundary, on the recompute and the
  stored-coefficient engine: positions through `oid` and the iteration
  count of every step, and on the recompute engine, whose products are
  JAX's band products, the residual diag[1] (the stored-coefficient engine
  splits x_ij into absolute coordinates, which rounds its pressure force
  unlike JAX's dense path: residual 0.98244171 against 0.98253477 at step
  1 with walls);
* checkpoints with the delta leaf across packages, the CLI on
  configs/pcisph_basic.json, and the checklist of tests/test_solvers.py:
  38-62.

JAX runs with f32 loop coefficients (`BAND_DTYPE`), as tests/
test_torch_iisph.py does. Tolerances: positions to atol 5e-6, iteration
counts exact (tests/test_solvers.py:263-271). The residual is an average
of rho - rho0 over the particles above rho0, each known to about one ulp
of rho (6.1e-5 at rho0): it is held to that ulp. (JAX's own walls and
clamp runs of this state, which touch no wall, give residuals 0.98253477
and 0.98249510 at step 1: 4.0e-5 apart, from XLA's fusions and FMA
contractions alone.) The pass sums the same f32 pair terms in another
order: 1e-5 of the output's largest magnitude.
"""

import copy
import json
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cfd_taichi_tpu.models.dfsph as jdfsph
import cfd_taichi_tpu.models.pcisph as jpcisph
from cfd_taichi_tpu import scene as jscene
from cfd_taichi_tpu.config import parse_config as jparse_config
from cfd_taichi_tpu.models import base as jbase
from cfd_taichi_tpu.ops import bandmat
from cfd_taichi_tpu.ops.vec import V3
from cfd_taichi_tpu.runner import Simulation as JaxSimulation
from cfd_taichi_tpu.utils import io as jio
from cfd_taichi_tpu_torch import Simulation, build_scene, models
from cfd_taichi_tpu_torch.config import parse_config
from cfd_taichi_tpu_torch.models import base, dfsph, pcisph
from cfd_taichi_tpu_torch.ops import neighbors as nb
from cfd_taichi_tpu_torch.ops import stencil
from cfd_taichi_tpu_torch.utils import io

TINY = {
    "scene": {"box_min": [0.0, 0.0, 0.0], "box_max": [0.6, 0.8, 0.6],
              "particle_radius": 0.025, "gravity": 9.8},
    "solver": {"name": "pcisph", "delta_time": 4e-4, "iter_cnt": 1},
    "fluid": {"start_pos": [0.15, 0.1, 0.15], "water_size": [0.3, 0.3, 0.3]},
}
ROOT = Path(__file__).resolve().parents[1]
STEPS = 6
SQUEEZE = 0.85
SEED = 20261017
RHO_ULP = float(np.spacing(np.float32(1000.0)))


@pytest.fixture(autouse=True)
def recompute_engine(monkeypatch):
    monkeypatch.setattr(dfsph, "COEF_BYTE_BUDGET", 0)


def _tiny(scene):
    raw = copy.deepcopy(TINY)
    raw["solver"]["boundary_handle"] = scene == "walls"
    return raw


def _by_oid(rows, oid):
    rows, oid = np.asarray(rows), np.asarray(oid)
    return rows[np.argsort(oid)]


def _leaves(state):
    return [np.asarray(a) for a in jax.tree_util.tree_flatten(state)[0]]


def run_jax(raw):
    """JAX steps from the compressed state with f32 loop coefficients: its
    init delta, the start leaves and a snapshot after each step."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jdfsph, "BAND_DTYPE", jnp.float32)
        # Read at trace time: drop the traces made before, and (after the
        # context) these, so no other test reuses them.
        jax.clear_caches()
        leaves = _leaves(JaxSimulation(jparse_config(raw)).state)
        delta = float(leaves[io._EXTRA])
        pos = np.stack(leaves[:3], axis=-1)
        mid = (pos.min(axis=0) + pos.max(axis=0)) / 2
        pos = (mid + SQUEEZE * (pos - mid)).astype(np.float32)
        leaves[:3] = [np.ascontiguousarray(pos[:, c]) for c in range(3)]
        sim = JaxSimulation(jparse_config(raw), plan_pos=pos)
        assert jpcisph.dense_eligible(sim.scene.static)
        sim.state = jax.tree_util.tree_unflatten(
            jax.tree_util.tree_structure(sim.state),
            [jnp.asarray(a) for a in leaves])
        snaps = []
        for _ in range(STEPS):
            sim.step()
            s = sim.state
            snaps.append(dict(
                pos=_by_oid(s.fluid.pos.to_numpy(), s.fluid.oid),
                diag=np.asarray(s.diag).copy(), overflow=int(s.overflow),
                leaves=_leaves(s)))
    jax.clear_caches()
    return dict(delta=delta, leaves=leaves, snaps=snaps)


@pytest.fixture(scope="module")
def jax_runs():
    return {scene: run_jax(_tiny(scene)) for scene in ("walls", "clamp")}


def _port_sim(scene="walls"):
    return Simulation(parse_config(_tiny(scene)), device="cpu")


# ---------------------------------------------------------------------------
# The predicted-density pass
# ---------------------------------------------------------------------------

def test_predict_rho_plain_matches_jax_ops():
    jsc = jscene.build_scene(jparse_config(_tiny("walls")))
    st = jsc.static
    sc = build_scene(parse_config(_tiny("walls")), device="cpu")
    rng = np.random.default_rng(SEED)
    r, n = st.particle_radius, st.n_fluid
    # The block moved 0.1 toward the floor and two walls (0.05 from them),
    # so that its outer layers have boundary pairs.
    pos = (jsc.fluid_pos0.to_numpy() - np.array([0.1, 0.1, 0.1])
           + rng.uniform(-0.1 * r, 0.1 * r, (n, 3))).astype(np.float32)
    dp = jbase.build_dense_prep(st, jsc.arrays, V3.from_rows(pos),
                                st.band_nb_wide, st.band_B)
    assert int(dp.overflow) == 0 and int(dp.bwin.overflow) == 0
    scid, perm, pos_s, _ = base.sort_by_cells(sc.grid, torch.from_numpy(pos))
    np.testing.assert_array_equal(perm.numpy(), np.asarray(dp.perm))
    starts = nb.csr_starts(scid, sc.grid.num_cells)
    shift = rng.standard_normal((n, 3)).astype(np.float32) * np.float32(
        0.3 * r / np.sqrt(3.0))
    pos_p = (pos_s.numpy() + shift).astype(np.float32)

    # Pairs cross r = h both ways between the start and predicted positions.
    d0 = pos_s.numpy()[:, None] - pos_s.numpy()[None]
    d1 = pos_p[:, None] - pos_p[None]
    h2 = np.float32(st.h) ** 2
    valid = ((d0 ** 2).sum(-1) <= h2) & ~np.eye(n, dtype=bool)
    near = ((d1 ** 2).sum(-1) <= h2) & ~np.eye(n, dtype=bool)
    assert (valid & ~near).sum() > 0 and (near & ~valid).sum() > 0

    want = np.asarray(
        bandmat.predicted_rho_op(dp.pos, h=st.h, m=st.particle_m,
                                 plan=dp.plan, B=st.band_B)(
            V3.from_rows(pos_p)))
    want_b = np.asarray(bandmat.boundary_predict_op(
        dp.bwin, dp.pos, h=st.h, rho0=1000.0, B=st.band_B)(
            V3.from_rows(pos_p)))
    assert (want_b > 0).sum() > 20
    stencil.reset_counts()
    args = (pos_s, starts, sc.grid, sc.h, sc.particle_m,
            torch.from_numpy(pos_p))
    fluid = stencil.pcisph_predict_rho(*args)
    both = stencil.pcisph_predict_rho(*args, base.walls(sc), 1000.0)
    assert stencil.KERNELS["pcisph_predict_rho"].plain_calls == 2
    for got, ref in ((fluid, want), (both, want + want_b)):
        np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                                   atol=1e-5 * float(np.abs(ref).max()))


# ---------------------------------------------------------------------------
# The solver
# ---------------------------------------------------------------------------

def test_stiffness_matches_jax_init_state(jax_runs):
    sim = _port_sim()
    (delta,) = sim.state.extra
    assert delta.shape == () and delta.dtype == torch.float32
    np.testing.assert_allclose(float(delta), jax_runs["walls"]["delta"],
                               rtol=1e-6)
    # The densest particle is not alone on the lattice: the first of the
    # tied ones in cell-sorted order is taken, as jnp.argmax takes it.
    sc = sim.scene
    scid, _, pos, _ = base.sort_by_cells(sc.grid, sc.fluid_pos0)
    count = stencil.fluid_terms(pos, nb.csr_starts(scid, sc.grid.num_cells),
                                sc.grid, sc.h, sc.particle_m).count
    assert int((count == count.max()).sum()) > 1


@pytest.mark.parametrize("engine", ["recompute", "coef"])
@pytest.mark.parametrize("scene", ["walls", "clamp"])
def test_pcisph_steps_match_jax(scene, engine, jax_runs, monkeypatch):
    run = jax_runs[scene]
    iters = [int(s["diag"][0]) for s in run["snaps"]]
    assert iters[0] >= 2, iters      # the first step's loop iterates
    if engine == "coef":
        monkeypatch.setattr(dfsph, "COEF_BYTE_BUDGET", 12e9)
    sim = _port_sim(scene)
    assert sim.scene.akinci == (scene == "walls")
    sim.state = io.state_from_numpy(run["leaves"], device="cpu")
    stencil.reset_counts()
    for k, snap in enumerate(run["snaps"], start=1):
        sim.step()
        assert snap["overflow"] == 0
        got = _by_oid(sim.state.fluid.pos.numpy(), sim.state.fluid.oid)
        np.testing.assert_allclose(got, snap["pos"], atol=5e-6,
                                   err_msg=f"step {k}")
        diag = sim.state.diag.numpy()
        assert diag[0] == snap["diag"][0], (k, diag, snap["diag"])
        if engine == "recompute":
            assert abs(diag[1] - snap["diag"][1]) <= RHO_ULP, (
                k, diag, snap["diag"])
        assert diag[1] <= 1.0
    k = stencil.KERNELS
    assert k["pcisph_predict_rho"].plain_calls == sum(iters) + STEPS
    assert k["viscosity"].plain_calls == STEPS
    mv = "matvec" if engine == "recompute" else "coef_matvec"
    assert k[mv].plain_calls == sum(iters)
    assert k["coef_build"].plain_calls == (STEPS if engine == "coef" else 0)
    assert k["matvec_dot"].plain_calls == k["coef_matvec_dot"].plain_calls \
        == k["wcsph_forces"].plain_calls == k["pbf_terms"].plain_calls == 0
    assert sim.telemetry()["nan_particles"] == 0


def test_checkpoints_with_delta_cross_between_packages(tmp_path, jax_runs):
    """PCISPH's state has one extra leaf, the stiffness delta (31 leaves):
    a port checkpoint loads into the JAX package and back, and a JAX one
    into the port."""
    sim = _port_sim()
    sim.step()
    path = str(tmp_path / "port.npz")
    io.save_checkpoint(path, sim.state, meta={"frame": 1})
    like = jpcisph.init_state(jscene.build_scene(jparse_config(
        _tiny("walls"))))
    jstate = jio.load_checkpoint(path, like)
    port = io.state_to_numpy(sim.state)
    assert len(port) == io.BASE_LEAVES + 1 and port[io._EXTRA].shape == ()
    for a, b in zip(_leaves(jstate), port, strict=True):
        np.testing.assert_array_equal(a, b)
    back = io.load_checkpoint(path, device="cpu")
    for a, b in zip(io.state_to_numpy(back), port, strict=True):
        np.testing.assert_array_equal(a, b)

    jleaves = jax_runs["walls"]["snaps"][-1]["leaves"]
    jpath = str(tmp_path / "jax.npz")
    np.savez(jpath, **{f"leaf_{i}": a for i, a in enumerate(jleaves)})
    carried = io.load_checkpoint(jpath, device="cpu")
    for a, b in zip(io.state_to_numpy(carried), jleaves, strict=True):
        np.testing.assert_array_equal(a, b)
    sim.state = carried
    sim.step()
    assert float(sim.state.extra[0]) == float(jleaves[io._EXTRA])


# ---------------------------------------------------------------------------
# Behaviour: tests/test_solvers.py:38-62, the CLI
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("scene", ["walls", "clamp"])
def test_pcisph_runs_stable_and_keeps_its_residual(scene):
    sim = _port_sim(scene)
    for _ in range(25):
        sim.step()
        it, res = sim.state.diag.tolist()[:2]
        assert 1 <= it <= pcisph.MAX_ITER
        assert res <= 1.0 or it == pcisph.MAX_ITER, (it, res)
    stats = sim.telemetry()
    assert stats["nan_particles"] == 0
    pos = sim.state.fluid.pos.numpy()
    assert np.all(pos >= -0.05) and np.all(pos <= 0.85)
    assert 100.0 < stats["rho_avg"] < 1500.0
    assert stats["avg_pos_err"] < 50.0


def test_pcisph_basic_runs_from_the_cli(tmp_path):
    assert models.get_solver("pcisph") is pcisph
    out = tmp_path / "out"
    done = subprocess.run(
        [sys.executable, "-m", "cfd_taichi_tpu_torch.runner", "--config",
         str(ROOT / "configs" / "pcisph_basic.json"), "--frames", "1",
         "--device", "cpu", "--output-dir", str(out), "--checkpoint-every",
         "1"], check=True, capture_output=True, text=True, timeout=300,
        cwd=ROOT)
    assert "[Solver]: pcisph" in done.stdout
    tele = json.loads(done.stdout.split("Final telemetry:")[1].splitlines()[0])
    assert tele["nan_particles"] == 0 and tele["steps"] == 1
    state = io.load_checkpoint(str(out / "ckpt_000001.npz"), device="cpu")
    assert state.fluid.pos.shape == (5880, 3) and state.extra[0].shape == ()
