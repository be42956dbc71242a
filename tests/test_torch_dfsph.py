"""The port's DFSPH slice held against the JAX package on the TINY scene of
tests/test_solvers.py:14-23 (216 fluid particles, Akinci walls), both on
the CPU: scene build, the step (positions through `oid`, dt, iteration
counts), a JAX state carried into the port, checkpoints and the runner.

The JAX loop coefficients are stored in bf16 by default
(cfd_taichi_tpu/models/dfsph.py:119); the port computes in f32, so the
reference run sets `BAND_DTYPE` to f32 as tests/test_solvers.py:251-256
does for its own engine comparisons. Tolerances are the repo's own
engine-equivalence bar (tests/test_solvers.py:263-271): positions to atol
5e-6, dt to rtol 1e-5, iteration counts exact.

The JAX reference runs its band engine on TINY, so the port is pinned to
its recompute engine (coef budget 0), as JAX's own tests pin engines
(tests/test_bandmat.py:280-291); tests/test_torch_coef.py holds the port's
stored-coefficient engine against the JAX coef engine.
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

import cfd_taichi_tpu.models.dfsph as jdfsph
from cfd_taichi_tpu import scene as jscene
from cfd_taichi_tpu.config import parse_config as jparse_config
from cfd_taichi_tpu.runner import Simulation as JaxSimulation
from cfd_taichi_tpu.utils import io as jio
from cfd_taichi_tpu_torch import Simulation, build_scene, read_config
from cfd_taichi_tpu_torch.config import parse_config
from cfd_taichi_tpu_torch import models
from cfd_taichi_tpu_torch.models import dfsph as pdfsph
from cfd_taichi_tpu_torch.utils import io

TINY = {
    "scene": {"box_min": [0.0, 0.0, 0.0], "box_max": [0.6, 0.8, 0.6],
              "particle_radius": 0.025, "gravity": 9.8},
    "solver": {"name": "dfsph", "delta_time": 4e-4, "iter_cnt": 1},
    "fluid": {"start_pos": [0.15, 0.1, 0.15], "water_size": [0.3, 0.3, 0.3]},
}
ROOT = Path(__file__).resolve().parents[1]
STEPS = 6
CARRY_AT = 20


@pytest.fixture(autouse=True)
def recompute_engine(monkeypatch):
    monkeypatch.setattr(pdfsph, "COEF_BYTE_BUDGET", 0)


def _pos_by_oid(pos, oid):
    pos, oid = np.asarray(pos), np.asarray(oid)
    return pos[np.argsort(oid)]


def _jax_snapshot(sim):
    s = sim.state
    return dict(pos=_pos_by_oid(s.fluid.pos.to_numpy(), s.fluid.oid),
                dt=float(s.dt), diag=np.asarray(s.diag).copy(),
                leaves=[np.asarray(a) for a in
                        jax.tree_util.tree_flatten(s)[0]])


def _tiny(scene):
    """TINY with Akinci walls ("walls") or the clamp boundary ("clamp")."""
    raw = copy.deepcopy(TINY)
    raw["solver"]["boundary_handle"] = scene == "walls"
    return raw


def _run_jax(raw, last):
    """JAX reference with f32 loop coefficients: a snapshot after each of
    the first STEPS steps and from CARRY_AT on, up to step `last`."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jdfsph, "BAND_DTYPE", jnp.float32)
        # The dtype is read at trace time: drop traces made with bf16, and
        # (after the context) the f32 ones, so no other test reuses them.
        jax.clear_caches()
        sim = JaxSimulation(jparse_config(raw))
        snaps = {}
        for k in range(1, last + 1):
            sim.step()
            if k <= STEPS or k >= CARRY_AT:
                snaps[k] = _jax_snapshot(sim)
    jax.clear_caches()
    return snaps


@pytest.fixture(scope="module")
def jax_run():
    return _run_jax(_tiny("walls"), CARRY_AT + 1)


@pytest.fixture(scope="module")
def jax_clamp_run():
    return _run_jax(_tiny("clamp"), STEPS)


def _port_sim(scene="walls"):
    return Simulation(parse_config(_tiny(scene)), device="cpu")


def _assert_step_matches(state, snap):
    got = _pos_by_oid(state.fluid.pos.numpy(), state.fluid.oid.numpy())
    print(f"parity dfsph step {int(state.step_count)}: pos err "
          f"{np.abs(got - snap['pos']).max():.3e}")
    np.testing.assert_allclose(got, snap["pos"], atol=5e-6)
    np.testing.assert_allclose(float(state.dt), snap["dt"], rtol=1e-5)
    diag = state.diag.numpy()
    assert (diag[0], diag[2]) == (snap["diag"][0], snap["diag"][2])


@pytest.mark.parametrize("scene", ["walls", "clamp"])
def test_dfsph_steps_match_jax(scene, request):
    snaps = request.getfixturevalue(
        "jax_run" if scene == "walls" else "jax_clamp_run")
    sim = _port_sim(scene)
    assert sim.scene.akinci == (scene == "walls")
    for k in range(1, STEPS + 1):
        sim.step()
        _assert_step_matches(sim.state, snaps[k])
    assert int(sim.state.overflow) == 0
    assert sim.telemetry()["nan_particles"] == 0


def test_dfsph_step_from_carried_jax_state(jax_run):
    sim = _port_sim()
    sim.state = io.state_from_numpy(jax_run[CARRY_AT]["leaves"],
                                     device="cpu")
    np.testing.assert_allclose(float(sim.state.t),
                               float(jax_run[CARRY_AT]["leaves"][26]))
    sim.step()
    _assert_step_matches(sim.state, jax_run[CARRY_AT + 1])


def test_scene_matches_jax_scene():
    jsc = jscene.build_scene(jparse_config(copy.deepcopy(TINY)))
    sc = build_scene(parse_config(copy.deepcopy(TINY)), device="cpu")
    order = np.asarray(jsc.arrays.boundary_table.order)
    np.testing.assert_array_equal(sc.boundary_pos.numpy(),
                                  jsc.arrays.boundary_pos.to_numpy()[order])
    np.testing.assert_allclose(sc.boundary_volume.numpy(),
                               np.asarray(jsc.arrays.boundary_volume)[order],
                               rtol=1e-6)
    np.testing.assert_array_equal(sc.boundary_starts.numpy(),
                                  np.asarray(jsc.arrays.boundary_table.starts))
    np.testing.assert_array_equal(sc.fluid_pos0.numpy(),
                                  jsc.fluid_pos0.to_numpy())
    st = jsc.static
    assert (sc.n_fluid, sc.n_boundary, sc.grid) == (
        st.n_fluid, st.n_boundary, tuple(st.grid))
    assert (sc.h, sc.particle_m) == (st.h, st.particle_m)


def test_missing_config_exits_3(tmp_path):
    with pytest.raises(SystemExit) as exc:
        read_config(str(tmp_path / "missing.json"))
    assert exc.value.code == 3


def test_unported_parts_raise_with_roadmap_pointer():
    for name in ("dfsph", "wcsph", "iisph", "pcisph", "pbf"):
        assert models.get_solver(name).__name__ == \
            f"cfd_taichi_tpu_torch.models.{name}"
    with pytest.raises(ValueError, match="Unknown solver"):
        models.get_solver("nope")
    # Every solver now takes an active rigid body: none refuses one
    raw = copy.deepcopy(TINY)
    raw["solid"] = {"mesh": "builtin:cube", "scale": 0.2, "active": True}
    scene = build_scene(parse_config(raw), device="cpu")
    assert scene.coupled
    for name in ("dfsph", "wcsph", "iisph", "pcisph", "pbf"):
        state = models.get_solver(name).init_state(scene)
        assert state.rigid.pos.shape == (scene.n_rigid, 3), name


def test_checkpoints_cross_between_packages(tmp_path, jax_run):
    """A port checkpoint loads into the JAX package and back, leaf for
    leaf; a JAX checkpoint loads into the port."""
    sim = _port_sim()
    sim.step()
    path = str(tmp_path / "port.npz")
    io.save_checkpoint(path, sim.state, meta={"frame": 1})
    jsim_like = jdfsph.init_state(
        jscene.build_scene(jparse_config(copy.deepcopy(TINY))))
    jstate = jio.load_checkpoint(path, jsim_like)
    for a, b in zip(jax.tree_util.tree_flatten(jstate)[0],
                    io.state_to_numpy(sim.state)):
        np.testing.assert_array_equal(np.asarray(a), b)
    back = io.load_checkpoint(path, device="cpu")
    for a, b in zip(io.state_to_numpy(back), io.state_to_numpy(sim.state)):
        np.testing.assert_array_equal(a, b)

    jpath = str(tmp_path / "jax.npz")
    np.savez(jpath, **{f"leaf_{i}": a for i, a in
                       enumerate(jax_run[CARRY_AT]["leaves"])})
    carried = io.load_checkpoint(jpath, device="cpu")
    for a, b in zip(io.state_to_numpy(carried), jax_run[CARRY_AT]["leaves"]):
        np.testing.assert_array_equal(a, b)


def test_runner_cli_checkpoint_and_resume(tmp_path):
    cfg = tmp_path / "tiny.json"
    cfg.write_text(json.dumps(TINY))
    out = tmp_path / "out"
    cmd = [sys.executable, "-m", "cfd_taichi_tpu_torch.runner",
           "--config", str(cfg), "--frames", "2", "--device", "cpu",
           "--output-dir", str(out), "--checkpoint-every", "2"]
    subprocess.run(cmd, check=True, capture_output=True, timeout=120,
                   cwd=ROOT)
    ckpt = out / "ckpt_000002.npz"
    assert ckpt.exists()
    state = io.load_checkpoint(str(ckpt), device="cpu")
    assert int(state.step_count) == 2
    done = subprocess.run(cmd[:-2] + ["--resume", str(ckpt)], check=True,
                          capture_output=True, text=True, timeout=120,
                          cwd=ROOT)
    tele = json.loads(done.stdout.split("Final telemetry:")[1].splitlines()[0])
    assert tele["nan_particles"] == 0 and tele["steps"] == 2
    assert tele["t"] > float(state.t)


def test_density_matches_jax_density():
    jsim = JaxSimulation(jparse_config(copy.deepcopy(TINY)))
    sim = _port_sim()
    np.testing.assert_allclose(sim.density().numpy(),
                               np.asarray(jsim.density()), rtol=1e-5)
