"""The port's IISPH (cfd_taichi_tpu_torch/models/iisph.py) held against the
JAX package on the TINY scene of tests/test_solvers.py:14-23 (216 fluid
particles), both on the CPU:

* steps: 6 from a compressed state (TINY's seeded block scaled by 0.85
  about its centre, which puts the block's interior above rho0, so the
  pressure solve iterates), with Akinci walls and with the clamp
  boundary: positions through `oid` and the iteration count of every
  step; and one step from a carried JAX state whose p_past is not zero;
* the Jacobi loop on the synthetic system of tests/test_solvers.py:
  328-417, whose gain sets the spectral radius: 0.55 converges, 2.5 must
  fire the break on a rising residual;
* the port's stored-coefficient engine against JAX's coef engine
  (`BAND_BYTE_BUDGET = 0`), as tests/test_torch_coef.py does for DFSPH;
* checkpoints with the p_past leaf across packages, and the registry.

The JAX reference runs with f32 loop coefficients (`BAND_DTYPE`), as
tests/test_torch_dfsph.py does, and the port on its recompute engine
(coef budget 0) unless the test says otherwise. Tolerances: positions to
atol 5e-6, iteration counts exact (tests/test_solvers.py:263-271); the
synthetic loop's p and residual to rtol 1e-6 (tests/test_solvers.py:
414-415).
"""

import copy
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cfd_taichi_tpu.models.dfsph as jdfsph
import cfd_taichi_tpu.models.iisph as jiisph
from cfd_taichi_tpu import scene as jscene
from cfd_taichi_tpu.config import parse_config as jparse_config
from cfd_taichi_tpu.ops.vec import V3
from cfd_taichi_tpu.runner import Simulation as JaxSimulation
from cfd_taichi_tpu.utils import io as jio
from cfd_taichi_tpu_torch import Simulation, models, read_config
from cfd_taichi_tpu_torch.config import parse_config
from cfd_taichi_tpu_torch.models import dfsph, iisph
from cfd_taichi_tpu_torch.ops import stencil
from cfd_taichi_tpu_torch.utils import io

TINY = {
    "scene": {"box_min": [0.0, 0.0, 0.0], "box_max": [0.6, 0.8, 0.6],
              "particle_radius": 0.025, "gravity": 9.8},
    "solver": {"name": "iisph", "delta_time": 4e-4, "iter_cnt": 1},
    "fluid": {"start_pos": [0.15, 0.1, 0.15], "water_size": [0.3, 0.3, 0.3]},
}
ROOT = Path(__file__).resolve().parents[1]
STEPS = 6
SQUEEZE = 0.85


@pytest.fixture(autouse=True)
def recompute_engine(monkeypatch):
    monkeypatch.setattr(dfsph, "COEF_BYTE_BUDGET", 0)


def _tiny(scene):
    raw = copy.deepcopy(TINY)
    raw["solver"]["boundary_handle"] = scene == "walls"
    return raw


def _pos_by_oid(pos, oid):
    pos, oid = np.asarray(pos), np.asarray(oid)
    return pos[np.argsort(oid)]


def _leaves(state):
    return [np.asarray(a) for a in jax.tree_util.tree_flatten(state)[0]]


def run_jax(raw, band_budget=None):
    """JAX steps from the compressed state, f32 loop coefficients (and the
    coef engine with `band_budget` 0): the start leaves and a snapshot
    after each step."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jdfsph, "BAND_DTYPE", jnp.float32)
        if band_budget is not None:
            mp.setattr(jdfsph, "BAND_BYTE_BUDGET", band_budget)
        # Both are read at trace time: drop the traces made before, and
        # (after the context) these, so no other test reuses them.
        jax.clear_caches()
        leaves = _leaves(JaxSimulation(jparse_config(raw)).state)
        pos = np.stack(leaves[:3], axis=-1)
        mid = (pos.min(axis=0) + pos.max(axis=0)) / 2
        pos = (mid + SQUEEZE * (pos - mid)).astype(np.float32)
        leaves[:3] = [np.ascontiguousarray(pos[:, c]) for c in range(3)]
        sim = JaxSimulation(jparse_config(raw), plan_pos=pos)
        st = sim.scene.static
        assert jdfsph.use_band_engine(st.n_fluid, st.band_nb) == (
            band_budget is None)
        sim.state = jax.tree_util.tree_unflatten(
            jax.tree_util.tree_structure(sim.state),
            [jnp.asarray(a) for a in leaves])
        snaps = []
        for _ in range(STEPS):
            sim.step()
            s = sim.state
            snaps.append(dict(
                pos=_pos_by_oid(s.fluid.pos.to_numpy(), s.fluid.oid),
                diag=np.asarray(s.diag).copy(), overflow=int(s.overflow),
                leaves=_leaves(s)))
    jax.clear_caches()
    return dict(leaves=leaves, snaps=snaps)


@pytest.fixture(scope="module")
def jax_runs():
    return {scene: run_jax(_tiny(scene)) for scene in ("walls", "clamp")}


def _port_sim(scene="walls"):
    return Simulation(parse_config(_tiny(scene)), device="cpu")


def _assert_step_matches(state, snap, tag):
    assert snap["overflow"] == 0
    got = _pos_by_oid(state.fluid.pos.numpy(), state.fluid.oid.numpy())
    print(f"parity iisph {tag}: pos err "
          f"{np.abs(got - snap['pos']).max():.3e}")
    np.testing.assert_allclose(got, snap["pos"], atol=5e-6, err_msg=tag)
    assert state.diag.numpy()[0] == snap["diag"][0], tag


def _run_port(sim, leaves, snaps):
    sim.state = io.state_from_numpy(leaves, device="cpu")
    for k, snap in enumerate(snaps, start=1):
        sim.step()
        _assert_step_matches(sim.state, snap, f"step {k}")


@pytest.mark.parametrize("scene", ["walls", "clamp"])
def test_iisph_steps_match_jax(scene, jax_runs):
    run = jax_runs[scene]
    iters = [float(s["diag"][0]) for s in run["snaps"]]
    # The first step's solve iterates and leaves a pressure: the block's
    # interior is pushed apart within two steps, so later solves stop
    # after their one iteration on a residual of 0.
    assert iters[0] >= 2, iters
    assert float(run["snaps"][0]["leaves"][io._EXTRA].max()) > 1e4
    sim = _port_sim(scene)
    assert sim.scene.akinci == (scene == "walls")
    stencil.reset_counts()
    _run_port(sim, run["leaves"], run["snaps"])
    k = stencil.KERNELS
    assert k["matvec"].plain_calls == sum(iters)
    assert k["matvec_dot"].plain_calls == STEPS + 2 * sum(iters)
    assert k["viscosity"].plain_calls == STEPS
    assert k["coef_build"].plain_calls == k["wcsph_forces"].plain_calls == 0
    assert sim.telemetry()["nan_particles"] == 0


def test_iisph_step_from_carried_jax_state(jax_runs):
    """One step from a JAX state whose p_past (the warm start) is not 0:
    step 2 from the state after step 1."""
    snaps = jax_runs["walls"]["snaps"]
    leaves = snaps[0]["leaves"]
    p_past = leaves[io._EXTRA]
    assert p_past.shape == (216,) and float(p_past.max()) > 0.0
    sim = _port_sim()
    sim.state = io.state_from_numpy(leaves, device="cpu")
    np.testing.assert_array_equal(sim.state.extra[0].numpy(), p_past)
    sim.step()
    _assert_step_matches(sim.state, snaps[1], "carried")
    assert float(sim.state.extra[0].max()) > 0.0


def test_iisph_coef_steps_match_jax_coef_engine(monkeypatch):
    """The port's stored-coefficient engine (f32) against JAX's coef
    engine, from the compressed state with walls."""
    run = run_jax(_tiny("walls"), band_budget=0)
    monkeypatch.setattr(dfsph, "COEF_BYTE_BUDGET", 12e9)
    sim = _port_sim()
    stencil.reset_counts()
    _run_port(sim, run["leaves"], run["snaps"])
    k = stencil.KERNELS
    assert k["coef_build"].plain_calls == STEPS
    assert k["coef_matvec"].plain_calls > 0
    assert k["matvec"].plain_calls == k["matvec_dot"].plain_calls == 0


# ---------------------------------------------------------------------------
# The Jacobi loop on a synthetic system
# ---------------------------------------------------------------------------

def _synthetic_ops(gain, xp):
    """tests/test_solvers.py:328-351 in numpy-like `xp` (jnp or torch):
    `gain` sets the spectral radius of the fixed-point map."""
    if xp is jnp:
        def d_ij_of(p):
            return V3(0.001 * p, -0.0005 * p, 0.0 * p)

        def first(d):
            return d.x
    else:
        def d_ij_of(p):
            return torch.stack([0.001 * p, -0.0005 * p, 0.0 * p], dim=1)

        def first(d):
            return d[:, 0]

    def r_sum_of(p, d_ij):
        mix = 0.5 * p + 0.25 * xp.roll(p, 1) + 0.25 * xp.roll(p, -1)
        return gain * mix + 100.0 * first(d_ij)

    def residual_of(p, r_sum):
        sel = p > 0.0
        num = xp.where(sel, -p + r_sum + 1.5, xp.zeros_like(p)).sum()
        cnt = sel.sum()
        return xp.where(cnt > 0, num / cnt, xp.zeros_like(num))

    return d_ij_of, r_sum_of, residual_of


@pytest.mark.parametrize("gain,breaks", [(0.55, False), (2.5, True)])
def test_jacobi_loop_matches_jax(gain, breaks):
    n = 64
    rng = np.random.default_rng(7)
    p0 = rng.uniform(0.5, 2.0, n).astype(np.float32)
    a_ii = np.full((n,), -1.0, np.float32)
    rho_adv = (iisph.RHO_0 + 1.0 + rng.uniform(0, 0.5, n)).astype(np.float32)
    p_j, _, _, res_j, it_j = jiisph.jacobi_loop(
        *_synthetic_ops(gain, jnp), jnp.asarray(p0), jnp.asarray(a_ii),
        jnp.asarray(rho_adv))
    p, d_ij, r_sum, res, it = iisph.jacobi_loop(
        *_synthetic_ops(gain, torch), torch.from_numpy(p0),
        torch.from_numpy(a_ii), torch.from_numpy(rho_adv))
    assert it == int(it_j)
    assert res.dtype == torch.float32 and res.shape == ()
    np.testing.assert_allclose(res, float(res_j), rtol=1e-6)
    np.testing.assert_allclose(p.numpy(), np.asarray(p_j), rtol=1e-6)
    assert d_ij.shape == (n, 3) and r_sum.shape == (n,)
    # The break fires on a rising residual, which leaves the loop above
    # its 0.1 % contract before the iteration cap; convergence ends below.
    assert (res > 1.0 and it < iisph.MAX_ITER) == breaks
    assert (res <= 1.0) == (not breaks)


# ---------------------------------------------------------------------------
# Checkpoints, registry and a real config
# ---------------------------------------------------------------------------

def test_checkpoints_with_p_past_cross_between_packages(tmp_path, jax_runs):
    """IISPH's state has one extra leaf, p_past (31 leaves): a port
    checkpoint loads into the JAX package and back, and a JAX one into
    the port."""
    sim = _port_sim()
    sim.state = io.state_from_numpy(jax_runs["walls"]["leaves"],
                                    device="cpu")
    sim.step()
    assert float(sim.state.extra[0].max()) > 0.0
    path = str(tmp_path / "port.npz")
    io.save_checkpoint(path, sim.state, meta={"frame": 1})
    like = jiisph.init_state(jscene.build_scene(jparse_config(_tiny("walls"))))
    jstate = jio.load_checkpoint(path, like)
    for a, b in zip(_leaves(jstate), io.state_to_numpy(sim.state),
                    strict=True):
        np.testing.assert_array_equal(a, b)
    back = io.load_checkpoint(path, device="cpu")
    for a, b in zip(io.state_to_numpy(back), io.state_to_numpy(sim.state),
                    strict=True):
        np.testing.assert_array_equal(a, b)

    jleaves = jax_runs["walls"]["snaps"][-1]["leaves"]
    assert len(jleaves) == io.BASE_LEAVES + 1
    jpath = str(tmp_path / "jax.npz")
    np.savez(jpath, **{f"leaf_{i}": a for i, a in enumerate(jleaves)})
    carried = io.load_checkpoint(jpath, device="cpu")
    for a, b in zip(io.state_to_numpy(carried), jleaves, strict=True):
        np.testing.assert_array_equal(a, b)


def test_breaking_dam_30k_config_steps_its_own_solver_on_the_cpu():
    """configs/breaking_dam_30k.json names IISPH: the registry resolves it,
    and the scene (29,120 fluid particles, Akinci walls) takes a step."""
    cfg = read_config(str(ROOT / "configs" / "breaking_dam_30k.json"))
    assert cfg.solver.name == "iisph"
    assert models.get_solver("iisph") is iisph
    sim = Simulation(cfg, device="cpu")
    assert sim.solver is iisph and sim.scene.n_fluid == 29_120
    sim.step()
    f = sim.state.fluid
    assert bool(torch.isfinite(f.pos).all()) and bool(torch.isfinite(f.vel)
                                                      .all())
    assert 1 <= float(sim.state.diag[0]) <= iisph.MAX_ITER
    assert float(f.pos[:, 1].mean()) < float(
        sim.scene.fluid_pos0[:, 1].mean())
