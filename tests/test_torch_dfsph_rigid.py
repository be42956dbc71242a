"""The port's coupled DFSPH step (cfd_taichi_tpu_torch/models/dfsph.py with
ops/rigid.py and models/rigid.py) held against the JAX package's dense
coupled path on the CPU, on the coupled scene of tests/test_rigid.py:12-21
(RIGID_CFG: 720 fluid particles, a 24-voxel box body) run as DFSPH with the
body at [0.4, 0.28, 0.4], in the water.

The two regimes of tests/test_rigid.py:139-210, with a rigid step after
each fluid step and the body's force sampled before it:

* squeeze 0.97, 4 steps: pressure dormant, the solid density, viscosity
  and contact terms live. Positions through oid to atol 5e-6, equal
  divergence and density iteration counts every step, the centroid to
  atol 1e-5: JAX's own dense-against-compact contract there;
* squeeze 0.85, 1 step: pressure acts and the reaction force transfers.
  JAX's own contract is max |F| to rtol 2e-2 and positions to 2e-3, with
  equal iteration counts; the port is held to about ten times what it
  measured against JAX on the CPU (printed), which is far inside it.

The JAX reference runs with f32 loop coefficients (`BAND_DTYPE`), as
tests/test_torch_dfsph.py does, and the port on its recompute engine
(coef budget 0). Also: the coupling switches (one-way coupling, an
inactive body), checkpoints with a body across packages, the CLI on
configs/torus_flush.json, and a coupled run's stability; every solver
steps an active body and an inactive one.

The JAX runs and the port's runs here serve the coupled PCISPH, IISPH and
WCSPH tests too (tests/test_torch_{pcisph,iisph,wcsph}_rigid.py).
"""

import copy
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
import cfd_taichi_tpu.models.wcsph as jwcsph
from cfd_taichi_tpu import scene as jscene
from cfd_taichi_tpu.config import parse_config as jparse_config
from cfd_taichi_tpu.runner import Simulation as JaxSimulation
from cfd_taichi_tpu.utils import io as jio
from cfd_taichi_tpu_torch import Simulation
from cfd_taichi_tpu_torch.config import parse_config
from cfd_taichi_tpu_torch.models import dfsph
from cfd_taichi_tpu_torch.ops import stencil
from cfd_taichi_tpu_torch.utils import io

ROOT = Path(__file__).resolve().parents[1]
RIGID_CFG = {
    "scene": {"box_min": [0, 0, 0], "box_max": [0.8, 1.0, 0.8],
              "particle_radius": 0.025, "gravity": 9.8},
    "solver": {"name": "dfsph", "delta_time": 4e-4, "iter_cnt": 1,
               "boundary_handle": True, "fs_couple": True},
    "fluid": {"start_pos": [0.1, 0.05, 0.1], "water_size": [0.6, 0.25, 0.6]},
    "solid": {"mesh": "builtin:cube1", "voxel_radius": 0.025,
              "rho_0": 500, "scale": 0.18, "pos_offset": [0.4, 0.28, 0.4],
              "attitude_offset": [0.0, 0.0, 0.0], "fill": True,
              "active": True},
}
# (squeeze, steps) of the two regimes
REGIMES = {"dormant": (0.97, 4), "pressure": (0.85, 1)}
# The port against JAX in the pressure regime, about ten times the errors
# measured (printed by the test): JAX's own contract is 2e-2 and 2e-3.
PRESSURE_FORCE_RTOL = 1e-5
PRESSURE_POS_ATOL = 6e-7
# The module whose dense_eligible says that JAX takes its dense step
# (tests/test_rigid.py:152).
DENSE_GATE = {"dfsph": jdfsph, "iisph": jdfsph, "pcisph": jpcisph,
              "wcsph": jwcsph}
SOLVERS = ("dfsph", "wcsph", "iisph", "pcisph", "pbf")
RIGID_KERNELS = ("rigid_terms", "rigid_contact_dot", "rigid_viscosity",
                 "rigid_side_force", "rigid_side_rows", "rigid_side_list",
                 "rigid_side_force_list", "pcisph_predict_rho_rigid")


@pytest.fixture(autouse=True)
def recompute_engine(monkeypatch):
    monkeypatch.setattr(dfsph, "COEF_BYTE_BUDGET", 0)


@pytest.fixture(autouse=True)
def one_thread():
    """The port's scenes here hold a few hundred particles, which torch's
    thread pool does not speed up; in a suite run in several processes
    its threads only contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def rigid_cfg(**overrides):
    raw = copy.deepcopy(RIGID_CFG)
    for path, value in overrides.items():
        section, key = path.split(".")
        raw[section][key] = value
    return raw


def _leaves(state):
    return [np.asarray(a) for a in jax.tree_util.tree_flatten(state)[0]]


def _pos_by_oid(pos, oid):
    pos, oid = np.asarray(pos), np.asarray(oid)
    return pos[np.argsort(oid)]


def run_jax(raw, squeeze, steps):
    """JAX's dense coupled step of `raw`'s solver from RIGID_CFG's block
    squeezed about its mean as tests/test_rigid.py:181-184 does: the start
    leaves, and after each step the fluid by oid, diag, the body's largest
    force component (before the rigid step) and the centroid (after
    it)."""
    sim = JaxSimulation(jparse_config(raw))
    st = sim.scene.static
    assert DENSE_GATE[raw["solver"]["name"]].dense_eligible(st)
    assert st.rq_cap > 0
    f = sim.state.fluid
    center = f.pos.mean(axis=0)
    sim.state = sim.state._replace(
        fluid=f._replace(pos=center + (f.pos - center) * squeeze))
    out = dict(leaves=_leaves(sim.state), snaps=[])
    for _ in range(steps):
        sim.step()
        s = sim.state
        snap = dict(pos=_pos_by_oid(s.fluid.pos.to_numpy(), s.fluid.oid),
                    diag=np.asarray(s.diag).copy(),
                    fmax=float(np.abs(s.rigid.force.to_numpy()).max()),
                    overflow=int(s.overflow), leaves=_leaves(s))
        sim.rigid_step()
        snap["centroid"] = np.asarray(sim.state.rigid.centroid).copy()
        out["snaps"].append(snap)
    return out


def jax_regimes(solver):
    """JAX's runs of both regimes as `solver`, with f32 loop
    coefficients."""
    raw = rigid_cfg(**{"solver.name": solver})
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jdfsph, "BAND_DTYPE", jnp.float32)
        # Read at trace time: drop the traces made before, and (after the
        # context) these, so no other test reuses them.
        jax.clear_caches()
        runs = {name: run_jax(raw, *REGIMES[name]) for name in REGIMES}
    jax.clear_caches()
    return runs


@pytest.fixture(scope="module")
def jax_runs():
    return jax_regimes("dfsph")


def run_port(leaves, steps, raw=None):
    """The port from JAX's start leaves: per step the state (before the
    rigid step), the body's largest force component and the centroid."""
    sim = Simulation(parse_config(raw or rigid_cfg()), device="cpu")
    sim.state = io.state_from_numpy(leaves, device="cpu")
    out = []
    for _ in range(steps):
        sim.step()
        state = sim.state
        fmax = float(state.rigid.force.abs().max())
        sim.rigid_step()
        out.append(dict(state=state, fmax=fmax,
                        centroid=sim.state.rigid.centroid.numpy().copy()))
    return sim, out


def _pos_err(state, snap):
    got = _pos_by_oid(state.fluid.pos.numpy(), state.fluid.oid.numpy())
    return float(np.abs(got - snap["pos"]).max())


def _counts(diag):
    return (float(diag[0]), float(diag[2]))


def test_coupled_steps_match_jax_pressure_dormant(jax_runs):
    run = jax_runs["dormant"]
    stencil.reset_counts()
    _, got = run_port(run["leaves"], len(run["snaps"]))
    for k, (g, snap) in enumerate(zip(got, run["snaps"]), start=1):
        assert snap["overflow"] == 0
        err = _pos_err(g["state"], snap)
        cerr = float(np.abs(g["centroid"] - snap["centroid"]).max())
        print(f"dormant step {k}: pos err {err:.3e}, centroid err "
              f"{cerr:.3e}, iters {_counts(g['state'].diag.numpy())}")
        assert err < 5e-6, (k, err)
        assert _counts(g["state"].diag.numpy()) == _counts(snap["diag"]), k
        assert cerr < 1e-5, (k, cerr)
    # every solid term ran: the sums once a step, the contact dot once a
    # loop, the solid viscosity once a step; the reaction list's rows and
    # the list once a step and its stream once a density iteration, never
    # the walk
    k = stencil.KERNELS
    steps = len(got)
    dens = sum(g["state"].diag.numpy()[2] for g in got)
    assert k["rigid_terms"].plain_calls == steps
    assert k["rigid_contact_dot"].plain_calls == 2 * steps
    assert k["rigid_viscosity"].plain_calls == steps
    assert k["rigid_side_force_list"].plain_calls == dens
    assert k["rigid_side_rows"].plain_calls == steps
    assert k["rigid_side_list"].plain_calls == steps
    assert k["rigid_side_force"].plain_calls == 0


def test_coupled_step_matches_jax_pressure_active(jax_runs):
    run = jax_runs["pressure"]
    snap = run["snaps"][0]
    _, (g,) = run_port(run["leaves"], 1)
    assert snap["overflow"] == 0
    assert g["fmax"] > 0 and snap["fmax"] > 0
    assert _counts(g["state"].diag.numpy()) == _counts(snap["diag"])
    ferr = abs(g["fmax"] - snap["fmax"]) / snap["fmax"]
    err = _pos_err(g["state"], snap)
    print(f"pressure step: max|F| {g['fmax']:.6e} vs JAX {snap['fmax']:.6e} "
          f"(rel err {ferr:.3e}); pos err {err:.3e}; iters "
          f"{_counts(snap['diag'])}")
    assert ferr < PRESSURE_FORCE_RTOL
    assert err < PRESSURE_POS_ATOL


def test_one_way_coupling_leaves_the_force_zero(jax_runs):
    """fs_couple false: the fluid still sees the body, the body gets no
    force and the reaction pass never runs."""
    raw = rigid_cfg(**{"solver.fs_couple": False})
    stencil.reset_counts()
    sim, got = run_port(jax_runs["pressure"]["leaves"], 2, raw)
    assert all(g["fmax"] == 0.0 for g in got)
    for name in ("rigid_side_force", "rigid_side_rows", "rigid_side_list",
                 "rigid_side_force_list"):
        assert stencil.KERNELS[name].plain_calls == 0
    assert stencil.KERNELS["rigid_terms"].plain_calls == 2
    # the body still falls under gravity alone
    assert float(sim.state.rigid.vel[1]) < 0.0


def test_inactive_body_is_ignored():
    """solid.active false: the body is built and left as it was, and the
    fluid steps exactly as in the scene without it (tests/test_rigid.py:
    104-111)."""
    body = Simulation(parse_config(rigid_cfg(**{"solid.active": False})),
                      device="cpu")
    raw = rigid_cfg()
    del raw["solid"]
    bare = Simulation(parse_config(raw), device="cpu")
    assert body.scene.has_rigid and not body.scene.rigid_active
    rigid0 = body.state.rigid
    stencil.reset_counts()
    for _ in range(3):
        body.frame()
        bare.frame()
    assert all(stencil.KERNELS[name].plain_calls == 0 for name in (
        "rigid_terms", "rigid_contact_dot", "rigid_viscosity",
        "rigid_side_force", "rigid_side_rows", "rigid_side_list",
        "rigid_side_force_list"))
    for a, b in zip(body.state.rigid, rigid0):
        assert torch.equal(a, b)
    assert torch.equal(body.state.fluid.pos, bare.state.fluid.pos)
    assert body.telemetry()["nan_particles"] == 0


@pytest.mark.parametrize("solver", SOLVERS)
def test_every_solver_steps_an_active_and_an_inactive_body(solver):
    """Two frames of RIGID_CFG, the body in the water, as each solver: an
    active body takes the solid passes (all but PBF, which ignores it as
    JAX's does) and moves; an inactive one is built and left as it was,
    and no solid pass runs."""
    for active in (True, False):
        sim = Simulation(parse_config(rigid_cfg(**{
            "solver.name": solver, "solid.active": active})), device="cpu",
            check_nan=True)
        rigid0 = sim.state.rigid
        stencil.reset_counts()
        for _ in range(2):
            sim.frame()
        calls = {k: stencil.KERNELS[k].plain_calls for k in RIGID_KERNELS}
        moved = not torch.equal(sim.state.rigid.centroid, rigid0.centroid)
        assert moved == active, (active, sim.state.rigid.centroid)
        assert calls["rigid_terms"] == (2 if active and solver != "pbf"
                                        else 0), calls
        if not active:
            assert not any(calls.values()), calls
            for a, b in zip(sim.state.rigid, rigid0):
                assert torch.equal(a, b)
        assert sim.telemetry()["nan_particles"] == 0


def test_checkpoints_with_a_body_cross_between_packages(tmp_path, jax_runs):
    """A port checkpoint of a coupled state loads into the JAX package
    and back, leaf for leaf; a JAX checkpoint with a body loads into the
    port."""
    sim, _ = run_port(jax_runs["dormant"]["leaves"], 1)
    leaves = io.state_to_numpy(sim.state)
    assert leaves[10].shape == (sim.scene.n_rigid,)
    assert np.abs(leaves[16]).max() > 0     # the body moved: vel
    path = str(tmp_path / "port.npz")
    io.save_checkpoint(path, sim.state, meta={"frame": 1})
    like = jdfsph.init_state(jscene.build_scene(jparse_config(rigid_cfg())))
    jstate = jio.load_checkpoint(path, like)
    for a, b in zip(jax.tree_util.tree_flatten(jstate)[0], leaves):
        np.testing.assert_array_equal(np.asarray(a), b)
    back = io.load_checkpoint(path, device="cpu")
    for a, b in zip(io.state_to_numpy(back), leaves):
        np.testing.assert_array_equal(a, b)

    want = jax_runs["dormant"]["snaps"][0]["leaves"]
    jpath = str(tmp_path / "jax.npz")
    np.savez(jpath, **{f"leaf_{i}": a for i, a in enumerate(want)})
    for a, b in zip(io.state_to_numpy(io.load_checkpoint(jpath,
                                                         device="cpu")),
                    want):
        np.testing.assert_array_equal(a, b)


def test_runner_cli_runs_torus_flush(tmp_path):
    out = tmp_path / "out"
    subprocess.run(
        [sys.executable, "-m", "cfd_taichi_tpu_torch.runner", "--config",
         str(ROOT / "configs" / "torus_flush.json"), "--frames", "1",
         "--device", "cpu", "--output-dir", str(out), "--checkpoint-every",
         "1"], check=True, capture_output=True, timeout=300, cwd=ROOT)
    state = io.load_checkpoint(str(out / "ckpt_000001.npz"), device="cpu")
    leaves = io.state_to_numpy(state)
    assert leaves[10].shape == (569,)
    for a in leaves[10:25]:
        assert np.isfinite(a).all()
    assert int(state.step_count) == 1


def test_coupled_run_stays_in_the_box():
    """RIGID_CFG as written (the body dropped from y 0.65 into the water),
    30 frames: fluid and body finite and inside the box +- 2r, the density
    in range, the body fallen."""
    sim = Simulation(parse_config(rigid_cfg(**{
        "solid.pos_offset": [0.4, 0.65, 0.4]})), device="cpu",
        check_nan=True)
    c0 = sim.state.rigid.centroid.clone()
    for _ in range(30):
        sim.frame()
    sc, margin = sim.scene, 2 * sim.scene.particle_radius
    lo = torch.tensor(sc.box_min) - margin
    hi = torch.tensor(sc.box_max) + margin
    for pts in (sim.state.fluid.pos, sim.state.rigid.pos):
        assert bool(((pts >= lo) & (pts <= hi)).all())
    tele = sim.telemetry()
    assert tele["nan_particles"] == 0 and tele["rigid_invalid"] == 0
    assert 100.0 < tele["rho_min"] and tele["rho_max"] < 2000.0
    assert float(sim.state.rigid.centroid[1]) < float(c0[1])
