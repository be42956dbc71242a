"""The port's coupled IISPH step (cfd_taichi_tpu_torch/models/iisph.py
with ops/rigid.py) held against the JAX package's dense coupled path
(`cfd_taichi_tpu/models/iisph.py:327-383`) on the CPU, on RIGID_CFG as
IISPH with the body at [0.4, 0.28, 0.4], in the water: the two regimes of
tests/test_torch_dfsph_rigid.py, with its tolerances (dormant: positions
5e-6, centroid 1e-5, equal counts; active: about ten times what the port
measured against JAX, printed, inside JAX's own 2e-2 and 2e-3, and equal
iteration counts, which JAX's own dense and compact runs need not have,
tests/test_rigid.py:204-218).

Also one-way coupling and a port checkpoint of a coupled state (the
p_past leaf and the body's leaves) across packages.
"""

import jax
import numpy as np
import pytest

import cfd_taichi_tpu.models.iisph as jiisph
from cfd_taichi_tpu import scene as jscene
from cfd_taichi_tpu.config import parse_config as jparse_config
from cfd_taichi_tpu.utils import io as jio
from cfd_taichi_tpu_torch.config import parse_config
from cfd_taichi_tpu_torch.ops import stencil
from cfd_taichi_tpu_torch.utils import io
# The autouse fixtures one_thread and recompute_engine come in with the
# helpers.
from test_torch_dfsph_rigid import (_counts, _pos_err,  # noqa: F401
                                    jax_regimes, one_thread, recompute_engine,
                                    rigid_cfg, run_port)

RAW = rigid_cfg(**{"solver.name": "iisph"})
# The port against JAX in the pressure regime, about ten times the errors
# measured (printed by the test).
PRESSURE_FORCE_RTOL = 7e-6
PRESSURE_POS_ATOL = 6e-7


@pytest.fixture(scope="module")
def jax_runs():
    return jax_regimes("iisph")


def test_coupled_steps_match_jax_pressure_dormant(jax_runs):
    run = jax_runs["dormant"]
    stencil.reset_counts()
    _, got = run_port(run["leaves"], len(run["snaps"]), RAW)
    for k, (g, snap) in enumerate(zip(got, run["snaps"]), start=1):
        assert snap["overflow"] == 0
        err = _pos_err(g["state"], snap)
        cerr = float(np.abs(g["centroid"] - snap["centroid"]).max())
        print(f"dormant step {k}: pos err {err:.3e}, centroid err "
              f"{cerr:.3e}, iters {_counts(g['state'].diag.numpy())}")
        assert err < 5e-6, (k, err)
        assert _counts(g["state"].diag.numpy()) == _counts(snap["diag"]), k
        assert cerr < 1e-5, (k, cerr)
    # the solid sums, viscosity, contact dot and reaction once a step
    k = stencil.KERNELS
    steps = len(got)
    for name in ("rigid_terms", "rigid_viscosity", "rigid_contact_dot",
                 "rigid_side_force"):
        assert k[name].plain_calls == steps, name
    assert k["pcisph_predict_rho_rigid"].plain_calls == 0
    # the reaction walks once a step: no list is built or streamed
    assert k["rigid_side_rows"].plain_calls == 0
    assert k["rigid_side_list"].plain_calls == 0
    assert k["rigid_side_force_list"].plain_calls == 0


def test_coupled_step_matches_jax_pressure_active(jax_runs):
    run = jax_runs["pressure"]
    snap = run["snaps"][0]
    _, (g,) = run_port(run["leaves"], 1, RAW)
    assert snap["overflow"] == 0
    assert g["fmax"] > 0 and snap["fmax"] > 0
    assert snap["diag"][0] >= 2      # the loop iterates
    assert _counts(g["state"].diag.numpy()) == _counts(snap["diag"])
    ferr = abs(g["fmax"] - snap["fmax"]) / snap["fmax"]
    err = _pos_err(g["state"], snap)
    print(f"pressure step: max|F| {g['fmax']:.6e} vs JAX {snap['fmax']:.6e} "
          f"(rel err {ferr:.3e}); pos err {err:.3e}; iters "
          f"{_counts(snap['diag'])}")
    assert ferr < PRESSURE_FORCE_RTOL
    assert err < PRESSURE_POS_ATOL


def test_one_way_coupling_leaves_the_force_zero(jax_runs):
    raw = rigid_cfg(**{"solver.name": "iisph", "solver.fs_couple": False})
    stencil.reset_counts()
    sim, got = run_port(jax_runs["pressure"]["leaves"], 2, raw)
    assert all(g["fmax"] == 0.0 for g in got)
    assert stencil.KERNELS["rigid_side_force"].plain_calls == 0
    assert stencil.KERNELS["rigid_contact_dot"].plain_calls == 2
    assert float(sim.state.rigid.vel[1]) < 0.0


def test_checkpoints_with_a_body_cross_between_packages(tmp_path, jax_runs):
    """A port checkpoint of a coupled IISPH state (the p_past leaf and the
    body's leaves 10-24) loads into the JAX package and back."""
    sim, _ = run_port(jax_runs["dormant"]["leaves"], 1, RAW)
    leaves = io.state_to_numpy(sim.state)
    assert leaves[10].shape == (sim.scene.n_rigid,)
    assert leaves[io._EXTRA].shape == (sim.scene.n_fluid,)
    path = str(tmp_path / "port.npz")
    io.save_checkpoint(path, sim.state, meta={"frame": 1})
    like = jiisph.init_state(jscene.build_scene(jparse_config(RAW)))
    jstate = jio.load_checkpoint(path, like)
    for a, b in zip(jax.tree_util.tree_flatten(jstate)[0], leaves):
        np.testing.assert_array_equal(np.asarray(a), b)
    for a, b in zip(io.state_to_numpy(io.load_checkpoint(path,
                                                         device="cpu")),
                    leaves):
        np.testing.assert_array_equal(a, b)
