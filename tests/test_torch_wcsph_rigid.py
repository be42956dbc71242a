"""The port's coupled WCSPH step (cfd_taichi_tpu_torch/models/wcsph.py
with ops/rigid.py) held against the JAX package's dense coupled path
(`cfd_taichi_tpu/models/wcsph.py:96-136`) on the CPU, on RIGID_CFG as
WCSPH with the body at [0.4, 0.28, 0.4], in the water: the two regimes of
tests/test_torch_dfsph_rigid.py, with its tolerances (dormant: positions
5e-6, centroid 1e-5; active: about ten times what the port measured
against JAX, printed, inside JAX's own 2e-2 and 2e-3). WCSPH has no loop.

Also one-way coupling, and PBF with an active body, which it ignores as
JAX's PBF does: the fluid and the body's centroid held to JAX's over a few
frames (positions 5e-6, centroid 1e-5).
"""

import numpy as np
import pytest

from cfd_taichi_tpu.config import parse_config as jparse_config
from cfd_taichi_tpu.runner import Simulation as JaxSimulation
from cfd_taichi_tpu_torch import Simulation
from cfd_taichi_tpu_torch.config import parse_config
from cfd_taichi_tpu_torch.ops import stencil
from cfd_taichi_tpu_torch.utils import io
# The autouse fixtures one_thread and recompute_engine come in with the
# helpers.
from test_torch_dfsph_rigid import (_leaves, _pos_by_oid,  # noqa: F401
                                    _pos_err, jax_regimes, one_thread,
                                    recompute_engine, rigid_cfg, run_port)

RAW = rigid_cfg(**{"solver.name": "wcsph"})
PBF_FRAMES = 3
# The port against JAX in the pressure regime, about ten times the errors
# measured (printed by the test).
PRESSURE_FORCE_RTOL = 2.5e-5
PRESSURE_POS_ATOL = 6e-7


@pytest.fixture(scope="module")
def jax_runs():
    return jax_regimes("wcsph")


def test_coupled_steps_match_jax_pressure_dormant(jax_runs):
    run = jax_runs["dormant"]
    stencil.reset_counts()
    _, got = run_port(run["leaves"], len(run["snaps"]), RAW)
    for k, (g, snap) in enumerate(zip(got, run["snaps"]), start=1):
        assert snap["overflow"] == 0
        err = _pos_err(g["state"], snap)
        cerr = float(np.abs(g["centroid"] - snap["centroid"]).max())
        print(f"dormant step {k}: pos err {err:.3e}, centroid err "
              f"{cerr:.3e}")
        assert err < 5e-6, (k, err)
        assert cerr < 1e-5, (k, cerr)
    # the solid sums, viscosity and reaction once a step
    k = stencil.KERNELS
    steps = len(got)
    for name in ("rigid_terms", "rigid_viscosity", "rigid_side_force"):
        assert k[name].plain_calls == steps, name
    assert k["rigid_contact_dot"].plain_calls == 0
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
    ferr = abs(g["fmax"] - snap["fmax"]) / snap["fmax"]
    err = _pos_err(g["state"], snap)
    print(f"pressure step: max|F| {g['fmax']:.6e} vs JAX {snap['fmax']:.6e} "
          f"(rel err {ferr:.3e}); pos err {err:.3e}")
    assert ferr < PRESSURE_FORCE_RTOL
    assert err < PRESSURE_POS_ATOL


def test_one_way_coupling_leaves_the_force_zero(jax_runs):
    raw = rigid_cfg(**{"solver.name": "wcsph", "solver.fs_couple": False})
    stencil.reset_counts()
    sim, got = run_port(jax_runs["pressure"]["leaves"], 2, raw)
    assert all(g["fmax"] == 0.0 for g in got)
    assert stencil.KERNELS["rigid_side_force"].plain_calls == 0
    assert stencil.KERNELS["rigid_terms"].plain_calls == 2
    assert float(sim.state.rigid.vel[1]) < 0.0


def test_pbf_ignores_an_active_body_as_jax_does():
    """PBF on RIGID_CFG, the body in the water, PBF_FRAMES frames from the
    same start: JAX takes its compact path on a coupled scene, the port
    its one step; both leave the body out of the fluid step and let it
    fall."""
    raw = rigid_cfg(**{"solver.name": "pbf"})
    jsim = JaxSimulation(jparse_config(raw))
    sim = Simulation(parse_config(raw), device="cpu")
    sim.state = io.state_from_numpy(_leaves(jsim.state), device="cpu")
    c0 = float(sim.state.rigid.centroid[1])
    stencil.reset_counts()
    for k in range(1, PBF_FRAMES + 1):
        jsim.frame()
        sim.frame()
        js, s = jsim.state, sim.state
        err = float(np.abs(
            _pos_by_oid(s.fluid.pos.numpy(), s.fluid.oid.numpy())
            - _pos_by_oid(js.fluid.pos.to_numpy(), js.fluid.oid)).max())
        cerr = float(np.abs(s.rigid.centroid.numpy()
                            - np.asarray(js.rigid.centroid)).max())
        print(f"pbf frame {k}: pos err {err:.3e}, centroid err {cerr:.3e}")
        assert err < 5e-6 and cerr < 1e-5, (k, err, cerr)
    assert float(sim.state.rigid.centroid[1]) < c0
    assert not any(stencil.KERNELS[name].plain_calls for name in (
        "rigid_terms", "rigid_viscosity", "rigid_side_force"))
    # one constraint pass a step, its walls' walk included
    assert stencil.KERNELS["pbf_terms"].plain_calls == PBF_FRAMES
