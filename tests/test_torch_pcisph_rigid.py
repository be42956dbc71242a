"""The port's coupled PCISPH step (cfd_taichi_tpu_torch/models/pcisph.py
with ops/rigid.py) held against the JAX package's dense coupled path
(`cfd_taichi_tpu/models/pcisph.py:212-287`) on the CPU, on RIGID_CFG as
PCISPH with the body at [0.4, 0.28, 0.4], in the water: the two regimes
of tests/test_torch_dfsph_rigid.py, with its tolerances (dormant:
positions 5e-6, centroid 1e-5, equal counts; active: about ten times what
the port measured against JAX, printed, inside JAX's own 2e-2 and 2e-3).

Also the predicted density's walk over the body: stencil.
pcisph_predict_rho's plain version with the body's table against JAX's
`predicted_rho_op` + `rigid_dense.predict_rho_op` + `boundary_predict_op`,
each sum to 1e-5 of its largest magnitude; one-way coupling, a port
checkpoint of a coupled state (the delta leaf and the body's leaves)
across packages, and configs/coupling_demo.json on the CLI.
"""

import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cfd_taichi_tpu.models.pcisph as jpcisph
from cfd_taichi_tpu import scene as jscene
from cfd_taichi_tpu.config import parse_config as jparse_config
from cfd_taichi_tpu.models import base as jbase
from cfd_taichi_tpu.ops import bandmat, rigid_dense
from cfd_taichi_tpu.ops.vec import V3
from cfd_taichi_tpu.utils import io as jio
from cfd_taichi_tpu_torch.config import parse_config
from cfd_taichi_tpu_torch.models import base
from cfd_taichi_tpu_torch.ops import neighbors as nb
from cfd_taichi_tpu_torch.ops import rigid as R
from cfd_taichi_tpu_torch.ops import stencil
from cfd_taichi_tpu_torch.utils import io
# The autouse fixtures one_thread and recompute_engine come in with the
# helpers.
from test_torch_dfsph_rigid import (ROOT, _counts, _pos_err,  # noqa: F401
                                    jax_regimes, one_thread, recompute_engine,
                                    rigid_cfg, run_port)
from test_torch_rigid import _assert_scaled, _pass_inputs

RAW = rigid_cfg(**{"solver.name": "pcisph"})
RHO0 = 1000.0
# The port against JAX in the pressure regime, about ten times the errors
# measured (printed by the test).
PRESSURE_FORCE_RTOL = 1e-6
PRESSURE_POS_ATOL = 6e-7


@pytest.fixture(scope="module")
def jax_runs():
    return jax_regimes("pcisph")


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
    # the solid sums and viscosity once a step, the reaction list's rows
    # and the list once a step and its stream once an iteration (never
    # the walk), the
    # body's predicted density once a predict
    k = stencil.KERNELS
    steps = len(got)
    iters = sum(g["state"].diag.numpy()[0] for g in got)
    assert iters >= steps
    assert k["rigid_terms"].plain_calls == k["rigid_viscosity"].plain_calls \
        == steps
    assert k["rigid_side_force_list"].plain_calls == iters
    assert k["rigid_side_rows"].plain_calls == steps
    assert k["rigid_side_list"].plain_calls == steps
    assert k["rigid_side_force"].plain_calls == 0
    assert k["pcisph_predict_rho_rigid"].plain_calls == \
        k["pcisph_predict_rho"].plain_calls == iters + steps
    assert k["rigid_contact_dot"].plain_calls == 0


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
    raw = rigid_cfg(**{"solver.name": "pcisph", "solver.fs_couple": False})
    stencil.reset_counts()
    sim, got = run_port(jax_runs["pressure"]["leaves"], 2, raw)
    assert all(g["fmax"] == 0.0 for g in got)
    for name in ("rigid_side_force", "rigid_side_rows", "rigid_side_list",
                 "rigid_side_force_list"):
        assert stencil.KERNELS[name].plain_calls == 0
    assert stencil.KERNELS["pcisph_predict_rho_rigid"].plain_calls > 0
    assert float(sim.state.rigid.vel[1]) < 0.0


def _jax_predict(st, arrays, pos, rpos, shift):
    """JAX's three predicted-density sums at the cell-sorted start
    positions plus `shift` (sorted inside, as its prepare does)."""
    dp = jbase.build_dense_prep(st, arrays, pos, st.band_nb_wide, st.band_B)
    rw = rigid_dense.build_rigid_windows(st, dp.pos, dp.qcells, rpos,
                                         arrays.rigid_volume, cap=st.rq_cap)
    pos_p = V3(dp.pos.x + shift[:, 0], dp.pos.y + shift[:, 1],
               dp.pos.z + shift[:, 2])
    fluid = bandmat.predicted_rho_op(dp.pos, h=st.h, m=st.particle_m,
                                     plan=dp.plan, B=st.band_B)(pos_p)
    body = rigid_dense.predict_rho_op(st, rw, RHO0, st.n_fluid)(pos_p)
    walls = bandmat.boundary_predict_op(dp.bwin, dp.pos, h=st.h, rho0=RHO0,
                                        B=st.band_B)(pos_p)
    return dict(perm=dp.perm, fluid=fluid, body=body, walls=walls,
                over=(dp.overflow, dp.bwin.overflow, rw.overflow))


def test_predict_rho_with_body_matches_jax_ops():
    """The plain version's three walks on RIGID_CFG's fluid shifted next to
    the body, predicted positions a further ~0.3 r away (pairs cross r = h
    both ways), against JAX's three ops."""
    js, sc, x = _pass_inputs(RAW, seed=8)
    st = js.static
    n, r = sc.n_fluid, sc.particle_radius
    shift = (np.random.default_rng(9).standard_normal((n, 3))
             * (0.3 * r / np.sqrt(3.0))).astype(np.float32)
    want = jax.jit(_jax_predict, static_argnums=0)(
        st, js.arrays, V3.from_rows(x["pos"]), V3.from_rows(x["rpos"]),
        jnp.asarray(shift))
    assert [int(o) for o in want["over"]] == [0, 0, 0]
    g = sc.grid
    scid, perm, pos, _ = base.sort_by_cells(g, torch.from_numpy(x["pos"]))
    np.testing.assert_array_equal(perm.numpy(), np.asarray(want["perm"]))
    starts = nb.csr_starts(scid, g.num_cells)
    pos_p = pos + torch.from_numpy(shift)
    table = R.rigid_table(g, torch.from_numpy(x["rpos"]), sc.rigid_volume)
    body = np.asarray(want["body"])
    assert (body > 0).sum() > 20
    stencil.reset_counts()
    args = (pos, starts, g, sc.h, sc.particle_m, pos_p)
    got = {key: stencil.pcisph_predict_rho(*args, *more).numpy()
           for key, more in (("fluid", ()), ("with_body", (None, RHO0,
                                                           table)),
                             ("all", (base.walls(sc), RHO0, table)))}
    assert stencil.KERNELS["pcisph_predict_rho"].plain_calls == 3
    assert stencil.KERNELS["pcisph_predict_rho_rigid"].plain_calls == 2
    fluid = np.asarray(want["fluid"])
    _assert_scaled(got["fluid"], fluid, "fluid")
    _assert_scaled(got["with_body"] - got["fluid"], body, "body")
    _assert_scaled(got["all"], fluid + body + np.asarray(want["walls"]),
                   "all")


def test_checkpoints_with_a_body_cross_between_packages(tmp_path, jax_runs):
    """A port checkpoint of a coupled PCISPH state (the delta leaf and the
    body's leaves 10-24) loads into the JAX package and back."""
    sim, _ = run_port(jax_runs["dormant"]["leaves"], 1, RAW)
    leaves = io.state_to_numpy(sim.state)
    assert leaves[10].shape == (sim.scene.n_rigid,)
    assert leaves[io._EXTRA].shape == () and float(leaves[io._EXTRA]) > 0
    path = str(tmp_path / "port.npz")
    io.save_checkpoint(path, sim.state, meta={"frame": 1})
    like = jpcisph.init_state(jscene.build_scene(jparse_config(RAW)))
    jstate = jio.load_checkpoint(path, like)
    for a, b in zip(jax.tree_util.tree_flatten(jstate)[0], leaves):
        np.testing.assert_array_equal(np.asarray(a), b)
    for a, b in zip(io.state_to_numpy(io.load_checkpoint(path,
                                                         device="cpu")),
                    leaves):
        np.testing.assert_array_equal(a, b)


def test_runner_cli_runs_coupling_demo(tmp_path):
    """configs/coupling_demo.json (55,200 fluid particles, a 3,200-voxel
    body) for one frame on the CPU."""
    out = tmp_path / "out"
    subprocess.run(
        [sys.executable, "-m", "cfd_taichi_tpu_torch.runner", "--config",
         str(ROOT / "configs" / "coupling_demo.json"), "--frames", "1",
         "--device", "cpu", "--output-dir", str(out), "--checkpoint-every",
         "1", "--quiet"], check=True, capture_output=True, timeout=600,
        cwd=ROOT)
    state = io.load_checkpoint(str(out / "ckpt_000001.npz"), device="cpu")
    leaves = io.state_to_numpy(state)
    assert leaves[0].shape == (55200,) and leaves[10].shape == (3200,)
    for a in leaves:
        assert np.isfinite(a).all()
    assert int(state.step_count) == 1
