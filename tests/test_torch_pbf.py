"""The port's PBF (cfd_taichi_tpu_torch/models/pbf.py) held against the JAX
package on the TINY scene of tests/test_solvers.py:14-23 (216 fluid
particles), both on the CPU:

* the smoothing kernels spiky and poly6 against the closed forms of
  tests/test_smoothing.py:79 and against JAX's jitted ones: the spiky
  kernels bit for bit, poly6 to 3e-7 of scale (XLA contracts 1 - q q into
  an FMA on the CPU; the port's kernels are built without FMA);
* the three pair passes' plain versions against `bandmat.dense_pbf_ops`
  (terms, lam_mv, xsph) and `bandmat.pbf_boundary_terms`, on TINY's block
  with a 0.1 r jitter moved next to the walls so that boundary pairs
  exist, seeded lambda and velocities, and updated positions shifted by a
  seeded ~0.3 r displacement, so that pairs cross r = h in both
  directions;
* steps: 6 from a compressed state (TINY's block scaled by 0.85 about its
  centre, so the constraint acts), with Akinci walls and with the clamp
  boundary: positions and velocities through `oid`;
* checkpoints of 30 leaves (PBF has no extra state) across packages, the
  CLI on configs/pbf_basic.json, and the checklist of tests/test_solvers.py:
  38-47.

Tolerances: positions to atol 5e-6 (tests/test_solvers.py:263-271); the
passes sum the same f32 pair terms in another order: 1e-5 of the output's
largest magnitude. Velocities: PBF sets v = (x~ - x) / dt, so a position
that rounds one ulp apart (2^-25 below 0.5 m) moves v by 7.5e-5 at dt =
4e-4, whatever the sum order; they are held to one ulp of the box's
largest coordinate over dt, 1.5e-4 (the port gives 7.3e-5 at most).
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

import cfd_taichi_tpu.models.pbf as jpbf
from cfd_taichi_tpu import scene as jscene
from cfd_taichi_tpu.config import parse_config as jparse_config
from cfd_taichi_tpu.models import base as jbase
from cfd_taichi_tpu.ops import bandmat
from cfd_taichi_tpu.ops import smoothing as jsm
from cfd_taichi_tpu.ops.vec import V3
from cfd_taichi_tpu.runner import Simulation as JaxSimulation
from cfd_taichi_tpu.utils import io as jio
from cfd_taichi_tpu_torch import Simulation, build_scene, models
from cfd_taichi_tpu_torch.config import parse_config
from cfd_taichi_tpu_torch.models import base, pbf
from cfd_taichi_tpu_torch.ops import neighbors as nb
from cfd_taichi_tpu_torch.ops import smoothing as sm
from cfd_taichi_tpu_torch.ops import stencil
from cfd_taichi_tpu_torch.utils import io

TINY = {
    "scene": {"box_min": [0.0, 0.0, 0.0], "box_max": [0.6, 0.8, 0.6],
              "particle_radius": 0.025, "gravity": 9.8},
    "solver": {"name": "pbf", "delta_time": 4e-4, "iter_cnt": 1},
    "fluid": {"start_pos": [0.15, 0.1, 0.15], "water_size": [0.3, 0.3, 0.3]},
}
ROOT = Path(__file__).resolve().parents[1]
STEPS = 6
SQUEEZE = 0.85
SEED = 20261018
VEL_ATOL = float(np.spacing(np.float32(0.8))) / 4e-4


def _tiny(scene):
    raw = copy.deepcopy(TINY)
    raw["solver"]["boundary_handle"] = scene == "walls"
    return raw


def _by_oid(rows, oid):
    rows, oid = np.asarray(rows), np.asarray(oid)
    return rows[np.argsort(oid)]


def _leaves(state):
    return [np.asarray(a) for a in jax.tree_util.tree_flatten(state)[0]]


def close(got, want, scale_rtol=1e-5):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=scale_rtol * float(np.abs(want).max()))


# ---------------------------------------------------------------------------
# Spiky and poly6
# ---------------------------------------------------------------------------

H = 0.1


def test_spiky_and_poly6_closed_forms_and_jax():
    z, out = torch.zeros(()), torch.tensor(1.5 * H)
    assert np.isclose(float(sm.spiky_w(z, H)), 15.0 / (np.pi * H**3),
                      rtol=1e-5)
    assert np.isclose(float(sm.poly6_w(z, H)),
                      315.0 / (64 * np.pi * H**3), rtol=1e-5)
    assert float(sm.spiky_grad_coeff(z, H)) == 0.0    # q = 0 is guarded
    for fn in (sm.spiky_w, sm.poly6_w, sm.spiky_grad_coeff):
        assert float(fn(out, H)) == 0.0               # compact support
    # spiky_grad = coeff * rvec (tests/test_smoothing.py:64-67)
    rng = np.random.default_rng(2)
    rvec = rng.uniform(-H, H, size=(128, 3)).astype(np.float32)
    r = np.linalg.norm(rvec, axis=-1)
    np.testing.assert_allclose(
        sm.spiky_grad_coeff(torch.from_numpy(r), H).numpy()[:, None] * rvec,
        np.asarray(jsm.spiky_grad(jnp.asarray(rvec), H)), rtol=1e-4,
        atol=1e-2)
    # JAX's jitted kernels: the spiky ones bit for bit; poly6 within an ulp
    # or two (XLA contracts 1 - q q into an FMA on the CPU).
    r = rng.uniform(0.0, 1.1 * H, 100_000).astype(np.float32)
    for name, rtol in (("spiky_grad_coeff", 0), ("spiky_w", 0),
                       ("poly6_w", 3e-7)):
        want = np.asarray(jax.jit(
            lambda x, f=getattr(jsm, name): f(x, H))(r))
        got = getattr(sm, name)(torch.from_numpy(r), H).numpy()
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=rtol * float(np.abs(want).max()),
                                   err_msg=name)


# ---------------------------------------------------------------------------
# The pair passes
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def pair_case():
    """TINY's jittered block moved next to three walls, cell-sorted in
    both packages, its JAX dense prep, and seeded lambda, updated positions
    and velocities."""
    jsc = jscene.build_scene(jparse_config(_tiny("walls")))
    st = jsc.static
    sc = build_scene(parse_config(_tiny("walls")), device="cpu")
    rng = np.random.default_rng(SEED)
    r, n = st.particle_radius, st.n_fluid
    pos = (jsc.fluid_pos0.to_numpy() - np.array([0.1, 0.1, 0.1])
           + rng.uniform(-0.1 * r, 0.1 * r, (n, 3))).astype(np.float32)
    dp = jbase.build_dense_prep(st, jsc.arrays, V3.from_rows(pos),
                                st.band_nb_wide, st.band_B,
                                want_bterms=False)
    assert int(dp.overflow) == 0 and int(dp.bwin.overflow) == 0
    scid, perm, pos_s, _ = base.sort_by_cells(sc.grid, torch.from_numpy(pos))
    np.testing.assert_array_equal(perm.numpy(), np.asarray(dp.perm))
    shift = rng.standard_normal((n, 3)).astype(np.float32) * np.float32(
        0.3 * r / np.sqrt(3.0))
    return dict(
        st=st, sc=sc, dp=dp, pos_s=pos_s,
        starts=nb.csr_starts(scid, sc.grid.num_cells),
        lam=rng.uniform(-2e-5, 0.0, n).astype(np.float32),
        new_pos=(pos_s.numpy() + shift).astype(np.float32),
        new_vel=rng.standard_normal((n, 3)).astype(np.float32),
        w_ref=pbf.w_ref(st.h))


def _jax_ops(c):
    st = c["st"]
    return bandmat.dense_pbf_ops(c["dp"].pos, h=st.h, m=st.particle_m,
                                 plan=c["dp"].plan, B=st.band_B,
                                 w_ref=c["w_ref"], k_corr=pbf.TENSION_K)


def _check_terms(got, want):
    rho, gsum, around, ssum = want
    for a, b in ((got.rho, rho), (got.gsum, gsum.to_numpy()),
                 (got.around, around), (got.ssum, ssum.to_numpy())):
        close(a, b)


def test_pbf_terms_plain_matches_dense_pbf_ops(pair_case):
    c, sc = pair_case, pair_case["sc"]
    terms, _, _ = _jax_ops(c)
    stencil.reset_counts()
    got, _ = stencil.pbf_terms_plain(c["pos_s"], c["starts"], sc.grid, sc.h,
                                     sc.particle_m, c["w_ref"],
                                     pbf.TENSION_K)
    assert stencil.KERNELS["pbf_terms"].plain_calls == 1
    assert float(got.ssum.abs().max()) > 0.0
    _check_terms(got, terms)


def test_pbf_boundary_terms_plain_matches_jax(pair_case):
    c, st, sc = pair_case, pair_case["st"], pair_case["sc"]
    want = bandmat.pbf_boundary_terms(
        c["dp"].bwin, c["dp"].pos, h=st.h, rho0=1000.0, B=st.band_B,
        w_ref=c["w_ref"], k_corr=pbf.TENSION_K)
    assert (np.asarray(want[0]) > 0).sum() > 20
    got = stencil.pbf_boundary_terms_plain(c["pos_s"], base.walls(sc),
                                           sc.grid, sc.h, 1000.0, c["w_ref"],
                                           pbf.TENSION_K)
    _check_terms(got, want)


# (walls, rho0) of the constraint pass' cases: on TINY's block with walls
# the model's rho0; without walls the fluid's density stays below 850 at
# rest, so rho0 700 makes about a third of the rows constrained.
ROWS_CASES = {"walls": (True, 1000.0), "clamp": (False, 700.0)}


def _jax_rows(c, walls, rho0):
    """JAX's constraint pass on the case: dense_pbf_ops' terms, on walls
    plus bandmat.pbf_boundary_terms, then the row algebra of
    cfd_taichi_tpu/models/pbf.py:96-115 in jnp, at density rho0."""
    st = c["st"]
    terms, _, _ = _jax_ops(c)
    rho = jbase.DENSITY_EPS + terms.rho
    gsum, around, ssum = terms.gsum.to_rows(), terms.around, terms.ssum.to_rows()
    if walls:
        b_rho, b_g, b_around, b_ssum = bandmat.pbf_boundary_terms(
            c["dp"].bwin, c["dp"].pos, h=st.h, rho0=rho0, B=st.band_B,
            w_ref=c["w_ref"], k_corr=pbf.TENSION_K)
        rho = rho + b_rho
        gsum = gsum + b_g.to_rows()
        around = around + b_around
        ssum = ssum + b_ssum.to_rows()
    constraint = jnp.maximum(rho / rho0 - 1.0, 0.0)
    g = gsum * jnp.float32(1.0 / rho0)
    denom = (g[:, 0] * g[:, 0] + g[:, 1] * g[:, 1] + g[:, 2] * g[:, 2]
             + around * jnp.float32(1.0 / rho0 ** 2))
    lam = jnp.where(constraint == 0.0, 0.0,
                    -constraint / (denom + jpbf.EPSILON))
    return constraint, lam, gsum, ssum


def _rows_args(c, walls, rho0):
    sc = c["sc"]
    return (c["pos_s"], c["starts"], sc.grid, sc.h, sc.particle_m,
            c["w_ref"], pbf.TENSION_K, None,
            base.walls(sc) if walls else None, rho0, pbf.EPSILON,
            base.DENSITY_EPS)


@pytest.mark.parametrize("case", ROWS_CASES)
def test_pbf_constraint_plain_matches_jax(pair_case, case):
    """The constraint pass (the fluid walk, the walls' walk, the rows'
    algebra) against JAX's dense step's, with walls and without."""
    stencil.reset_counts()
    got, _ = stencil.pbf_constraint_plain(
        *_rows_args(pair_case, *ROWS_CASES[case]))
    assert stencil.KERNELS["pbf_terms"].plain_calls == 1
    want = _jax_rows(pair_case, *ROWS_CASES[case])
    assert float(got.constraint.max()) > 0.0
    assert int((got.lam < 0).sum()) > 10
    for a, b in zip(got, want, strict=True):
        close(a, b)


def _parent_rows(terms, bt, rho0=pbf.RHO_0):
    """The row algebra as models/pbf.solve took it before its epilogue went
    into the kernel: the fluid walk's `terms`, the walls' `bt` or None (and
    rho0 a parameter)."""
    rho = sm.f32(base.DENSITY_EPS) + terms.rho
    gsum, around, ssum = terms.gsum, terms.around, terms.ssum
    if bt is not None:
        rho = rho + bt.rho
        gsum = gsum + bt.gsum
        around = around + bt.around
        ssum = ssum + bt.ssum
    constraint = torch.clamp(rho * sm.f32(1.0 / rho0) - 1.0, min=0.0)
    grad_c_i = gsum * sm.f32(1.0 / rho0)
    denom = (grad_c_i[:, 0] * grad_c_i[:, 0] + grad_c_i[:, 1] * grad_c_i[:, 1]
             + grad_c_i[:, 2] * grad_c_i[:, 2]
             + around * sm.f32(1.0 / rho0**2))
    lam = torch.where(constraint == 0.0, torch.zeros_like(constraint),
                      -constraint / (denom + sm.f32(pbf.EPSILON)))
    return constraint, lam, gsum, ssum


def _parent_composition(pos, starts, grid, h, m, w_ref, k_corr, rows, walls,
                        rho0, epsilon, rho_seed):
    """stencil.pbf_constraint as the two walks' plain versions and the
    algebra before it (`_parent_rows`)."""
    terms, pairs = stencil.pbf_terms_plain(pos, starts, grid, h, m, w_ref,
                                           k_corr, rows)
    bt = None if walls is None else stencil.pbf_boundary_terms_plain(
        pos, walls, grid, h, rho0, w_ref, k_corr)
    return stencil.PbfConstraint(*_parent_rows(terms, bt, rho0)), pairs


@pytest.mark.parametrize("case", ROWS_CASES)
def test_pbf_constraint_plain_keeps_the_composed_bits(pair_case, case):
    """pbf_constraint_plain gives the bits of the two walks followed by the
    algebra models/pbf.solve ran on them, and the same pair list."""
    args = _rows_args(pair_case, *ROWS_CASES[case])
    got, pl = stencil.pbf_constraint_plain(*args)
    want, want_pl = _parent_composition(*args)
    assert int((got.lam < 0).sum()) > 10
    for a, b in zip(got, want, strict=True):
        assert torch.equal(a, b)
    assert torch.equal(pl.cnt, want_pl.cnt)
    assert torch.equal(stencil.stored_pairs(pl)[1],
                       stencil.stored_pairs(want_pl)[1])


def test_pbf_lambda_plain_matches_lam_mv(pair_case):
    c, sc = pair_case, pair_case["sc"]
    _, lam_mv, _ = _jax_ops(c)
    got = stencil.pbf_lambda_plain(c["pos_s"], c["starts"], sc.grid, sc.h,
                                   torch.from_numpy(c["lam"]))
    close(got, lam_mv(jnp.asarray(c["lam"])).to_numpy())


def test_pbf_xsph_plain_matches_xsph_at_updated_positions(pair_case):
    c, sc = pair_case, pair_case["sc"]
    n = sc.n_fluid
    p0, p1 = c["pos_s"].numpy(), c["new_pos"]
    h2 = np.float32(sc.h) ** 2
    valid = (((p0[:, None] - p0[None]) ** 2).sum(-1) <= h2) & ~np.eye(
        n, dtype=bool)
    near = (((p1[:, None] - p1[None]) ** 2).sum(-1) <= h2) & ~np.eye(
        n, dtype=bool)
    assert (valid & ~near).sum() > 0 and (near & ~valid).sum() > 0
    _, _, xsph = _jax_ops(c)
    want = xsph(V3.from_rows(p1), V3.from_rows(c["new_vel"])).to_numpy()
    got = stencil.pbf_xsph_plain(c["pos_s"], c["starts"], sc.grid, sc.h,
                                 torch.from_numpy(p1),
                                 torch.from_numpy(c["new_vel"]))
    close(got, want)


# ---------------------------------------------------------------------------
# The solver
# ---------------------------------------------------------------------------

def run_jax(raw):
    """JAX steps from the compressed state: the start leaves and, after
    each step, positions and velocities through oid and the leaves."""
    leaves = _leaves(JaxSimulation(jparse_config(raw)).state)
    pos = np.stack(leaves[:3], axis=-1)
    mid = (pos.min(axis=0) + pos.max(axis=0)) / 2
    pos = (mid + SQUEEZE * (pos - mid)).astype(np.float32)
    leaves[:3] = [np.ascontiguousarray(pos[:, c]) for c in range(3)]
    sim = JaxSimulation(jparse_config(raw), plan_pos=pos)
    assert jpbf.dense_eligible(sim.scene.static)
    sim.state = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(sim.state),
        [jnp.asarray(a) for a in leaves])
    snaps = []
    for _ in range(STEPS):
        sim.step()
        f = sim.state.fluid
        snaps.append(dict(pos=_by_oid(f.pos.to_numpy(), f.oid),
                          vel=_by_oid(f.vel.to_numpy(), f.oid),
                          overflow=int(sim.state.overflow),
                          leaves=_leaves(sim.state)))
    return dict(leaves=leaves, snaps=snaps)


@pytest.fixture(scope="module")
def jax_runs():
    runs = {scene: run_jax(_tiny(scene)) for scene in ("walls", "clamp")}
    jax.clear_caches()
    return runs


def _port_sim(scene="walls"):
    return Simulation(parse_config(_tiny(scene)), device="cpu")


@pytest.mark.parametrize("scene", ["walls", "clamp"])
def test_pbf_steps_match_jax(scene, jax_runs):
    run = jax_runs[scene]
    sim = _port_sim(scene)
    sim.state = io.state_from_numpy(run["leaves"], device="cpu")
    stencil.reset_counts()
    moved = 0.0
    for k, snap in enumerate(run["snaps"], start=1):
        sim.step()
        assert snap["overflow"] == 0
        f = sim.state.fluid
        got_pos, got_vel = _by_oid(f.pos.numpy(), f.oid), _by_oid(
            f.vel.numpy(), f.oid)
        print(f"parity pbf {scene} step {k}: pos err "
              f"{np.abs(got_pos - snap['pos']).max():.3e}, vel err "
              f"{np.abs(got_vel - snap['vel']).max():.3e}")
        np.testing.assert_allclose(_by_oid(f.pos.numpy(), f.oid), snap["pos"],
                                   atol=5e-6, err_msg=f"step {k}")
        np.testing.assert_allclose(_by_oid(f.vel.numpy(), f.oid), snap["vel"],
                                   atol=VEL_ATOL, err_msg=f"step {k}")
        moved = max(moved, float(np.abs(snap["vel"]).max()))
    assert moved > 1.0      # the constraint pushes the block apart
    k = stencil.KERNELS
    # one constraint pass a step: both walks and the rows in one call
    assert k["pbf_terms"].plain_calls == STEPS
    assert k["pbf_lambda"].plain_calls == k["pbf_xsph"].plain_calls == STEPS
    assert k["fluid_terms"].plain_calls == k["viscosity"].plain_calls == 0
    assert sim.telemetry()["nan_particles"] == 0


@pytest.mark.parametrize("scene", ["walls", "clamp"])
def test_pbf_steps_keep_the_composed_bits(scene, jax_runs, monkeypatch):
    """Steps from the compressed state give the bits of steps whose
    constraint pass is the two walks followed by the algebra models/pbf.py
    ran on them (`_parent_composition`): positions and velocities exactly."""
    sims = []
    for composed in (False, True):
        if composed:
            monkeypatch.setattr(stencil, "pbf_constraint",
                                _parent_composition)
        sim = _port_sim(scene)
        sim.state = io.state_from_numpy(jax_runs[scene]["leaves"],
                                        device="cpu")
        for _ in range(3):
            sim.step()
        sims.append(sim.state.fluid)
    assert torch.equal(sims[0].pos, sims[1].pos)
    assert torch.equal(sims[0].vel, sims[1].vel)
    assert torch.equal(sims[0].oid, sims[1].oid)


def test_checkpoints_of_30_leaves_cross_between_packages(tmp_path, jax_runs):
    sim = _port_sim()
    sim.state = io.state_from_numpy(jax_runs["walls"]["leaves"],
                                    device="cpu")
    sim.step()
    path = str(tmp_path / "port.npz")
    io.save_checkpoint(path, sim.state, meta={"frame": 1})
    like = jpbf.init_state(jscene.build_scene(jparse_config(_tiny("walls"))))
    port = io.state_to_numpy(sim.state)
    assert len(port) == io.BASE_LEAVES
    for a, b in zip(_leaves(jio.load_checkpoint(path, like)), port,
                    strict=True):
        np.testing.assert_array_equal(a, b)
    jleaves = jax_runs["walls"]["snaps"][-1]["leaves"]
    jpath = str(tmp_path / "jax.npz")
    np.savez(jpath, **{f"leaf_{i}": a for i, a in enumerate(jleaves)})
    for a, b in zip(io.state_to_numpy(io.load_checkpoint(jpath,
                                                         device="cpu")),
                    jleaves, strict=True):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# Behaviour: tests/test_solvers.py:38-47, the CLI
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("scene", ["walls", "clamp"])
def test_pbf_runs_stable(scene):
    sim = _port_sim(scene)
    for _ in range(25):
        sim.step()
    stats = sim.telemetry()
    assert stats["nan_particles"] == 0
    pos = sim.state.fluid.pos.numpy()
    assert np.all(pos >= -0.05) and np.all(pos <= 0.85)
    assert 100.0 < stats["rho_avg"] < 1500.0


def test_pbf_basic_runs_from_the_cli(tmp_path):
    assert models.get_solver("pbf") is pbf
    done = subprocess.run(
        [sys.executable, "-m", "cfd_taichi_tpu_torch.runner", "--config",
         str(ROOT / "configs" / "pbf_basic.json"), "--frames", "1",
         "--device", "cpu", "--output-dir", str(tmp_path / "out")],
        check=True, capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert "[Solver]: pbf" in done.stdout
    tele = json.loads(done.stdout.split("Final telemetry:")[1].splitlines()[0])
    assert tele["nan_particles"] == 0 and tele["steps"] == 1
