"""The port's WCSPH (cfd_taichi_tpu_torch/models/wcsph.py) held against the
JAX package on the TINY scene of tests/test_solvers.py:14-23 (216 fluid
particles), both on the CPU:

* the pair pass: `wcsph_forces_plain` against `bandmat.dense_wcsph_forces`
  on a jittered, cell-sorted TINY block with seeded velocities (both signs
  of shear) and positive p', and fluid_terms' rho against
  `bandmat.dense_rho_count` (both exclude the self term);
* steps: 6 from rest and 6 from a compressed state, with Akinci walls and
  with the clamp boundary, positions through `oid`;
* the behaviours of tests/test_wcsph.py:40-90 (stable, contained, density
  bounds, falls under gravity, deterministic, the clamp's 2r margin);
* checkpoints of 30 leaves (WCSPH has no extra state) across packages.

From rest TINY's density sits under rho0 (the self term is excluded), so
Tait gives p = 0 and only gravity, viscosity and cohesion act. The
compressed state, TINY's seeded block scaled by 0.85 about its centre,
puts the block's interior (64 of 216 particles) above rho0, so the
pressure term acts; both packages
get it through their state leaves, and JAX sizes its capacities from it
(`plan_pos`).

Tolerances: positions to atol 5e-6 and dt exactly, the repo's
engine-equivalence bar (tests/test_solvers.py:263-271). The pair pass sums
the same f32 pair terms in another order: 1e-5 of the output's largest
magnitude.
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

import cfd_taichi_tpu.models.wcsph as jwcsph
from cfd_taichi_tpu import scene as jscene
from cfd_taichi_tpu.config import parse_config as jparse_config
from cfd_taichi_tpu.models import base as jbase
from cfd_taichi_tpu.ops import bandmat
from cfd_taichi_tpu.ops.vec import V3
from cfd_taichi_tpu.runner import Simulation as JaxSimulation
from cfd_taichi_tpu.utils import io as jio
from cfd_taichi_tpu_torch import Simulation, build_scene, models
from cfd_taichi_tpu_torch.config import parse_config
from cfd_taichi_tpu_torch.models import base
from cfd_taichi_tpu_torch.models import wcsph
from cfd_taichi_tpu_torch.ops import neighbors as nb
from cfd_taichi_tpu_torch.ops import stencil
from cfd_taichi_tpu_torch.utils import io

TINY = {
    "scene": {"box_min": [0.0, 0.0, 0.0], "box_max": [0.6, 0.8, 0.6],
              "particle_radius": 0.025, "gravity": 9.8},
    "solver": {"name": "wcsph", "delta_time": 4e-4, "iter_cnt": 1},
    "fluid": {"start_pos": [0.15, 0.1, 0.15], "water_size": [0.3, 0.3, 0.3]},
}
ROOT = Path(__file__).resolve().parents[1]
STEPS = 6
SQUEEZE = 0.85
SEED = 20261017
FORCES = dict(c_s=wcsph.VISCOSITY_C_S, alpha=wcsph.VISCOSITY_ALPHA,
              tension_k=wcsph.TENSION_K)


def _tiny(scene):
    raw = copy.deepcopy(TINY)
    raw["solver"]["boundary_handle"] = scene == "walls"
    return raw


def _pos_by_oid(pos, oid):
    pos, oid = np.asarray(pos), np.asarray(oid)
    return pos[np.argsort(oid)]


def compressed_leaves(jsim):
    """The JAX state leaves of `jsim` with the fluid block scaled by
    SQUEEZE about its centre."""
    leaves = [np.asarray(a) for a in
              jax.tree_util.tree_flatten(jsim.state)[0]]
    pos = np.stack(leaves[:3], axis=-1)
    mid = (pos.min(axis=0) + pos.max(axis=0)) / 2
    pos = (mid + SQUEEZE * (pos - mid)).astype(np.float32)
    leaves[:3] = [np.ascontiguousarray(pos[:, c]) for c in range(3)]
    return leaves


def run_jax(raw, start, steps):
    """JAX steps from rest or from the compressed state: the start leaves
    and a snapshot after each step."""
    sim = JaxSimulation(jparse_config(raw))
    leaves = [np.asarray(a) for a in jax.tree_util.tree_flatten(sim.state)[0]]
    if start == "compressed":
        leaves = compressed_leaves(sim)
        sim = JaxSimulation(jparse_config(raw),
                            plan_pos=np.stack(leaves[:3], axis=-1))
        treedef = jax.tree_util.tree_structure(sim.state)
        sim.state = jax.tree_util.tree_unflatten(
            treedef, [jnp.asarray(a) for a in leaves])
    snaps = []
    for _ in range(steps):
        sim.step()
        s = sim.state
        snaps.append(dict(
            pos=_pos_by_oid(s.fluid.pos.to_numpy(), s.fluid.oid),
            dt=float(s.dt), overflow=int(s.overflow),
            leaves=[np.asarray(a) for a in jax.tree_util.tree_flatten(s)[0]]))
    return dict(leaves=leaves, snaps=snaps)


@pytest.fixture(scope="module")
def jax_runs():
    runs = {(scene, start): run_jax(_tiny(scene), start, STEPS)
            for scene in ("walls", "clamp")
            for start in ("rest", "compressed")}
    jax.clear_caches()
    return runs


def _port_sim(scene="walls", raw=None):
    return Simulation(parse_config(raw or _tiny(scene)), device="cpu")


# ---------------------------------------------------------------------------
# The pair pass
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def pair_case():
    """TINY's block with a 0.1 r jitter, cell-sorted in both packages, the
    JAX block plan, seeded velocities and positive p'."""
    jsc = jscene.build_scene(jparse_config(copy.deepcopy(TINY)))
    st = jsc.static
    sc = build_scene(parse_config(copy.deepcopy(TINY)), device="cpu")
    rng = np.random.default_rng(SEED)
    r, n = st.particle_radius, st.n_fluid
    pos = (jsc.fluid_pos0.to_numpy() + rng.uniform(
        -0.1 * r, 0.1 * r, (n, 3))).astype(np.float32)
    dp = jbase.build_dense_prep(st, jsc.arrays, V3.from_rows(pos),
                                st.band_nb_wide, st.band_B)
    assert int(dp.overflow) == 0
    scid, perm, pos_s, _ = base.sort_by_cells(sc.grid, torch.from_numpy(pos))
    np.testing.assert_array_equal(perm.numpy(), np.asarray(dp.perm))
    vel = rng.standard_normal((n, 3)).astype(np.float32)
    p_over_rho2 = rng.uniform(0.0, 0.05, n).astype(np.float32)
    return dict(st=st, sc=sc, dp=dp, pos_s=pos_s, vel=vel,
                p_over_rho2=p_over_rho2,
                starts=nb.csr_starts(scid, sc.grid.num_cells))


def test_fluid_terms_rho_matches_dense_rho_count(pair_case):
    """WCSPH takes rho from fluid_terms: the sum JAX's dense_rho_count
    takes, over the same pairs, self excluded."""
    c, st, sc = pair_case, pair_case["st"], pair_case["sc"]
    rho_f, count, _ = bandmat.dense_rho_count(
        c["dp"].pos, h=st.h, m=st.particle_m, plan=c["dp"].plan, B=st.band_B)
    ft = stencil.fluid_terms(c["pos_s"], c["starts"], sc.grid, sc.h,
                             sc.particle_m)
    np.testing.assert_array_equal(ft.count.numpy(), np.asarray(count))
    np.testing.assert_allclose(ft.rho.numpy(), np.asarray(rho_f), rtol=0,
                               atol=1e-5 * float(np.abs(rho_f).max()))


def test_wcsph_forces_plain_matches_dense_wcsph_forces(pair_case):
    c, st, sc = pair_case, pair_case["st"], pair_case["sc"]
    rho_f, _, _ = bandmat.dense_rho_count(
        c["dp"].pos, h=st.h, m=st.particle_m, plan=c["dp"].plan, B=st.band_B)
    rho = np.array(jbase.DENSITY_EPS + rho_f)
    want = bandmat.dense_wcsph_forces(
        c["dp"].pos, V3.from_rows(c["vel"]), jnp.asarray(rho),
        jnp.asarray(c["p_over_rho2"]), h=st.h, m=st.particle_m,
        plan=c["dp"].plan, B=st.band_B, **FORCES).to_numpy()
    stencil.reset_counts()
    got = stencil.wcsph_forces(
        c["pos_s"], c["starts"], sc.grid, sc.h, sc.particle_m,
        torch.from_numpy(c["vel"]), torch.from_numpy(rho),
        torch.from_numpy(c["p_over_rho2"]), **FORCES)
    assert stencil.KERNELS["wcsph_forces"].plain_calls == 1
    # Each of the three terms acts: pressure (p' > 0), viscosity on the
    # compressive pairs of the random velocities, cohesion.
    no_visc = stencil.wcsph_forces_plain(
        c["pos_s"], c["starts"], sc.grid, sc.h, sc.particle_m,
        torch.zeros(st.n_fluid, 3), torch.from_numpy(rho),
        torch.from_numpy(c["p_over_rho2"]), **FORCES)
    assert float((got - no_visc).abs().max()) > 1e-3 * float(
        got.abs().max())
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-5 * float(np.abs(want).max()))


def test_records_hold_pos_and_p_then_vel_and_rho(pair_case):
    """The kernel's packed records: a = (x, y, z, p'), b = (vx, vy, vz,
    rho), contiguous and 16-byte aligned; the packed entry point gives the
    wrapper's forces bit for bit."""
    c, sc = pair_case, pair_case["sc"]
    vel = torch.from_numpy(c["vel"])
    rho = torch.from_numpy(np.linspace(600.0, 1400.0, sc.n_fluid,
                                       dtype=np.float32))
    pr = torch.from_numpy(c["p_over_rho2"])
    rec = stencil.wcsph_records(c["pos_s"], vel, rho, pr)
    for t, head, tail in ((rec.a, c["pos_s"], pr), (rec.b, vel, rho)):
        assert t.shape == (sc.n_fluid, 4) and t.dtype == torch.float32
        assert t.is_contiguous() and t.data_ptr() % 16 == 0
        assert torch.equal(t[:, :3], head) and torch.equal(t[:, 3], tail)
    args = (c["starts"], sc.grid, sc.h, sc.particle_m)
    assert torch.equal(
        stencil.wcsph_forces_packed(rec, *args, **FORCES),
        stencil.wcsph_forces(c["pos_s"], *args, vel, rho, pr, **FORCES))


@pytest.mark.parametrize("fault", ["misaligned", "strided"])
def test_packed_records_must_be_contiguous_and_aligned(pair_case, fault):
    c, sc = pair_case, pair_case["sc"]
    n = sc.n_fluid
    good = stencil.wcsph_records(
        c["pos_s"], torch.from_numpy(c["vel"]), torch.ones(n),
        torch.from_numpy(c["p_over_rho2"]))
    if fault == "misaligned":
        bad = torch.empty(4 * n + 1)[1:].view(n, 4)
    else:
        bad = torch.empty(n, 8)[:, :4]
    bad.copy_(good.a)
    with pytest.raises(ValueError, match="record a"):
        stencil.wcsph_forces_packed(
            stencil.WcsphRecords(bad, good.b), c["starts"], sc.grid, sc.h,
            sc.particle_m, **FORCES)


def test_scene_constants_are_made_once():
    """gravity_acc and the clamp bounds are the scene's tensors, made once
    (per margin), with the values the step built each time before:
    f32(b + margin) of the Python double."""
    sc = build_scene(parse_config(_tiny("clamp")), device="cpu")
    assert base.gravity_acc(sc) is base.gravity_acc(sc)
    assert base.gravity_acc(sc).tolist() == [0.0, np.float32(-9.8), 0.0]
    margin = 2.0 * sc.particle_radius
    lo, hi = base.clamp_bounds(sc, margin)
    assert base.clamp_bounds(sc, margin)[0] is lo
    assert lo.tolist() == [np.float32(b + margin) for b in sc.box_min]
    assert hi.tolist() == [np.float32(b - margin) for b in sc.box_max]
    assert base.clamp_bounds(sc, sc.particle_radius)[0] is not lo
    assert sorted(sc.clamp_bounds) == [sc.particle_radius, margin]


def test_tait_pressure_matches_jax():
    rho = np.linspace(600.0, 1400.0, 257).astype(np.float32)
    want = np.asarray(jwcsph.tait_pressure(jnp.asarray(rho)))
    got = wcsph.tait_pressure(torch.from_numpy(rho)).numpy()
    assert (got[rho <= 1000.0] == 0.0).all() and want.max() > 1e4
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


# ---------------------------------------------------------------------------
# Steps
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("start", ["rest", "compressed"])
@pytest.mark.parametrize("scene", ["walls", "clamp"])
def test_wcsph_steps_match_jax(scene, start, jax_runs):
    run = jax_runs[(scene, start)]
    sim = _port_sim(scene)
    assert sim.scene.akinci == (scene == "walls")
    if start == "compressed":
        sim.state = io.state_from_numpy(run["leaves"], device="cpu")
        # The block's 4 x 4 x 4 interior sits above rho0.
        assert float((sim.density() > 1000.0).float().mean()) > 0.25
    stencil.reset_counts()
    for k, snap in enumerate(run["snaps"], start=1):
        sim.step()
        assert snap["overflow"] == 0
        got = _pos_by_oid(sim.state.fluid.pos.numpy(),
                          sim.state.fluid.oid.numpy())
        print(f"parity wcsph {scene} {start} step {k}: pos err "
              f"{np.abs(got - snap['pos']).max():.3e}")
        np.testing.assert_allclose(got, snap["pos"], atol=5e-6,
                                   err_msg=f"step {k}")
        assert float(sim.state.dt) == snap["dt"]
    kern = stencil.KERNELS
    assert kern["wcsph_forces"].plain_calls == STEPS
    assert kern["boundary_terms"].plain_calls == (
        STEPS if scene == "walls" else 0)
    assert kern["viscosity"].plain_calls == kern["matvec"].plain_calls == 0
    if scene == "clamp":
        pos = sim.state.fluid.pos.numpy()
        margin = 2 * sim.scene.particle_radius
        assert pos.min() >= margin - 1e-6
        assert (pos <= np.asarray(TINY["scene"]["box_max"]) - margin
                + 1e-6).all()


def test_density_error_matches_jax(jax_runs):
    run = jax_runs[("walls", "compressed")]
    jsim = JaxSimulation(jparse_config(_tiny("walls")),
                         plan_pos=np.stack(run["leaves"][:3], axis=-1))
    jstate = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(jsim.state),
        [jnp.asarray(a) for a in run["leaves"]])
    want = float(jwcsph.density_error(jsim.scene.static, jsim.scene.arrays,
                                      jstate))
    sim = _port_sim()
    sim.state = io.state_from_numpy(run["leaves"], device="cpu")
    got = float(wcsph.density_error(sim.scene, sim.state))
    assert want > 0.05
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_checkpoints_of_30_leaves_cross_between_packages(tmp_path, jax_runs):
    """WCSPH's state has no extra leaf: a port checkpoint holds 30 leaves,
    loads into the JAX package and back, and a JAX one loads into the
    port."""
    sim = _port_sim()
    sim.step()
    assert sim.state.extra == ()
    path = str(tmp_path / "port.npz")
    io.save_checkpoint(path, sim.state, meta={"frame": 1})
    assert len(io.state_to_numpy(sim.state)) == io.BASE_LEAVES == 30
    like = jwcsph.init_state(jscene.build_scene(jparse_config(_tiny("walls"))))
    jstate = jio.load_checkpoint(path, like)
    for a, b in zip(jax.tree_util.tree_flatten(jstate)[0],
                    io.state_to_numpy(sim.state), strict=True):
        np.testing.assert_array_equal(np.asarray(a), b)
    back = io.load_checkpoint(path, device="cpu")
    assert back.extra == ()
    for a, b in zip(io.state_to_numpy(back), io.state_to_numpy(sim.state),
                    strict=True):
        np.testing.assert_array_equal(a, b)

    jleaves = jax_runs[("walls", "compressed")]["snaps"][-1]["leaves"]
    jpath = str(tmp_path / "jax.npz")
    np.savez(jpath, **{f"leaf_{i}": a for i, a in enumerate(jleaves)})
    carried = io.load_checkpoint(jpath, device="cpu")
    for a, b in zip(io.state_to_numpy(carried), jleaves, strict=True):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# Behaviours (tests/test_wcsph.py:40-90)
# ---------------------------------------------------------------------------

BEHAVIOUR_STEPS = 20


@pytest.fixture(scope="module")
def stepped():
    raw = copy.deepcopy(TINY)
    raw["solver"]["delta_time"] = 5e-4    # tests/test_wcsph.py:17
    sim = _port_sim(raw=raw)
    y0 = float(sim.state.fluid.pos[:, 1].mean())
    for _ in range(BEHAVIOUR_STEPS):
        sim.step()
    return sim, y0


def test_wcsph_runs_stable(stepped):
    stats = stepped[0].telemetry()
    assert stats["nan_particles"] == 0
    assert stats["steps"] == BEHAVIOUR_STEPS


def test_wcsph_particles_contained(stepped):
    pos = stepped[0].state.fluid.pos.numpy()
    assert (pos >= -0.05).all()
    assert (pos <= np.array([0.6, 0.8, 0.6]) + 0.05).all()


def test_wcsph_density_reasonable(stepped):
    rho = stepped[0].density().numpy()
    # The self term is excluded, so a rest lattice sits near 0.68 rho0.
    assert rho.min() > 100.0 and rho.max() < 2000.0


def test_wcsph_fluid_falls_under_gravity(stepped):
    sim, y0 = stepped
    assert float(sim.state.fluid.pos[:, 1].mean()) < y0


def test_wcsph_deterministic():
    sims = [_port_sim() for _ in range(2)]
    for _ in range(5):
        for s in sims:
            s.step()
    assert torch.equal(sims[0].state.fluid.pos, sims[1].state.fluid.pos)


def test_wcsph_clamp_boundary_mode():
    sim = _port_sim("clamp")
    for _ in range(BEHAVIOUR_STEPS):
        sim.step()
    assert sim.telemetry()["nan_particles"] == 0
    pos = sim.state.fluid.pos.numpy()
    # Clamp margin = diameter (wcsph_solver.py:57-63).
    assert pos.min() >= 0.05 - 1e-5
    assert (pos <= np.array([0.6, 0.8, 0.6]) - 0.05 + 1e-5).all()


def test_wcsph_resolves_and_runs_from_the_cli(tmp_path):
    assert models.get_solver("wcsph") is wcsph
    cfg = tmp_path / "tiny.json"
    cfg.write_text(json.dumps(TINY))
    out = tmp_path / "out"
    done = subprocess.run(
        [sys.executable, "-m", "cfd_taichi_tpu_torch.runner", "--config",
         str(cfg), "--frames", "2", "--device", "cpu", "--output-dir",
         str(out), "--checkpoint-every", "2"], check=True,
        capture_output=True, text=True, timeout=120, cwd=ROOT)
    assert "[Solver]: wcsph" in done.stdout
    tele = json.loads(done.stdout.split("Final telemetry:")[1].splitlines()[0])
    assert tele["nan_particles"] == 0 and tele["steps"] == 2
    state = io.load_checkpoint(str(out / "ckpt_000002.npz"), device="cpu")
    assert state.extra == () and int(state.step_count) == 2
