"""The port's slab decomposition (cfd_taichi_tpu_torch/parallel/) on gloo
ranks on the CPU, case by case against tests/test_sharding.py: its CFG
(256 fluid particles in a 1.0 x 0.5 x 0.4 box) on NDEV = 4 slabs.

One module-scoped spawn a world size (parallel/launch.spawn, 4 ranks and 2
ranks, each pinned to one torch thread) runs every case of that world;
each rank writes its blocks, with `oid`, to an npz that the tests read.

* the JAX package's sharded DFSPH and WCSPH steps (4 virtual CPU devices,
  `BAND_DTYPE` f32 set with monkeypatch) and the port's start from one
  sharded state (`sharded_state_from_numpy`), from rest and from the block
  squeezed by 0.85 (perf/inputs.SQUEEZE, so that pressure acts): positions
  through `oid` to 5e-6, dt to rtol 1e-5, iteration counts equal. The same
  for IISPH, PCISPH and PBF is marked slow;
* all five sharded solvers against the port's single-device step (held to
  JAX by tests/test_torch_{dfsph,wcsph,iisph,pcisph,pbf}.py) from the
  squeezed block, step for step: the same bars;
* particles conserved over 20 steps, the 60-step migration stress dam
  break, a slab with no particle, the halo overflow counted at hcap = 8
  and zero on the healthy scene;
* a world of one (no process group: `initialize` is a no-op, idempotent),
  which is the single-device step bit for bit, and a world of two (both
  neighbours the same rank).

JAX is imported inside the fixtures, never at module level: the ranks
import this module to find their program.
"""

import concurrent.futures
import contextlib
import copy
import dataclasses
import os

import numpy as np
import pytest
import torch

from cfd_taichi_tpu_torch import Simulation, build_scene
from cfd_taichi_tpu_torch.config import parse_config
from cfd_taichi_tpu_torch.models import dfsph as pdfsph
from cfd_taichi_tpu_torch.parallel import domain, launch, multihost
from cfd_taichi_tpu_torch.perf.inputs import SQUEEZE

NDEV = 4
CFG = {
    "scene": {"box_min": [0, 0, 0], "box_max": [1.0, 0.5, 0.4],
              "particle_radius": 0.025, "gravity": 9.8},
    "solver": {"name": "wcsph", "delta_time": 5e-4, "iter_cnt": 1},
    "fluid": {"start_pos": [0.1, 0.1, 0.1], "water_size": [0.8, 0.2, 0.2]},
}
SOLVERS = ("dfsph", "wcsph", "iisph", "pcisph", "pbf")
COEF_BUDGET = pdfsph.COEF_BYTE_BUDGET
JAX_STEPS = {"dfsph": 3, "wcsph": 5, "iisph": 3, "pcisph": 3, "pbf": 3}
STEPS = 3
POS_TOL, DT_RTOL = 5e-6, 1e-5
# A dam that fills slabs 0 and 1 only: slab 2 holds halo rows, slab 3 none.
EMPTY_SLAB_FLUID = {"start_pos": [0.1, 0.1, 0.1],
                    "water_size": [0.3, 0.2, 0.2]}


def _cfg(solver, fluid=None):
    raw = copy.deepcopy(CFG)
    raw["solver"]["name"] = solver
    if fluid is not None:
        raw["fluid"] = copy.deepcopy(fluid)
    return parse_config(raw)


@contextlib.contextmanager
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def squeeze(pos):
    """perf/inputs.squeezed's arithmetic on (N, 3) f32 numpy rows."""
    pos = np.asarray(pos, np.float32)
    mid = (pos.min(axis=0) + pos.max(axis=0)) / np.float32(2)
    return mid + np.float32(SQUEEZE) * (pos - mid)


# ---------------------------------------------------------------------------
# The ranks' program
# ---------------------------------------------------------------------------

def _record(ring, state, out: dict, name: str, per_step: dict) -> None:
    f = state.fluid
    m = f.mask
    out[f"{name}/pos"] = f.pos[m].numpy()
    out[f"{name}/vel"] = f.vel[m].numpy()
    out[f"{name}/oid"] = f.oid[m].numpy()
    for key, vals in per_step.items():
        out[f"{name}/{key}"] = np.asarray(vals)


def _run_case(ring, case: dict, out: dict) -> None:
    solver = case["solver"]
    pdfsph.COEF_BYTE_BUDGET = case.get("coef_budget", COEF_BUDGET)
    scene = build_scene(_cfg(solver, case.get("fluid")), device="cpu")
    spec = domain.make_spec(scene, ring.world, case.get("slack", 1.7))
    if "hcap" in case:
        spec = dataclasses.replace(spec, hcap=case["hcap"])
    if "leaves" in case:
        state = domain.sharded_state_from_numpy(ring, spec, solver,
                                                case["leaves"])
    else:
        pos = case.get("pos", scene.fluid_pos0)
        state = domain.init_sharded_solver(ring, spec, scene, pos, solver,
                                           vel=case.get("vel"))
    step = domain.make_sharded_solver_step(scene, ring, spec, solver)
    comm = domain.Comm(ring)
    axis_pos = [domain.unshard(ring, state.fluid)[0][:, spec.axis]]
    per_step = {k: [] for k in ("dt", "diag", "overflow", "count")}
    for _ in range(case["steps"]):
        state = step(state)
        per_step["dt"].append(float(state.dt))
        per_step["diag"].append(state.diag.tolist())
        per_step["overflow"].append(int(state.overflow))
        per_step["count"].append(int(comm.sum(state.fluid.mask.sum())[0]))
    axis_pos.append(domain.unshard(ring, state.fluid)[0][:, spec.axis])
    per_step["slab_counts"] = [
        np.bincount(np.clip(((x - spec.lo) // spec.slab_w).astype(int), 0,
                            spec.ndev - 1), minlength=spec.ndev)
        for x in axis_pos]
    _record(ring, state, out, case["name"], per_step)


def _rank_cases(ring, cases: list, out_dir: str) -> str:
    """Run every case on this rank; write its blocks to an npz."""
    out: dict = {}
    for case in cases:
        _run_case(ring, case, out)
    path = os.path.join(out_dir, f"rank{ring.rank}.npz")
    np.savez(path, **out)
    return path


def _spawn(world: int, cases: list, tmp_dir) -> list[dict]:
    paths = launch.spawn(_rank_cases, world, backend="gloo", device="cpu",
                         args=(cases, str(tmp_dir)), timeout=600, threads=1)
    return [dict(np.load(p)) for p in paths]


def _gather(ranks: list[dict], name: str) -> dict:
    """A case's valid rows of every rank, in oid order, and rank 0's
    per-step records (every rank holds the same)."""
    oid = np.concatenate([r[f"{name}/oid"] for r in ranks])
    order = np.argsort(oid)
    got = {k: np.concatenate([r[f"{name}/{k}"] for r in ranks])[order]
           for k in ("pos", "vel", "oid")}
    for key in ("dt", "diag", "overflow", "count", "slab_counts"):
        got[key] = ranks[0][f"{name}/{key}"]
    got["per_rank_diag"] = [r[f"{name}/diag"] for r in ranks]
    return got


# ---------------------------------------------------------------------------
# References
# ---------------------------------------------------------------------------

def _single(solver, steps, pos=None, fluid=None):
    """The port's single-device run: per-step dt and diag, the final rows
    in oid order."""
    sim = Simulation(_cfg(solver, fluid), device="cpu")
    if pos is not None:
        sim.state = sim.state._replace(fluid=sim.state.fluid._replace(
            pos=torch.from_numpy(np.asarray(pos, np.float32))))
    dts, diags = [], []
    for _ in range(steps):
        sim.step()
        dts.append(float(sim.state.dt))
        diags.append(sim.state.diag.tolist())
    f = sim.state.fluid
    order = np.argsort(f.oid.numpy())
    return dict(pos=f.pos.numpy()[order], vel=f.vel.numpy()[order],
                dt=np.asarray(dts), diag=np.asarray(diags))


def _jax_start(solver, squeezed: bool):
    """The JAX package's initial sharded state of CFG as `solver` (from
    rest or squeezed), its numpy leaves and its step."""
    import jax
    import jax.numpy as jnp

    from cfd_taichi_tpu.config import parse_config as jparse
    from cfd_taichi_tpu.parallel import domain as jdomain
    from cfd_taichi_tpu.runner import Simulation as JaxSimulation

    raw = copy.deepcopy(CFG)
    raw["solver"]["name"] = solver
    sim = JaxSimulation(jparse(raw))
    st = sim.scene.static
    mesh = jdomain.make_mesh(NDEV)
    spec = jdomain.make_spec(st, NDEV)
    state = jdomain.init_sharded_solver(mesh, spec, st, sim.scene.fluid_pos0,
                                        solver)
    leaves, treedef = jax.tree_util.tree_flatten(state)
    leaves = [np.asarray(a).copy() for a in leaves]
    if squeezed:
        mask, oid = leaves[6], leaves[7]
        sq = squeeze(sim.scene.fluid_pos0.to_numpy())
        for c in range(3):
            leaves[c][mask] = sq[oid[mask], c]
    consts = None
    if solver == "pcisph":
        from cfd_taichi_tpu.models import pcisph as jpcisph

        consts = {"delta": float(jpcisph.init_state(sim.scene).extra[0])}
    step = jdomain.make_sharded_solver_step(st, sim.scene.arrays, mesh, spec,
                                            solver, consts=consts)
    start = jax.tree_util.tree_unflatten(treedef,
                                         [jnp.asarray(a) for a in leaves])
    return dict(leaves=leaves, step=step, start=start, spec=spec)


def _jax_run(start: dict, steps: int) -> dict:
    from cfd_taichi_tpu.parallel import domain as jdomain

    state, dts, diags = start["start"], [], []
    for _ in range(steps):
        state = start["step"](state)
        dts.append(float(state.dt))
        diags.append(np.asarray(state.diag).tolist())
    pos, vel = jdomain.unshard(state.fluid)
    mask = np.asarray(state.fluid.mask)
    order = np.argsort(np.asarray(state.fluid.oid)[mask])
    return dict(pos=pos[order], vel=vel[order], dt=np.asarray(dts),
                diag=np.asarray(diags),
                overflow=int(np.asarray(state.overflow)))


# ---------------------------------------------------------------------------
# The spawns
# ---------------------------------------------------------------------------

def _with_jax(solvers, cases, tmp_dir, local=None):
    """Start JAX and the port's ranks from one state for each of `solvers`
    (from rest and squeezed), then run the ranks on those cases and
    `cases` in a thread while JAX steps here, and `local()` after it.
    Returns (ranks, JAX results, JAX starts, local's result)."""
    import jax.numpy as jnp

    import cfd_taichi_tpu.models.dfsph as jdfsph

    starts, cases = {}, list(cases)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jdfsph, "BAND_DTYPE", jnp.float32)
        for solver in solvers:
            for sq in (False, True):
                name = f"jax_{solver}_{'squeezed' if sq else 'rest'}"
                starts[name] = _jax_start(solver, sq)
                # The JAX reference runs its band engine on CFG; the port
                # its recompute engine, as tests/test_torch_dfsph.py pins.
                cases.append(dict(name=name, solver=solver,
                                  steps=JAX_STEPS[solver],
                                  leaves=starts[name]["leaves"],
                                  coef_budget=0))
        with concurrent.futures.ThreadPoolExecutor(1) as pool:
            ranks = pool.submit(_spawn, NDEV, cases, tmp_dir)
            ref = {name: _jax_run(s, JAX_STEPS[name.split("_")[1]])
                   for name, s in starts.items()}
            with _one_thread():
                mine = local() if local is not None else None
            ranks = ranks.result()
    return ranks, ref, starts, mine


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    scene = build_scene(_cfg("dfsph"), device="cpu")
    sq = squeeze(scene.fluid_pos0.numpy())
    vel0 = np.tile(np.asarray([[1.5, -0.5, 0.0]], np.float32),
                   (scene.n_fluid, 1))
    cases = [dict(name=f"{s}_single", solver=s, steps=STEPS, pos=sq)
             for s in SOLVERS]
    cases += [
        dict(name="conserve", solver="wcsph", steps=20),
        dict(name="migration", solver="dfsph", steps=60, vel=vel0),
        dict(name="hcap8", solver="wcsph", steps=1, hcap=8),
        # two slabs hold the dam: the default slack of 1.7 would leave
        # them ~48 slots for ~48 particles each
        dict(name="empty_slab", solver="dfsph", steps=STEPS,
             fluid=EMPTY_SLAB_FLUID, slack=4.0),
    ]

    def single():
        out = {s: _single(s, STEPS, pos=sq) for s in SOLVERS}
        out["empty_slab"] = _single("dfsph", STEPS, fluid=EMPTY_SLAB_FLUID)
        return out

    ranks, jax_ref, jax_starts, single = _with_jax(
        ("dfsph", "wcsph"), cases, tmp_path_factory.mktemp("world4"),
        single)
    return dict(ranks=ranks, jax_ref=jax_ref, jax_starts=jax_starts,
                single=single, scene=scene)


def _assert_match(got: dict, ref: dict, tag: str) -> None:
    assert got["pos"].shape == ref["pos"].shape, f"{tag}: particle count"
    err = float(np.abs(got["pos"] - ref["pos"]).max())
    assert err <= POS_TOL, f"{tag}: positions differ by {err}"
    np.testing.assert_allclose(got["dt"], ref["dt"], rtol=DT_RTOL,
                               err_msg=f"{tag}: dt")
    np.testing.assert_array_equal(got["diag"][:, [0, 2]],
                                  ref["diag"][:, [0, 2]],
                                  err_msg=f"{tag}: iteration counts")


# ---------------------------------------------------------------------------
# Tests
# ---------------------------------------------------------------------------

def test_spec_sane_and_equal_to_jax(world4):
    from cfd_taichi_tpu.config import parse_config as jparse
    from cfd_taichi_tpu.scene import build_scene as jbuild

    scene = world4["scene"]
    spec = domain.make_spec(scene, NDEV)
    assert spec.ndev == NDEV
    assert spec.cap * NDEV >= scene.n_fluid
    assert spec.slab_w >= 2 * scene.h
    jspec = world4["jax_starts"]["jax_dfsph_rest"]["spec"]
    assert dataclasses.asdict(spec) == dataclasses.asdict(jspec)
    jscene = jbuild(jparse(copy.deepcopy(CFG)))
    from cfd_taichi_tpu.parallel import domain as jdomain

    assert dataclasses.asdict(domain.make_spec(scene, 2)) == \
        dataclasses.asdict(jdomain.make_spec(jscene.static, 2))


def test_cfg_is_test_sharding_cfg():
    import test_sharding

    assert CFG == test_sharding.CFG and NDEV == test_sharding.NDEV


def test_too_many_devices_rejected():
    scene = build_scene(_cfg("wcsph"), device="cpu")
    with pytest.raises(ValueError, match="thinner than"):
        domain.make_spec(scene, 8)  # 1.0 / 8 = 0.125 < 2h = 0.2


def test_shard_roundtrip_and_capacity():
    scene = build_scene(_cfg("wcsph"), device="cpu")
    spec = domain.make_spec(scene, NDEV)
    pos0 = scene.fluid_pos0.numpy()
    blocks = [domain.shard_fluid(multihost.Ring(r, NDEV,
                                                torch.device("cpu"), None),
                                 spec, pos0) for r in range(NDEV)]
    oid = np.concatenate([b.oid[b.mask].numpy() for b in blocks])
    pos = np.concatenate([b.pos[b.mask].numpy() for b in blocks])
    assert np.array_equal(np.sort(oid), np.arange(scene.n_fluid))
    assert np.array_equal(pos[np.argsort(oid)], pos0)
    for b in blocks:
        assert bool(b.mask[:int(b.mask.sum())].all())  # packed in front
        assert bool((b.oid[~b.mask] == -1).all())
    tight = dataclasses.replace(spec, cap=8)
    with pytest.raises(ValueError, match="over capacity"):
        domain.shard_fluid(multihost.Ring(0, NDEV, torch.device("cpu"),
                                          None), tight, pos0)


@pytest.mark.parametrize("solver", ["dfsph", "wcsph"])
@pytest.mark.parametrize("start", ["rest", "squeezed"])
def test_sharded_step_matches_jax_sharded(world4, solver, start):
    name = f"jax_{solver}_{start}"
    got = _gather(world4["ranks"], name)
    ref = world4["jax_ref"][name]
    _assert_match(got, ref, name)
    assert ref["overflow"] == 0 and int(got["overflow"][-1]) == 0


@pytest.mark.parametrize("solver", SOLVERS)
def test_sharded_step_matches_single_device(world4, solver):
    got = _gather(world4["ranks"], f"{solver}_single")
    ref = world4["single"][solver]
    _assert_match(got, ref, solver)
    assert int(np.max(got["overflow"])) == 0
    if solver in ("iisph", "pcisph"):
        assert np.all(ref["diag"][:, 0] >= 1)
    for diag in got["per_rank_diag"]:      # every rank left on one trip
        np.testing.assert_array_equal(diag, got["diag"])


def test_particles_conserved_many_steps(world4):
    got = _gather(world4["ranks"], "conserve")
    n = world4["scene"].n_fluid
    assert got["pos"].shape[0] == n
    assert np.array_equal(got["oid"], np.arange(n))
    assert np.all(got["count"] == n)
    assert np.isfinite(got["pos"]).all() and np.isfinite(got["vel"]).all()


def test_sharded_migration_stress_dam_break(world4):
    """tests/test_sharding.py:211: the dam seeded with an axial velocity
    floods across the slab faces over 60 steps."""
    got = _gather(world4["ranks"], "migration")
    n = world4["scene"].n_fluid
    assert np.all(got["count"] == n), "particles lost"
    assert np.array_equal(got["oid"], np.arange(n))
    assert int(np.max(got["overflow"])) == 0
    assert np.isfinite(got["pos"]).all() and np.isfinite(got["vel"]).all()
    c0, c1 = got["slab_counts"]
    assert np.abs(c1 - c0).sum() > 0.1 * n, (c0.tolist(), c1.tolist())
    assert float(got["diag"][-1][2]) >= 2.0


def test_empty_slab(world4):
    """Slab 3 holds no particle and no halo row: its rank steps an empty
    set and takes part in every collective."""
    got = _gather(world4["ranks"], "empty_slab")
    c0, _ = got["slab_counts"]
    assert c0[3] == 0 and c0[0] > 0 and c0[1] > 0
    _assert_match(got, world4["single"]["empty_slab"], "empty slab")


def test_halo_overflow_is_counted(world4):
    got = _gather(world4["ranks"], "hcap8")
    assert int(got["overflow"][0]) > 0


def test_sharded_overflow_zero_on_healthy_scene(world4):
    for name in ("dfsph_single", "conserve", "empty_slab"):
        assert int(np.max(_gather(world4["ranks"], name)["overflow"])) == 0


def test_world_of_one_seam():
    """No process group: `initialize` is a no-op that returns 1, twice;
    the ring is rank 0 of 1, its collectives the identity."""
    assert multihost.initialize() == 1
    assert multihost.initialize() == 1
    assert not multihost.is_multihost()
    ring = multihost.global_ring("cpu")
    assert ring == multihost.Ring(0, 1, torch.device("cpu"), None)
    scene = build_scene(_cfg("wcsph"), device="cpu")
    spec = domain.make_spec(scene, 1)
    fluid = domain.shard_fluid(ring, spec, scene.fluid_pos0)
    out = domain.make_sharded_wcsph_step(scene, ring, spec)(fluid)
    assert int(out.mask.sum()) == scene.n_fluid


@pytest.mark.parametrize("boundary", ["walls", "clamp"])
@pytest.mark.parametrize("solver", SOLVERS)
def test_world_of_one_is_the_single_device_step(solver, boundary):
    """One slab, no neighbour: the sharded step keeps its owned rows in
    the step's sorted order and integrates as the single-device step, so
    it is that step bit for bit (positions, velocities, order, dt, diag;
    PBF's sharded diag[1] is the largest density constraint over the
    ranks, JAX's sharded telemetry, where the single-device step has 0)."""
    raw = copy.deepcopy(CFG)
    raw["solver"].update(name=solver, boundary_handle=boundary == "walls")
    scene = build_scene(parse_config(raw), device="cpu")
    ring = multihost.global_ring("cpu")
    spec = domain.make_spec(scene, 1)
    sq = squeeze(scene.fluid_pos0.numpy())
    state = domain.init_sharded_solver(ring, spec, scene, sq, solver)
    step = domain.make_sharded_solver_step(scene, ring, spec, solver)
    assert step.loops == "eager"
    sim = Simulation(parse_config(raw), device="cpu")
    sim.state = sim.state._replace(fluid=sim.state.fluid._replace(
        pos=torch.from_numpy(sq)))
    with _one_thread():
        for _ in range(STEPS):
            state = step(state)
            sim.step()
            cols = [0, 2, 3] if solver == "pbf" else [0, 1, 2, 3]
            assert torch.equal(state.diag[cols], sim.state.diag[cols])
            assert torch.equal(state.dt, sim.state.dt)
    f, n = sim.state.fluid, scene.n_fluid
    got = state.fluid
    assert torch.equal(got.mask, torch.arange(spec.cap) < n)
    for a, b in ((got.pos[:n], f.pos), (got.vel[:n], f.vel),
                 (got.oid[:n], f.oid)):
        assert torch.equal(a, b)


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    scene = build_scene(_cfg("dfsph"), device="cpu")
    sq = squeeze(scene.fluid_pos0.numpy())
    cases = [dict(name=f"{s}_single", solver=s, steps=STEPS, pos=sq)
             for s in ("dfsph", "pcisph")]
    ranks = _spawn(2, cases, tmp_path_factory.mktemp("world2"))
    with _one_thread():
        single = {s: _single(s, STEPS, pos=sq) for s in ("dfsph", "pcisph")}
    return dict(ranks=ranks, single=single)


@pytest.mark.parametrize("solver", ["dfsph", "pcisph"])
def test_world_of_two(world2, solver):
    """Two slabs: rank 0's right neighbour and rank 1's left one are the
    same rank, one message each way."""
    got = _gather(world2["ranks"], f"{solver}_single")
    _assert_match(got, world2["single"][solver], f"world 2 {solver}")
    assert int(np.max(got["overflow"])) == 0


@pytest.mark.slow
@pytest.mark.parametrize("solver", ["iisph", "pcisph", "pbf"])
def test_sharded_iterative_solver_matches_jax_sharded(tmp_path, solver):
    ranks, ref, _, _ = _with_jax((solver,), [], tmp_path)
    for start in ("rest", "squeezed"):
        name = f"jax_{solver}_{start}"
        got = _gather(ranks, name)
        _assert_match(got, ref[name], name)
        assert ref[name]["overflow"] == 0
