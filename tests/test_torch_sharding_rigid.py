"""The port's coupled sharded step (cfd_taichi_tpu_torch/parallel/domain.py,
the coupled branches of models/{dfsph,pcisph,iisph,wcsph}.solve behind the
rank's hooks) on gloo ranks on the CPU, case by case against
tests/test_sharding.py:258-321: its COUPLED_CFG (480 fluid particles and
an active 18-voxel builtin:cube1 body in a 1.2 x 0.6 x 0.5 box) on NDEV =
4 slabs of 0.3.

A frame is a sharded fluid step, then `make_sharded_rigid_step` (iter_cnt
1), against the single-device `Simulation.frame`. Two starts:

* "written": COUPLED_CFG as written. Its voxels (x 0.625-0.725, y
  0.325-0.375) hang more than h over the water (y <= 0.2): no fluid-rigid
  pair yet, the body falls, carried whole on every rank;
* "immersed": the cube moved into the water and across the x = 0.6 face
  of slabs 1 and 2 (solid.pos_offset IMMERSED_OFFSET: voxels x
  0.525-0.625, y 0.175-0.225), so that every solid term and the reaction
  act from the first frame, and the owned rows of ranks 1 and 2 both
  charge it.

One module-scoped spawn of 4 ranks (parallel/launch.spawn, each pinned to
one torch thread) runs every case; each rank writes its blocks, with
`oid`, the body and its share of the reaction, to an npz:

* JAX's sharded coupled step (4 virtual CPU devices, `BAND_DTYPE` f32)
  and the port's start from one sharded state with the body's leaves
  (`sharded_state_from_numpy`), immersed, 3 frames: positions through
  `oid` to 5e-6, dt to rtol 1e-5, equal iteration counts, the body's
  centroid, velocity and angular velocity to BODY_TOL (tighter than
  test_sharding.py:300-308's 1e-5 / 1e-3 / 1e-2) or, where the body spins
  fast, BODY_RTOL of its magnitude, and the force on each of
  its particles to FORCE_TOL of the run's largest component. DFSPH and
  WCSPH here; PCISPH and IISPH are marked slow;
* the port's single-device frames, the four coupled solvers and PBF
  beside the body, from both starts: the same bars, the body's force of
  every frame included;
* the reaction across the slab face: more than one rank charges it, and
  the sum of the ranks' shares is the single-device force, not twice it;
* a slab with no fluid, `overflow` 0, and the ranks agreeing on the body
  bit for bit;
* a world of one (no process group), which is the single-device frame
  bit for bit, and the sharded rho quirk table against `base.rho_quirk`,
  with more rigid than fluid particles too.

JAX is imported inside the fixtures, never at module level: the ranks
import this module to find their program.
"""

import concurrent.futures
import contextlib
import copy
import os

import numpy as np
import pytest
import torch

from cfd_taichi_tpu_torch import Simulation, build_scene
from cfd_taichi_tpu_torch.config import parse_config
from cfd_taichi_tpu_torch.models import base
from cfd_taichi_tpu_torch.models import dfsph as pdfsph
from cfd_taichi_tpu_torch.parallel import domain, launch, multihost

NDEV = 4
COUPLED_CFG = {
    "scene": {"box_min": [0, 0, 0], "box_max": [1.2, 0.6, 0.5],
              "particle_radius": 0.025, "gravity": 9.8},
    "solver": {"name": "pcisph", "delta_time": 4e-4, "iter_cnt": 1,
               "boundary_handle": True, "fs_couple": True},
    "fluid": {"start_pos": [0.1, 0.05, 0.1],
              "water_size": [1.0, 0.2, 0.3]},
    "solid": {"mesh": "builtin:cube1", "voxel_radius": 0.025,
              "rho_0": 500, "scale": 0.15, "pos_offset": [0.6, 0.3, 0.25],
              "attitude_offset": [0.0, 0.0, 0.0], "fill": True,
              "active": True},
}
IMMERSED_OFFSET = [0.5, 0.15, 0.25]
STARTS = ("written", "immersed")
COUPLED = ("dfsph", "pcisph", "iisph", "wcsph")
SOLVERS = COUPLED + ("pbf",)
COEF_BUDGET = pdfsph.COEF_BYTE_BUDGET
FRAMES = 3
POS_TOL, DT_RTOL = 5e-6, 1e-5
# The body after FRAMES frames: centroid, velocity, angular velocity, to
# BODY_TOL or BODY_RTOL of the reference's largest component, whichever is
# larger. The relative bars serve PCISPH on the immersed start, whose loop
# runs to its cap of 80 iterations every frame and charges the reaction
# at each (the reference's accumulation, pcisph_solver.py:178-188): forces
# to 6.7e5, the body at 241 m/s and 82 rad/s after 3 frames. Its omega is
# a torque's sum of forces that cancel, so the forces' f32 differences
# (2.8e-6 of the largest) leave 1.3e-4 of it against JAX (1.1e-2 rad/s,
# over test_sharding.py's absolute 1e-2) and 3.1e-5 against the port's
# single device. A body this fast gets an omega bar above 1e-2 rad/s
# (WCSPH's at 86 rad/s too, where it measured 4.3e-4).
BODY_TOL = {"centroid": 1e-5, "vel": 1e-4, "omega": 1e-3}
BODY_RTOL = {"centroid": 1e-5, "vel": 1e-5, "omega": 2e-4}
# The body's force before each rigid step, particle by particle, over the
# largest component of the reference run: tests/test_torch_dfsph_rigid.py's
# bar on max |F| against JAX. Measured at most 2.4e-6 (DFSPH, the empty
# slab's frame 2). Not the frame's own largest component: PCISPH's frame
# 1 sums the reaction of 47 iterations, in another order on 4 ranks, to a
# net force 19x smaller than frame 0's (1.2e-5 of it, 6.2e-7 of the
# run's).
FORCE_TOL = 1e-5
# A dam over slabs 0-2 only: slab 3 holds no particle and no halo row.
EMPTY_SLAB_FLUID = {"start_pos": [0.1, 0.05, 0.1],
                    "water_size": [0.55, 0.2, 0.3]}


def _cfg(solver, start, fluid=None):
    raw = copy.deepcopy(COUPLED_CFG)
    raw["solver"]["name"] = solver
    if start == "immersed":
        raw["solid"]["pos_offset"] = list(IMMERSED_OFFSET)
    if fluid is not None:
        raw["fluid"] = copy.deepcopy(fluid)
    return raw


@contextlib.contextmanager
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def _body(rigid) -> dict:
    return {k: np.asarray(getattr(rigid, k)) for k in
            ("centroid", "vel", "omega")}


# ---------------------------------------------------------------------------
# The ranks' program
# ---------------------------------------------------------------------------

def _run_case(ring, case: dict, out: dict) -> None:
    solver, name = case["solver"], case["name"]
    pdfsph.COEF_BYTE_BUDGET = case.get("coef_budget", COEF_BUDGET)
    scene = build_scene(parse_config(_cfg(solver, case["start"],
                                          case.get("fluid"))), device="cpu")
    spec = domain.make_spec(scene, ring.world, case.get("slack", 1.7))
    if "leaves" in case:
        state = domain.sharded_state_from_numpy(ring, spec, solver,
                                                case["leaves"])
    else:
        state = domain.init_sharded_solver(ring, spec, scene,
                                           scene.fluid_pos0, solver)
    # The rank's share of the reaction: what it hands to the sum over the
    # ranks (the (Nr, 3) all-reduce of base.reaction_total).
    shares = []
    comm_total = domain.Comm.total

    def total(self, t):
        if t.dim() == 2:
            shares.append(t.clone())
        return comm_total(self, t)

    domain.Comm.total = total
    try:
        step = domain.make_sharded_solver_step(scene, ring, spec, solver)
        rstep = domain.make_sharded_rigid_step(scene)
        comm = domain.Comm(ring)
        rec = {k: [] for k in ("dt", "diag", "overflow", "count", "force",
                               "share", "held")}
        for _ in range(case["frames"]):
            rec["held"].append(int(state.fluid.mask.sum()))
            state = step(state)
            rec["dt"].append(float(state.dt))
            rec["diag"].append(state.diag.tolist())
            rec["overflow"].append(int(state.overflow))
            rec["count"].append(int(comm.sum(state.fluid.mask.sum())[0]))
            rec["force"].append(state.rigid.force.numpy().copy())
            rec["share"].append(shares.pop().numpy() if shares else
                                np.zeros_like(rec["force"][-1]))
            state = rstep(state)
    finally:
        domain.Comm.total = comm_total
    f = state.fluid
    m = f.mask
    out[f"{name}/pos"] = f.pos[m].numpy()
    out[f"{name}/vel"] = f.vel[m].numpy()
    out[f"{name}/oid"] = f.oid[m].numpy()
    for key, vals in rec.items():
        out[f"{name}/{key}"] = np.asarray(vals)
    for key, val in _body(state.rigid).items():
        out[f"{name}/body_{key}"] = val
    out[f"{name}/body_pos"] = state.rigid.pos.numpy()


def _rank_cases(ring, cases: list, out_dir: str) -> str:
    out: dict = {}
    for case in cases:
        _run_case(ring, case, out)
    path = os.path.join(out_dir, f"rank{ring.rank}.npz")
    np.savez(path, **out)
    return path


def _gather(ranks: list[dict], name: str) -> dict:
    """A case's valid rows of every rank in oid order, rank 0's per-frame
    records and body (the tests hold every rank's to rank 0's), and every
    rank's shares and held counts."""
    oid = np.concatenate([r[f"{name}/oid"] for r in ranks])
    order = np.argsort(oid)
    got = {k: np.concatenate([r[f"{name}/{k}"] for r in ranks])[order]
           for k in ("pos", "vel", "oid")}
    for key in ("dt", "diag", "overflow", "count", "force", "body_centroid",
                "body_vel", "body_omega", "body_pos"):
        got[key] = ranks[0][f"{name}/{key}"]
    got["body"] = {k: got[f"body_{k}"] for k in ("centroid", "vel", "omega")}
    got["shares"] = np.stack([r[f"{name}/share"] for r in ranks])
    got["held"] = np.stack([r[f"{name}/held"] for r in ranks])
    got["ranks"] = ranks
    return got


# ---------------------------------------------------------------------------
# References
# ---------------------------------------------------------------------------

def _single(solver, start, frames, fluid=None):
    """The port's single-device frames: per frame dt, diag and the body's
    force (before the rigid step), the final rows in oid order and the
    body. Beside them the same frames sharded over a world of one (no
    process group) in lockstep: `world1` lists what parts from the
    single-device frame's bits (PBF's sharded diag[1] is JAX's sharded
    telemetry, not compared)."""
    raw = parse_config(_cfg(solver, start, fluid))
    sim = Simulation(raw, device="cpu")
    scene = sim.scene
    ring = multihost.global_ring("cpu")
    spec = domain.make_spec(scene, 1)
    state = domain.init_sharded_solver(ring, spec, scene, scene.fluid_pos0,
                                       solver)
    step = domain.make_sharded_solver_step(scene, ring, spec, solver)
    rstep = domain.make_sharded_rigid_step(scene)
    cols = [0, 2, 3] if solver == "pbf" else [0, 1, 2, 3]
    rec = {"dt": [], "diag": [], "force": []}
    world1 = []
    for k in range(frames):
        sim.step()
        state = step(state)
        rec["dt"].append(float(sim.state.dt))
        rec["diag"].append(sim.state.diag.tolist())
        rec["force"].append(sim.state.rigid.force.numpy().copy())
        sim.rigid_step()
        state = rstep(state)
        got, want = state.fluid, sim.state.fluid
        n = scene.n_fluid
        pairs = dict(dt=(state.dt, sim.state.dt),
                     diag=(state.diag[cols], sim.state.diag[cols]),
                     mask=(got.mask, torch.arange(spec.cap) < n),
                     pos=(got.pos[:n], want.pos), vel=(got.vel[:n], want.vel),
                     oid=(got.oid[:n], want.oid),
                     **{f"body {f}": (a, b) for f, a, b in zip(
                         state.rigid._fields, state.rigid, sim.state.rigid)})
        world1 += [f"frame {k}: {key}" for key, (a, b) in pairs.items()
                   if not torch.equal(a, b)]
    f = sim.state.fluid
    order = np.argsort(f.oid.numpy())
    return dict(pos=f.pos.numpy()[order], vel=f.vel.numpy()[order],
                body=_body(sim.state.rigid), world1=world1,
                **{k: np.asarray(v) for k, v in rec.items()})


def _jax_start(solver):
    """The JAX package's initial sharded state of the immersed start as
    `solver`, with the body: its numpy leaves, its fluid and rigid steps."""
    import jax
    import jax.numpy as jnp

    from cfd_taichi_tpu.config import parse_config as jparse
    from cfd_taichi_tpu.models import base as jbase
    from cfd_taichi_tpu.parallel import domain as jdomain
    from cfd_taichi_tpu.runner import Simulation as JaxSimulation

    sim = JaxSimulation(jparse(_cfg(solver, "immersed")))
    st, arrays = sim.scene.static, sim.scene.arrays
    mesh = jdomain.make_mesh(NDEV)
    spec = jdomain.make_spec(st, NDEV)
    state = jdomain.init_sharded_solver(
        mesh, spec, st, sim.scene.fluid_pos0, solver,
        rigid=jbase.init_rigid_state(sim.scene))
    leaves, treedef = jax.tree_util.tree_flatten(state)
    leaves = [np.asarray(a).copy() for a in leaves]
    consts = None
    if solver == "pcisph":
        from cfd_taichi_tpu.models import pcisph as jpcisph

        consts = {"delta": float(jpcisph.init_state(sim.scene).extra[0])}
    return dict(
        leaves=leaves,
        start=jax.tree_util.tree_unflatten(treedef,
                                           [jnp.asarray(a) for a in leaves]),
        fstep=jdomain.make_sharded_solver_step(st, arrays, mesh, spec,
                                               solver, consts=consts),
        rstep=jdomain.make_sharded_rigid_step(st, arrays))


def _jax_run(start: dict, frames: int) -> dict:
    from cfd_taichi_tpu.parallel import domain as jdomain

    state = start["start"]
    rec = {"dt": [], "diag": [], "force": []}
    for _ in range(frames):
        state = start["fstep"](state)
        rec["dt"].append(float(state.dt))
        rec["diag"].append(np.asarray(state.diag).tolist())
        rec["force"].append(np.stack(
            [np.asarray(c) for c in state.rigid.force.astuple()], axis=-1))
        state = start["rstep"](state)
    pos, vel = jdomain.unshard(state.fluid)
    mask = np.asarray(state.fluid.mask)
    order = np.argsort(np.asarray(state.fluid.oid)[mask])
    return dict(pos=pos[order], vel=vel[order], body=_body(state.rigid),
                overflow=int(np.asarray(state.overflow)),
                **{k: np.asarray(v) for k, v in rec.items()})


# ---------------------------------------------------------------------------
# The spawn
# ---------------------------------------------------------------------------

def _with_jax(solvers, cases, tmp_dir, local=None):
    """Start JAX and the port's ranks from one immersed state for each of
    `solvers`, then run the ranks on those cases and `cases` in a thread
    while JAX steps here, and `local()` after it. Returns (ranks, JAX
    results, local's result)."""
    import jax.numpy as jnp

    import cfd_taichi_tpu.models.dfsph as jdfsph

    starts, cases = {}, list(cases)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jdfsph, "BAND_DTYPE", jnp.float32)
        for solver in solvers:
            name = f"jax_{solver}"
            starts[name] = _jax_start(solver)
            # JAX's band engine with f32 coefficients against the port's
            # recompute engine, as tests/test_torch_sharding.py holds them
            cases.append(dict(name=name, solver=solver, start="immersed",
                              frames=FRAMES, leaves=starts[name]["leaves"],
                              coef_budget=0))
        with concurrent.futures.ThreadPoolExecutor(1) as pool:
            ranks = pool.submit(
                launch.spawn, _rank_cases, NDEV, backend="gloo",
                device="cpu", args=(cases, str(tmp_dir)), timeout=600,
                threads=1)
            ref = {name: _jax_run(s, FRAMES) for name, s in starts.items()}
            with _one_thread():
                mine = local() if local is not None else None
            ranks = [dict(np.load(p)) for p in ranks.result()]
    return ranks, ref, mine


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    cases = [dict(name=f"{s}_{start}", solver=s, start=start, frames=FRAMES)
             for s in SOLVERS for start in STARTS]
    # two slabs hold most of the dam: slack 4 gives them room
    cases.append(dict(name="empty_slab", solver="dfsph", start="immersed",
                      frames=FRAMES, fluid=EMPTY_SLAB_FLUID, slack=4.0))

    def single():
        out = {f"{s}_{start}": _single(s, start, FRAMES)
               for s in SOLVERS for start in STARTS}
        out["empty_slab"] = _single("dfsph", "immersed", FRAMES,
                                    EMPTY_SLAB_FLUID)
        return out

    ranks, jax_ref, single = _with_jax(("dfsph", "wcsph"), cases,
                                       tmp_path_factory.mktemp("world4"),
                                       single)
    return dict(ranks=ranks, jax_ref=jax_ref, single=single)


def _assert_match(got: dict, ref: dict, solver: str, tag: str) -> None:
    assert got["pos"].shape == ref["pos"].shape, f"{tag}: particle count"
    err = float(np.abs(got["pos"] - ref["pos"]).max())
    np.testing.assert_allclose(got["dt"], ref["dt"], rtol=DT_RTOL,
                               err_msg=f"{tag}: dt")
    cols = [0, 2] if solver == "dfsph" else [0]
    np.testing.assert_array_equal(got["diag"][:, cols], ref["diag"][:, cols],
                                  err_msg=f"{tag}: iteration counts")
    scale = float(np.abs(ref["force"]).max())
    ferr = [float(np.abs(g - w).max()) for g, w in
            zip(got["force"], ref["force"])]
    berr = {k: float(np.abs(got["body"][k] - ref["body"][k]).max())
            for k in BODY_TOL}
    bar = {k: max(tol, BODY_RTOL[k] * float(np.abs(ref["body"][k]).max()))
           for k, tol in BODY_TOL.items()}
    print(f"{tag}: pos err {err:.3e}; largest force {scale:.6e}, frames' "
          f"force err {[f'{e:.3e}' for e in ferr]}; body err {berr} "
          f"(bars {bar})")
    assert err <= POS_TOL, f"{tag}: positions differ by {err}"
    for k, e in enumerate(ferr):
        assert e <= FORCE_TOL * scale, f"{tag}: frame {k} force err {e}"
    for k, tol in bar.items():
        assert berr[k] <= tol, f"{tag}: body {k} differs by {berr[k]}"


def _assert_ranks_agree(got: dict, name: str) -> None:
    """Every rank ends with the same body, dt and diag, bit for bit."""
    for r in got["ranks"]:
        for key in ("dt", "diag", "force", "body_centroid", "body_vel",
                    "body_omega", "body_pos"):
            np.testing.assert_array_equal(r[f"{name}/{key}"], got[key],
                                          err_msg=f"{name}: {key}")


# ---------------------------------------------------------------------------
# Tests
# ---------------------------------------------------------------------------

def test_coupled_cfg_is_test_sharding_coupled_cfg():
    import test_sharding

    assert COUPLED_CFG == test_sharding.COUPLED_CFG
    assert NDEV == test_sharding.NDEV


def test_the_body_straddles_a_slab_face():
    """The immersed start's cube spans x 0.525-0.625, across the 0.6 face
    of slabs 1 and 2, and sits in the water; the written one hangs more
    than h over it."""
    scene = build_scene(parse_config(_cfg("dfsph", "immersed")),
                        device="cpu")
    spec = domain.make_spec(scene, NDEV)
    x = scene.rigid0.pos[:, spec.axis]
    face = spec.lo + 2 * spec.slab_w
    assert spec.axis == 0 and abs(face - 0.6) < 1e-6
    assert float(x.min()) < face < float(x.max())
    assert scene.n_rigid < scene.n_fluid
    top = float(scene.fluid_pos0[:, 1].max())
    assert float(scene.rigid0.pos[:, 1].min()) < top
    written = build_scene(parse_config(_cfg("dfsph", "written")),
                          device="cpu")
    assert float(written.rigid0.pos[:, 1].min()) - top > written.h


@pytest.mark.parametrize("solver", ["dfsph", "wcsph"])
def test_coupled_sharded_step_matches_jax_sharded(world4, solver):
    name = f"jax_{solver}"
    got = _gather(world4["ranks"], name)
    ref = world4["jax_ref"][name]
    _assert_match(got, ref, solver, name)
    assert ref["overflow"] == 0 and int(got["overflow"][-1]) == 0
    assert float(np.abs(ref["force"][0]).max()) > 0.0


@pytest.mark.parametrize("start", STARTS)
@pytest.mark.parametrize("solver", SOLVERS)
def test_coupled_sharded_frames_match_single_device(world4, solver, start):
    name = f"{solver}_{start}"
    got = _gather(world4["ranks"], name)
    ref = world4["single"][name]
    _assert_match(got, ref, solver, name)
    _assert_ranks_agree(got, name)
    assert int(np.max(got["overflow"])) == 0
    assert np.all(got["count"] == ref["pos"].shape[0])
    charged = solver != "pbf" and start == "immersed"
    assert (float(np.abs(ref["force"][0]).max()) > 0.0) == charged
    if solver == "pbf":      # PBF steps the fluid as if the body were not
        assert not np.any(got["force"])            # there; the body falls
        assert float(got["body"]["vel"][1]) < 0.0


@pytest.mark.parametrize("solver", COUPLED)
def test_reaction_across_the_slab_face_is_charged_once(world4, solver):
    """The owned rows of ranks 1 and 2, on either side of the face, both
    charge the body in the first frame, and the force is the sum of the
    ranks' shares, which test_coupled_sharded_frames_match_single_device
    holds to the single-device force: a pair charged by a ghost row too
    would count twice."""
    name = f"{solver}_immersed"
    got = _gather(world4["ranks"], name)
    charged = [r for r in range(NDEV) if np.any(got["shares"][r, 0])]
    assert charged == [1, 2], charged
    scale = float(np.abs(got["force"]).max())
    for k in range(FRAMES):
        np.testing.assert_allclose(got["shares"][:, k].sum(axis=0),
                                   got["force"][k], rtol=0,
                                   atol=1e-6 * scale)


def test_coupled_empty_slab(world4):
    """Slab 3 holds no particle and no halo row: its rank steps an empty
    set and joins every sum, the reaction's and the quirk table's."""
    got = _gather(world4["ranks"], "empty_slab")
    held = got["held"][:, 0]
    assert held[3] == 0 and held[0] > 0 and held[1] > 0, held
    assert not np.any(got["shares"][3])
    _assert_match(got, world4["single"]["empty_slab"], "dfsph",
                  "empty slab")
    _assert_ranks_agree(got, "empty_slab")
    assert int(np.max(got["overflow"])) == 0


@pytest.mark.parametrize("start", STARTS)
@pytest.mark.parametrize("solver", SOLVERS)
def test_world_of_one_is_the_single_device_frame(world4, solver, start):
    """One slab, no neighbour: the coupled sharded frame is the
    single-device frame bit for bit, frame by frame: positions,
    velocities, order, dt, diag and every leaf of the body."""
    single = world4["single"][f"{solver}_{start}"]
    assert single["world1"] == []


def _quirk_shard(owned, summed=None, tables=None):
    """A rank's hooks for base.rho_quirk alone: `total` records the rank's
    table, or returns the sum over the ranks."""
    def total(t):
        if tables is not None:
            tables.append(t)
            return t
        return summed

    return base.Shard(sync=None, owned=owned, upd=owned, sum=None, max=None,
                      loop={}, total=total)


@pytest.mark.parametrize("n_rigid", [7, 40, 63])
def test_sharded_rho_quirk_table_is_rho_quirk(n_rigid):
    """40 fluid rows in seeding-order ids, dealt to 4 ranks; each rank also
    holds ghosts (other ranks' rows, not owned) and padding-like rows
    (oid -1). The table built from owned rows and summed over the ranks
    reads as the single-device quirk, bit for bit, on every rank,
    with fewer rigid than fluid particles and with more (j clipped to the
    last fluid id). A world of one is the single-device quirk too."""
    n = 40
    rng = np.random.default_rng(5)
    rho = torch.tensor(rng.uniform(900.0, 1100.0, n), dtype=torch.float32)
    oid = torch.tensor(rng.permutation(n), dtype=torch.int32)
    want = base.rho_quirk(rho, oid, n_rigid)
    one = base.rho_quirk(rho, oid, n_rigid,
                         _quirk_shard(torch.ones(n, dtype=torch.bool),
                                      tables=[]), n)
    assert torch.equal(one, want)
    owner = torch.tensor(rng.integers(0, NDEV, n))
    ranks = []
    for r in range(NDEV):
        ghost = torch.tensor(rng.random(n) < 0.3) & (owner != r)
        rows = torch.nonzero((owner == r) | ghost).squeeze(1)
        r_rho = torch.cat([rho[rows], torch.full((3,), 777.0)])
        r_oid = torch.cat([oid[rows], torch.full((3,), -1,
                                                 dtype=torch.int32)])
        owned = torch.cat([owner[rows] == r, torch.zeros(3, dtype=bool)])
        ranks.append((r_rho, r_oid, owned))
    tables = []
    for r_rho, r_oid, owned in ranks:
        base.rho_quirk(r_rho, r_oid, n_rigid,
                       _quirk_shard(owned, tables=tables), n)
    summed = sum(tables)
    assert summed.shape == (min(n_rigid, n),)
    for r_rho, r_oid, owned in ranks:
        got = base.rho_quirk(r_rho, r_oid, n_rigid,
                             _quirk_shard(owned, summed=summed), n)
        assert torch.equal(got, want)


def test_pcisph_stiffness_counts_the_body_as_jax_does():
    """PCISPH's init stiffness (`pcisph.stiffness`, which the sharded step
    takes from the global seed) counts the body's particles as neighbours
    where the body takes part in the step, as JAX's neighbour list holds
    them (`cfd_taichi_tpu/models/pcisph.py:43-58`). In the immersed start
    the densest particle neighbours the body, and delta falls from 510.81
    to 153.01; an inactive body leaves it. To JAX's at
    tests/test_torch_pcisph.py's rtol 1e-6 (equal bit for bit here,
    printed)."""
    import dataclasses

    from cfd_taichi_tpu.config import parse_config as jparse
    from cfd_taichi_tpu.models import pcisph as jpcisph
    from cfd_taichi_tpu.scene import build_scene as jbuild
    from cfd_taichi_tpu_torch.models import pcisph

    raw = _cfg("pcisph", "immersed")
    want = float(jpcisph.init_state(jbuild(jparse(raw))).extra[0])
    scene = build_scene(parse_config(raw), device="cpu")
    got = float(pcisph.stiffness(scene))
    alone = float(pcisph.stiffness(dataclasses.replace(scene,
                                                       rigid_active=False)))
    print(f"delta {got!r} (JAX {want!r}; without the body {alone!r})")
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert got < 0.5 * alone
    raw["solid"]["active"] = False
    inactive = build_scene(parse_config(raw), device="cpu")
    assert float(pcisph.stiffness(inactive)) == alone


def test_sharded_state_from_numpy_reads_the_body():
    """A coupled scene's state from leaves: the body's fifteen leaves after
    the fluid's, whole on every rank; without them an empty body."""
    from cfd_taichi_tpu_torch.utils import io

    scene = build_scene(parse_config(_cfg("dfsph", "immersed")),
                        device="cpu")
    ring = multihost.Ring(1, NDEV, torch.device("cpu"), None)
    spec = domain.make_spec(scene, NDEV)
    body = base.init_rigid_state(scene)
    blocks = [domain.init_sharded_solver(
        multihost.Ring(r, NDEV, torch.device("cpu"), None), spec, scene,
        scene.fluid_pos0, "dfsph") for r in range(NDEV)]

    def cat(get):
        return np.concatenate([get(b).numpy() for b in blocks])

    fluid = [cat(lambda b, c=c: b.fluid.pos[:, c]) for c in range(3)]
    fluid += [cat(lambda b, c=c: b.fluid.vel[:, c]) for c in range(3)]
    fluid += [cat(lambda b: b.fluid.mask), cat(lambda b: b.fluid.oid),
              cat(lambda b: b.extras[0])]
    tail = [np.float32(scene.dt0), np.float32(0.0), np.zeros(4, np.float32)]
    leaves = io.rigid_to_numpy(body)
    assert len(leaves) == io.RIGID_LEAVES
    got = domain.sharded_state_from_numpy(ring, spec, "dfsph",
                                          fluid + tail + leaves)
    for a, b in zip(got.rigid, body):
        assert torch.equal(a, b)
    assert torch.equal(got.fluid.pos, blocks[1].fluid.pos)
    bare = domain.sharded_state_from_numpy(ring, spec, "dfsph", fluid + tail)
    assert bare.rigid.pos.shape == (0, 3)
    with pytest.raises(ValueError, match="sharded state leaves"):
        domain.sharded_state_from_numpy(ring, spec, "dfsph", fluid)


@pytest.mark.slow
@pytest.mark.parametrize("solver", ["pcisph", "iisph"])
def test_coupled_iterative_solver_matches_jax_sharded(tmp_path, solver):
    ranks, ref, _ = _with_jax((solver,), [], tmp_path)
    name = f"jax_{solver}"
    got = _gather(ranks, name)
    _assert_match(got, ref[name], solver, name)
    assert ref[name]["overflow"] == 0
