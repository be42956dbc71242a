"""The body's reaction list and its stream, held on the CPU:

* the list that `rigid.rigid_side_list` builds once a step (plain version
  `rigid_side_list_plain`, which the CPU runs): each row's pairs, as a
  set, equal to the fluid neighbours of JAX's `rigid_dense.
  build_rigid_side` (idx where mask, with no overflow), on perf/inputs.
  coupled_inputs of two scenes: TINY's block (tests/test_solvers.py:
  14-23) with a box body across its water surface, and RIGID_CFG
  (tests/test_rigid.py:12-21);
* the stream (`rigid_side_force_list`, plain version
  `rigid_side_force_list_plain`) over that list against JAX's
  `rigid_dense.rigid_side_force` and against the walk's plain version
  (`rigid_side_force_plain`), the reaction (the output less the incoming
  force) to 1e-5 of its largest magnitude, the tolerance of
  tests/test_torch_rigid.py's reaction: the same f32 pair terms summed in
  another order;
* the list's rows (`rigid.rigid_side_rows`, plain version
  `rigid_side_rows_plain`): every row's count at most its walk's
  candidates and its warp's room, each warp's room its rows' largest
  candidate count, the rows' slots disjoint and inside the list; a body
  with no fluid near leaves the force as it was; on a rank of a sharded
  step the rows it does not own add nothing;
* the solvers' choice: coupled DFSPH and PCISPH steps stream the list
  (its rows and the list built once a step, its size read with the pair
  count: one host read), and within `dfsph.walked_reaction` walk as IISPH
  and WCSPH do, to the same positions and counts;
* the wrappers take the plain versions on the CPU only.

JAX runs once a module (a fixture), torch on one thread.
"""

import contextlib
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfd_taichi_tpu import scene as jscene
from cfd_taichi_tpu.config import parse_config as jparse_config
from cfd_taichi_tpu.models import base as jbase
from cfd_taichi_tpu.ops import rigid_dense
from cfd_taichi_tpu.ops.vec import V3
from cfd_taichi_tpu_torch import Simulation, build_scene
from cfd_taichi_tpu_torch.config import parse_config
from cfd_taichi_tpu_torch.models import base, dfsph, pcisph
from cfd_taichi_tpu_torch.ops import neighbors as nb
from cfd_taichi_tpu_torch.ops import rigid as R
from cfd_taichi_tpu_torch.ops import stencil
from cfd_taichi_tpu_torch.perf import inputs
from test_torch_dfsph_rigid import rigid_cfg
from test_torch_rigid import _assert_scaled

RHO0 = 1000.0
SEED = 11
# TINY's block, Akinci walls, a box body of 0.25 across the water's top
# face (y 0.4) and more than one warp of voxels
TINY_BODY = {
    "scene": {"box_min": [0.0, 0.0, 0.0], "box_max": [0.6, 0.8, 0.6],
              "particle_radius": 0.025, "gravity": 9.8},
    "solver": {"name": "dfsph", "delta_time": 4e-4, "iter_cnt": 1,
               "boundary_handle": True, "fs_couple": True},
    "fluid": {"start_pos": [0.15, 0.1, 0.15], "water_size": [0.3, 0.3, 0.3]},
    "solid": {"mesh": "builtin:cube1", "voxel_radius": 0.025,
              "rho_0": 500, "scale": 0.25, "pos_offset": [0.2, 0.3, 0.2],
              "attitude_offset": [0.0, 0.0, 0.0], "fill": True,
              "active": True},
}
SCENES = {"tiny": TINY_BODY, "rigid_cfg": rigid_cfg()}


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_side(st, arrays, pos, rpos, u, force):
    """JAX's list over the cell-sorted `pos` (sorted again inside, as its
    prepare does: the identity) and its reaction of `u` on `force`."""
    dp = jbase.build_dense_prep(st, arrays, pos, st.band_nb_wide, st.band_B)
    rs = rigid_dense.build_rigid_side(st, rpos, arrays.rigid_volume, dp.pos,
                                      dp.starts, RHO0, Kf=st.K)
    fr = rigid_dense.rigid_side_force(rs, u[dp.perm], jnp.zeros_like(u),
                                      force)
    return dict(perm=dp.perm, idx=rs.idx, mask=rs.mask, over=rs.overflow,
                force=fr)


_jax_side_jit = jax.jit(_jax_side, static_argnums=0)


def _v3(v):
    return np.stack([np.asarray(c) for c in v.astuple()], axis=-1)


@pytest.fixture(scope="module")
def cases():
    """perf/inputs.coupled_inputs of each scene on the CPU, its list, and
    JAX's list and reaction on the same inputs."""
    out = {}
    for tag, raw in SCENES.items():
        sc = build_scene(parse_config(copy.deepcopy(raw)), device="cpu")
        x = inputs.coupled_inputs(sc, SEED, device="cpu")
        js = jscene.build_scene(jparse_config(copy.deepcopy(raw)))
        want = _jax_side_jit(
            js.static, js.arrays, V3.from_rows(x["p"].numpy()),
            V3.from_rows(x["rpos"].numpy()), jnp.asarray(x["u"].numpy()),
            V3.from_rows(x["force"].numpy()))
        np.testing.assert_array_equal(np.asarray(want["perm"]),
                                      np.arange(sc.n_fluid))
        offs = R.rigid_side_rows(x["rpos"], x["st"], sc.grid)
        x["offs"] = offs
        x["side"] = R.rigid_side_list(x["rpos"], x["rvol"], x["p"], x["st"],
                                      sc.grid, sc.h, RHO0, offs,
                                      R.list_slots(offs))
        x["jax"] = {k: np.asarray(v) if not isinstance(v, V3) else _v3(v)
                    for k, v in want.items()}
        out[tag] = x
    return out


@pytest.mark.parametrize("tag", SCENES)
def test_list_pairs_equal_jax_build_rigid_side(cases, tag):
    x = cases[tag]
    want = x["jax"]
    assert int(want["over"]) == 0
    rows, i, _ = R.side_pairs(x["side"])
    got = [set() for _ in range(x["rpos"].shape[0])]
    for j, k in zip(rows.tolist(), i.tolist()):
        assert k not in got[j], (j, k)       # each pair once
        got[j].add(k)
    ref = [set(want["idx"][j][want["mask"][j]].tolist())
           for j in range(len(got))]
    assert got == ref
    # some rows near the water, some not: the rows differ in length
    cnt = x["side"].cnt
    assert int(cnt.max()) > 0 and int(cnt.min()) < int(cnt.max())


@pytest.mark.parametrize("tag", SCENES)
def test_stream_matches_jax_and_the_walk(cases, tag):
    x = cases[tag]
    sc = x["sc"]
    stencil.reset_counts()
    got = R.rigid_side_force_list(x["side"], x["u"], x["force"])
    walk = R.rigid_side_force_plain(x["rpos"], x["rvol"], x["p"], x["st"],
                                    sc.grid, sc.h, RHO0, x["u"], x["force"])
    assert stencil.KERNELS["rigid_side_force_list"].plain_calls == 1
    assert stencil.KERNELS["rigid_side_force_list"].launches == 0
    f0 = x["force"].numpy()
    _assert_scaled(got.numpy() - f0, x["jax"]["force"] - f0, "against JAX")
    _assert_scaled(got.numpy() - f0, walk.numpy() - f0, "against the walk")


@pytest.mark.parametrize("tag", SCENES)
def test_rows_hold_their_pairs(cases, tag):
    """A row's count is at most its walk's candidates (the fluid in its
    cell's stencil) and its warp's room; the rows' slots are disjoint and
    inside the list."""
    x = cases[tag]
    g, side = x["grid"], x["side"]
    nr = x["rpos"].shape[0]
    cand = nb.stencil_counts(x["st"], g)[nb.cell_id(x["rpos"], g).long()]
    assert bool((side.cnt <= cand).all())
    base = side.base.long()
    # a warp's room: the gap from its first slot to the next warp's, over
    # the stride; its rows' largest candidate count
    first = torch.cat([base[::stencil.LIST_STRIDE],
                       torch.tensor([side.rec.shape[0]])])
    room = (first[1:] - first[:-1]) // stencil.LIST_STRIDE
    most = torch.stack([c.max() for c in cand.split(stencil.LIST_STRIDE)])
    assert torch.equal(room, most.long())
    warp = torch.arange(nr) // stencil.LIST_STRIDE
    assert bool((side.cnt.long() <= room[warp]).all())
    slots = [int(b) + stencil.LIST_STRIDE * t
             for b, c in zip(base.tolist(), side.cnt.tolist())
             for t in range(c)]
    assert len(set(slots)) == len(slots)
    assert max(slots) < side.rec.shape[0]
    assert R.list_slots(x["offs"]) == side.rec.shape[0]
    assert torch.equal(x["offs"][:-1] * stencil.LIST_STRIDE,
                       first[:-1])


def test_a_body_with_no_fluid_near_leaves_the_force():
    x = inputs.coupled_inputs(
        build_scene(parse_config(copy.deepcopy(TINY_BODY)), device="cpu"),
        SEED, device="cpu")
    sc = x["sc"]
    # the body moved to the box's top corner, far from the water
    far = x["rpos"] - x["rpos"].amin(dim=0) + torch.tensor([0.0, 0.55, 0.0])
    offs = R.rigid_side_rows(far, x["st"], sc.grid)
    side = R.rigid_side_list(far, x["rvol"], x["p"], x["st"], sc.grid, sc.h,
                             RHO0, offs, R.list_slots(offs))
    assert int(side.cnt.sum()) == 0
    assert torch.equal(R.rigid_side_force_list(side, x["u"], x["force"]),
                       x["force"])


def test_rows_a_rank_does_not_own_add_nothing(cases):
    """base.body_reaction on a rank (only `owned` of the hooks is read):
    u on the rows the rank does not own is never charged, whatever it
    holds, and the list agrees with the walk there too."""
    x = cases["tiny"]
    sc = x["sc"]
    rigid = base.init_rigid_state(sc)
    owned = torch.from_numpy(
        np.random.default_rng(SEED).uniform(size=sc.n_fluid) < 0.5)
    shard = base.Shard(sync=None, owned=owned, upd=owned, sum=None, max=None,
                       loop={}, total=None)
    noisy = torch.where(owned, x["u"], torch.full_like(x["u"], 1e6))
    args = (sc, rigid, x["p"], x["st"])
    got = base.body_reaction(*args, noisy, x["force"], shard, x["side"])
    mine = torch.where(owned, x["u"], torch.zeros_like(x["u"]))
    assert torch.equal(got, base.body_reaction(*args, mine, x["force"],
                                               side=x["side"]))
    walk = base.body_reaction(*args, noisy, x["force"], shard)
    f0 = x["force"].numpy()
    _assert_scaled(got.numpy() - f0, walk.numpy() - f0, "against the walk")


@pytest.mark.parametrize("solver", ["dfsph", "pcisph"])
def test_the_loop_streams_the_list_and_walked_reaction_walks(solver):
    """Two steps of TINY_BODY squeezed by 0.85 (pressure acts): the
    step's rows and list built once and streamed once a loop iteration,
    one host read outside the trips; within `dfsph.walked_reaction` the
    walk instead, to the same counts and positions within 5e-6 (the plain
    versions sum the same terms in another order)."""
    raw = copy.deepcopy(TINY_BODY)
    raw["solver"]["name"] = solver
    step = {"dfsph": dfsph.step, "pcisph": pcisph.step}[solver]
    runs = {}
    for walk in (False, True):
        sim = Simulation(parse_config(copy.deepcopy(raw)), device="cpu")
        sim.state = inputs.squeezed(sim.state)
        stencil.reset_counts()
        sim.scene.loop_graphs.reset()
        iters, forces = 0.0, []
        for _ in range(2):
            with (dfsph.walked_reaction() if walk
                  else contextlib.nullcontext()):
                sim.state = step(sim.scene, sim.state)
            forces.append(sim.state.rigid.force)
            sim.rigid_step()
            iters += float(sim.state.diag[2 if solver == "dfsph" else 0])
        k = stencil.KERNELS
        calls = {name: k[name].plain_calls for name in (
            "rigid_side_force", "rigid_side_rows", "rigid_side_list",
            "rigid_side_force_list")}
        assert calls == ({"rigid_side_force": iters, "rigid_side_rows": 0,
                          "rigid_side_list": 0,
                          "rigid_side_force_list": 0} if walk else
                         {"rigid_side_force": 0, "rigid_side_rows": 2,
                          "rigid_side_list": 2,
                          "rigid_side_force_list": iters}), calls
        assert sim.scene.loop_graphs.reads == 2
        runs[walk] = (sim.state, torch.stack(forces))
    (a, fa), (b, fb) = runs[False], runs[True]
    assert torch.equal(a.diag[[0, 2]], b.diag[[0, 2]])
    assert torch.equal(a.fluid.oid, b.fluid.oid)
    assert float((a.fluid.pos - b.fluid.pos).abs().max()) < 5e-6
    _assert_scaled(fa.numpy(), fb.numpy(), "the body's force")


def test_wrappers_take_the_plain_version_on_the_cpu_only(cases):
    x = cases["rigid_cfg"]
    sc, side = x["sc"], x["side"]
    meta = R.SideList(*(t.to("meta") for t in side))
    with pytest.raises(ValueError, match="no kernel"):
        R.rigid_side_force_list(meta, x["u"].to("meta"),
                                x["force"].to("meta"))
    with pytest.raises(ValueError, match="no kernel"):
        R.rigid_side_list(x["rpos"].to("meta"), x["rvol"], x["p"], x["st"],
                          sc.grid, sc.h, RHO0, x["offs"],
                          side.rec.shape[0])
    with pytest.raises(ValueError, match="no kernel"):
        R.rigid_side_rows(x["rpos"].to("meta"), x["st"], sc.grid)
