"""The body's reaction list on the ordered lane-group walk, and its stream
of the solver's per-fluid value and scale, held on the CPU:

* the list's stores (csrc/rigid_side_force.cu, `SideStore`) modelled over
  the walk's batches (tests/test_torch_rigid_walk.py, `model_batches`):
  each batch's charged hits ranked among the group's lanes, the hit of
  rank q stored at slot found + q, give `rigid_side_list_plain`'s
  records, counts and bases bit for bit, for the groups and chunks the
  kernel was swept over, on TINY's block with a box body
  (tests/test_torch_rigid_stream.py);
* `rigid_side_force_list_plain` of (k, m) bit-equal to it of (k m, 1.0),
  and with a rank's `owned` mask to it of where(owned, k m, 0), on that
  scene and RIGID_CFG (tests/test_rigid.py:12-21), and to JAX's
  `rigid_dense.rigid_side_force` of k m to 1e-5 of the reaction's scale;
* `base.body_reaction` of (k, m), streaming and walking, on one device
  and on a rank, bit-equal to its call with u = k m formed in torch;
* DFSPH's density loop hands the stream its rate's k and m, and forms
  no u over the rows;
* the wrapper takes the plain version on the CPU only, with the mask too.

JAX runs once a module (a fixture), torch on one thread.
"""

import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfd_taichi_tpu import scene as jscene
from cfd_taichi_tpu.config import parse_config as jparse_config
from cfd_taichi_tpu.ops.vec import V3
from cfd_taichi_tpu_torch import Simulation, build_scene
from cfd_taichi_tpu_torch.config import parse_config
from cfd_taichi_tpu_torch.models import base, dfsph
from cfd_taichi_tpu_torch.ops import rigid as R
from cfd_taichi_tpu_torch.ops import stencil
from cfd_taichi_tpu_torch.ops.smoothing import (CubicConstants,
                                                cubic_grad_coeff, f32,
                                                ieee_sqrt)
from cfd_taichi_tpu_torch.perf import inputs
from test_torch_rigid import _assert_scaled
from test_torch_rigid_stream import SCENES, TINY_BODY, _jax_side_jit
from test_torch_rigid_walk import model_batches

RHO0 = 1000.0
SEED = 11
WARP = 32


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _owned(n: int) -> torch.Tensor:
    return torch.from_numpy(
        np.random.default_rng(SEED).uniform(size=n) < 0.5)


@pytest.fixture(scope="module")
def scenes():
    """perf/inputs.coupled_inputs of each scene on the CPU (its `k` the
    value, m the scale), its list, and JAX's reaction of u = k m."""
    out = {}
    for tag, raw in SCENES.items():
        sc = build_scene(parse_config(copy.deepcopy(raw)), device="cpu")
        x = inputs.coupled_inputs(sc, SEED, device="cpu")
        offs = R.rigid_side_rows(x["rpos"], x["st"], sc.grid)
        x["offs"] = offs
        x["side"] = R.rigid_side_list(x["rpos"], x["rvol"], x["p"], x["st"],
                                      sc.grid, sc.h, RHO0, offs,
                                      R.list_slots(offs))
        x["km"] = x["k"] * f32(sc.particle_m)
        js = jscene.build_scene(jparse_config(copy.deepcopy(raw)))
        want = _jax_side_jit(
            js.static, js.arrays, V3.from_rows(x["p"].numpy()),
            V3.from_rows(x["rpos"].numpy()), jnp.asarray(x["km"].numpy()),
            V3.from_rows(x["force"].numpy()))
        x["jax_force"] = np.stack(
            [np.asarray(c) for c in want["force"].astuple()], axis=-1)
        out[tag] = x
    return out


def model_list(x, g, c):
    """The list kernel's stores over the walk's batches of G lanes and C
    candidates a lane a round: (base, cnt, {slot: record}). A batch's hits
    sit on lanes 0, 1, ...; a lane's hit is charged where r <= h, and the
    charged hit of rank q among the group's goes to slot found + q of the
    row, found counting the row's earlier charged hits."""
    order, _ = model_batches(x, g, c)
    hf = CubicConstants.of(x["h"]).h
    nr = x["rpos"].shape[0]
    offs = x["offs"].tolist()
    base_ = [WARP * offs[j // WARP] + j % WARP for j in range(nr)]
    cnt = [0] * nr
    stored = {}
    for j, hits in order.items():
        coeff_v = f32(RHO0) * x["rvol"][j]
        for b0 in range(0, len(hits), g):         # a batch's lanes
            batch = hits[b0:b0 + g]
            d = torch.tensor(np.array([h[1:] for h in batch], np.float32))
            r2 = d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1] + d[:, 2] * d[:, 2]
            r = ieee_sqrt(torch.clamp(r2, min=f32(1e-24)))
            coeff = coeff_v * cubic_grad_coeff(r, x["h"])
            gvec = (-d) * coeff[:, None]
            charged = (r <= hf).tolist()
            for lane, hit in enumerate(batch):
                if not charged[lane]:
                    continue
                rank = sum(charged[:lane])      # the ballot's rank
                slot = base_[j] + WARP * (cnt[j] + rank)
                stored[slot] = (hit[0], *gvec[lane].view(torch.int32)
                                .tolist())
            cnt[j] += sum(charged)
    return base_, cnt, stored


@pytest.mark.parametrize("g,c", [(16, 2), (16, 1), (8, 2), (8, 1)])
def test_ranked_stores_are_the_plain_list(scenes, g, c):
    x = scenes["tiny"]
    side = x["side"]
    base_, cnt, stored = model_list(x, g, c)
    assert base_ == side.base.tolist() and cnt == side.cnt.tolist()
    assert sum(cnt) > 50 and max(cnt) > g      # rows of several batches
    written = torch.nonzero(side.rec[:, 0] >= 0).flatten().tolist()
    assert sorted(stored) == written
    for slot, rec in stored.items():
        assert tuple(side.rec[slot].tolist()) == rec, slot


@pytest.mark.parametrize("tag", SCENES)
def test_stream_of_value_and_scale_is_the_stream_of_their_product(scenes,
                                                                  tag):
    x = scenes[tag]
    side, force, m = x["side"], x["force"], x["sc"].particle_m
    got = R.rigid_side_force_list_plain(side, x["k"], force, m)
    want = R.rigid_side_force_list_plain(side, x["km"], force, 1.0)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert not torch.equal(got, force)
    f0 = force.numpy()
    _assert_scaled(got.numpy() - f0, x["jax_force"] - f0, "against JAX")
    owned = _owned(x["p"].shape[0])
    mine = torch.where(owned, x["km"], torch.zeros_like(x["km"]))
    got = R.rigid_side_force_list_plain(side, x["k"], force, m, owned)
    want = R.rigid_side_force_list_plain(side, mine, force)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("tag", SCENES)
@pytest.mark.parametrize("ranked", [False, True])
def test_body_reaction_of_value_and_scale(scenes, tag, ranked):
    """The reaction of (k, m), streamed over the list and walked, is the
    reaction of u = k m formed in torch (on a rank: where(owned, k m, 0),
    only `owned` of the rank's hooks being read), bit for bit."""
    x = scenes[tag]
    sc = x["sc"]
    rigid = base.init_rigid_state(sc)
    shard = None
    u = x["km"]
    if ranked:
        owned = _owned(sc.n_fluid)
        shard = base.Shard(sync=None, owned=owned, upd=owned, sum=None,
                           max=None, loop={}, total=None)
        u = torch.where(owned, u, torch.zeros_like(u))
    args = (sc, rigid, x["p"], x["st"])
    for side in (x["side"], None):
        got = base.body_reaction(*args, x["k"], x["force"], shard, side,
                                 sc.particle_m)
        want = base.body_reaction(*args, u, x["force"], side=side)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_the_density_loop_streams_k_and_m(monkeypatch):
    """A DFSPH step of TINY_BODY squeezed by 0.85: each density iteration's
    stream is handed the rate's k (the step's k buffer, not a product
    formed over the rows) and the scale m."""
    sim = Simulation(parse_config(copy.deepcopy(TINY_BODY)), device="cpu")
    sim.state = inputs.squeezed(sim.state)
    seen = []
    stream = R.rigid_side_force_list

    def spy(side, value, force, scale=1.0, owned=None):
        seen.append((value.data_ptr(), scale, owned))
        return stream(side, value, force, scale, owned)

    monkeypatch.setattr(R, "rigid_side_force_list", spy)
    sim.state = dfsph.step(sim.scene, sim.state)
    iters = int(sim.state.diag[2])
    assert len(seen) == iters > 1
    assert {s for _, s, _ in seen} == {sim.scene.particle_m}
    assert all(o is None for _, _, o in seen)
    # one buffer a step, which every rate writes its k into
    assert len({p for p, _, _ in seen}) == 1


def test_wrapper_takes_the_plain_version_on_the_cpu_only(scenes):
    x = scenes["rigid_cfg"]
    side = x["side"]
    stencil.reset_counts()
    R.rigid_side_force_list(side, x["k"], x["force"], 2.0,
                            _owned(x["p"].shape[0]))
    assert stencil.KERNELS["rigid_side_force_list"].plain_calls == 1
    assert stencil.KERNELS["rigid_side_force_list"].launches == 0
    meta = R.SideList(*(t.to("meta") for t in side))
    with pytest.raises(ValueError, match="no kernel"):
        R.rigid_side_force_list(meta, x["k"].to("meta"),
                                x["force"].to("meta"), 2.0,
                                _owned(x["p"].shape[0]).to("meta"))
