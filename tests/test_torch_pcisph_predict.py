"""The stream form of PCISPH's predicted density and the body gate of both
forms, held on the CPU:

* the stream form (`stencil.pcisph_predict_rho` given the step's pair
  store; plain version `pcisph_predict_rho_list_plain`, which the CPU runs)
  over the store `coef.build_coef` makes, against JAX's
  `bandmat.predicted_rho_op` + `boundary_predict_op` on TINY's block as
  tests/test_torch_pcisph.py:142-187 sets it (moved next to the walls, a
  0.1 r jitter, predicted positions a seeded ~0.3 r away, so that pairs
  cross r = h both ways), to 1e-5 of the output's largest magnitude; and
  against the stencil form's plain version on the same pairs, to 1e-6 of
  it (the same f32 terms summed in another order);
* the same with a rigid body, against `rigid_dense.predict_rho_op`, on
  RIGID_CFG as tests/test_torch_pcisph_rigid.py:113-164 starts it;
* the gate's plain logic (`make_body_box`, `in_body_box`: the comparisons
  the kernels make), a hypothesis test over bodies and queries drawn from
  a seed: every query with a body pair, by the f32 pair test of the walks,
  lies inside the gate, so that a gated walk leaves every output as it
  was.

JAX runs once a module (fixtures), torch on one thread.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as hst

from cfd_taichi_tpu import scene as jscene
from cfd_taichi_tpu.config import parse_config as jparse_config
from cfd_taichi_tpu.models import base as jbase
from cfd_taichi_tpu.ops import bandmat
from cfd_taichi_tpu.ops.vec import V3
from cfd_taichi_tpu_torch import build_scene
from cfd_taichi_tpu_torch.config import parse_config
from cfd_taichi_tpu_torch.models import base
from cfd_taichi_tpu_torch.ops import coef
from cfd_taichi_tpu_torch.ops import neighbors as nb
from cfd_taichi_tpu_torch.ops import rigid as R
from cfd_taichi_tpu_torch.ops import stencil
from test_torch_pcisph import SEED, _tiny
from test_torch_pcisph_rigid import RAW, RHO0, _jax_predict
from test_torch_rigid import _assert_scaled, _pass_inputs


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _store(pos, starts, sc):
    """The step's pair store of the cell-sorted `pos`, as the coef engine
    builds it."""
    g, h, m = sc.grid, sc.h, sc.particle_m
    count = stencil.fluid_terms(pos, starts, g, h, m).count
    return coef.build_coef(pos, starts, g, h, m, coef.csr_offsets(count))


def _close(got, want, rel, tag):
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert scale > 0, tag
    assert err <= rel * scale, f"{tag}: error {err} over scale {scale}"


@pytest.fixture(scope="module")
def tiny():
    """TINY's block moved 0.1 toward the floor and two walls, jittered,
    cell-sorted, its predicted positions, and JAX's fluid and wall sums."""
    jsc = jscene.build_scene(jparse_config(_tiny("walls")))
    st = jsc.static
    sc = build_scene(parse_config(_tiny("walls")), device="cpu")
    rng = np.random.default_rng(SEED)
    r, n = st.particle_radius, st.n_fluid
    pos = (jsc.fluid_pos0.to_numpy() - np.array([0.1, 0.1, 0.1])
           + rng.uniform(-0.1 * r, 0.1 * r, (n, 3))).astype(np.float32)
    dp = jbase.build_dense_prep(st, jsc.arrays, V3.from_rows(pos),
                                st.band_nb_wide, st.band_B)
    assert int(dp.overflow) == 0 and int(dp.bwin.overflow) == 0
    scid, perm, pos_s, _ = base.sort_by_cells(sc.grid, torch.from_numpy(pos))
    np.testing.assert_array_equal(perm.numpy(), np.asarray(dp.perm))
    shift = rng.standard_normal((n, 3)).astype(np.float32) * np.float32(
        0.3 * r / np.sqrt(3.0))
    pos_p = (pos_s.numpy() + shift).astype(np.float32)
    fluid = np.asarray(bandmat.predicted_rho_op(
        dp.pos, h=st.h, m=st.particle_m, plan=dp.plan, B=st.band_B)(
            V3.from_rows(pos_p)))
    walls = np.asarray(bandmat.boundary_predict_op(
        dp.bwin, dp.pos, h=st.h, rho0=RHO0, B=st.band_B)(
            V3.from_rows(pos_p)))
    return dict(sc=sc, pos=pos_s, starts=nb.csr_starts(scid,
                                                       sc.grid.num_cells),
                pos_p=torch.from_numpy(pos_p), fluid=fluid, walls=walls)


def test_stream_form_plain_matches_jax_ops(tiny):
    sc, pos, pos_p = tiny["sc"], tiny["pos"], tiny["pos_p"]
    # pairs cross r = h both ways between the start and predicted positions
    h2 = np.float32(sc.h) ** 2
    eye = np.eye(pos.shape[0], dtype=bool)
    valid = (torch.cdist(pos, pos).numpy() ** 2 <= h2) & ~eye
    near = (torch.cdist(pos_p, pos_p).numpy() ** 2 <= h2) & ~eye
    assert (valid & ~near).sum() > 0 and (near & ~valid).sum() > 0
    assert (tiny["walls"] > 0).sum() > 20
    eng = _store(pos, tiny["starts"], sc)
    stencil.reset_counts()
    args = (pos, tiny["starts"], sc.grid, sc.h, sc.particle_m, pos_p)
    fluid = stencil.pcisph_predict_rho(*args, eng=eng).numpy()
    both = stencil.pcisph_predict_rho(*args, base.walls(sc), RHO0,
                                      eng=eng).numpy()
    k = stencil.KERNELS
    assert k["pcisph_predict_rho_list"].plain_calls == 2
    assert k["pcisph_predict_rho"].plain_calls == 0
    _close(fluid, tiny["fluid"], 1e-5, "fluid")
    _close(both, tiny["fluid"] + tiny["walls"], 1e-5, "fluid + walls")


@pytest.mark.parametrize("with_walls", [False, True])
def test_stream_form_plain_matches_the_stencil_form(tiny, with_walls):
    """The store's rows are the stencil's pairs: the two plain versions sum
    the same terms, in another order."""
    sc = tiny["sc"]
    more = (base.walls(sc), RHO0) if with_walls else ()
    args = (tiny["pos"], tiny["starts"], sc.grid, sc.h, sc.particle_m,
            tiny["pos_p"], *more)
    eng = _store(tiny["pos"], tiny["starts"], sc)
    assert eng.nbr.shape[0] > 0
    got = stencil.pcisph_predict_rho(*args, eng=eng).numpy()
    want = stencil.pcisph_predict_rho(*args).numpy()
    _close(got, want, 1e-6, "stream against stencil")


@pytest.fixture(scope="module")
def with_body():
    """RIGID_CFG's fluid shifted next to the body, predicted positions a
    further ~0.3 r away, and JAX's three sums (tests/
    test_torch_pcisph_rigid.py's inputs)."""
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
    return dict(sc=sc, pos=pos, starts=nb.csr_starts(scid, g.num_cells),
                pos_p=pos + torch.from_numpy(shift),
                table=R.rigid_table(g, torch.from_numpy(x["rpos"]),
                                    sc.rigid_volume),
                **{key: np.asarray(want[key])
                   for key in ("fluid", "body", "walls")})


def test_stream_form_plain_with_a_body_matches_jax_ops(with_body):
    c = with_body
    sc = c["sc"]
    assert (c["body"] > 0).sum() > 20
    eng = _store(c["pos"], c["starts"], sc)
    args = (c["pos"], c["starts"], sc.grid, sc.h, sc.particle_m, c["pos_p"])
    stencil.reset_counts()
    got = {key: stencil.pcisph_predict_rho(*args, *more, eng=eng).numpy()
           for key, more in (("fluid", ()),
                             ("with_body", (None, RHO0, c["table"])),
                             ("all", (base.walls(sc), RHO0, c["table"])))}
    k = stencil.KERNELS
    assert k["pcisph_predict_rho_list"].plain_calls == 3
    assert k["pcisph_predict_rho_rigid"].plain_calls == 2
    _assert_scaled(got["fluid"], c["fluid"], "fluid")
    _assert_scaled(got["with_body"] - got["fluid"], c["body"], "body")
    _assert_scaled(got["all"], c["fluid"] + c["body"] + c["walls"], "all")
    stencil_all = stencil.pcisph_predict_rho(
        *args, base.walls(sc), RHO0, c["table"]).numpy()
    _close(got["all"], stencil_all, 1e-6, "stream against stencil")


def test_body_gate_of_the_body_in_water(with_body):
    """RIGID_CFG's cube in the water: the gate holds every query with a
    body pair and leaves most of the block out."""
    c = with_body
    sc = c["sc"]
    box = stencil.make_body_box(c["table"].pos, sc.h)
    inside = stencil.in_body_box(c["pos"], box)
    paired = R.rigid_terms(c["pos"], c["table"], sc.grid, sc.h,
                           RHO0).rho > 0
    assert int(paired.sum()) > 20
    assert bool(inside[paired].all())
    assert int(inside.sum()) < c["pos"].shape[0] // 2


@settings(max_examples=60, deadline=None, derandomize=True,
          database=None)
@given(seed=hst.integers(0, 2**32 - 1),
       h=hst.sampled_from([0.1, 0.05, 0.0731, 0.2]),
       extent=hst.sampled_from([1.0, 4.0, 30.0]))
def test_body_gate_holds_every_query_with_a_body_pair(seed, h, extent):
    """Bodies and queries drawn from `seed` on a grid of cell h over a box
    of `extent`: a cluster of 1-60 body particles somewhere in it, queries
    around them out to 1.5 h, a quarter of them at exactly f32(h) along
    an axis from a body particle. Every query with a pair (the walks' f32
    test over the body's table) lies inside `make_body_box`'s gate."""
    rng = np.random.default_rng(seed)
    grid = nb.grid_for_box((0.0, 0.0, 0.0), (extent,) * 3, h)
    nr = int(rng.integers(1, 61))
    centre = rng.uniform(2 * h, extent - 2 * h, 3)
    spread = rng.uniform(0.0, 3 * h)
    bpos = (centre + rng.uniform(-spread, spread, (nr, 3))).astype(
        np.float32)
    nq = 400
    src = bpos[rng.integers(0, nr, nq)]
    q = src + rng.uniform(-1.5 * h, 1.5 * h, (nq, 3)).astype(np.float32)
    edge = rng.integers(0, nq, nq // 4)
    axis = rng.integers(0, 3, edge.shape[0])
    q[edge] = src[edge]
    q[edge, axis] += np.where(rng.random(edge.shape[0]) < 0.5, 1.0,
                              -1.0).astype(np.float32) * np.float32(h)
    q = torch.from_numpy(q.astype(np.float32))
    table = R.rigid_table(grid, torch.from_numpy(bpos),
                          torch.full((nr,), 1e-4))
    paired = torch.zeros(nq, dtype=torch.bool)
    for rows, pr in stencil._pair_chunks(q, table.pos, table.starts, grid, h,
                                         exclude_self=False):
        paired[rows] = pr.valid.any(dim=1)
    inside = stencil.in_body_box(q, stencil.make_body_box(table.pos, h))
    assert bool(paired.any())
    assert bool(inside[paired].all()), int((paired & ~inside).sum())


def test_body_gate_of_no_body_holds_nothing():
    box = stencil.make_body_box(torch.zeros((0, 3)), 0.1)
    assert not bool(stencil.in_body_box(torch.rand(50, 3), box).any())
