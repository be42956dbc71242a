"""ops/loops.while_loop_unrolled of the port held to the JAX package's
`while_loop_unrolled` (cfd_taichi_tpu/ops/loops.py) on the carry of
tests/test_loops.py:15-33, made from numpy, every leaf bit for bit; and
the DFSPH, IISPH and PCISPH steps of the TINY scene at one iteration a
trip against three, positions and diagnostics bit for bit, with the
launches of the masked iterations counted as trips x U. On the CPU, where
the loop runs its trips eagerly (the card's graph replay is
chip_smoke.py's [loops] phase)."""

import copy
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfd_taichi_tpu.ops.loops import while_loop_unrolled as jax_loop
from cfd_taichi_tpu.ops.vec import V3
from cfd_taichi_tpu_torch import Simulation
from cfd_taichi_tpu_torch.config import parse_config
from cfd_taichi_tpu_torch.models import dfsph
from cfd_taichi_tpu_torch.ops import loops, stencil
from cfd_taichi_tpu_torch.perf import inputs

TINY = {
    "scene": {"box_min": [0.0, 0.0, 0.0], "box_max": [0.6, 0.8, 0.6],
              "particle_radius": 0.025, "gravity": 9.8},
    "solver": {"name": "dfsph", "delta_time": 4e-4, "iter_cnt": 1},
    "fluid": {"start_pos": [0.15, 0.1, 0.15], "water_size": [0.3, 0.3, 0.3]},
}
UNROLLS = [1, 2, 3, 4, 7]
N_STOPS = [1, 5, 12, 100]


@pytest.fixture(autouse=True)
def one_thread():
    """One torch thread a test: the suite runs files side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _init_np():
    return (np.arange(4.0, dtype=np.float32), np.ones(4, np.float32),
            np.zeros(4, np.float32), np.float32(100.0), np.bool_(False),
            np.int32(0))


def _jax_run(unroll, n_stop):
    """tests/test_loops.py:15-33 on the numpy carry, as the JAX package
    runs it."""
    def cond(c):
        v, resid, stop, it = c
        return (resid > 1.0) & (it < 50) & jnp.logical_not(stop)

    def body(c):
        v, resid, stop, it = c
        v = V3(v.x * 0.5, v.y + 1.0, v.z - v.x)
        resid = resid * 0.6
        stop = it + 1 >= n_stop
        return (v, resid, stop, it + 1)

    x, y, z, resid, stop, it = (jnp.asarray(a) for a in _init_np())
    out = jax.jit(lambda: jax_loop(cond, body, (V3(x, y, z), resid, stop, it),
                                   unroll=unroll))()
    return [np.asarray(a) for a in jax.tree.leaves(out)]


def _cond(c):
    _, _, _, resid, stop, it = c
    return (resid > 1.0) & (it < 50) & ~stop


def _body(n_stop):
    def body(c):
        x, y, z, resid, _, it = c
        return (x * 0.5, y + 1.0, z - x, resid * 0.6, it + 1 >= n_stop,
                it + 1)
    return body


def _port_run(unroll, n_stop, pool=None):
    init = tuple(torch.from_numpy(np.asarray(a)) for a in _init_np())
    return loops.while_loop_unrolled(_cond, _body(n_stop), init, unroll,
                                     pool)


@pytest.mark.parametrize("unroll", UNROLLS)
@pytest.mark.parametrize("n_stop", N_STOPS)
def test_loop_matches_jax_bit_for_bit(unroll, n_stop):
    want = _jax_run(unroll, n_stop)
    got = [t.numpy() for t in _port_run(unroll, n_stop)]
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("unroll", UNROLLS)
def test_one_read_a_trip(unroll, monkeypatch):
    """A loop of n real iterations runs ceil(n / U) trips (the first with
    no read before it) and reads its condition once a trip."""
    reads = []

    def counting_bool(x):
        reads.append(1)
        return bool(x)

    for n_stop in N_STOPS:
        want = int(_port_run(1, n_stop)[-1])
        pool = loops.GraphPool()
        monkeypatch.setattr(loops, "bool", counting_bool, raising=False)
        reads.clear()
        got = int(_port_run(unroll, n_stop, pool)[-1])
        monkeypatch.delattr(loops, "bool")
        assert got == want
        assert pool.trips == len(reads) == math.ceil(want / unroll)
        assert pool.captures == 0         # no capture on the CPU


def test_loop_refuses_a_leaf_that_changes_type():
    init = (torch.zeros(3), torch.zeros((), dtype=torch.int32))

    def body(c):
        return c[0] + 1.0, c[1] + 1.5     # the counter becomes f32

    with pytest.raises(ValueError, match="leaf 1"):
        loops.while_loop_unrolled(lambda c: c[1] < 3, body, init)
    with pytest.raises(ValueError, match="unroll 0"):
        loops.while_loop_unrolled(lambda c: c[1] < 3, body, init, unroll=0)


def _steps(solver: str, unroll: int, steps: int, monkeypatch):
    """TINY as `solver`, from rest (DFSPH) or from its squeezed block, for
    `steps` steps at `unroll` iterations a trip on the CPU. Returns the
    simulation and the coef_matvec plain calls."""
    monkeypatch.setattr(dfsph, "loop_unroll", lambda scene: unroll)
    raw = copy.deepcopy(TINY)
    raw["solver"]["name"] = solver
    sim = Simulation(parse_config(raw), device="cpu")
    if solver != "dfsph":
        sim.state = inputs.squeezed(sim.state)
    stencil.reset_counts()
    diags = []
    for _ in range(steps):
        sim.step()
        diags.append(sim.state.diag.tolist())
    return sim, diags, stencil.KERNELS["coef_matvec"].plain_calls


def _trips(n: float, unroll: int) -> int:
    return math.ceil(round(n) / unroll)


@pytest.mark.parametrize("solver", ["dfsph", "iisph", "pcisph"])
def test_tiny_steps_equal_at_one_and_three_a_trip(solver, monkeypatch):
    """The counterpart of tests/test_loops.py::test_dfsph_unroll_bitexact:
    positions and diag bit for bit at U = 1 and U = 3, and coef_matvec
    run as often as trips x U give (the masked iterations included)."""
    runs = {u: _steps(solver, u, 4, monkeypatch) for u in (1, 3)}
    (a, da, ca), (b, db, cb) = runs[1], runs[3]
    np.testing.assert_array_equal(a.state.fluid.pos.numpy(),
                                  b.state.fluid.pos.numpy())
    np.testing.assert_array_equal(a.state.fluid.oid.numpy(),
                                  b.state.fluid.oid.numpy())
    assert da == db
    assert float(a.state.t) == float(b.state.t)
    loop_cols = (0, 2) if solver == "dfsph" else (0,)
    # the loops iterate more than once somewhere, so that U = 3 masks
    assert max(d[c] for d in da for c in loop_cols) >= 2, da
    for u, calls, diags in ((1, ca, da), (3, cb, db)):
        looped = sum(_trips(d[c], u) * u for d in diags for c in loop_cols)
        # DFSPH's warm start is one matvec more a step
        assert calls == looped + (len(diags) if solver == "dfsph" else 0)
