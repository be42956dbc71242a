"""The source record of DFSPH's rate (ops/coef.py): rec[j] = [v_j, x_j . v_j],
which the kick writes for the v it returns, `dfsph_pack` for a v that no
kick wrote, and the rate reads in place of v (models/dfsph.py's module
note says why its loops always hand the rate the record of its v). On the
CPU the plain versions keep that dataflow, so a stale record shows here:

(a) the kick's record is the pack of its v_out bit for bit, the rows a
    rank does not update (upd False: v itself) included, written in place
    where a buffer is given;
(b) the wrappers refuse a record that is not a contiguous, 16-byte aligned
    (N, 4) f32 tensor;
(c) TINY carried from JAX's state after step 34 (the block on the floor,
    both loops iterating: ~15 divergence and ~10 density iterations a
    step) and stepped on the stored-coefficient engine at U = 1, 2 and 4
    gated sub-iterations a trip is bit for bit the same steps with every
    rate handed a record packed afresh from its v, while a step whose pack
    is left out is not; and it is within 5e-6 of JAX's steps on its coef
    engine (positions through oid, f32 coefficients) with equal iteration
    counts, the bar of tests/test_torch_dfsph.py;
(d) the rate writes the next kick's k into a buffer where it is given one
    (`k_out`), the same bits as a k of its own, and refuses a buffer that
    is not a contiguous (N,) f32 tensor; so does the composition that the
    recompute engine runs;
(e) the divergence loop carries no k: its kicks read the buffer into
    which every rate writes (models/dfsph.py). From the same start at
    U = 1, 2 and 4 the steps are bit for bit those whose divergence kicks
    are each handed k = (dr alpha / dt) / rho formed afresh from the dr
    they are handed (the carry's, the k a carry would hold), while a step
    whose rates leave the buffer alone is not.

The rate over the record against JAX's `loop_operators` and against the
composition the loops ran before is tests/test_torch_dfsph_fused.py's.
"""

import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cfd_taichi_tpu.models.dfsph as jdfsph
from cfd_taichi_tpu.config import parse_config as jparse_config
from cfd_taichi_tpu.runner import Simulation as JaxSimulation
from cfd_taichi_tpu_torch import Simulation, build_scene
from cfd_taichi_tpu_torch.config import parse_config
from cfd_taichi_tpu_torch.models import base, dfsph
from cfd_taichi_tpu_torch.ops import coef
from cfd_taichi_tpu_torch.ops import neighbors as nb
from cfd_taichi_tpu_torch.ops import stencil
from cfd_taichi_tpu_torch.perf import cases
from cfd_taichi_tpu_torch.utils import io

TINY = {
    "scene": {"box_min": [0.0, 0.0, 0.0], "box_max": [0.6, 0.8, 0.6],
              "particle_radius": 0.025, "gravity": 9.8},
    "solver": {"name": "dfsph", "delta_time": 4e-4, "iter_cnt": 1},
    "fluid": {"start_pos": [0.15, 0.1, 0.15], "water_size": [0.3, 0.3, 0.3]},
}
STEPS = 4
UNROLLS = (1, 2, 4)
CARRY_AT = 34


@pytest.fixture(autouse=True)
def one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def lattice():
    """TINY's block jittered by 0.1 r (numpy seed), cell-sorted, the plain
    pair store over it, and the kick's inputs (perf/cases.dfsph_inputs)."""
    torch.set_num_threads(1)
    sc = build_scene(parse_config(copy.deepcopy(TINY)), device="cpu")
    g, h, m, n = sc.grid, sc.h, sc.particle_m, sc.n_fluid
    rng = np.random.default_rng(24)
    raw = sc.fluid_pos0 + torch.from_numpy(rng.uniform(
        -0.1, 0.1, (n, 3)).astype(np.float32)) * sc.particle_radius
    scid, _, pos, _ = base.sort_by_cells(g, raw)
    starts = nb.csr_starts(scid, g.num_cells)
    ft = stencil.fluid_terms_plain(pos, starts, g, h, m)
    eng = coef.build_coef_plain(pos, starts, g, h, m,
                                coef.csr_offsets(ft.count))
    rho = torch.from_numpy(rng.uniform(900.0, 1100.0, n).astype(np.float32))
    d = cases.dfsph_inputs(pos, starts, g, h, m, rho, seed=9)
    return dict(pos=pos, eng=eng,
                v=torch.from_numpy(rng.standard_normal((n, 3))
                                   .astype(np.float32)),
                k=torch.from_numpy(rng.uniform(0.0, 2.0, n)
                                   .astype(np.float32)), **d)


# ---------------------------------------------------------------------------
# (a) the kick's record
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("form", ["density", "divergence", "masked"])
def test_kick_record_is_the_pack_of_its_v_out(lattice, form):
    x = lattice
    args = (x["v"], x["k"], x["S"], x["dt"])
    if form != "density":
        args += (x["wk"], x["dr"], x["alpha"])
    if form == "masked":
        args += (x["upd"],)
        assert not bool(x["upd"].all())
    buf = torch.full((x["pos"].shape[0], 4), float("nan"))
    v_out, _, rec = coef.dfsph_kick(x["eng"], x["pos"], *args, rec=buf)
    assert rec.data_ptr() == buf.data_ptr()
    assert cases.bit_equal(rec, coef.dfsph_pack_plain(x["pos"], v_out))
    fresh = coef.dfsph_kick(x["eng"], x["pos"], *args)[2]
    assert cases.bit_equal(fresh, rec)
    if form == "masked":
        keep = ~x["upd"]
        assert torch.equal(rec[keep, :3], x["v"][keep])
    xv = (x["pos"][:, 0] * v_out[:, 0] + x["pos"][:, 1] * v_out[:, 1]
          + x["pos"][:, 2] * v_out[:, 2])
    assert torch.equal(rec[:, 3], xv)


def test_pack_writes_in_place(lattice):
    x = lattice
    buf = torch.zeros(x["pos"].shape[0], 4)
    rec = coef.dfsph_pack(x["pos"], x["v"], buf)
    assert rec.data_ptr() == buf.data_ptr()
    assert cases.bit_equal(rec, coef.dfsph_pack(x["pos"], x["v"]))
    assert torch.equal(rec[:, :3], x["v"])


# ---------------------------------------------------------------------------
# (b) records the wrappers refuse
# ---------------------------------------------------------------------------

def _bad_records(n):
    """(name, record) of every kind the wrappers refuse."""
    raw = torch.zeros(4 * n + 1)
    return [("(N, 3)", torch.zeros(n, 3)),
            ("(N + 1, 4)", torch.zeros(n + 1, 4)),
            ("f64", torch.zeros(n, 4, dtype=torch.float64)),
            ("strided", torch.zeros(4, n).t()),
            ("misaligned", raw[1:].view(n, 4))]


@pytest.mark.parametrize("call", ["rate", "kick", "pack"])
def test_wrappers_refuse_a_bad_record(lattice, call):
    x = lattice
    n = x["pos"].shape[0]
    for what, rec in _bad_records(n):
        assert what != "misaligned" or rec.data_ptr() % 16 == 4
        with pytest.raises(ValueError, match="rec: want"):
            if call == "rate":
                coef.dfsph_rate(x["eng"], x["pos"], rec, x["S"], x["alpha"],
                                x["rho"], x["dt"],
                                coef.Density(x["dt2"], 1000.0))
            elif call == "kick":
                coef.dfsph_kick(x["eng"], x["pos"], x["v"], x["k"], x["S"],
                                x["dt"], rec=rec)
            else:
                coef.dfsph_pack(x["pos"], x["v"], rec)


# ---------------------------------------------------------------------------
# (c) no rate reads a stale record: TINY's steps
# ---------------------------------------------------------------------------

def _pos_by_oid(pos, oid):
    pos, oid = np.asarray(pos), np.asarray(oid)
    return pos[np.argsort(oid)]


def _leaves(state):
    return [np.asarray(a) for a in jax.tree_util.tree_flatten(state)[0]]


@pytest.fixture(scope="module")
def jax_run():
    """JAX's TINY steps on its stored-coefficient engine with f32
    coefficients (as tests/test_torch_coef.py runs it): the leaves after
    step CARRY_AT, when the block has reached the floor and the density
    loop iterates, and a snapshot after each of the STEPS steps that
    follow."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jdfsph, "BAND_BYTE_BUDGET", 0)
        mp.setattr(jdfsph, "BAND_DTYPE", jnp.float32)
        jax.clear_caches()
        sim = JaxSimulation(jparse_config(copy.deepcopy(TINY)))
        for _ in range(CARRY_AT):
            sim.step()
        leaves = _leaves(sim.state)
        snaps = []
        for _ in range(STEPS):
            sim.step()
            s = sim.state
            snaps.append(dict(
                pos=_pos_by_oid(s.fluid.pos.to_numpy(), s.fluid.oid),
                diag=np.asarray(s.diag).copy()))
    jax.clear_caches()
    return dict(leaves=leaves, snaps=snaps)


def _steps(leaves, unroll, monkeypatch, wrap=None):
    """STEPS steps of TINY on the coef engine from JAX's start `leaves`,
    at `unroll` sub-iterations a trip, each step's (kick, rate, pack)
    wrapped by `wrap` where one is given: (positions, oid, diag) after
    each step."""
    monkeypatch.setattr(dfsph, "loop_unroll", lambda scene: unroll)
    if wrap is not None:
        algebra = dfsph.loop_algebra

        def wrapped(*args):
            return wrap(*algebra(*args))
        monkeypatch.setattr(dfsph, "loop_algebra", wrapped)
    sim = Simulation(parse_config(copy.deepcopy(TINY)), device="cpu")
    sim.state = io.state_from_numpy(leaves, device="cpu")
    out = []
    for _ in range(STEPS):
        sim.step()
        f = sim.state.fluid
        out.append((f.pos.clone(), f.oid.clone(), sim.state.diag.clone()))
    monkeypatch.undo()
    return out


def _repacked(kick, rate, pack):
    """The rate handed a record packed afresh from its v on every call."""
    def call(v, *args):
        pack(v)
        return rate(v, *args)
    return kick, call, pack


def _same(a, b):
    return all(cases.bit_equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("unroll", UNROLLS)
def test_no_rate_reads_a_stale_record(unroll, monkeypatch, jax_run):
    stencil.reset_counts()
    got = _steps(jax_run["leaves"], unroll, monkeypatch)
    k = stencil.KERNELS
    assert k["dfsph_pack"].plain_calls == STEPS
    assert k["dfsph_rate"].plain_calls > STEPS
    assert k["matvec"].plain_calls == 0
    want = _steps(jax_run["leaves"], unroll, monkeypatch, _repacked)
    assert all(_same(a, b) for a, b in zip(got, want))
    # pressure acts: every density loop runs past its minimum
    assert min(float(d[2]) for _, _, d in got) > dfsph.MIN_ITER_DENSITY
    for (pos, oid, diag), snap in zip(got, jax_run["snaps"]):
        err = np.abs(_pos_by_oid(pos.numpy(), oid.numpy())
                     - snap["pos"]).max()
        print(f"U={unroll}: positions within {err:.3e} of JAX's")
        assert err <= 5e-6
        assert (diag[0], diag[2]) == (snap["diag"][0], snap["diag"][2])


def test_a_step_without_its_pack_differs(monkeypatch, jax_run):
    """The check above can fail: leave the pack out, and the density
    loop's first rate reads the divergence loop's last record."""
    want = _steps(jax_run["leaves"], 1, monkeypatch)
    monkeypatch.setattr(coef, "dfsph_pack", lambda pos, v, out=None: out)
    got = _steps(jax_run["leaves"], 1, monkeypatch)
    assert not all(_same(a, b) for a, b in zip(got, want))


# ---------------------------------------------------------------------------
# (d) the rate's k written into a buffer
# ---------------------------------------------------------------------------

def _rate_args(x, form):
    mode = (coef.Density(x["dt2"], 1000.0) if form == "density"
            else coef.Divergence(x["counts"], 20))
    return (x["S"], x["alpha"], x["rho"], x["dt"], mode) + (
        (x["c_s"], x["owned"]) if form == "contact" else ())


@pytest.mark.parametrize("form", ["divergence", "density", "contact"])
def test_rate_writes_its_k_into_the_buffer_given(lattice, form):
    x = lattice
    n = x["pos"].shape[0]
    args = _rate_args(x, form)
    rec = coef.dfsph_pack(x["pos"], x["v"])
    mvd = functools.partial(coef.coef_matvec_dot_plain, x["eng"], x["pos"])
    for call in (functools.partial(coef.dfsph_rate, x["eng"], x["pos"], rec),
                 functools.partial(coef.rate_composition, mvd, x["v"])):
        want = call(*args)
        buf = torch.full((n,), float("nan"))
        got = call(*args, k_out=buf)
        assert got.k is buf
        assert cases.bit_equal(got, want)
        assert bool(torch.isfinite(buf).all())


@pytest.mark.parametrize("what", ["(N + 1,)", "f64", "strided"])
def test_rate_refuses_a_bad_k_buffer(lattice, what):
    x = lattice
    n = x["pos"].shape[0]
    buf = {"(N + 1,)": torch.zeros(n + 1),
           "f64": torch.zeros(n, dtype=torch.float64),
           "strided": torch.zeros(2 * n)[::2]}[what]
    with pytest.raises(ValueError, match="k_out: want"):
        coef.dfsph_rate(x["eng"], x["pos"], coef.dfsph_pack(x["pos"], x["v"]),
                        *_rate_args(x, "divergence"), k_out=buf)


# ---------------------------------------------------------------------------
# (e) no kick reads a stale k: TINY's steps
# ---------------------------------------------------------------------------

def _k_from_carry(kick, rate, pack):
    """Each divergence kick (the one handed wk) handed k = (dr alpha / dt)
    / rho formed from the dr it is handed, the carry's, as the rate forms
    it, in place of the rate's buffer; rho is the rates' (a step
    constant)."""
    seen = {}

    def rate_(v, S, alpha, rho, *args, **kw):
        seen["rho"] = rho
        return rate(v, S, alpha, rho, *args, **kw)

    def kick_(v, k, S, dt, wk=None, dr=None, alpha=None, upd=None):
        if wk is not None:
            k = torch.div(dr * alpha / dt, seen["rho"])
        return kick(v, k, S, dt, wk, dr, alpha, upd)
    return kick_, rate_, pack


def _buffer_left_alone(kick, rate, pack):
    """Each rate hands back its k in a tensor of its own and zeroes the
    buffer it wrote."""
    def rate_(*args, **kw):
        r = rate(*args, **kw)
        k = r.k.clone()
        r.k.zero_()
        return r._replace(k=k)
    return kick, rate_, pack


@pytest.mark.parametrize("unroll", UNROLLS)
def test_no_kick_reads_a_stale_k(unroll, monkeypatch, jax_run):
    got = _steps(jax_run["leaves"], unroll, monkeypatch)
    want = _steps(jax_run["leaves"], unroll, monkeypatch, _k_from_carry)
    assert all(_same(a, b) for a, b in zip(got, want))
    # the divergence loop iterates past its first kick in every step
    assert min(float(d[0]) for _, _, d in got) > 1


def test_a_step_whose_rates_leave_the_k_buffer_differs(monkeypatch,
                                                      jax_run):
    """The check above can fail: with the buffer zeroed after each rate
    the divergence loop's kicks read zeros, and the steps change, unless
    they take k from the carry's dr."""
    want = _steps(jax_run["leaves"], 1, monkeypatch)
    got = _steps(jax_run["leaves"], 1, monkeypatch, _buffer_left_alone)
    assert not all(_same(a, b) for a, b in zip(got, want))
    fixed = _steps(jax_run["leaves"], 1, monkeypatch,
                   lambda *t: _k_from_carry(*_buffer_left_alone(*t)))
    assert all(_same(a, b) for a, b in zip(fixed, want))
