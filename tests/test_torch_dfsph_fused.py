"""DFSPH's loop kernels, dfsph_kick and dfsph_rate (ops/coef.py), by their
plain versions on the CPU:

(a) against JAX's `loop_operators` (`cfd_taichi_tpu/models/dfsph.py:
    174-222`: stiff_vel_delta, rho_derivative, rho_adv_residual) over
    JAX's coef engine of the jittered TINY block (tests/test_solvers.py:
    14-23), carried into the port by `coef.coef_from_blocks`: fluid-only,
    with a contact dot c_s, and with a rank's owned and upd masks (JAX's
    `resid_mask`, and the `torch.where` on upd of its sharded kick);
(b) bit for bit against the torch ops DFSPH ran around the contraction
    before the kernels took them (written out below as `parent_kick` and
    `parent_rate`: coef_matvec_plain or coef_matvec_dot_plain, then the
    algebra), on the same inputs;
(c) the loops' choice: a TINY step calls the two kernels' wrappers on the
    stored-coefficient engine and the composition on the recompute one.

Tolerances. JAX's engine and the port's plain contraction add the same
f32 products in another order, so each output is held to 1e-5 of the
magnitude of its terms (`perf/cases.fused_scales`: the matvec's final
form cancels, x_i s0 - s), and the selection of the residual average row
by row, so its count exactly; the averages to 1e-5 relative.
"""

import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cfd_taichi_tpu.models.dfsph as jdfsph
from cfd_taichi_tpu.ops import bandmat
from cfd_taichi_tpu.ops import neighbors as jnb
from cfd_taichi_tpu.ops.vec import V3
from cfd_taichi_tpu_torch import Simulation, build_scene
from cfd_taichi_tpu_torch.config import parse_config
from cfd_taichi_tpu_torch.models import base, dfsph
from cfd_taichi_tpu_torch.ops import coef
from cfd_taichi_tpu_torch.ops import neighbors as nb
from cfd_taichi_tpu_torch.ops import stencil
from cfd_taichi_tpu_torch.perf import cases

TINY = {
    "scene": {"box_min": [0.0, 0.0, 0.0], "box_max": [0.6, 0.8, 0.6],
              "particle_radius": 0.025, "gravity": 9.8},
    "solver": {"name": "dfsph", "delta_time": 4e-4, "iter_cnt": 1},
    "fluid": {"start_pos": [0.15, 0.1, 0.15], "water_size": [0.3, 0.3, 0.3]},
}
B = 8
TOL = 1e-5
RHO0 = 1000.0
# (contact dot, masks) of each variant
VARIANTS = {"fluid": (False, False), "c_s": (True, False),
            "masks": (True, True)}


@pytest.fixture(scope="module")
def block():
    """TINY's block jittered by 0.1 r (numpy seed), cell-sorted alike in
    both packages, JAX's f32 coef engine over it and the port's CSR copy,
    and the loop's inputs: S, counts and alpha from fluid_terms
    (cases.dfsph_inputs), random v, k, rho, wk, dr, c_s and masks."""
    torch.set_num_threads(1)
    sc = build_scene(parse_config(copy.deepcopy(TINY)), device="cpu")
    h, m, n = sc.h, sc.particle_m, sc.n_fluid
    rng = np.random.default_rng(20261018)
    raw = (sc.fluid_pos0.numpy() + rng.uniform(
        -0.1, 0.1, (n, 3)) * sc.particle_radius).astype(np.float32)
    box = (TINY["scene"]["box_min"], TINY["scene"]["box_max"])
    grid = nb.grid_for_box(*box, h)
    scid, _, pos, _ = base.sort_by_cells(grid, torch.from_numpy(raw))
    starts = nb.csr_starts(scid, grid.num_cells)
    jgrid = jnb.grid_for_box(*box, h)
    order = np.asarray(jnp.argsort(jnb.cell_id(V3.from_rows(raw), jgrid),
                                   stable=True))
    pos_s = V3.from_rows(raw[order])
    np.testing.assert_array_equal(pos.numpy(), pos_s.to_numpy())
    table = jnb.build_cell_table(pos_s, jgrid)
    _, plan = jnb.find_neighbors_grouped(
        pos_s, jnp.arange(n, dtype=jnp.int32), pos_s, table, jgrid, K=64,
        nbcap=16, B=B, exclude_self=True)
    jeng = bandmat.build_coef_engine(pos_s, h=h, m=m, plan=plan, B=B,
                                     dtype=jnp.float32)
    eng = coef.coef_from_blocks(np.asarray(jeng.blkq), np.asarray(jeng.w),
                                n, B, bandmat.BLOCK)

    def f32(a):
        return torch.from_numpy(np.asarray(a, np.float32))

    rho = f32(rng.uniform(900.0, 1100.0, n))
    d = cases.dfsph_inputs(pos, starts, grid, h, m, rho, seed=5)
    assert int((d["counts"] < dfsph.MIN_NEIGHBORS).sum()) > 0
    return dict(pos=pos, eng=eng, jops=bandmat.coef_matvec_ops(jeng, n, B),
                v=f32(rng.standard_normal((n, 3))),
                k=f32(rng.uniform(0.0, 2.0, n)), **d)


def _mode(x, divergence):
    return (coef.Divergence(x["counts"], dfsph.MIN_NEIGHBORS) if divergence
            else coef.Density(x["dt2"], RHO0))


def _kick_args(x, variant, wk):
    _, masks = VARIANTS[variant]
    args = (x["v"], x["k"], x["S"], x["dt"])
    args += (x["wk"], x["dr"], x["alpha"]) if wk else (None,) * 3
    return args + ((x["upd"],) if masks else (None,))


def _rate_args(x, variant, divergence):
    """The rate's arguments after its source: v for the composition, the
    record for the plain version."""
    c_s, masks = VARIANTS[variant]
    return (x["S"], x["alpha"], x["rho"], x["dt"], _mode(x, divergence),
            x["c_s"] if c_s else None, x["owned"] if masks else None)


def _np(t):
    return None if t is None else np.array(t)


def _jax_rate(x, variant, divergence):
    """JAX's rho_derivative or rho_adv_residual (resid_mask = owned) and
    the outputs the port's rate gives, from JAX's: dr, k, the masked
    value and the selection."""
    c_s, masks = VARIANTS[variant]
    mv, mvd = x["jops"]
    counts = jnp.asarray(x["counts"].numpy())
    owned = x["owned"].numpy() if masks else None
    S = V3.from_rows(x["S"].numpy())
    ops = jdfsph.loop_operators(
        mv, mvd, S, counts, None if owned is None else jnp.asarray(owned))
    v = V3.from_rows(x["v"].numpy())
    cs = jnp.asarray(x["c_s"].numpy()) if c_s else jnp.float32(0.0)
    alpha, rho = x["alpha"].numpy(), x["rho"].numpy()
    dt, dt2 = np.float32(x["dt"]), np.float32(x["dt2"])
    if divergence:
        dr, avg = ops[2](v, cs)
        val = _np(dr)
        sel = val > 0.0
        k = (val * alpha / dt) / rho
    else:
        rho_adv, avg = ops[3](jnp.asarray(rho), jnp.float32(dt), v, cs)
        val = _np(rho_adv)
        sel = val != RHO0
        k = ((val - RHO0) * alpha / dt2) / rho
    if owned is not None:
        sel &= owned
    want = coef.Rate(torch.from_numpy(val) if divergence else None,
                     torch.from_numpy(k.astype(np.float32)),
                     torch.from_numpy(np.where(sel, val, 0.0)
                                      .astype(np.float32)),
                     torch.from_numpy(sel))
    return want, float(avg)


@pytest.mark.parametrize("wk", [False, True])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_kick_matches_jax_stiff_vel_delta(block, variant, wk):
    x = block
    args = _kick_args(x, variant, wk)
    got = coef.dfsph_kick_plain(x["eng"], x["pos"], *args)
    mv, mvd = x["jops"]
    S = V3.from_rows(x["S"].numpy())
    ops = jdfsph.loop_operators(mv, mvd, S, jnp.asarray(x["counts"].numpy()))
    delta = ops[0](jnp.asarray(x["k"].numpy())).to_numpy()
    v = x["v"].numpy()
    new = v - delta * np.float32(x["dt"])
    if args[-1] is not None:
        new = np.where(args[-1].numpy()[:, None], new, v)
    want = (torch.from_numpy(new.astype(np.float32)),
            (x["wk"] + x["dr"] * x["alpha"]) if wk else None)
    e = cases.fused_error("dfsph_kick", got, want,
                          cases.fused_scales("dfsph_kick", x["eng"], x["pos"],
                                             *args), TOL)
    assert e["ok"], e
    assert (got[1] is None) == (not wk)


@pytest.mark.parametrize("divergence", [True, False],
                         ids=["divergence", "density"])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_rate_matches_jax_loop_operators(block, variant, divergence):
    x = block
    args = _rate_args(x, variant, divergence)
    rec = coef.dfsph_pack_plain(x["pos"], x["v"])
    got = coef.dfsph_rate_plain(x["eng"], x["pos"], rec, *args)
    want, avg = _jax_rate(x, variant, divergence)
    e = cases.fused_error("dfsph_rate", got, want,
                          cases.fused_scales("dfsph_rate", x["eng"], x["pos"],
                                             x["v"], *args), TOL)
    assert e["ok"], e
    assert e["flips"] == 0
    assert int(got.sel.sum()) == int(want.sel.sum()) > 0
    cnt = got.sel.sum()
    got_avg = float(torch.where(cnt > 0, got.masked.sum() / cnt,
                                torch.tensor(0.0 if divergence else RHO0)))
    np.testing.assert_allclose(got_avg, avg, rtol=TOL)


# ---------------------------------------------------------------------------
# (b) the parent's composition, written out
# ---------------------------------------------------------------------------

def parent_kick(eng, pos, v, k, S, dt, wk=None, dr=None, alpha=None,
                upd=None):
    """The kick as DFSPH ran it around coef_matvec: `kick` and the
    divergence body's wk update."""
    new = v - (S * k[:, None] + coef.coef_matvec_plain(eng, pos, k)) * dt
    if upd is not None:
        new = torch.where(upd[:, None], new, v)
    return new, (None if wk is None else wk + dr * alpha)


def parent_rate(eng, pos, v, S, alpha, rho, dt, mode, c_s=None,
                owned=None):
    """rho_derivative or rho_adv_residual as DFSPH ran them around
    coef_matvec_dot, with the next kick's k the loop bodies took from
    them, and the average's masked value and selection."""
    d = v[:, 0] * S[:, 0] + v[:, 1] * S[:, 1] + v[:, 2] * S[:, 2] \
        - coef.coef_matvec_dot_plain(eng, pos, v)
    if c_s is not None:
        d = d - c_s
    if isinstance(mode, coef.Divergence):
        dr = torch.where(mode.counts < dfsph.MIN_NEIGHBORS,
                         torch.zeros_like(d), torch.clamp(d, min=0.0))
        sel, val = dr > 0.0, dr
        k = (dr * alpha / dt) / rho
    else:
        dr = None
        val = torch.clamp(rho + dt * d, min=RHO0)
        sel = val != RHO0
        k = ((val - RHO0) * alpha / mode.dt2) / rho
    if owned is not None:
        sel = sel & owned
    return dr, k, torch.where(sel, val, torch.zeros_like(val)), sel


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_plain_versions_give_the_parent_composition_bits(block, variant):
    x = block
    for wk in (False, True):
        args = _kick_args(x, variant, wk)
        got = coef.dfsph_kick_plain(x["eng"], x["pos"], *args)
        assert cases.bit_equal(got[:2], parent_kick(x["eng"], x["pos"],
                                                    *args))
    rec = coef.dfsph_pack_plain(x["pos"], x["v"])
    for divergence in (True, False):
        args = _rate_args(x, variant, divergence)
        assert cases.bit_equal(tuple(coef.dfsph_rate_plain(x["eng"], x["pos"],
                                                           rec, *args)),
                               parent_rate(x["eng"], x["pos"], x["v"], *args))


def test_nan_rates_are_kept_as_the_composition_keeps_them(block):
    """A NaN velocity: the divergence rate stays NaN through the clamp
    (torch.clamp keeps it, as the kernel does) and is not selected, the
    density's rho_adv stays NaN and is selected (NaN != rho0), bit for bit
    as the parent's composition."""
    x = block
    v = x["v"].clone()
    row = int(torch.nonzero(x["counts"] >= dfsph.MIN_NEIGHBORS)[0])
    v[row] = float("nan")
    rec = coef.dfsph_pack_plain(x["pos"], v)
    for divergence in (True, False):
        args = _rate_args(x, "fluid", divergence)
        got = coef.dfsph_rate_plain(x["eng"], x["pos"], rec, *args)
        assert cases.bit_equal(tuple(got),
                               parent_rate(x["eng"], x["pos"], v, *args))
        if divergence:
            assert torch.isnan(got.dr[row]) and not bool(got.sel[row])
        else:
            assert bool(got.sel[row]) and torch.isnan(got.masked[row])


def test_kernel_wrappers_take_cpu_or_cuda_tensors_only(block):
    x = block
    meta = x["pos"].to("meta")
    with pytest.raises(ValueError, match="no kernel for device meta"):
        coef.dfsph_kick(x["eng"], meta, x["v"], x["k"], x["S"], x["dt"])
    with pytest.raises(ValueError, match="no kernel for device meta"):
        coef.dfsph_rate(x["eng"], meta, x["v"].to("meta"),
                        *_rate_args(x, "fluid", True))


# ---------------------------------------------------------------------------
# (c) the loops' choice
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("budget", ["default", "zero"])
def test_dfsph_loops_take_the_kernels_on_the_coef_engine(budget,
                                                        monkeypatch):
    """One TINY step: on the stored-coefficient engine every kick and rate
    goes through the two wrappers (1 + iterations of each loop a step) and
    the density loop's first record through dfsph_pack (once); on the
    recompute engine none does, and the composition runs on the stencil
    kernels."""
    if budget == "zero":
        monkeypatch.setattr(dfsph, "COEF_BYTE_BUDGET", 0)
    sim = Simulation(parse_config(copy.deepcopy(TINY)), device="cpu")
    stencil.reset_counts()
    sim.step()
    k = stencil.KERNELS
    iters = round(float(sim.state.diag[0]) + float(sim.state.diag[2]))
    fused = (k["dfsph_kick"].plain_calls, k["dfsph_rate"].plain_calls,
             k["dfsph_pack"].plain_calls)
    if budget == "default":
        assert fused == (1 + iters, 1 + iters, 1)
        assert k["coef_matvec"].plain_calls == 1 + iters
        assert k["matvec"].plain_calls == 0
    else:
        assert fused == (0, 0, 0)
        assert k["matvec"].plain_calls == k["matvec_dot"].plain_calls \
            == 1 + iters
