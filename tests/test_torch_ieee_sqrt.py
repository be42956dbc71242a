"""The port's square roots on the CPU, which its plain versions and steps
are held to the JAX package by.

On the CPU torch.sqrt runs MKL's vector math: it rounds up to an ulp off
the exact root, and on its first call in a process, where the intra-op
threads enter it together, it has returned whole threads' chunks up to
3.2e-4 off (about one fresh process in forty). A process whose first
root was the plain pair passes' distance r then gave PBF's four sums, the
rigid sums and every other pass 1e-4 to 1e-3 of scale off JAX's. The port
takes every root through `smoothing.ieee_sqrt`, the IEEE root on every
device. Held here, within one process:

* `ieee_sqrt` is numpy's root (the processor's sqrt instruction) bit for
  bit, on the pair distances' range and on 0-d and strided tensors;
* the plain passes' pair distances (`stencil._pair_chunks`, which the
  rigid passes share) are that root of max(r2, 1e-24), bit for bit;
* with torch.sqrt replaced by one that keeps 12 bits (what the first call
  gave), `stencil.pbf_terms_plain` still holds to JAX's
  `bandmat.dense_pbf_ops` at tests/test_torch_pbf.py's 1e-5 bar, the
  fluid-rigid plain versions keep their bits, and so does a coupled step
  of each solver whose step takes a root (DFSPH's CFL and the body's
  speed, PCISPH's stiffness).
"""

import copy

import numpy as np
import pytest
import torch

from cfd_taichi_tpu_torch import Simulation, build_scene
from cfd_taichi_tpu_torch.config import parse_config
from cfd_taichi_tpu_torch.models import pbf
from cfd_taichi_tpu_torch.ops import rigid as R
from cfd_taichi_tpu_torch.ops import smoothing as sm
from cfd_taichi_tpu_torch.ops import stencil
from cfd_taichi_tpu_torch.perf import cases, inputs
from test_torch_dfsph_rigid import rigid_cfg
from test_torch_pbf import _check_terms, _jax_ops, pair_case  # noqa: F401
from test_torch_rigid_stream import TINY_BODY

SQRT = torch.sqrt


def coarse_sqrt(t: torch.Tensor) -> torch.Tensor:
    """torch.sqrt with the low 12 of its 23 mantissa bits cleared: off by
    up to 4.9e-4, as the first call's chunks were off by up to 3.2e-4."""
    return (SQRT(t).view(torch.int32) & ~0xFFF).view(torch.float32)


def _bits(out) -> list:
    return [t.contiguous().view(torch.int32) for t in cases.tensors(out)]


def test_ieee_sqrt_is_the_exact_root():
    rng = np.random.default_rng(7)
    x = np.concatenate([rng.uniform(0.0, 0.0121, 1_000_000),
                        rng.uniform(1e-24, 1e-12, 1000), [0.0, 1e-24]])
    x = torch.from_numpy(x.astype(np.float32))
    got = sm.ieee_sqrt(x)
    assert got.dtype == torch.float32 and got.shape == x.shape
    np.testing.assert_array_equal(got.numpy(), np.sqrt(x.numpy()))
    # torch.sqrt on the CPU is not it (MKL's vector math, an ulp off)
    assert int((SQRT(x) != got).sum()) > 0
    assert float(sm.ieee_sqrt(torch.tensor(2.0, dtype=torch.float32))) == \
        float(np.sqrt(np.float32(2.0)))
    np.testing.assert_array_equal(sm.ieee_sqrt(x[::7]).numpy(),
                                  np.sqrt(x.numpy()[::7]))


def test_pair_distances_are_the_exact_root(pair_case):  # noqa: F811
    c, sc = pair_case, pair_case["sc"]
    n = 0
    for _, pr in stencil._pair_chunks(c["pos_s"], c["pos_s"], c["starts"],
                                      sc.grid, sc.h, exclude_self=True):
        want = np.sqrt(np.maximum(pr.r2.numpy(), np.float32(1e-24)))
        np.testing.assert_array_equal(pr.r.numpy(), want)
        n += int(pr.valid.sum())
    assert n > 1000


def test_pbf_terms_hold_to_jax_whatever_torch_sqrt_gives(
        pair_case, monkeypatch):  # noqa: F811
    c, sc = pair_case, pair_case["sc"]
    terms, _, _ = _jax_ops(c)
    monkeypatch.setattr(torch, "sqrt", coarse_sqrt)
    got, _ = stencil.pbf_terms_plain(c["pos_s"], c["starts"], sc.grid, sc.h,
                                     sc.particle_m, c["w_ref"],
                                     pbf.TENSION_K)
    _check_terms(got, terms)


def test_rigid_plain_versions_keep_their_bits_whatever_torch_sqrt_gives(
        monkeypatch):
    sc = build_scene(parse_config(copy.deepcopy(TINY_BODY)), device="cpu")
    x = inputs.coupled_inputs(sc, 11, device="cpu")
    plains = [plain for _, plain in cases.gated_calls(x).values()]
    side = (x["rpos"], x["rvol"], x["p"], x["st"], x["grid"], x["h"],
            cases.RHO0, x["u"], x["force"])
    plains.append(lambda: R.rigid_side_force_plain(*side))
    want = [_bits(plain()) for plain in plains]
    monkeypatch.setattr(torch, "sqrt", coarse_sqrt)
    for plain, w in zip(plains, want):
        assert all(torch.equal(a, b) for a, b in zip(_bits(plain()), w))


@pytest.mark.parametrize("solver", ["dfsph", "pcisph"])
def test_coupled_steps_keep_their_bits_whatever_torch_sqrt_gives(
        solver, monkeypatch):
    """RIGID_CFG squeezed by 0.85 (pressure acts), one frame, built and
    stepped with torch.sqrt as it is and with the coarse one."""
    def frame():
        sim = Simulation(parse_config(rigid_cfg(**{"solver.name": solver})),
                         device="cpu")
        sim.state = inputs.squeezed(sim.state)
        sim.frame()
        return [sim.state.fluid.pos, sim.state.fluid.vel, sim.state.dt,
                sim.state.rigid.pos, sim.state.rigid.vel]

    want = _bits(tuple(frame()))
    monkeypatch.setattr(torch, "sqrt", coarse_sqrt)
    got = _bits(tuple(frame()))
    assert all(torch.equal(a, b) for a, b in zip(got, want))
