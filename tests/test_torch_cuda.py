"""The CUDA kernels of cfd_taichi_tpu_torch against their plain PyTorch
versions, on the card. Every test here is marked `cuda` and skips where
torch.cuda is unavailable; the CPU parity of the plain versions with the
JAX package is tests/test_torch_stencil.py and tests/test_torch_dfsph.py.

The file imports no JAX, so on a machine with a card and without JAX run
it without the suite's JAX conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: kernel and plain version sum the same f32 pair terms in a
different order, so float outputs agree to 1e-5 x their largest
magnitude and integer counts exactly; stepped positions agree to the
repo's engine-equivalence bar, atol 5e-6. The coef contraction's final
form cancels (x_i s0 - s), so it is held to 1e-5 of the largest
|x_i| |s_i| and its four lane sums to 1e-5 of each lane's largest value;
the stored pair slots compare exactly.
"""

import copy

import numpy as np
import pytest
import torch

from cfd_taichi_tpu_torch import Simulation, build_scene
from cfd_taichi_tpu_torch.config import parse_config
from cfd_taichi_tpu_torch.models import base
from cfd_taichi_tpu_torch.ops import coef
from cfd_taichi_tpu_torch.ops import neighbors as nb
from cfd_taichi_tpu_torch.ops import stencil
from cfd_taichi_tpu_torch.perf import inputs

TINY = {
    "scene": {"box_min": [0.0, 0.0, 0.0], "box_max": [0.6, 0.8, 0.6],
              "particle_radius": 0.025, "gravity": 9.8},
    "solver": {"name": "dfsph", "delta_time": 4e-4, "iter_cnt": 1},
    "fluid": {"start_pos": [0.15, 0.1, 0.15], "water_size": [0.3, 0.3, 0.3]},
}
VISC = dict(c_s=13.0, alpha=0.08)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run only there")
    return torch.device("cuda")


def _all_outputs(sc, pos, starts, k, v, rho):
    """Every wrapper once, outputs as a flat list (coef lane sums one lane
    at a time)."""
    g, h, m = sc.grid, sc.h, sc.particle_m
    ft = stencil.fluid_terms(pos, starts, g, h, m)
    eng = coef.build_coef(pos, starts, g, h, m, coef.csr_offsets(ft.count))
    return [*ft,
            *stencil.boundary_terms(pos, sc.boundary_pos, sc.boundary_volume,
                                    sc.boundary_starts, g, h, 1000.0),
            stencil.matvec(pos, starts, g, h, m, k),
            stencil.matvec_dot(pos, starts, g, h, m, v),
            stencil.viscosity(pos, starts, g, h, m, v, rho, **VISC),
            eng.nbr, eng.w,
            *coef.coef_matvec(eng, pos, k, lane_sums=True).unbind(1),
            *coef.coef_matvec_dot(eng, pos, v, lane_sums=True).unbind(1)]


def _tiny_inputs(dev, seed=11):
    """TINY's seed lattice with a 0.1 r jitter, cell-sorted, and random k,
    v and rho: the same numbers on every device for one seed."""
    sc = build_scene(parse_config(copy.deepcopy(TINY)), device=dev)
    rng = np.random.default_rng(seed)
    n, r = sc.n_fluid, sc.particle_radius
    jitter, k, v, rho = (
        torch.tensor(a, dtype=torch.float32, device=dev) for a in
        (rng.uniform(-0.1 * r, 0.1 * r, (n, 3)), rng.uniform(0.0, 2.0, n),
         rng.standard_normal((n, 3)), rng.uniform(900.0, 1100.0, n)))
    scid, _, pos, _ = base.sort_by_cells(sc.grid, sc.fluid_pos0 + jitter)
    return sc, pos, nb.csr_starts(scid, sc.grid.num_cells), k, v, rho


@pytest.mark.cuda
def test_kernels_match_plain_versions(cuda):
    outputs = {}
    for dev in (cuda, torch.device("cpu")):
        inputs = _tiny_inputs(dev)
        stencil.reset_counts()
        outputs[dev.type] = _all_outputs(*inputs)
        torch.cuda.synchronize()
        want = (1, 0) if dev.type == "cuda" else (0, 1)
        for kern in stencil.KERNELS.values():
            assert (kern.launches, kern.plain_calls) == want, kern.name
    for got, ref in zip(outputs["cuda"], outputs["cpu"]):
        got = got.cpu().numpy()
        if ref.dtype == torch.int32:
            np.testing.assert_array_equal(got, ref.numpy())
        else:
            np.testing.assert_allclose(
                got, ref.numpy(), rtol=0,
                atol=1e-5 * float(ref.abs().max()))


@pytest.mark.cuda
def test_dfsph_steps_on_the_card_match_the_cpu(cuda):
    sims = [Simulation(parse_config(copy.deepcopy(TINY)), device=dev)
            for dev in (cuda, "cpu")]
    for _ in range(6):
        for s in sims:
            s.step()
        a, b = (s.state for s in sims)
        pa = a.fluid.pos.cpu().numpy()[np.argsort(a.fluid.oid.cpu().numpy())]
        pb = b.fluid.pos.numpy()[np.argsort(b.fluid.oid.numpy())]
        np.testing.assert_allclose(pa, pb, atol=5e-6)
        np.testing.assert_allclose(float(a.dt), float(b.dt), rtol=1e-5)
        np.testing.assert_array_equal(a.diag.cpu().numpy()[[0, 2]],
                                      b.diag.numpy()[[0, 2]])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_coef_kernels_match_plain_versions(cuda, dtype):
    sc, pos, starts, k, v, _ = _tiny_inputs(cuda)
    g, h, m = sc.grid, sc.h, sc.particle_m
    off = coef.csr_offsets(stencil.fluid_terms(pos, starts, g, h, m).count)
    eng = coef.build_coef(pos, starts, g, h, m, off, dtype)
    want = coef.CoefEngine(*(t.cpu() for t in coef.build_coef_plain(
        pos, starts, g, h, m, off, dtype)))
    np.testing.assert_array_equal(eng.nbr.cpu().numpy(), want.nbr.numpy())
    got_w, want_w = eng.w.float().cpu().numpy(), want.w.float().numpy()
    if dtype == torch.float32:
        np.testing.assert_allclose(got_w, want_w, rtol=0,
                                   atol=1e-5 * np.abs(want_w).max())
    else:
        # f32 w that differ in the last bits may round to neighbouring
        # bf16 values: at most one ulp (2^-7 relative) apart.
        np.testing.assert_allclose(got_w, want_w, rtol=2.0**-7)
    for fn, x in ((coef.coef_matvec, k), (coef.coef_matvec_dot, v)):
        sums = fn(eng, pos, x, lane_sums=True).cpu().numpy()
        ref = fn(want, pos.cpu(), x.cpu(), lane_sums=True).numpy()
        for r in range(4):
            np.testing.assert_allclose(
                sums[:, r], ref[:, r], rtol=0,
                atol=1e-5 * float(np.abs(ref[:, r]).max()))
        lanes = ref[:, :1] if fn is coef.coef_matvec else ref[:, :3]
        scale = float((np.linalg.norm(pos.cpu().numpy(), axis=1)
                       * np.linalg.norm(lanes, axis=1)).max())
        np.testing.assert_allclose(fn(eng, pos, x).cpu().numpy(),
                                   fn(want, pos.cpu(), x.cpu()).numpy(),
                                   rtol=0, atol=1e-5 * scale)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1000, 1003])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_coef_kernels_on_ragged_engines(cuda, dtype, n):
    """Rows of 0, 1, G-1, G+1 and 100+ pairs, random sources, a row count
    that is not a multiple of the rows a block takes."""
    eng, pos, k, v = inputs.ragged_engine(n, dtype, device=cuda)
    cpu = coef.CoefEngine(*(t.cpu() for t in eng))
    for fn, x in ((coef.coef_matvec, k), (coef.coef_matvec_dot, v)):
        sums = fn(eng, pos, x, lane_sums=True).cpu().numpy()
        ref = fn(cpu, pos.cpu(), x.cpu(), lane_sums=True).numpy()
        for r in range(4):
            np.testing.assert_allclose(
                sums[:, r], ref[:, r], rtol=0,
                atol=1e-5 * float(np.abs(ref[:, r]).max()))
        lanes = ref[:, :1] if fn is coef.coef_matvec else ref[:, :3]
        scale = float((np.linalg.norm(pos.cpu().numpy(), axis=1)
                       * np.linalg.norm(lanes, axis=1)).max())
        np.testing.assert_allclose(fn(eng, pos, x).cpu().numpy(),
                                   fn(cpu, pos.cpu(), x.cpu()).numpy(),
                                   rtol=0, atol=1e-5 * scale)
