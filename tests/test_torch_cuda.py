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
the stored pair slots compare exactly, and bf16 w within one ulp in at
most 1e-4 of the slots (perf/cases.py, build_error).
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
from cfd_taichi_tpu_torch.perf import cases, inputs

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
            stencil.wcsph_forces(pos, starts, g, h, m, v, rho, 0.01 * k,
                                 **cases.WCSPH),
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
    _assert_card_matches_cpu(
        [Simulation(parse_config(copy.deepcopy(TINY)), device=dev)
         for dev in (cuda, "cpu")])


@pytest.mark.cuda
@pytest.mark.parametrize("solver", ["wcsph", "iisph"])
def test_wcsph_and_iisph_steps_on_the_card_match_the_cpu(cuda, solver):
    """From TINY's block squeezed by 0.85 about its centre, so that
    pressure acts."""
    raw = copy.deepcopy(TINY)
    raw["solver"]["name"] = solver
    sims = [Simulation(parse_config(raw), device=dev)
            for dev in (cuda, "cpu")]
    for s in sims:
        s.state = inputs.squeezed(s.state)
    _assert_card_matches_cpu(sims)


def _assert_card_matches_cpu(sims):
    """Six steps of the card's and the CPU's simulation: positions through
    oid, dt and iteration counts."""
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


@pytest.fixture
def clustered(cuda):
    """The clustered cloud (a blob of ~200 a cell, empty cells, pairs at
    exactly r = h on cell faces, particles clamped into edge cells) and
    its CSR offsets."""
    x = inputs.clustered_inputs(20_000, seed=5, device=cuda)
    return x, coef.csr_offsets(stencil.fluid_terms(
        x["p"], x["st"], x["grid"], x["h"], x["m"]).count)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_coef_build_on_the_clustered_cloud(clustered, dtype):
    x, off = clustered
    args = (x["p"], x["st"], x["grid"], x["h"], x["m"], off, dtype)
    err = cases.build_error(coef.build_coef(*args),
                            coef.build_coef_plain(*args))
    assert err["ok"], err


@pytest.mark.cuda
def test_viscosity_on_the_clustered_cloud(clustered):
    x, _ = clustered
    args = (x["p"], x["st"], x["grid"], x["h"], x["m"], x["v"], x["rho"])
    want = stencil.viscosity_plain(*args, **VISC).cpu().numpy()
    np.testing.assert_allclose(
        stencil.viscosity(*args, **VISC).cpu().numpy(), want, rtol=0,
        atol=1e-5 * np.abs(want).max())


@pytest.mark.cuda
def test_fluid_terms_on_the_clustered_cloud(clustered):
    x, _ = clustered
    args = (x["p"], x["st"], x["grid"], x["h"], x["m"])
    got, want = stencil.fluid_terms(*args), stencil.fluid_terms_plain(*args)
    np.testing.assert_array_equal(got.count.cpu().numpy(),
                                  want.count.cpu().numpy())
    assert cases.terms_error(got, want) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("table", ["given", "made by the wrapper"])
def test_boundary_terms_on_the_clustered_cloud(clustered, table):
    """Over the cloud's boundary set (a wall sheet on cell faces, a dense
    patch, particles clamped into edge cells, none near most queries),
    with the per-cell table handed in or left to the wrapper."""
    x, _ = clustered
    args = (x["p"], x["bp"], x["bvol"], x["bst"], x["grid"], x["h"], 1000.0)
    near = nb.stencil_counts(x["bst"], x["grid"]) if table == "given" \
        else None
    want = stencil.boundary_terms_plain(*args)
    assert float(want.rho.max()) > 0.0 and int((want.rho == 0).sum()) > 0
    assert cases.terms_error(stencil.boundary_terms(*args, near), want) \
        <= 1e-5


def _recompute_products(x):
    """[(kernel output, plain output)] of matvec and matvec_dot on `x`."""
    args = (x["p"], x["st"], x["grid"], x["h"], x["m"])
    return [(stencil.matvec(*args, x["k"]),
             stencil.matvec_plain(*args, x["k"])),
            (stencil.matvec_dot(*args, x["v"]),
             stencil.matvec_dot_plain(*args, x["v"]))]


@pytest.mark.cuda
def test_recompute_products_on_the_clustered_cloud(clustered):
    """Queries of hundreds of pairs drain their queues several times."""
    x, off = clustered
    assert int((off[1:] - off[:-1]).max()) > 100
    for got, want in _recompute_products(x):
        assert float(want.abs().max()) > 0.0
        assert cases.scaled_error(got, want) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 129])
def test_recompute_products_with_one_live_lane(cuda, n):
    """n = 1 and n = 129: the last warp holds one query and 31 lanes
    without one, which must walk along to every vote."""
    x = inputs.clustered_inputs(2000, seed=5, device=cuda)
    scid, _, p, _ = base.sort_by_cells(x["grid"], x["p"][-n:].clone())
    few = dict(x, p=p, st=nb.csr_starts(scid, x["grid"].num_cells),
               k=x["k"][:n].contiguous(), v=x["v"][:n].contiguous())
    for got, want in _recompute_products(few):
        assert got.shape == want.shape and bool(torch.isfinite(got).all())
        np.testing.assert_allclose(
            got.cpu().numpy(), want.cpu().numpy(), rtol=0,
            atol=1e-5 * max(float(want.abs().max()), 1e-30))


@pytest.mark.cuda
def test_recompute_products_repeat_bit_for_bit(clustered):
    x, _ = clustered
    args = (x["p"], x["st"], x["grid"], x["h"], x["m"])
    for fn, arg in ((stencil.matvec, x["k"]), (stencil.matvec_dot, x["v"])):
        assert torch.equal(fn(*args, arg), fn(*args, arg))


def _wcsph_pair(x):
    """(kernel output, plain output) of wcsph_forces on inputs `x`, with
    their positive p' (`pr`) and random velocities."""
    args = (x["p"], x["st"], x["grid"], x["h"], x["m"], x["v"], x["rho"],
            x["pr"])
    return (stencil.wcsph_forces(*args, **cases.WCSPH),
            stencil.wcsph_forces_plain(*args, **cases.WCSPH))


@pytest.mark.cuda
def test_wcsph_forces_on_the_30k_lattice(cuda):
    x = inputs.lattice_inputs("breaking_dam_30k.json", seed=7, device=cuda)
    sc = x["sc"]
    got, want = _wcsph_pair(dict(x, grid=sc.grid, h=sc.h, m=sc.particle_m))
    assert float(want.abs().max()) > 0.0
    assert cases.scaled_error(got, want) <= 1e-5


@pytest.mark.cuda
def test_wcsph_forces_on_the_clustered_cloud(clustered):
    x, off = clustered
    assert int((off[1:] - off[:-1]).max()) > 100
    got, want = _wcsph_pair(x)
    assert cases.scaled_error(got, want) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 129])
def test_wcsph_forces_with_one_live_lane(cuda, n):
    """n = 1 and n = 129: the last warp holds one query and 31 lanes
    without one, which must walk along to every vote."""
    x = inputs.clustered_inputs(2000, seed=5, device=cuda)
    scid, _, p, _ = base.sort_by_cells(x["grid"], x["p"][-n:].clone())
    few = dict(x, p=p, st=nb.csr_starts(scid, x["grid"].num_cells),
               **{key: x[key][:n].contiguous() for key in ("v", "rho", "pr")})
    got, want = _wcsph_pair(few)
    assert got.shape == want.shape == (n, 3)
    assert bool(torch.isfinite(got).all())
    np.testing.assert_allclose(
        got.cpu().numpy(), want.cpu().numpy(), rtol=0,
        atol=1e-5 * max(float(want.abs().max()), 1e-30))


@pytest.mark.cuda
def test_wcsph_forces_repeat_bit_for_bit(clustered):
    x, _ = clustered
    assert torch.equal(_wcsph_pair(x)[0], _wcsph_pair(x)[0])
