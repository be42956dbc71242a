"""The port's CSR-stencil pair passes (cfd_taichi_tpu_torch/ops/stencil.py)
held against the JAX passes they replace, on the TINY scene of
tests/test_solvers.py:14-23 (216 fluid particles, Akinci walls) with a
numpy-seeded jitter of 0.1 r and random v, k and rho.

On the CPU the wrappers run their plain PyTorch versions; the CUDA kernels
are compared with those plain versions in tests/test_torch_cuda.py.

Tolerances: both sides sum the same f32 pair terms, in different orders,
so a sum can differ by a few ulp of its largest term. Where terms cancel
(S, tvec and the viscosity in the bulk) a per-element rtol means nothing,
so every float output is compared with atol = 1e-5 x its largest
magnitude. Integer counts must match exactly.
"""

import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfd_taichi_tpu import scene as jscene
from cfd_taichi_tpu.config import parse_config as jparse_config
from cfd_taichi_tpu.models import base as jbase
from cfd_taichi_tpu.ops import bandmat
from cfd_taichi_tpu.ops import neighbors as jnb
from cfd_taichi_tpu.ops.vec import V3
from cfd_taichi_tpu_torch import build_scene
from cfd_taichi_tpu_torch.config import parse_config
from cfd_taichi_tpu_torch.models import base
from cfd_taichi_tpu_torch.ops import coef
from cfd_taichi_tpu_torch.ops import neighbors as nb
from cfd_taichi_tpu_torch.ops import stencil

TINY = {
    "scene": {"box_min": [0.0, 0.0, 0.0], "box_max": [0.6, 0.8, 0.6],
              "particle_radius": 0.025, "gravity": 9.8},
    "solver": {"name": "dfsph", "delta_time": 4e-4, "iter_cnt": 1},
    "fluid": {"start_pos": [0.15, 0.1, 0.15], "water_size": [0.3, 0.3, 0.3]},
}
SEED = 20261016
VISC = dict(c_s=13.0, alpha=0.08)


def close(got, want, scale_rtol=1e-5):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=scale_rtol * float(np.abs(want).max()))


@pytest.fixture(scope="module")
def case():
    jsc = jscene.build_scene(jparse_config(copy.deepcopy(TINY)))
    st, arrays = jsc.static, jsc.arrays
    sc = build_scene(parse_config(copy.deepcopy(TINY)), device="cpu")
    rng = np.random.default_rng(SEED)
    r = st.particle_radius
    pos = jsc.fluid_pos0.to_numpy() + rng.uniform(
        -0.1 * r, 0.1 * r, (st.n_fluid, 3)).astype(np.float32)
    pos = pos.astype(np.float32)
    dp = jbase.build_dense_prep(st, arrays, V3.from_rows(pos),
                                st.band_nb_wide, st.band_B)
    assert int(dp.overflow) == 0
    scid, perm, pos_s, _ = base.sort_by_cells(sc.grid, torch.from_numpy(pos))
    np.testing.assert_array_equal(perm.numpy(), np.asarray(dp.perm))
    np.testing.assert_array_equal(pos_s.numpy(), dp.pos.to_numpy())
    n = st.n_fluid
    return dict(
        st=st, arrays=arrays, sc=sc, dp=dp, pos=pos, pos_s=pos_s,
        starts=nb.csr_starts(scid, sc.grid.num_cells),
        k=rng.uniform(0.0, 2.0, n).astype(np.float32),
        v=rng.standard_normal((n, 3)).astype(np.float32),
        rho=rng.uniform(900.0, 1100.0, n).astype(np.float32))


def _band_terms(c):
    st, dp = c["st"], c["dp"]
    return bandmat.build_band_terms(dp.pos, h=st.h, m=st.particle_m,
                                    plan=dp.plan, B=st.band_B,
                                    dtype=jnp.float32)


def test_csr_table_matches_jax_and_brute_force(case):
    c = case
    sc = c["sc"]
    jt = jnb.build_cell_table(V3.from_rows(c["pos"]), c["st"].grid)
    table = nb.build_cell_table(torch.from_numpy(c["pos"]), sc.grid)
    np.testing.assert_array_equal(table.order.numpy(), np.asarray(jt.order))
    np.testing.assert_array_equal(table.starts.numpy(), np.asarray(jt.starts))
    np.testing.assert_array_equal(c["starts"].numpy(), np.asarray(jt.starts))

    n = c["st"].n_fluid
    brute = jnb.brute_force_neighbors(
        c["dp"].pos, jnp.arange(n), c["dp"].pos, sc.h, K=n, exclude_self=True)
    _, own = nb.brute_force_neighbors(c["pos_s"], c["pos_s"], sc.h,
                                      exclude_self=True)
    ft = stencil.fluid_terms(c["pos_s"], c["starts"], sc.grid, sc.h,
                             sc.particle_m)
    np.testing.assert_array_equal(ft.count.numpy(), np.asarray(brute.count))
    np.testing.assert_array_equal(ft.count.numpy(), own.numpy())


def test_fluid_terms_match_build_band_terms(case):
    c, sc = case, case["sc"]
    want = _band_terms(c)
    assert int(want.band.overflow) == 0
    got = stencil.fluid_terms(c["pos_s"], c["starts"], sc.grid, sc.h,
                              sc.particle_m)
    np.testing.assert_array_equal(got.count.numpy(), np.asarray(want.count))
    close(got.rho, want.rho)
    close(got.s, want.band.s.to_numpy())
    close(got.qsum, want.qsum)
    close(got.tvec, want.tvec.to_numpy())


def test_boundary_terms_match_dense_boundary_terms(case):
    c, sc = case, case["sc"]
    want = c["dp"].bterms
    assert int(want.overflow) == 0
    got = stencil.boundary_terms(c["pos_s"], sc.boundary_pos,
                                 sc.boundary_volume, sc.boundary_starts,
                                 sc.grid, sc.h, 1000.0)
    assert float(np.abs(np.asarray(want.rho)).max()) > 0.0  # walls touched
    close(got.rho, want.rho)
    close(got.s, want.s.to_numpy())
    close(got.qsum, want.qsum)
    close(got.g2, want.g2)


def test_matvec_pair_matches_f32_band(case):
    c, sc = case, case["sc"]
    band = _band_terms(c).band
    got = stencil.matvec(c["pos_s"], c["starts"], sc.grid, sc.h,
                         sc.particle_m, torch.from_numpy(c["k"]))
    close(got, bandmat.matvec(band, jnp.asarray(c["k"])).to_numpy())
    got_dot = stencil.matvec_dot(c["pos_s"], c["starts"], sc.grid, sc.h,
                                 sc.particle_m, torch.from_numpy(c["v"]))
    close(got_dot, bandmat.matvec_dot(band, V3.from_rows(c["v"])))


def test_viscosity_matches_dense_viscosity(case):
    c, sc, st = case, case["sc"], case["st"]
    want = bandmat.dense_viscosity(
        c["dp"].pos, V3.from_rows(c["v"]), jnp.asarray(c["rho"]), h=st.h,
        m=st.particle_m, plan=c["dp"].plan, B=st.band_B, **VISC)
    got = stencil.viscosity(c["pos_s"], c["starts"], sc.grid, sc.h,
                            sc.particle_m, torch.from_numpy(c["v"]),
                            torch.from_numpy(c["rho"]), **VISC)
    close(got, want.to_numpy())


def test_cpu_tensors_take_the_plain_versions(case):
    c = case
    sc, pos, starts = c["sc"], c["pos_s"], c["starts"]
    k, v, rho = (torch.from_numpy(c[key]) for key in ("k", "v", "rho"))
    stencil.reset_counts()
    ft = stencil.fluid_terms(pos, starts, sc.grid, sc.h, sc.particle_m)
    stencil.boundary_terms(pos, sc.boundary_pos, sc.boundary_volume,
                           sc.boundary_starts, sc.grid, sc.h, 1000.0)
    stencil.matvec(pos, starts, sc.grid, sc.h, sc.particle_m, k)
    stencil.matvec_dot(pos, starts, sc.grid, sc.h, sc.particle_m, v)
    stencil.viscosity(pos, starts, sc.grid, sc.h, sc.particle_m, v, rho,
                      **VISC)
    stencil.wcsph_forces(pos, starts, sc.grid, sc.h, sc.particle_m, v, rho,
                         k, tension_k=0.2, **VISC)
    eng = coef.build_coef(pos, starts, sc.grid, sc.h, sc.particle_m,
                          coef.csr_offsets(ft.count))
    coef.coef_matvec(eng, pos, k)
    coef.coef_matvec_dot(eng, pos, v)
    stencil.pcisph_predict_rho(pos, starts, sc.grid, sc.h, sc.particle_m,
                               pos + 0.01 * v, base.walls(sc), 1000.0)
    stencil.pbf_terms(pos, starts, sc.grid, sc.h, sc.particle_m, 1e3, 1e-7)
    stencil.pbf_lambda(pos, starts, sc.grid, sc.h, -1e-5 * k)
    stencil.pbf_xsph(pos, starts, sc.grid, sc.h, pos + 0.01 * v, v)
    for kern in stencil.KERNELS.values():
        assert (kern.launches, kern.plain_calls) == (0, 1), kern.name


def test_wrappers_reject_other_devices(case):
    meta = torch.empty((4, 3), device="meta")
    starts = torch.empty((case["sc"].grid.num_cells + 1,), dtype=torch.int32,
                         device="meta")
    grid = case["sc"].grid
    walls = stencil.Walls(meta, meta[:, 0], starts, starts[1:])
    for call in (
            lambda: stencil.fluid_terms(meta, starts, grid, 0.1, 0.1),
            lambda: stencil.pcisph_predict_rho(meta, starts, grid, 0.1, 0.1,
                                               meta, walls, 1000.0),
            lambda: stencil.pbf_terms(meta, starts, grid, 0.1, 0.1, 1e3,
                                      1e-7),
            lambda: stencil.pbf_boundary_terms(meta, walls, grid, 0.1,
                                               1000.0, 1e3, 1e-7),
            lambda: stencil.pbf_lambda(meta, starts, grid, 0.1, meta[:, 0]),
            lambda: stencil.pbf_xsph(meta, starts, grid, 0.1, meta, meta)):
        with pytest.raises(ValueError, match="no kernel for device"):
            call()
