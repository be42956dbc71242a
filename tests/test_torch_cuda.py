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

import contextlib
import copy

import numpy as np
import pytest
import torch

from cfd_taichi_tpu_torch import Simulation, build_scene
from cfd_taichi_tpu_torch import geometry as geo
from cfd_taichi_tpu_torch.config import parse_config
from cfd_taichi_tpu_torch.models import base, dfsph, pbf, pcisph
from cfd_taichi_tpu_torch.ops import coef
from cfd_taichi_tpu_torch.ops import neighbors as nb
from cfd_taichi_tpu_torch.ops import rigid
from cfd_taichi_tpu_torch.ops import stencil
from cfd_taichi_tpu_torch.ops.smoothing import f32
from cfd_taichi_tpu_torch.perf import cases, inputs

TINY = {
    "scene": {"box_min": [0.0, 0.0, 0.0], "box_max": [0.6, 0.8, 0.6],
              "particle_radius": 0.025, "gravity": 9.8},
    "solver": {"name": "dfsph", "delta_time": 4e-4, "iter_cnt": 1},
    "fluid": {"start_pos": [0.15, 0.1, 0.15], "water_size": [0.3, 0.3, 0.3]},
}
VISC = dict(c_s=13.0, alpha=0.08)
# tests/test_rigid.py:12-21 as DFSPH, the body in the water
RIGID_CFG = {
    "scene": {"box_min": [0, 0, 0], "box_max": [0.8, 1.0, 0.8],
              "particle_radius": 0.025, "gravity": 9.8},
    "solver": {"name": "dfsph", "delta_time": 4e-4, "iter_cnt": 1,
               "boundary_handle": True, "fs_couple": True},
    "fluid": {"start_pos": [0.1, 0.05, 0.1], "water_size": [0.6, 0.25, 0.6]},
    "solid": {"mesh": "builtin:cube1", "voxel_radius": 0.025,
              "rho_0": 500, "scale": 0.18, "pos_offset": [0.4, 0.28, 0.4],
              "attitude_offset": [0.0, 0.0, 0.0], "fill": True,
              "active": True},
}


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
    terms, pl = stencil.pbf_constraint(pos, starts, g, h, m, pbf.w_ref(h),
                                       pbf.TENSION_K, None, base.walls(sc),
                                       *pbf.ROW_CONSTANTS)
    return [*ft,
            *stencil.boundary_terms(pos, sc.boundary_pos, sc.boundary_volume,
                                    sc.boundary_starts, g, h, 1000.0),
            stencil.matvec(pos, starts, g, h, m, k),
            stencil.matvec_dot(pos, starts, g, h, m, v),
            stencil.viscosity(pos, starts, g, h, m, v, rho, **VISC),
            stencil.wcsph_forces(pos, starts, g, h, m, v, rho, 0.01 * k,
                                 **cases.WCSPH),
            *terms, pl.cnt, stencil.stored_pairs(pl)[1].to(torch.int32),
            stencil.pbf_lambda(pos, pl, h, -1e-5 * k),
            stencil.pbf_xsph(pl, h, pos + 0.01 * v, v),
            stencil.pcisph_predict_rho(pos, starts, g, h, m, pos + 0.01 * v,
                                       base.walls(sc), 1000.0, eng=eng),
            eng.nbr, eng.w,
            *coef.coef_matvec(eng, pos, k, lane_sums=True).unbind(1),
            *coef.coef_matvec_dot(eng, pos, v, lane_sums=True).unbind(1),
            *_dfsph_outputs(eng, pos, ft, k, v, rho),
            *_body_outputs(sc, pos, starts, v, rho)]


def _dfsph_outputs(eng, pos, ft, k, v, rho):
    """DFSPH's loop kernels once each, in their fullest form: the kick with
    wk and a rank's upd mask (and its record), the pack of v, the
    divergence rate over that record with a contact dot and a rank's owned
    mask (the floats: a row's selection may differ at the threshold
    between summation orders)."""
    dt = torch.tensor(4e-4, dtype=torch.float32, device=pos.device)
    alpha = 1e-3 * k
    kick = coef.dfsph_kick(eng, pos, v, k, ft.s, dt, k, 0.5 * k, alpha,
                           k > 0.2)
    rec = coef.dfsph_pack(pos, v)
    rate = coef.dfsph_rate(eng, pos, rec, ft.s, alpha, rho, dt,
                           coef.Divergence(ft.count, dfsph.MIN_NEIGHBORS),
                           0.1 * k, k < 1.8)
    return [*kick, rec, rate.dr, rate.k, rate.masked]


def _body_outputs(sc, pos, starts, v, rho):
    """The fluid-rigid wrappers (the reaction's walk, and its list's rows,
    the list and its stream among them; the body's gate, made once and
    taken by the four gated passes) and PCISPH's predicted density with
    its walks over the body and the walls once, for a 24-voxel box body in
    TINY's block with numpy-seeded volumes and velocities."""
    dev = pos.device
    rng = np.random.default_rng(13)
    vox = np.ascontiguousarray(geo.voxelize_mesh(
        *geo.load_mesh("builtin:cube1", scale=0.18), pitch=0.05)
        + np.float32([0.25, 0.2, 0.25]))
    nr = vox.shape[0]
    rpos, rvol, v_r, rq, force = (
        torch.tensor(a, dtype=torch.float32, device=dev) for a in
        (vox, rng.uniform(1e-4, 2e-4, nr), rng.standard_normal((nr, 3)),
         rng.uniform(900.0, 1100.0, nr), rng.standard_normal((nr, 3))))
    table = rigid.rigid_table(sc.grid, rpos, rvol)
    g, h, m = sc.grid, sc.h, sc.particle_m
    box = stencil.make_body_box(table.pos, h)
    offs = rigid.rigid_side_rows(rpos, starts, g)
    side = rigid.rigid_side_list(rpos, rvol, pos, starts, g, h, 1000.0,
                                 offs, rigid.list_slots(offs))
    _, fluid, pair_g = rigid.side_pairs(side)
    return [*rigid.rigid_terms(pos, table, g, h, 1000.0, body_box=box), box,
            rigid.rigid_contact_dot(pos, table, g, h, 1000.0, v_r, box),
            rigid.rigid_viscosity(pos, table, g, h, 1000.0, m, v, rho, rq,
                                  v_r[0].contiguous(), **VISC,
                                  body_box=box),
            rigid.rigid_side_force(rpos, rvol, pos, starts, g, h, 1000.0,
                                   1e-4 * rho, force),
            offs.to(torch.int32), side.cnt, fluid.to(torch.int32), pair_g,
            rigid.rigid_side_force_list(side, 1e-4 * rho, force),
            stencil.pcisph_predict_rho(pos, starts, g, h, m, pos + 0.01 * v,
                                       base.walls(sc), 1000.0, table,
                                       body_box=box)]


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
        for kern in stencil.KERNELS.values():
            # the plain dfsph_kick runs the plain coef_matvec
            want = (1, 0) if dev.type == "cuda" else \
                (0, 2 if kern.name == "coef_matvec" else 1)
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


@pytest.mark.cuda
@pytest.mark.parametrize("solver", ["pcisph", "pbf"])
def test_pcisph_and_pbf_steps_on_the_card_match_the_cpu(cuda, solver):
    """From TINY's block squeezed by 0.85 about its centre: PCISPH's loop
    iterates, PBF's constraint acts."""
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
@pytest.mark.parametrize("form", ["", "_div", "_mask", "_mask_den"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dfsph_loop_kernels_match_the_composition(cuda, dtype, form):
    """dfsph_kick and dfsph_rate on the jittered TINY lattice, in each form
    a loop calls them (perf/cases.dfsph_cases: the density loop's, the
    divergence loop's, and both with a rank's masks and a contact dot):
    bit for bit against the composition the loops ran before (coef_matvec
    or coef_matvec_dot, then the torch ops) and over two launches, and
    against the plain version to 1e-5 of each output's terms
    (cases.fused_error: the selection may differ only at the average's
    threshold)."""
    sc = build_scene(parse_config(copy.deepcopy(TINY)), device=cuda)
    rng = np.random.default_rng(7)
    n = sc.n_fluid
    jitter = rng.uniform(-0.1, 0.1, (n, 3)).astype(np.float32)
    raw = sc.fluid_pos0 + torch.from_numpy(jitter).to(cuda) * \
        sc.particle_radius
    scid, _, pos, _ = base.sort_by_cells(sc.grid, raw)
    starts = nb.csr_starts(scid, sc.grid.num_cells)
    g, h, m = sc.grid, sc.h, sc.particle_m

    def dev(a):
        return torch.from_numpy(a.astype(np.float32)).to(cuda)

    k, v = dev(rng.uniform(0.0, 2.0, n)), dev(rng.standard_normal((n, 3)))
    rho = dev(rng.uniform(900.0, 1100.0, n))
    d = cases.dfsph_inputs(pos, starts, g, h, m, rho, seed=3)
    off = coef.csr_offsets(stencil.fluid_terms(pos, starts, g, h, m).count)
    eng = coef.build_coef(pos, starts, g, h, m, off, dtype)
    for case in cases.dfsph_cases(eng, pos, v, k, d, forms=(form,)):
        got = case.kern()
        assert cases.bit_equal(got, case.parent()), case.key
        assert cases.bit_equal(got, case.kern()), case.key
        e = cases.fused_error(case.name, got, case.plain(), case.scales(),
                              1e-5)
        assert e["ok"], (case.key, e)
        if case.name == "dfsph_kick":
            # the kick's record is the pack kernel's of its v_out
            assert cases.bit_equal(got[2], coef.dfsph_pack(pos, got[0]))


@pytest.mark.cuda
def test_dfsph_pack_matches_its_plain_version(clustered):
    """The source record of a v, bit for bit (one rounding an operation on
    both sides), on the clustered cloud, and written in place."""
    x, _ = clustered
    want = coef.dfsph_pack_plain(x["p"], x["v"])
    assert cases.bit_equal(coef.dfsph_pack(x["p"], x["v"]), want)
    buf = torch.empty_like(want)
    assert coef.dfsph_pack(x["p"], x["v"], buf).data_ptr() == buf.data_ptr()
    assert cases.bit_equal(buf, want)


@pytest.mark.cuda
@pytest.mark.parametrize("unroll", [1, 3])
def test_dfsph_steps_read_no_stale_record_on_the_card(cuda, unroll,
                                                      monkeypatch):
    """TINY as DFSPH from rest, 40 steps on the card (the block reaches the
    floor near step 33, and both loops iterate) with graph trips at
    `unroll` iterations a trip: bit for bit the same steps with every rate
    handed a record packed afresh from its v; dfsph_kick and dfsph_rate
    launched 1 + trips x U times a step, dfsph_pack once a step, the
    contraction alone never."""
    def run(repack):
        algebra = dfsph.loop_algebra

        def wrapped(*args):
            kick, rate, pack = algebra(*args)

            def fresh(v, *a):
                pack(v)
                return rate(v, *a)
            return kick, fresh if repack else rate, pack
        monkeypatch.setattr(dfsph, "loop_algebra", wrapped)
        sim = Simulation(parse_config(copy.deepcopy(TINY)), device=cuda)
        stencil.reset_counts()
        diags = []
        with inputs.loop_mode(unroll=unroll):
            for _ in range(40):
                sim.step()
                diags.append(sim.state.diag.tolist())
        monkeypatch.undo()
        counts = {name: stencil.KERNELS[name].launches for name in
                  ("dfsph_kick", "dfsph_rate", "dfsph_pack", "coef_matvec",
                   "coef_matvec_dot")}
        return sim.state, diags, counts

    state, diags, counts = run(False)
    again, _, _ = run(True)
    assert torch.equal(state.fluid.pos, again.fluid.pos)
    assert torch.equal(state.diag, again.diag)
    assert max(d[2] for d in diags) > dfsph.MIN_ITER_DENSITY
    looped = sum(-(-round(d[c]) // unroll) * unroll for d in diags
                 for c in (0, 2))
    assert counts == dict(dfsph_kick=40 + looped, dfsph_rate=40 + looped,
                          dfsph_pack=40, coef_matvec=0, coef_matvec_dot=0)


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


@pytest.mark.cuda
@pytest.mark.parametrize("fault", ["misaligned", "strided"])
def test_wcsph_forces_refuses_a_record_it_cannot_load(clustered, fault):
    """The kernel loads each record row as one float4: a record off a
    16-byte boundary or not contiguous raises before any launch."""
    x, _ = clustered
    n, dev = x["p"].shape[0], x["p"].device
    rec = stencil.wcsph_records(x["p"], x["v"], x["rho"], x["pr"])
    if fault == "misaligned":
        bad = torch.empty(4 * n + 1, device=dev)[1:].view(n, 4)
    else:
        bad = torch.empty(n, 8, device=dev)[:, :4]
    bad.copy_(rec.b)
    stencil.reset_counts()
    with pytest.raises(ValueError, match="record b"):
        stencil.wcsph_forces_packed(
            stencil.WcsphRecords(rec.a, bad), x["st"], x["grid"], x["h"],
            x["m"], **cases.WCSPH)
    assert stencil.KERNELS["wcsph_forces"].launches == 0
    got = stencil.wcsph_forces_packed(rec, x["st"], x["grid"], x["h"],
                                      x["m"], **cases.WCSPH)
    assert torch.equal(got, _wcsph_pair(x)[0])


def _solver_cases(x, walls):
    """perf/cases.py's PCISPH and PBF kernel calls on inputs `x` (shifted
    positions, lambda, velocities) with the boundary set `walls`."""
    return list(cases.solver_cases(x["p"], x["st"], x["grid"], x["h"],
                                   x["m"], walls, x, {}))


def _assert_case_matches_plain(case):
    got, want = cases.compared(case)
    for a, b in zip(got, want, strict=True):
        if not b.dtype.is_floating_point:   # pair counts and lists
            assert torch.equal(a, b), case.name
            continue
        assert a.shape == b.shape and bool(torch.isfinite(a).all())
        np.testing.assert_allclose(
            a.cpu().numpy(), b.cpu().numpy(), rtol=0,
            atol=1e-5 * max(float(b.abs().max()), 1e-30), err_msg=case.name)


def _walls(x):
    return stencil.Walls(x["bp"], x["bvol"], x["bst"], x["bnear"])


@pytest.mark.cuda
def test_pcisph_and_pbf_kernels_on_the_30k_lattice(cuda):
    x = inputs.lattice_inputs("breaking_dam_30k.json", seed=7, device=cuda)
    sc = x["sc"]
    x = dict(x, grid=sc.grid, h=sc.h, m=sc.particle_m)
    for case in _solver_cases(x, base.walls(sc)):
        _assert_case_matches_plain(case)


@pytest.mark.cuda
def test_pcisph_and_pbf_kernels_on_the_clustered_cloud(clustered):
    """Pairs cross r = h both ways between the start and the shifted
    positions; queries of hundreds of pairs; a boundary sheet on cell faces
    and a dense boundary patch."""
    x, off = clustered
    assert int((off[1:] - off[:-1]).max()) > 100
    p, q = x["p"], x["shifted"]
    near = torch.cdist(q[:2000], q) <= x["h"]
    valid = torch.cdist(p[:2000], p) <= x["h"]
    assert bool((near & ~valid).any()) and bool((valid & ~near).any())
    for case in _solver_cases(x, _walls(x)):
        _assert_case_matches_plain(case)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 129])
def test_pcisph_and_pbf_kernels_with_one_live_lane(cuda, n):
    """n = 1 and n = 129: the last warp holds one query and 31 lanes
    without one, which must walk along to every vote."""
    x = inputs.clustered_inputs(2000, seed=5, device=cuda)
    keys = ("v", "shifted", "lam")
    scid, _, p, rows = base.sort_by_cells(
        x["grid"], x["p"][-n:].clone(), tuple(x[key][-n:] for key in keys))
    few = dict(x, p=p, st=nb.csr_starts(scid, x["grid"].num_cells),
               **dict(zip(keys, rows)))
    for case in _solver_cases(few, _walls(x)):
        _assert_case_matches_plain(case)


@pytest.mark.cuda
def test_pcisph_and_pbf_kernels_repeat_bit_for_bit(clustered):
    x, _ = clustered
    for case in _solver_cases(x, _walls(x)):
        view = case.view or (lambda out: out if isinstance(out, tuple)
                             else (out,))
        first, again = view(case.kern()), view(case.kern())
        assert all(torch.equal(a, b) for a, b in zip(first, again)), \
            case.name


@pytest.mark.cuda
def test_pbf_pair_list_and_streams(clustered):
    """The pair list that PBF's constraint pass (pbf_terms) stores against
    the plain version's exactly (each row's count and its sources in walk
    order, within the row's room) on the clustered cloud, and pbf_lambda
    and pbf_xsph over it against their stream forms' plain versions and the
    walking plain versions, to 1e-5 of scale, bit for bit over two
    launches."""
    x, off = clustered
    p, st, g, h, m = x["p"], x["st"], x["grid"], x["h"], x["m"]
    rows = stencil.pair_rows(st, g, nb.cell_id(p, g))
    args = cases.pbf_constraint_args(p, st, g, h, m, rows, _walls(x))
    _, pl = stencil.pbf_constraint(*args)
    _, want = stencil.pbf_constraint_plain(*args)
    assert torch.equal(pl.cnt, want.cnt)
    assert torch.equal(coef.csr_offsets(pl.cnt), off)
    assert torch.equal(stencil.stored_pairs(pl)[1],
                       stencil.stored_pairs(want)[1])
    room = nb.stencil_counts(st, g)[nb.cell_id(p, g).long()]
    assert bool((pl.cnt <= room).all())
    lam, sp, v = x["lam"], x["shifted"], x["v"]
    for kern, plain, walk in (
            (lambda: stencil.pbf_lambda(p, pl, h, lam),
             lambda: stencil.pbf_lambda_list_plain(pl, p, h, lam),
             lambda: stencil.pbf_lambda_plain(p, st, g, h, lam)),
            (lambda: stencil.pbf_xsph(pl, h, sp, v),
             lambda: stencil.pbf_xsph_list_plain(pl, h, sp, v),
             lambda: stencil.pbf_xsph_plain(p, st, g, h, sp, v))):
        got = kern()
        assert torch.equal(got, kern())
        for ref in (plain(), walk()):
            assert cases.scaled_error(got, ref) <= 1e-5


def _pbf_case(where, device):
    """(cell-sorted positions, CSR, grid, h, m, walls) of PBF's constraint
    pass: the 30k lattice with its walls, the clustered cloud (20k) with
    its boundary cloud, or the cloud's last n particles (n = 1, 129: a
    warp of one live lane) re-sorted, with the cloud's boundary."""
    if where == "30k":
        x = inputs.lattice_inputs("breaking_dam_30k.json", seed=7,
                                  device=device)
        sc = x["sc"]
        return x["p"], x["st"], sc.grid, sc.h, sc.particle_m, base.walls(sc)
    x = inputs.clustered_inputs(20_000 if where == "clustered" else 2000,
                                seed=5, device=device)
    p, st = x["p"], x["st"]
    if where != "clustered":
        n = int(where.split("_")[1])
        scid, _, p, _ = base.sort_by_cells(x["grid"], p[-n:].clone())
        st = nb.csr_starts(scid, x["grid"].num_cells)
    return p, st, x["grid"], x["h"], x["m"], _walls(x)


@pytest.mark.cuda
@pytest.mark.parametrize("rho0", [1000.0, 800.0], ids=["rho0_1000",
                                                      "rho0_800"])
@pytest.mark.parametrize("walls", [True, False], ids=["walls", "clamp"])
@pytest.mark.parametrize("where", ["30k", "clustered", "lane_1", "lane_129"])
def test_pbf_constraint_one_launch(cuda, where, walls, rho0):
    """PBF's constraint pass in one launch (pbf_terms' kernel: the fluid
    walk with its list, the walls' walk, the rows' constraint and lambda)
    against its plain version (constraint, lambda, gsum and ssum to 1e-5
    of scale, the list exactly), with walls and without, at PBF's rest
    density and at cases.LOW_RHO0, where the 30k lattice's rows are
    constrained (at 1000 they are not); bit for bit over two launches."""
    p, st, g, h, m, w = _pbf_case(where, cuda)
    rows = stencil.pair_rows(st, g, nb.cell_id(p, g))
    args = cases.pbf_constraint_args(p, st, g, h, m, rows,
                                     w if walls else None, rho0)
    view = cases.pbf_terms_view
    stencil.reset_counts()
    got = view(stencil.pbf_constraint(*args))
    assert stencil.KERNELS["pbf_terms"].launches == 1
    want = view(stencil.pbf_constraint_plain(*args))
    for a, b in zip(got, want, strict=True):
        if not b.dtype.is_floating_point:
            assert torch.equal(a, b)
            continue
        assert bool(torch.isfinite(a).all())
        assert cases.scaled_error(a, b) <= 1e-5
    if rho0 == cases.LOW_RHO0 and where in ("30k", "clustered"):
        assert int((got[1] != 0).sum()) > 0
    assert cases.same_bits(got, view(stencil.pbf_constraint(*args)))


def _rigid_cases(x):
    return list(cases.rigid_cases(x))


@pytest.mark.cuda
@pytest.mark.parametrize("where", ["30k", "torus"])
def test_predicted_density_body_gate_keeps_every_bit(cuda, where):
    """Both forms of the predicted density with the body's gate (its box
    grown by h, stencil.make_body_box) against the same launch with a gate
    that holds every query, bit for bit, on a body in water and on the
    half-immersed torus; the gate lets fewer queries walk the body than
    there are."""
    x = (inputs.body_inputs("breaking_dam_30k.json", seed=3, device=cuda)
         if where == "30k" else inputs.torus_inputs(seed=3, device=cuda))
    args = (x["p"], x["st"], x["grid"], x["h"], x["m"], x["shifted"],
            base.walls(x["sc"]), cases.RHO0, x["table"])
    box = stencil.make_body_box(x["table"].pos, x["h"])
    assert int(stencil.in_body_box(x["p"], box).sum()) < x["p"].shape[0]
    eng = cases.pair_store(x["p"], x["st"], x["grid"], x["h"], x["m"])
    for store in (None, eng):
        gated = stencil.pcisph_predict_rho(*args, eng=store, body_box=box)
        ungated = stencil.pcisph_predict_rho(
            *args, eng=store, body_box=cases.ungated_box(cuda))
        assert torch.equal(gated, ungated), store is None


@pytest.mark.cuda
@pytest.mark.parametrize("where", ["30k", "1m", "torus"])
def test_predicted_density_body_walk(cuda, where):
    """Both forms of the predicted density, whose warps with a row inside
    the body's gate walk the body: against the plain version to 1e-5 of
    scale, gated bit-equal to ungated, two launches bit-equal, the body's
    sum (the call less the call without the body) nonzero on some rows;
    one launch a call, no plain call."""
    x = (inputs.torus_inputs(seed=3, device=cuda) if where == "torus" else
         inputs.body_inputs({"30k": "breaking_dam_30k.json",
                             "1m": "breaking_dam_1m.json"}[where], seed=3,
                            device=cuda))
    args = (x["p"], x["st"], x["grid"], x["h"], x["m"], x["shifted"],
            base.walls(x["sc"]), cases.RHO0)
    box = cases.gate_box(x)
    eng = cases.pair_store(x["p"], x["st"], x["grid"], x["h"], x["m"])
    for store in (None, eng):
        want = (stencil.pcisph_predict_rho_plain(*args, x["table"])
                if store is None else stencil.pcisph_predict_rho_list_plain(
                    store, x["p"], *args[2:], x["table"]))
        stencil.reset_counts()
        got = stencil.pcisph_predict_rho(*args, x["table"], store, box)
        assert stencil.KERNELS["pcisph_predict_rho_rigid"].launches == 1
        assert all(k.plain_calls == 0 for k in stencil.KERNELS.values())
        assert cases.scaled_error(got, want) <= 1e-5, store is None
        assert torch.equal(got, stencil.pcisph_predict_rho(
            *args, x["table"], store, box))
        assert torch.equal(got, stencil.pcisph_predict_rho(
            *args, x["table"], store, cases.ungated_box(cuda)))
        alone = stencil.pcisph_predict_rho(*args, None, store)
        assert bool((got != alone).any())


@pytest.mark.cuda
@pytest.mark.parametrize("nr", [1, 31, 1024, 8191, 8193, 16_384, 16_385,
                                39_146, 70_001])
def test_body_box_cluster_at_edge_sizes(cuda, nr):
    """The body's gate, one block's fold or a cluster's, each block a
    slice: bit for bit with its plain version on a numpy-seeded cloud of
    nr particles (one, less than a warp, a block's threads, its two passes
    less and more one, the most one block takes and one more, the 1M
    block's body, and more than the largest cluster's one pass), and on
    the cloud moved far from the origin, where the margin's slack term
    counts; one launch a call."""
    rng = np.random.default_rng(nr)
    bpos = torch.from_numpy(rng.uniform(-3.0, 5.0, size=(nr, 3)).astype(
        np.float32)).to(cuda)
    for shift in (0.0, 300.0):
        moved = (bpos + shift).contiguous()
        stencil.reset_counts()
        got = stencil.make_body_box(moved, 0.1)
        assert stencil.KERNELS["body_box"].launches == 1
        assert torch.equal(got, stencil.make_body_box_plain(moved, 0.1))
    assert 1 <= stencil.body_box_blocks(nr) <= 16


@pytest.mark.cuda
@pytest.mark.parametrize("where", ["30k", "1m", "torus"])
def test_contact_dot_and_viscosity_body_gate_keeps_every_bit(cuda, where):
    """rigid_terms, rigid_contact_dot and rigid_viscosity with the body's
    gate (made once, as a step makes it, by body_box: its plain version's
    bits) against the same launch with a gate that holds every query, bit
    for bit (all four of rigid_terms' sums), on a body in water at 30k and
    1M and on the half-immersed torus; each against the plain version to
    1e-5 of scale; one launch a call, no plain call."""
    x = (inputs.torus_inputs(seed=3, device=cuda) if where == "torus" else
         inputs.body_inputs({"30k": "breaking_dam_30k.json",
                             "1m": "breaking_dam_1m.json"}[where], seed=3,
                            device=cuda))
    box = cases.gate_box(x)
    assert torch.equal(box, stencil.make_body_box_plain(x["table"].pos,
                                                        x["h"]))
    assert int(stencil.in_body_box(x["p"], box).sum()) < x["p"].shape[0]
    for name, (call, plain) in cases.gated_calls(x).items():
        want = plain()
        stencil.reset_counts()
        gated = call(box)
        assert stencil.KERNELS[name].launches == 1, name
        assert stencil.KERNELS[name].plain_calls == 0, name
        assert cases.same_bits(gated, call(cases.ungated_box(cuda))), name
        assert cases.terms_error(gated, want) <= 1e-5, name


@pytest.mark.cuda
def test_pcisph_recompute_engine_launches_the_stencil_form(cuda,
                                                            monkeypatch):
    """TINY squeezed by 0.85 as PCISPH, 3 steps on the card: on the
    recompute engine (coef budget 0) the predicted density launches its
    stencil form and no stream form; on the stored-coefficient engine the
    reverse; iterations + 1 launches a step either way."""
    raw = copy.deepcopy(TINY)
    raw["solver"]["name"] = "pcisph"
    for budget, form, other in ((0, "pcisph_predict_rho",
                                 "pcisph_predict_rho_list"),
                                (12e9, "pcisph_predict_rho_list",
                                 "pcisph_predict_rho")):
        monkeypatch.setattr(dfsph, "COEF_BYTE_BUDGET", budget)
        sim = Simulation(parse_config(raw), device=cuda)
        sim.state = inputs.squeezed(sim.state)
        stencil.reset_counts()
        iters = 0
        with inputs.loop_mode(unroll=1, eager=True):
            for _ in range(3):
                sim.step()
                iters += int(sim.state.diag[0])
        k = stencil.KERNELS
        assert k[form].launches == iters + 3, form
        assert k[other].launches == 0, other
        assert all(kk.plain_calls == 0 for kk in k.values())


@pytest.mark.cuda
@pytest.mark.parametrize("where", ["30k", "torus"])
def test_rigid_kernels_match_plain_versions(cuda, where):
    """The fluid-rigid kernels (PCISPH's predicted density with its walk
    over the body among them) on a body in water (the 30k block with a
    ~3,200-voxel box at its centre) and on the half-immersed torus."""
    x = (inputs.body_inputs("breaking_dam_30k.json", seed=3, device=cuda)
         if where == "30k" else inputs.torus_inputs(seed=3, device=cuda))
    stencil.reset_counts()
    for case in _rigid_cases(x):
        _assert_case_matches_plain(case)
    for name in ("rigid_terms", "rigid_contact_dot", "rigid_viscosity",
                 "rigid_side_force", "rigid_side_force_list",
                 "pcisph_predict_rho", "pcisph_predict_rho_list"):
        assert stencil.KERNELS[name].launches == 1, name
    # the rows and list the stream reads, then their own cases
    assert stencil.KERNELS["rigid_side_rows"].launches == 2
    assert stencil.KERNELS["rigid_side_list"].launches == 2
    # both forms of the predicted density walk the body
    assert stencil.KERNELS["pcisph_predict_rho_rigid"].launches == 2


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 129])
def test_rigid_kernels_with_one_live_lane(cuda, n):
    """n fluid queries and n rigid particles: the last warp of each launch
    holds one live lane."""
    x = inputs.torus_inputs(seed=3, device=cuda)
    near = rigid.rigid_terms(x["p"], x["table"], x["grid"], x["h"],
                             1000.0).rho > 0
    keys = ("v", "rho", "u", "shifted")
    scid, _, p, rows = base.sort_by_cells(
        x["grid"], x["p"][near][:n].clone(),
        tuple(x[key][near][:n] for key in keys))
    few = dict(x, p=p, st=nb.csr_starts(scid, x["grid"].num_cells),
               **dict(zip(keys, rows)))
    for key in ("rpos", "rvol", "v_r", "rho_quirk", "force"):
        few[key] = x[key][:n].contiguous()
    few["table"] = rigid.rigid_table(x["grid"], few["rpos"], few["rvol"])
    for case in _rigid_cases(few):
        _assert_case_matches_plain(case)


@pytest.mark.cuda
def test_rigid_kernels_repeat_bit_for_bit(cuda):
    x = inputs.body_inputs("breaking_dam_30k.json", seed=3, device=cuda)
    for case in _rigid_cases(x):
        first, again = case.kern(), case.kern()
        if case.view is not None:   # the list: its rows, not its spare slots
            first, again = case.view(first), case.view(again)
        first = first if isinstance(first, tuple) else (first,)
        again = again if isinstance(again, tuple) else (again,)
        assert all(torch.equal(a, b) for a, b in zip(first, again)), \
            case.name


@pytest.mark.cuda
@pytest.mark.parametrize("where", ["30k", "torus"])
def test_the_reaction_stream_gives_the_walks_bits(cuda, where):
    """The reaction's list, built by its kernel, streamed: the walk's
    output bit for bit on a body in water and on the half-immersed torus
    (the walk's lane groups add their terms in walk order); the walk
    repeats bit for bit."""
    x = (inputs.body_inputs("breaking_dam_30k.json", seed=3, device=cuda)
         if where == "30k" else inputs.torus_inputs(seed=3, device=cuda))
    _, side = cases.side_list(x)
    got = rigid.rigid_side_force_list(side, x["u"], x["force"])
    walk = rigid.rigid_side_force(x["rpos"], x["rvol"], x["p"], x["st"],
                                  x["grid"], x["h"], cases.RHO0, x["u"],
                                  x["force"])
    assert int(side.cnt.sum()) > 0
    assert torch.equal(got, walk)
    assert torch.equal(walk, rigid.rigid_side_force(
        x["rpos"], x["rvol"], x["p"], x["st"], x["grid"], x["h"],
        cases.RHO0, x["u"], x["force"]))


@pytest.mark.cuda
@pytest.mark.parametrize("where", ["30k", "1m", "torus"])
def test_the_reaction_list_and_its_stream_of_k_and_m(cuda, where):
    """The list's kernel (the ordered group walk, its pairs ranked by a
    ballot) against its plain version, each row's base, count and records
    bit for bit; its stream of the density loop's k and the scale m
    against the stream and the walk of u = k m formed in torch, and with a
    rank's mask against the stream of where(owned, k m, 0), bit for bit;
    one launch a call."""
    x = (inputs.torus_inputs(seed=3, device=cuda) if where == "torus" else
         inputs.body_inputs({"30k": "breaking_dam_30k.json",
                             "1m": "breaking_dam_1m.json"}[where], seed=3,
                            device=cuda))
    build, side = cases.side_list(x)
    plain = rigid.rigid_side_list_plain(*build)
    assert torch.equal(side.base, plain.base)
    for a, b in zip(cases.side_list_view(side), cases.side_list_view(plain)):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    assert int(side.cnt.sum()) > 0
    m = x["m"]
    km = x["k"] * f32(m)
    stencil.reset_counts()
    got = rigid.rigid_side_force_list(side, x["k"], x["force"], m)
    assert stencil.KERNELS["rigid_side_force_list"].launches == 1
    assert stencil.KERNELS["rigid_side_force_list"].plain_calls == 0
    bits = got.view(torch.int32)
    assert torch.equal(bits, rigid.rigid_side_force_list(
        side, km, x["force"]).view(torch.int32))
    assert torch.equal(bits, rigid.rigid_side_force(
        x["rpos"], x["rvol"], x["p"], x["st"], x["grid"], x["h"],
        cases.RHO0, km, x["force"]).view(torch.int32))
    owned = torch.from_numpy(np.random.default_rng(5).uniform(
        size=km.shape[0]) < 0.5).to(cuda)
    got = rigid.rigid_side_force_list(side, x["k"], x["force"], m, owned)
    want = rigid.rigid_side_force_list(
        side, torch.where(owned, km, torch.zeros_like(km)), x["force"])
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert not torch.equal(got, bits.view(torch.float32))


@pytest.mark.cuda
def test_the_reaction_walk_of_a_body_far_from_the_fluid(cuda):
    """A body moved out of the water (its stencils hold no fluid) and one
    half in it, with a body count that leaves the last warp's groups
    partly empty: the walk against its plain version, the far body's
    force as it was, bit for bit."""
    x = inputs.body_inputs("breaking_dam_30k.json", seed=3, device=cuda)
    nr = x["rpos"].shape[0]
    for shift, n in ((10.0, nr), (0.0, nr - 5)):
        rpos = (x["rpos"][:n] + torch.tensor([shift, 0.0, 0.0],
                                              device=cuda)).contiguous()
        args = (rpos, x["rvol"][:n].contiguous(), x["p"], x["st"],
                x["grid"], x["h"], cases.RHO0, x["u"],
                x["force"][:n].contiguous())
        got = rigid.rigid_side_force(*args)
        if shift:
            assert torch.equal(got, args[-1])
        assert cases.scaled_error(got, rigid.rigid_side_force_plain(
            *args)) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("squeeze,steps", [(0.97, 4), (0.85, 1)])
def test_coupled_dfsph_steps_on_the_card_match_the_cpu(cuda, squeeze, steps):
    """RIGID_CFG as DFSPH, its block squeezed about its mean, with a rigid
    step after each fluid step: positions through oid to 5e-6, equal
    iteration counts, the centroid to 1e-5 and the body's largest force
    component (sampled before the rigid step) to rtol 1e-5."""
    sims = [Simulation(parse_config(copy.deepcopy(RIGID_CFG)), device=dev)
            for dev in (cuda, "cpu")]
    pos = sims[1].state.fluid.pos
    mid = pos.mean(dim=0)
    pos = mid + (pos - mid) * squeeze
    for s in sims:
        s.state = s.state._replace(fluid=s.state.fluid._replace(
            pos=pos.to(s.device)))
    stencil.reset_counts()
    for _ in range(steps):
        forces = []
        for s in sims:
            s.step()
            forces.append(float(s.state.rigid.force.abs().max()))
            s.rigid_step()
        a, b = (s.state for s in sims)
        pa = a.fluid.pos.cpu().numpy()[np.argsort(a.fluid.oid.cpu().numpy())]
        pb = b.fluid.pos.numpy()[np.argsort(b.fluid.oid.numpy())]
        np.testing.assert_allclose(pa, pb, atol=5e-6)
        np.testing.assert_array_equal(a.diag.cpu().numpy()[[0, 2]],
                                      b.diag.numpy()[[0, 2]])
        np.testing.assert_allclose(a.rigid.centroid.cpu().numpy(),
                                   b.rigid.centroid.numpy(), atol=1e-5)
        np.testing.assert_allclose(forces[0], forces[1], rtol=1e-5)
    if squeeze < 0.9:
        assert forces[0] > 0
    for name in ("rigid_terms", "rigid_contact_dot", "rigid_viscosity",
                 "rigid_side_rows", "rigid_side_list",
                 "rigid_side_force_list", "body_box"):
        kern = stencil.KERNELS[name]
        assert kern.launches > 0 and kern.launches == kern.plain_calls, name
    assert stencil.KERNELS["rigid_side_force"].launches == 0


@pytest.mark.cuda
@pytest.mark.parametrize("solver", ["dfsph", "pcisph"])
def test_coupled_steps_stream_the_walks_bits(cuda, solver):
    """RIGID_CFG squeezed by 0.85 about its mean (pressure acts), 3 steps
    with rigid steps on the card: streaming the reaction's list and
    walking it (`dfsph.walked_reaction`) give the same fluid, body, dt and
    diag, and the same force, bit for bit."""
    raw = copy.deepcopy(RIGID_CFG)
    raw["solver"]["name"] = solver
    step = {"dfsph": dfsph.step, "pcisph": pcisph.step}[solver]
    sims = [Simulation(parse_config(copy.deepcopy(raw)), device=cuda)
            for _ in range(2)]
    pos = sims[0].state.fluid.pos
    mid = pos.mean(dim=0)
    for s in sims:
        s.state = s.state._replace(fluid=s.state.fluid._replace(
            pos=mid + (pos - mid) * 0.85))
    largest = 0.0
    for _ in range(3):
        forces = []
        for s, walk in zip(sims, (False, True)):
            with (dfsph.walked_reaction() if walk
                  else contextlib.nullcontext()):
                s.state = step(s.scene, s.state)
            forces.append(s.state.rigid.force)
            s.rigid_step()
        a, b = (s.state for s in sims)
        assert torch.equal(forces[0], forces[1])
        for x, y in (*zip(a.fluid, b.fluid), *zip(a.rigid, b.rigid),
                     (a.dt, b.dt), (a.diag, b.diag)):
            assert torch.equal(x, y)
        largest = max(largest, float(forces[0].abs().max()))
    assert largest > 0


@pytest.mark.cuda
@pytest.mark.parametrize("solver", ["pcisph", "iisph", "wcsph"])
@pytest.mark.parametrize("squeeze,steps", [(0.97, 4), (0.85, 1)])
def test_coupled_steps_on_the_card_match_the_cpu(cuda, solver, squeeze,
                                                 steps):
    """RIGID_CFG as PCISPH, IISPH and WCSPH, as the DFSPH test above:
    positions through oid to 5e-6, equal iteration counts, the centroid to
    1e-5 and the body's largest force component to rtol 1e-5."""
    raw = copy.deepcopy(RIGID_CFG)
    raw["solver"]["name"] = solver
    sims = [Simulation(parse_config(raw), device=dev)
            for dev in (cuda, "cpu")]
    pos = sims[1].state.fluid.pos
    mid = pos.mean(dim=0)
    pos = mid + (pos - mid) * squeeze
    for s in sims:
        s.state = s.state._replace(fluid=s.state.fluid._replace(
            pos=pos.to(s.device)))
    for _ in range(steps):
        forces = []
        for s in sims:
            s.step()
            forces.append(float(s.state.rigid.force.abs().max()))
            s.rigid_step()
        a, b = (s.state for s in sims)
        pa = a.fluid.pos.cpu().numpy()[np.argsort(a.fluid.oid.cpu().numpy())]
        pb = b.fluid.pos.numpy()[np.argsort(b.fluid.oid.numpy())]
        np.testing.assert_allclose(pa, pb, atol=5e-6)
        np.testing.assert_array_equal(a.diag.cpu().numpy()[[0, 2]],
                                      b.diag.numpy()[[0, 2]])
        np.testing.assert_allclose(a.rigid.centroid.cpu().numpy(),
                                   b.rigid.centroid.numpy(), atol=1e-5)
        np.testing.assert_allclose(forces[0], forces[1], rtol=1e-5)
    if squeeze < 0.9:
        assert forces[0] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("unroll", [1, 3])
@pytest.mark.parametrize("solver", ["dfsph", "iisph", "pcisph"])
def test_graph_loops_match_eager_loops_on_the_card(cuda, solver, unroll):
    """TINY squeezed by 0.85 (the loops iterate), 4 steps on the card with
    the pressure loops' graph trips and with eager trips
    (ops/loops.while_loop_unrolled_plain) at `unroll` iterations a trip:
    positions, oid and diag bit for bit, the loop's matvec (DFSPH's
    dfsph_kick, the others' coef_matvec) launched as often in both (trips
    x U of each loop's sub-iterations), a capture where a loop takes a
    second trip."""
    raw = copy.deepcopy(TINY)
    raw["solver"]["name"] = solver
    runs = {}
    for eager in (False, True):
        sim = Simulation(parse_config(raw), device=cuda)
        sim.state = inputs.squeezed(sim.state)
        stencil.reset_counts()
        diags = []
        with inputs.loop_mode(unroll=unroll, eager=eager):
            for _ in range(4):
                sim.step()
                diags.append(sim.state.diag.tolist())
        mv = "dfsph_kick" if solver == "dfsph" else "coef_matvec"
        runs[eager] = (sim, diags, stencil.KERNELS[mv].launches)
    (graph, diags, mv), (plain, _, mv_plain) = runs[False], runs[True]
    for a, b in ((graph.state.fluid.pos, plain.state.fluid.pos),
                 (graph.state.fluid.oid, plain.state.fluid.oid),
                 (graph.state.diag, plain.state.diag)):
        assert torch.equal(a, b)
    assert mv == mv_plain > 0
    trips = [-(-round(d[c]) // unroll) for d in diags
             for c in ((0, 2) if solver == "dfsph" else (0,))]
    g = graph.scene.loop_graphs
    assert g.trips == plain.scene.loop_graphs.trips == sum(trips)
    assert g.captures == sum(t > 1 for t in trips)
    assert plain.scene.loop_graphs.captures == 0


# tests/test_sharding.py:14-19, the sharded scenes' CFG
SHARD_CFG = {
    "scene": {"box_min": [0, 0, 0], "box_max": [1.0, 0.5, 0.4],
              "particle_radius": 0.025, "gravity": 9.8},
    "solver": {"name": "dfsph", "delta_time": 5e-4, "iter_cnt": 1},
    "fluid": {"start_pos": [0.1, 0.1, 0.1], "water_size": [0.8, 0.2, 0.2]},
}
SHARD_STEPS = 4


def _shard_sim(solver, device):
    """SHARD_CFG as `solver` on `device`, its block squeezed by 0.85."""
    raw = copy.deepcopy(SHARD_CFG)
    raw["solver"]["name"] = solver
    sim = Simulation(parse_config(raw), device=device)
    sim.state = inputs.squeezed(sim.state)
    return sim


def _shard_rank_card(ring, solver):
    """SHARD_STEPS sharded steps of `solver` from SHARD_CFG's squeezed
    block on this rank's device: its rows with oid, dt, diag, launches and
    plain calls (launch.spawn pickles this function by name)."""
    from cfd_taichi_tpu_torch.parallel import domain

    sim = _shard_sim(solver, ring.device)
    spec = domain.make_spec(sim.scene, ring.world)
    state = domain.init_sharded_solver(ring, spec, sim.scene,
                                       sim.state.fluid.pos, solver)
    step = domain.make_sharded_solver_step(sim.scene, ring, spec, solver)
    stencil.reset_counts()
    dts, diags = [], []
    for _ in range(SHARD_STEPS):
        state = step(state)
        dts.append(float(state.dt))
        diags.append(state.diag.tolist())
    f = state.fluid
    return dict(pos=f.pos[f.mask].cpu().numpy(),
                oid=f.oid[f.mask].cpu().numpy(), dt=dts, diag=diags,
                loops=step.loops, overflow=int(state.overflow),
                counts={k.name: (k.launches, k.plain_calls)
                        for k in stencil.KERNELS.values()})


def _single_run(solver, device):
    sim = _shard_sim(solver, device)
    dts, diags = [], []
    for _ in range(SHARD_STEPS):
        sim.step()
        dts.append(float(sim.state.dt))
        diags.append(sim.state.diag.tolist())
    f = sim.state.fluid
    order = np.argsort(f.oid.cpu().numpy())
    return dict(pos=f.pos.cpu().numpy()[order], dt=dts, diag=diags)


def _check_shards(ranks, ref, loops):
    pos = np.concatenate([r["pos"] for r in ranks])
    oid = np.concatenate([r["oid"] for r in ranks])
    assert pos.shape == ref["pos"].shape
    err = float(np.abs(pos[np.argsort(oid)] - ref["pos"]).max())
    assert err <= 5e-6, err
    for r in ranks:
        assert r["loops"] == loops and r["overflow"] == 0
        assert [(d[0], d[2]) for d in r["diag"]] == \
            [(d[0], d[2]) for d in ref["diag"]]
        np.testing.assert_allclose(r["dt"], ref["dt"], rtol=1e-5)
        assert all(plain == 0 for _, plain in r["counts"].values())


@pytest.mark.cuda
@pytest.mark.parametrize("solver", ["dfsph", "wcsph", "iisph", "pcisph",
                                    "pbf"])
def test_sharded_step_on_nccl_world_one_matches_single_device(cuda, solver):
    """One NCCL rank on the card (parallel/domain.py): the sharded step of
    the squeezed block against the single-device step on the card, with
    its loops' trips replayed from graphs that hold the collectives."""
    from cfd_taichi_tpu_torch.parallel import launch

    ranks = launch.spawn(_shard_rank_card, 1, backend="nccl",
                         device="cuda", args=(solver,), timeout=600)
    _check_shards(ranks, _single_run(solver, cuda), "graph")
    launched = {k for k, (n, _) in ranks[0]["counts"].items() if n}
    assert launched >= {"dfsph": {"dfsph_kick", "dfsph_rate", "viscosity"},
                        "wcsph": {"wcsph_forces"},
                        "iisph": {"coef_matvec_dot"},
                        "pcisph": {"pcisph_predict_rho_list"},
                        "pbf": {"pbf_lambda", "pbf_xsph"}}[solver]


@pytest.mark.cuda
@pytest.mark.parametrize("solver", ["dfsph", "pcisph"])
def test_two_gloo_ranks_sharing_the_card_match_the_cpu(cuda, solver):
    """Two gloo ranks on one card, their messages staged through host
    memory (eager trips), against the single-device step on the CPU."""
    from cfd_taichi_tpu_torch.parallel import launch

    ranks = launch.spawn(_shard_rank_card, 2, backend="gloo",
                         device="cuda", args=(solver,), timeout=600)
    _check_shards(ranks, _single_run(solver, "cpu"), "eager")


# tests/test_sharding.py:258-269's COUPLED_CFG with the cube moved into the
# water and across the x = 0.6 slab face, as tests/test_torch_sharding_rigid.py
# starts it ("immersed")
SHARD_COUPLED_CFG = {
    "scene": {"box_min": [0, 0, 0], "box_max": [1.2, 0.6, 0.5],
              "particle_radius": 0.025, "gravity": 9.8},
    "solver": {"name": "pcisph", "delta_time": 4e-4, "iter_cnt": 1,
               "boundary_handle": True, "fs_couple": True},
    "fluid": {"start_pos": [0.1, 0.05, 0.1],
              "water_size": [1.0, 0.2, 0.3]},
    "solid": {"mesh": "builtin:cube1", "voxel_radius": 0.025,
              "rho_0": 500, "scale": 0.15, "pos_offset": [0.5, 0.15, 0.25],
              "attitude_offset": [0.0, 0.0, 0.0], "fill": True,
              "active": True},
}
SHARD_FRAMES = 3


def _coupled_rank_card(ring, solver):
    """SHARD_FRAMES coupled frames of SHARD_COUPLED_CFG as `solver`, sharded
    (a fluid step, then make_sharded_rigid_step) and single-device
    (Simulation.frame) on this rank's card: what parts from the
    single-device frame's bits, and each run's (launches, plain calls)."""
    from cfd_taichi_tpu_torch.parallel import domain

    raw = copy.deepcopy(SHARD_COUPLED_CFG)
    raw["solver"]["name"] = solver
    sim = Simulation(parse_config(raw), device=ring.device)
    scene = sim.scene
    spec = domain.make_spec(scene, ring.world)
    state = domain.init_sharded_solver(ring, spec, scene, scene.fluid_pos0,
                                       solver)
    step = domain.make_sharded_solver_step(scene, ring, spec, solver)
    rstep = domain.make_sharded_rigid_step(scene)
    counts = {}
    for tag in ("sharded", "single"):
        stencil.reset_counts()
        for _ in range(SHARD_FRAMES):
            if tag == "sharded":
                state = rstep(step(state))
            else:
                sim.frame()
        counts[tag] = {k.name: (k.launches, k.plain_calls)
                       for k in stencil.KERNELS.values()}
    n = scene.n_fluid
    got, want = state.fluid, sim.state.fluid
    cols = [0, 2, 3] if solver == "pbf" else [0, 1, 2, 3]
    pairs = dict(dt=(state.dt, sim.state.dt),
                 diag=(state.diag[cols], sim.state.diag[cols]),
                 pos=(got.pos[:n], want.pos), vel=(got.vel[:n], want.vel),
                 oid=(got.oid[:n], want.oid),
                 **{f"body {f}": (a, b) for f, a, b in zip(
                     state.rigid._fields, state.rigid, sim.state.rigid)})
    return dict(parts=[k for k, (a, b) in pairs.items()
                       if not torch.equal(a, b)],
                counts=counts, loops=step.loops,
                overflow=int(state.overflow))


@pytest.mark.cuda
@pytest.mark.parametrize("solver", ["dfsph", "pcisph", "iisph", "wcsph",
                                    "pbf"])
def test_coupled_sharded_frame_on_nccl_world_one_is_the_single_device(
        cuda, solver):
    """One NCCL rank on the card: the coupled sharded frame, with the body
    in the water and its reaction summed over the ranks, is the
    single-device frame bit for bit, and launches every kernel as often,
    with no plain version."""
    from cfd_taichi_tpu_torch.parallel import launch

    (r,) = launch.spawn(_coupled_rank_card, 1, backend="nccl",
                        device="cuda", args=(solver,), timeout=600)
    assert r["parts"] == []
    assert r["loops"] == "graph" and r["overflow"] == 0
    assert r["counts"]["sharded"] == r["counts"]["single"]
    assert all(plain == 0 for _, plain in r["counts"]["sharded"].values())
    launched = {k for k, (n, _) in r["counts"]["sharded"].items() if n}
    if solver != "pbf":
        reaction = ({"rigid_side_rows", "rigid_side_list",
                     "rigid_side_force_list"}
                    if solver in ("dfsph", "pcisph") else
                    {"rigid_side_force"})
        assert {"rigid_terms", "rigid_viscosity"} | reaction <= launched
