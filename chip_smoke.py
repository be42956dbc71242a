#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (cfd_taichi_tpu_torch) on one
NVIDIA GPU. Run it from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, each fatal on failure (exit code 1, and no final "ok" line):

1. device     - a CUDA card must be present; prints its name and the
                `nvidia-smi` name and power limit.
2. build      - compiles the kernels of cfd_taichi_tpu_torch/csrc, one nvcc
                per source, all at once.
3. kernels    - every kernel against its plain PyTorch version on the same
                inputs (breaking_dam_30k and breaking_dam_1m seed lattices
                with a numpy-seeded 0.1 r jitter, random v, k, rho and
                positive p', so that wcsph_forces' pressure, viscosity
                (both signs of shear) and cohesion terms all act):
                integer outputs exactly, float outputs to 1e-5 x their
                largest magnitude (same f32 pair terms summed in another
                order). The coef kernels run with f32 and bf16 storage:
                stored slots exactly, f32 w to 1e-5 of its largest value,
                bf16 w within one ulp in at most 1e-4 of the slots (the
                count is printed), the four lane sums to 1e-5 of each
                lane's largest value and the final form to 1e-5 of the
                largest |x_i| |s_i| (it cancels). The coef contraction
                also runs on ragged CSR engines (rows of 0, 1, G-1, G+1 and
                100+ pairs for every lane-group width G in 4-32, random
                sources, 1000 and 1003 rows), f32 and bf16. coef_build
                (f32 and bf16, nbr exactly), viscosity, matvec, matvec_dot,
                wcsph_forces, fluid_terms (count exactly) and
                boundary_terms also run on a clustered cloud
                of 100k particles (perf/inputs.py: a blob of ~200 a cell,
                empty cells, pairs at exactly r = h on cell faces,
                particles clamped into edge cells; boundary_terms over its
                boundary cloud: a wall sheet on cell faces, a dense patch,
                boundary particles clamped into edge cells, none near
                most queries); wcsph_forces is timed there too.
                pcisph_predict_rho, pbf_terms (its fluid and boundary
                entries together), pbf_lambda and pbf_xsph run at 30k, 1M
                and on the clustered cloud, with walls, their predicted or
                updated positions the inputs' shifted by ~0.3 r (pairs
                cross r = h both ways) and a random negative lambda. Kernel
                and plain times: CUDA events, median of 10 after 3 warm-up
                calls. Each kernel's bound (perf/bounds.py: the bytes and
                f32 operations of the call's inputs at the H100's peaks)
                and, for the coef contraction, the one PyTorch call that
                computes its lane sums (torch.sparse CSR @ dense lanes,
                row- and column-major, timed like the kernel; the port
                never calls it): perf/cases.py, which perf/kernel_table.py
                shares.
4. agree      - the TINY scene (tests/test_solvers.py:14-23) stepped 6 times
                on the card and on the CPU, as DFSPH from rest and as WCSPH,
                IISPH, PCISPH and PBF from TINY's block squeezed by 0.85
                about its centre (pressure acts): positions through oid to
                5e-6 (WCSPH 6.0e-8 and IISPH 9.0e-8, what the same kernels
                gave before), dt to rtol 1e-5, equal iteration counts every
                step; the errors are printed.
5. main       - configs/breaking_dam_30k.json as DFSPH, 100 steps from rest
                through Simulation.step on the default engine (stored
                coefficients, f32). fluid_terms, boundary_terms, viscosity,
                coef_build, coef_matvec and coef_matvec_dot must have
                launched and no plain version may have run; positions
                finite; the last step's density residual at most 1.0 (0.1%
                rho0, the loop's threshold); the last residuals and the mean
                density iterations a step, as printed, the ones the kernels
                gave before (DFSPH_30K).
6. recompute  - the same 30k run with the coef budget at 0: the recompute
                engine's matvec and matvec_dot must launch, residual <= 1.0,
                diagnostics as in main (DFSPH_30K); then breaking_dam_1m
                for 15 steps on it.
7. scale      - configs/breaking_dam_1m.json as DFSPH on the default
                engine, steps 1-5 and 6-15: coef kernels launched, finite,
                last density residual <= 1.0.
8. pcisph     - breaking_dam_30k as PCISPH, steps 1-100 from rest, and
                breaking_dam_1m as PCISPH, steps 6-15, on the scenes that
                main and scale built: fluid_terms, boundary_terms,
                viscosity, coef_build, coef_matvec and pcisph_predict_rho
                launched and no plain version; finite; every particle
                inside the box +- 2r; the last residual <= 1.0 unless the
                step hit 80 iterations; iterations a step printed.
9. pbf        - the same runs as PBF: pbf_terms, pbf_lambda and pbf_xsph
                launched (pbf_terms twice a step: fluid and boundary
                entries) and no plain version; finite; inside the box +-
                2r.
10. scale-bf16 - 1M and 30k with bf16 coefficient storage: iterations and
                residual printed, positions finite.
11. wcsph     - breaking_dam_30k as WCSPH, steps 1-100 from rest, and
                breaking_dam_1m as WCSPH, steps 6-15: fluid_terms,
                boundary_terms and wcsph_forces launched once a step and
                no plain version; finite; every particle inside the box
                +- 2r; density within (100, 2000) (tests/test_wcsph.py:
                53-58), and its range, to two decimals, the one the
                kernels gave before (WCSPH_RHO).
12. iisph     - configs/breaking_dam_30k.json as written (IISPH, on the
                card by default), steps 1-50 from rest on the coef engine
                and on the recompute engine: that engine's kernels
                launched, no plain version, finite, at most 180 Jacobi
                iterations a step; from rest, one iteration every step and
                a last residual of 0, as before. The 0.1 % contract is not
                required: the reference's break on a rising residual may
                stop above it.

Each run prints steps/s, iterations per step, the last residuals and
peak device memory; the whole run's wall time comes before the JSON. The line before the last is {"kernels": [...]}
(ms, plain_ms, bound_ms, library_ms at 30k; bound_us_1m, library_ms_1m
and the other sizes and dtypes beside them), the last one {"ok": true,
"device": {...}}.
"""

from __future__ import annotations

import copy
import functools
import json
import statistics
import subprocess
import sys
import time

TOL = 1e-5
TINY = {
    "scene": {"box_min": [0.0, 0.0, 0.0], "box_max": [0.6, 0.8, 0.6],
              "particle_radius": 0.025, "gravity": 9.8},
    "solver": {"name": "dfsph", "delta_time": 4e-4, "iter_cnt": 1},
    "fluid": {"start_pos": [0.15, 0.1, 0.15], "water_size": [0.3, 0.3, 0.3]},
}
CONFIGS = (("30k", "breaking_dam_30k.json"), ("1m", "breaking_dam_1m.json"))
CLUSTERED_N = 100_000
# Kernels each run must launch (and no plain version may run).
COEF_PATH = ("fluid_terms", "boundary_terms", "viscosity", "coef_build",
             "coef_matvec", "coef_matvec_dot")
RECOMPUTE_PATH = ("fluid_terms", "boundary_terms", "viscosity", "matvec",
                  "matvec_dot")
WCSPH_PATH = ("fluid_terms", "boundary_terms", "wcsph_forces")
PCISPH_PATH = COEF_PATH[:5] + ("pcisph_predict_rho",)
PBF_PATH = ("pbf_terms", "pbf_lambda", "pbf_xsph")
# [agree]: (solver, whether to start from TINY's squeezed block, the
# largest card-vs-CPU position error allowed over its 6 steps: the bar
# 5e-6, or what the same kernels gave before, 5.960e-08 and 8.941e-08 on
# an H100 80GB HBM3, so that a kernel that moves it shows; PCISPH and
# PBF, new, gave 6.855e-07 and 1.788e-07 there at first)
AGREE = (("dfsph", False, 5e-6), ("wcsph", True, 6.0e-8),
         ("iisph", True, 9.0e-8), ("pcisph", True, 5e-6), ("pbf", True, 5e-6))
# [wcsph]: the density range after the run, as printed (%.2f), that the
# kernels gave before; the same arithmetic in the same order repeats it.
WCSPH_RHO = {"30k": ("293.99", "693.86"), "1m": ("289.52", "684.12")}
# [main] and [recompute] at 30k: the last divergence residual, the mean
# density iterations a step and the last density residual, as printed,
# that the kernels gave before (PERF.md section 5).
DFSPH_30K = {"main": ("90.25", "8.22", "0.8486"),
             "recompute": ("89.78", "8.24", "0.9008")}


class SmokeFailure(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


# ---------------------------------------------------------------------------
# [kernels]
# ---------------------------------------------------------------------------

def compare(name: str, got, want, torch) -> float:
    """Max abs error of a kernel's outputs against the plain version's."""
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    worst = 0.0
    for i, (a, b) in enumerate(zip(got, want)):
        check(a.shape == b.shape, f"{name}[{i}] shape {a.shape} != {b.shape}")
        if b.dtype == torch.int32:
            bad = int((a != b).sum())
            print(f"    {name}[{i}] int32: {bad} mismatches (want 0)")
            check(bad == 0, f"{name}[{i}]: {bad} count mismatches")
            continue
        check(bool(torch.isfinite(a).all()), f"{name}[{i}] not finite")
        err = float((a - b).abs().max())
        scale = float(b.abs().max())
        tol = TOL * scale
        print(f"    {name}[{i}] max_abs_err {err:.3e}  max|plain| "
              f"{scale:.3e}  tol {tol:.3e}")
        check(err <= tol, f"{name}[{i}]: error {err} above {tol}")
        worst = max(worst, err)
    return worst


def check_build(tag: str, eng, want) -> float:
    """coef_build's engine against the plain build (perf/cases.py,
    build_error): nbr exactly, f32 w to 1e-5 of scale, bf16 w within one
    ulp in at most 1e-4 of the slots. Its max_abs_err on w."""
    from cfd_taichi_tpu_torch.perf import cases

    e = cases.build_error(eng, want)
    off = (f", {e['w_off']} of {eng.w.numel()} bf16 slots one ulp off"
           if "w_off" in e else "")
    print(f"    {tag}: {e['nbr_bad']} of {eng.nbr.numel()} nbr slots differ "
          f"(want 0); w max_abs_err {e['w_abs_err']:.3e}, over scale "
          f"{e['w_err']:.3e}{off}")
    check(e["ok"], f"{tag}: {e}")
    return e["w_abs_err"]


def compare_contraction(tag: str, got_sums, want_sums, got, want, pos,
                        dot: bool, torch) -> float:
    """The four lane sums to 1e-5 of each lane's largest value; the final
    form to 1e-5 of the largest |x_i| |s_i|, the magnitude that cancels."""
    check(bool(torch.isfinite(got).all()), f"{tag}: not finite")
    for r in range(4):
        err = float((got_sums[:, r] - want_sums[:, r]).abs().max())
        tol = TOL * float(want_sums[:, r].abs().max())
        check(err <= tol, f"{tag} lane {r}: error {err} above {tol}")
    s = want_sums[:, :3] if dot else want_sums[:, :1]
    scale = float((pos.norm(dim=1) * s.norm(dim=1)).max())
    err = float((got - want).abs().max())
    print(f"    {tag}: lane sums within 1e-5 of scale; final max_abs_err "
          f"{err:.3e}  max|x||s| {scale:.3e}  tol {TOL * scale:.3e}")
    check(err <= TOL * scale, f"{tag}: error {err} above {TOL * scale}")
    return err


def check_case(case, pos, torch) -> float:
    """Compare a case's kernel with its plain version; its max_abs_err."""
    if case.name == "coef_build":
        return check_build(case.key, case.kern(), case.plain())
    if case.library:        # the coef contraction
        return compare_contraction(
            case.key, case.kern(lane_sums=True), case.plain(lane_sums=True),
            case.kern(), case.plain(), pos, case.name == "coef_matvec_dot",
            torch)
    return compare(case.key, case.kern(), case.plain(), torch)


def ragged_checks(torch) -> None:
    """The coef contraction on ragged CSR engines, kernel against plain."""
    from cfd_taichi_tpu_torch.perf import cases, inputs

    for dtype in (torch.float32, torch.bfloat16):
        for n in (1000, 1003):
            eng, pos, k, v = inputs.ragged_engine(n, dtype)
            print(f"[kernels] ragged engine: {n} rows, "
                  f"{eng.nbr.numel()} pairs, {dtype} storage")
            for name, fn, plain, src, dot in cases.CONTRACTIONS:
                arg = k if src == "k" else v
                compare_contraction(
                    f"{name} ragged", fn(eng, pos, arg, lane_sums=True),
                    plain(eng, pos, arg, lane_sums=True), fn(eng, pos, arg),
                    plain(eng, pos, arg), pos, dot, torch)


def clustered_checks(torch, results: dict) -> None:
    """coef_build (f32 and bf16), viscosity, matvec, matvec_dot,
    wcsph_forces, fluid_terms, boundary_terms and the PCISPH and PBF
    kernels on the clustered cloud, kernel against plain: a blob of
    ~200 particles a cell, empty cells, pairs at exactly r = h on cell
    faces, particles clamped into edge cells; boundary_terms over the
    cloud's boundary set, whose per-cell table of boundary particles near
    the wrapper makes itself here (perf/inputs.py). wcsph_forces is also
    timed there (CUDA events, its record build included)."""
    from cfd_taichi_tpu_torch.ops import coef
    from cfd_taichi_tpu_torch.ops import stencil as S
    from cfd_taichi_tpu_torch.ops.neighbors import cell_id, stencil_counts
    from cfd_taichi_tpu_torch.perf import cases, inputs, timing

    x = inputs.clustered_inputs(CLUSTERED_N, seed=5)
    g, h, m, p, st = (x[key] for key in ("grid", "h", "m", "p", "st"))
    occ = st[1:] - st[:-1]
    ft = S.fluid_terms(p, st, g, h, m)
    off = coef.csr_offsets(ft.count)
    print(f"[kernels] clustered cloud: {p.shape[0]} particles, "
          f"{int(off[-1])} pairs, largest cell {int(occ.max())}, "
          f"{int((occ > 100).sum())} cells over 100, "
          f"{int((occ == 0).sum())} of {occ.numel()} cells empty")
    for dtype in (torch.float32, torch.bfloat16):
        check_build(f"coef_build clustered {dtype}",
                    coef.build_coef(p, st, g, h, m, off, dtype),
                    coef.build_coef_plain(p, st, g, h, m, off, dtype))
    compare("viscosity clustered",
            S.viscosity(p, st, g, h, m, x["v"], x["rho"], **cases.VISC),
            S.viscosity_plain(p, st, g, h, m, x["v"], x["rho"], **cases.VISC),
            torch)
    compare("matvec clustered", S.matvec(p, st, g, h, m, x["k"]),
            S.matvec_plain(p, st, g, h, m, x["k"]), torch)
    compare("matvec_dot clustered", S.matvec_dot(p, st, g, h, m, x["v"]),
            S.matvec_dot_plain(p, st, g, h, m, x["v"]), torch)
    wc = (p, st, g, h, m, x["v"], x["rho"], x["pr"])
    kern = functools.partial(S.wcsph_forces, *wc, **cases.WCSPH)
    plain = functools.partial(S.wcsph_forces_plain, *wc, **cases.WCSPH)
    row = dict(max_abs_err_clustered=compare("wcsph_forces clustered",
                                             kern(), plain(), torch),
               ms_clustered=timing.event_ms(kern),
               plain_ms_clustered=timing.event_ms(plain))
    results["wcsph_forces"].update(row)
    print(f"  wcsph_forces    clustered: kernel {row['ms_clustered']:.4f} ms"
          f"  plain {row['plain_ms_clustered']:.4f} ms")
    compare("fluid_terms clustered", ft, S.fluid_terms_plain(p, st, g, h, m),
            torch)
    bnd = (p, x["bp"], x["bvol"], x["bst"], g, h, 1000.0)
    near = stencil_counts(x["bst"], g)[cell_id(p, g).long()] > 0
    print(f"[kernels] clustered boundary cloud: {x['bp'].shape[0]} "
          f"particles, near {int(near.sum())} of {p.shape[0]} queries")
    compare("boundary_terms clustered", S.boundary_terms(*bnd),
            S.boundary_terms_plain(*bnd), torch)
    walls = S.Walls(x["bp"], x["bvol"], x["bst"], x["bnear"])
    for case in cases.solver_cases(p, st, g, h, m, walls, x, {}):
        results[case.name]["max_abs_err_clustered"] = compare(
            f"{case.name} clustered", case.kern(), case.plain(), torch)


def record(results: dict, case, key: str, err: float) -> None:
    """Time the case (perf/cases.py: kernel, bound, library call) and its
    plain version; store them under `key`."""
    from cfd_taichi_tpu_torch.perf import cases, timing

    row = cases.measure(case)
    row["plain_ms"], row["max_abs_err"] = timing.event_ms(case.plain), err
    results.setdefault(case.name, {}).update(
        {f"{k}_{key}": val for k, val in row.items()})
    lib = ""
    if case.library:
        lib = (f"  torch.sparse {row['library_ms']:.4f} ms "
               f"({row['library_layout']} lanes; kernel lane sums "
               f"{row['lane_sums_ms']:.4f} ms)"
               if row["library_ms"] is not None else
               "  torch.sparse not available")
    print(f"  {case.name:15s} {key}: kernel {row['ms']:.4f} ms  plain "
          f"{row['plain_ms']:.4f} ms  max_abs_err {err:.3e}  bound "
          f"{row['bound_ms'] * 1e3:.2f} us ({row['bound_by']}), share "
          f"{row['share']:.3f}{lib}")


def phase_kernels(torch, results: dict) -> None:
    from cfd_taichi_tpu_torch.perf import cases, inputs

    for tag, cfg_name in CONFIGS:
        x = inputs.lattice_inputs(cfg_name, seed=7)
        pairs = cases.fluid_pairs(x)
        print(f"[kernels] {cfg_name}: {x['sc'].n_fluid} fluid particles, "
              f"{pairs} pairs")
        for case in cases.scene_cases(x, pairs):
            record(results, case, tag + case.key[len(case.name):],
                   check_case(case, x["p"], torch))
        del x
        torch.cuda.empty_cache()
    ragged_checks(torch)
    clustered_checks(torch, results)


# ---------------------------------------------------------------------------
# [agree]
# ---------------------------------------------------------------------------

def oid_sorted(state):
    import numpy as np

    pos, oid = state.fluid.pos.cpu().numpy(), state.fluid.oid.cpu().numpy()
    return pos[np.argsort(oid)]


def phase_agree(torch) -> None:
    import numpy as np

    from cfd_taichi_tpu_torch import Simulation
    from cfd_taichi_tpu_torch.config import parse_config
    from cfd_taichi_tpu_torch.perf import inputs

    for solver, squeeze, bar in AGREE:
        raw = copy.deepcopy(TINY)
        raw["solver"]["name"] = solver
        sims = {dev: Simulation(parse_config(raw), device=dev)
                for dev in ("cuda", "cpu")}
        if squeeze:
            for s in sims.values():
                s.state = inputs.squeezed(s.state)
        for step in range(1, 7):
            for s in sims.values():
                s.step()
            a, b = (sims[d].state for d in ("cuda", "cpu"))
            err = float(np.abs(oid_sorted(a) - oid_sorted(b)).max())
            da, db = a.diag.cpu().tolist(), b.diag.cpu().tolist()
            print(f"[agree] {solver} step {step}: pos err {err:.3e}  iters "
                  f"cuda {da[0]:.0f}/{da[2]:.0f} cpu {db[0]:.0f}/{db[2]:.0f}"
                  f"  dt {float(a.dt):.6e} / {float(b.dt):.6e}")
            tag = f"TINY {solver} step {step}"
            check(err <= bar, f"{tag}: cuda vs cpu pos err {err} above {bar}")
            check(abs(float(a.dt) - float(b.dt)) <= 1e-5 * float(b.dt),
                  f"{tag}: dt differs")
            check((da[0], da[2]) == (db[0], db[2]),
                  f"{tag}: iteration counts differ")


# ---------------------------------------------------------------------------
# The solver runs
# ---------------------------------------------------------------------------

def run_steps(sim, steps: int, torch):
    diags = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        sim.step()
        diags.append(sim.state.diag)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return wall, [d.tolist() for d in diags]


def check_state(sim, tag: str) -> None:
    f = sim.state.fluid
    check(tuple(f.pos.shape) == (sim.scene.n_fluid, 3),
          f"{tag}: pos shape {tuple(f.pos.shape)}")
    from cfd_taichi_tpu_torch.utils.telemetry import check_valid

    bad = int(check_valid(f.pos, f.vel, f.acc))
    print(f"[{tag}] particles with NaN/Inf in pos/vel/acc: {bad}")
    check(bad == 0, f"{tag}: {bad} non-finite particles")


def iter_summary(solver: str, diags) -> str:
    if solver in ("wcsph", "pbf"):
        return "no solver loop"
    its = [d[0] for d in diags]
    if solver in ("iisph", "pcisph"):
        return (f"iters a step {[int(i) for i in its]}; mean "
                f"{statistics.mean(its):.2f} max {max(its):.0f}; last "
                f"residual {diags[-1][1]}")
    den = [d[2] for d in diags]
    return (f"div iters mean {statistics.mean(its):.2f} max {max(its):.0f}; "
            f"density iters mean {statistics.mean(den):.2f} max "
            f"{max(den):.0f}; last step {diags[-1]}")


def drive(sim, tag: str, windows, path, torch) -> dict:
    """Run `sim` from rest for each window of steps with the launch counts
    set to 0 just before; check that every kernel of `path` launched, that
    no plain version ran and that the state is finite."""
    from cfd_taichi_tpu_torch.ops import stencil

    sim.state = sim.solver.init_state(sim.scene)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    stencil.reset_counts()
    rates, diags, done = [], [], 0
    for steps in windows:
        wall, d = run_steps(sim, steps, torch)
        rates.append(steps / wall)
        diags += d
        print(f"[{tag}] n={sim.scene.n_fluid} boundary="
              f"{sim.scene.n_boundary}: steps {done + 1}-{done + steps} in "
              f"{wall:.3f} s = {steps / wall:.3f} steps/s")
        done += steps
    counts = {k.name: (k.launches, k.plain_calls)
              for k in stencil.KERNELS.values()}
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"[{tag}] {iter_summary(sim.cfg.solver.name, diags)}")
    print(f"[{tag}] kernel (launches, plain calls): {counts}")
    print(f"[{tag}] last diag {diags[-1]}; peak device memory {peak:.3f} "
          f"GiB")
    for name, (launches, plain) in counts.items():
        check(plain == 0, f"{tag}: plain version of {name} ran")
        check(launches > 0 or name not in path,
              f"{tag}: {name} never launched")
    check_state(sim, tag)
    return dict(steps_per_sec=rates, last_diag=diags[-1],
                max_diag=[max(col) for col in zip(*diags)],
                mean_diag=[statistics.mean(col) for col in zip(*diags)],
                total_diag=[sum(col) for col in zip(*diags)],
                peak_gib=peak,
                launches={k: c[0] for k, c in counts.items()})


def check_dfsph_30k(tag: str, run: dict) -> None:
    """The 30k run's diagnostics repeat DFSPH_30K[tag] digit for digit."""
    last, mean = run["last_diag"], run["mean_diag"]
    got = (f"{last[1]:.2f}", f"{mean[2]:.2f}", f"{last[3]:.4f}")
    check(got == DFSPH_30K[tag],
          f"{tag}: 30k diagnostics {got}, not {DFSPH_30K[tag]}")


def phase_main(torch, sims: dict, results: dict) -> None:
    from cfd_taichi_tpu_torch import Simulation
    from cfd_taichi_tpu_torch.perf import inputs

    sim = sims["30k"] = Simulation(
        inputs.solver_config("breaking_dam_30k.json"), device="cuda")
    run = drive(sim, "main", [100], COEF_PATH, torch)
    for name in ("matvec", "matvec_dot"):
        check(run["launches"][name] == 0,
              f"main: recompute {name} launched on the coef engine")
    tele = sim.telemetry()
    print(f"[main] telemetry {json.dumps(tele)}")
    check(tele["nan_particles"] == 0, "main: NaN particles")
    residual = run["last_diag"][3]
    check(residual <= 1.0, f"main: density residual {residual} > 1.0")
    check_dfsph_30k("main", run)
    for name in COEF_PATH:
        results[name]["launches"] = run["launches"][name]
    results["_runs"]["30k_coef_f32"] = run


def one_million(torch, sims: dict):
    from cfd_taichi_tpu_torch import Simulation
    from cfd_taichi_tpu_torch.perf import inputs

    if "1m" not in sims:
        t0 = time.perf_counter()
        sims["1m"] = Simulation(inputs.solver_config("breaking_dam_1m.json"),
                                device="cuda")
        print(f"[scale] breaking_dam_1m scene built in "
              f"{time.perf_counter() - t0:.1f} s")
    return sims["1m"]


def phase_recompute(torch, sims: dict, results: dict) -> None:
    from cfd_taichi_tpu_torch.perf.inputs import engine

    with engine(budget=0):
        run = drive(sims["30k"], "recompute", [100], RECOMPUTE_PATH, torch)
        residual = run["last_diag"][3]
        check(residual <= 1.0, f"recompute: density residual {residual}")
        check_dfsph_30k("recompute", run)
        for name in ("coef_build", "coef_matvec", "coef_matvec_dot"):
            check(run["launches"][name] == 0,
                  f"recompute: {name} launched with a coef budget of 0")
        for name in ("matvec", "matvec_dot"):
            results[name]["launches"] = run["launches"][name]
        results["_runs"]["30k_recompute"] = run
        results["_runs"]["1m_recompute"] = drive(
            one_million(torch, sims), "recompute", [5, 10], RECOMPUTE_PATH,
            torch)


def phase_scale(torch, sims: dict, results: dict) -> None:
    run = drive(one_million(torch, sims), "scale", [5, 10], COEF_PATH, torch)
    residual = run["last_diag"][3]
    check(residual <= 1.0, f"scale: density residual {residual} > 1.0")
    results["_runs"]["1m_coef_f32"] = run


def with_solver(sim, solver: str):
    """A Simulation on `sim`'s scene, which does not depend on the solver,
    that steps `solver` (`drive` starts it from rest)."""
    import dataclasses

    from cfd_taichi_tpu_torch import models

    other = copy.copy(sim)
    other.cfg = dataclasses.replace(sim.cfg, solver=dataclasses.replace(
        sim.cfg.solver, name=solver))
    other.solver = models.get_solver(solver)
    return other


def outside_box(sim, torch) -> int:
    """Particles outside the box grown by 2r."""
    sc, pos = sim.scene, sim.state.fluid.pos
    margin = 2.0 * sc.particle_radius
    lo = torch.tensor(sc.box_min, device=pos.device) - margin
    hi = torch.tensor(sc.box_max, device=pos.device) + margin
    return int((~((pos >= lo) & (pos <= hi)).all(dim=1)).sum())


def phase_solver(torch, sims: dict, results: dict, solver: str) -> None:
    """PCISPH or PBF from rest at 30k (steps 1-100) and 1M (steps 6-15) on
    the scenes that main and scale built: the path's kernels launched as
    often as the step calls them, no other kernel and no plain version,
    the state finite and contained; PCISPH's last residual within its
    threshold unless the step hit its iteration cap."""
    from cfd_taichi_tpu_torch.models import pcisph

    path = PCISPH_PATH if solver == "pcisph" else PBF_PATH
    for tag, windows in (("30k", [100]), ("1m", [5, 10])):
        sim = with_solver(sims[tag], solver)
        run = drive(sim, solver, windows, path, torch)
        steps, diag = sum(windows), run["last_diag"]
        iters = round(run["total_diag"][0])
        want = dict.fromkeys(path, steps)
        if solver == "pcisph":
            want.update(coef_matvec=iters, pcisph_predict_rho=iters + steps)
            check(diag[1] <= 1.0 or diag[0] == pcisph.MAX_ITER,
                  f"{solver} {tag}: residual {diag[1]} after {diag[0]} "
                  f"iterations")
        else:
            want["pbf_terms"] = 2 * steps   # fluid and boundary entries
        for name, launches in run["launches"].items():
            check(launches == want.get(name, 0),
                  f"{solver} {tag}: {name} launched {launches} times, not "
                  f"{want.get(name, 0)}")
        outside = outside_box(sim, torch)
        print(f"[{solver}] {tag}: {outside} particles outside the box +- 2r")
        check(outside == 0, f"{solver} {tag}: {outside} particles escaped")
        if tag == "30k":
            for name in path[-1:] if solver == "pcisph" else path:
                results[name]["launches"] = run["launches"][name]
        results["_runs"][f"{tag}_{solver}"] = run


def phase_scale_bf16(torch, sims: dict, results: dict) -> None:
    from cfd_taichi_tpu_torch.perf.inputs import engine

    with engine(dtype=torch.bfloat16):
        results["_runs"]["1m_coef_bf16"] = drive(
            one_million(torch, sims), "scale-bf16", [5, 10], COEF_PATH, torch)
        # Free the 1M state, so that the 30k run's peak memory is its own.
        del sims["1m"]
        torch.cuda.empty_cache()
        results["_runs"]["30k_coef_bf16"] = drive(
            sims["30k"], "scale-bf16", [100], COEF_PATH, torch)


def phase_wcsph(torch, results: dict) -> None:
    """WCSPH at 30k (steps 1-100) and 1M (steps 6-15) from rest: its three
    pair kernels once a step, and the state contained and sane."""
    from cfd_taichi_tpu_torch import Simulation
    from cfd_taichi_tpu_torch.perf import inputs

    for tag, cfg_name, windows in (("30k", "breaking_dam_30k.json", [100]),
                                   ("1m", "breaking_dam_1m.json", [5, 10])):
        t0 = time.perf_counter()
        sim = Simulation(inputs.solver_config(cfg_name, "wcsph"),
                         device="cuda")
        print(f"[wcsph] {cfg_name} scene built in "
              f"{time.perf_counter() - t0:.1f} s")
        run = drive(sim, "wcsph", windows, WCSPH_PATH, torch)
        for name, launches in run["launches"].items():
            want = sum(windows) if name in WCSPH_PATH else 0
            check(launches == want,
                  f"wcsph {tag}: {name} launched {launches} times, not "
                  f"{want}")
        outside = outside_box(sim, torch)
        rho = sim.density()
        lo_rho, hi_rho = float(rho.min()), float(rho.max())
        print(f"[wcsph] {tag}: {outside} particles outside the box +- 2r; "
              f"density min {lo_rho:.2f} max {hi_rho:.2f}")
        check(outside == 0, f"wcsph {tag}: {outside} particles escaped")
        check(100.0 < lo_rho and hi_rho < 2000.0,
              f"wcsph {tag}: density range {lo_rho}, {hi_rho}")
        got = (f"{lo_rho:.2f}", f"{hi_rho:.2f}")
        check(got == WCSPH_RHO[tag],
              f"wcsph {tag}: density range {got}, not {WCSPH_RHO[tag]}")
        if tag == "30k":
            results["wcsph_forces"]["launches"] = \
                run["launches"]["wcsph_forces"]
        results["_runs"][f"{tag}_wcsph"] = run
        del sim
        torch.cuda.empty_cache()


def phase_iisph(torch, results: dict) -> None:
    """configs/breaking_dam_30k.json as written (IISPH), on the card by
    default, steps 1-50 from rest on each loop engine."""
    from cfd_taichi_tpu_torch import Simulation, read_config
    from cfd_taichi_tpu_torch.perf import inputs

    sim = Simulation(read_config(str(inputs.CONFIGS /
                                     "breaking_dam_30k.json")))
    check(sim.cfg.solver.name == "iisph" and sim.device.type == "cuda",
          f"iisph: {sim.cfg.solver.name} on {sim.device}")
    for engine, pins, path, idle in (
            ("coef", {}, COEF_PATH, ("matvec", "matvec_dot")),
            ("recompute", {"budget": 0}, RECOMPUTE_PATH,
             ("coef_build", "coef_matvec", "coef_matvec_dot"))):
        with inputs.engine(**pins):
            run = drive(sim, f"iisph-{engine}", [50], path, torch)
        for name in idle + ("wcsph_forces",):
            check(run["launches"][name] == 0,
                  f"iisph {engine}: {name} launched")
        iters = run["max_diag"][0]
        check(iters <= 180, f"iisph {engine}: {iters} Jacobi iterations")
        # from rest the block touches nothing: rho_adv stays under rho0
        check(run["mean_diag"][0] == 1.0 and run["last_diag"][1] == 0.0,
              f"iisph {engine}: not 1 iteration a step and residual 0: "
              f"mean {run['mean_diag']}, last {run['last_diag']}")
        results["_runs"][f"30k_iisph_{engine}"] = run


def main() -> int:
    try:
        import torch

        from cfd_taichi_tpu_torch.ops import _build, stencil
    except ImportError as e:
        print(f"FAIL: cannot import the port: {e}", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    try:
        kind = torch.cuda.get_device_name(0)
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip()
        print(f"[device] torch {torch.__version__} cuda {torch.version.cuda}"
              f" device {kind} count {torch.cuda.device_count()}")
        print("[device] nvidia-smi name, power.limit:")
        print(smi)

        start = t0 = time.perf_counter()
        lib = _build.library()
        print(f"[build] {lib.path.name}: nvcc {lib.build_seconds:.1f} s, "
              f"ready in {time.perf_counter() - t0:.1f} s")
        for line in lib.log.splitlines():
            if "registers" in line or "Compiling entry" in line:
                print(f"[build] {line.strip()}")

        results: dict = {"_runs": {}}
        sims: dict = {}
        phase_kernels(torch, results)
        phase_agree(torch)
        phase_main(torch, sims, results)
        phase_recompute(torch, sims, results)
        phase_scale(torch, sims, results)
        for solver in ("pcisph", "pbf"):
            phase_solver(torch, sims, results, solver)
        phase_scale_bf16(torch, sims, results)
        phase_wcsph(torch, results)
        phase_iisph(torch, results)
    except (SmokeFailure, RuntimeError, subprocess.SubprocessError,
            OSError) as e:
        print(f"FAIL: {type(e).__name__}: {e}", file=sys.stderr)
        return 1

    print("[runs] " + json.dumps(results.pop("_runs")))
    print(f"[time] chip_smoke ran {time.perf_counter() - start:.1f} s")
    kernels = []
    for k in stencil.KERNELS.values():
        row = results[k.name]
        head = dict(
            name=k.name, route="cuda", source=k.source, replaces=k.replaces,
            launches=row.pop("launches"),
            max_abs_err=row.pop("max_abs_err_30k"), ms=row.pop("ms_30k"),
            plain_ms=row.pop("plain_ms_30k"),
            bound_ms=row.pop("bound_ms_30k"),
            bound_by=row.pop("bound_by_30k"),
            library_ms=row.pop("library_ms_30k", None),
            bound_us_1m=row["bound_ms_1m"] * 1e3,
            library_ms_1m=row.pop("library_ms_1m", None))
        kernels.append({**head, **dict(sorted(row.items()))})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
