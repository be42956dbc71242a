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
                with a numpy-seeded 0.1 r jitter, random v, k and rho):
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
                sources, 1000 and 1003 rows), f32 and bf16. Kernel and
                plain times: CUDA events, median of 10 after 3 warm-up
                calls. Each kernel's bound (perf/bounds.py: the bytes and
                f32 operations of the call's inputs at the H100's peaks)
                and, for the coef contraction, the one PyTorch call that
                computes its lane sums (torch.sparse CSR @ dense lanes,
                row- and column-major, timed like the kernel; the port
                never calls it): perf/cases.py, which perf/kernel_table.py
                shares.
4. agree      - the TINY scene (tests/test_solvers.py:14-23) stepped 6 times
                on the card and on the CPU: positions through oid to 5e-6,
                dt to rtol 1e-5, equal iteration counts.
5. main       - configs/breaking_dam_30k.json as DFSPH, 100 steps from rest
                through Simulation.step on the default engine (stored
                coefficients, f32). fluid_terms, boundary_terms, viscosity,
                coef_build, coef_matvec and coef_matvec_dot must have
                launched and no plain version may have run; positions
                finite; the last step's density residual at most 1.0 (0.1%
                rho0, the loop's threshold).
6. recompute  - the same 30k run with the coef budget at 0: the recompute
                engine's matvec and matvec_dot must launch, residual <= 1.0;
                then breaking_dam_1m for 15 steps on it.
7. scale      - configs/breaking_dam_1m.json as DFSPH on the default
                engine, steps 1-5 and 6-15: coef kernels launched, finite,
                last density residual <= 1.0.
8. scale-bf16 - 1M and 30k with bf16 coefficient storage: iterations and
                residual printed, positions finite.

Each run prints steps/s, iterations per step, the last density residual
and peak device memory. The line before the last is {"kernels": [...]}
(ms, plain_ms, bound_ms, library_ms at 30k; bound_us_1m, library_ms_1m
and the other sizes and dtypes beside them), the last one {"ok": true,
"device": {...}}.
"""

from __future__ import annotations

import copy
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
# Kernels each run must launch (and no plain version may run).
COEF_PATH = ("fluid_terms", "boundary_terms", "viscosity", "coef_build",
             "coef_matvec", "coef_matvec_dot")
RECOMPUTE_PATH = ("fluid_terms", "boundary_terms", "viscosity", "matvec",
                  "matvec_dot")


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


def compare_w(tag: str, got, want, torch) -> float:
    """Stored coefficients: f32 to 1e-5 of the largest |w|. A bf16 w may
    round a value that sits on a rounding boundary the other way, so slots
    may differ by one ulp (2^-7 relative), in at most 1e-4 of them."""
    a, b = got.float(), want.float()
    err = float((a - b).abs().max())
    if got.dtype == torch.float32:
        tol = TOL * float(b.abs().max())
        print(f"    {tag} w: max_abs_err {err:.3e}  tol {tol:.3e}")
        check(err <= tol, f"{tag} w: error {err} above {tol}")
        return err
    n_diff = int((a != b).sum())
    ulp_ok = bool(((a - b).abs() <= 2.0**-7 * b.abs()).all())
    print(f"    {tag} w: {n_diff} of {b.numel()} bf16 slots differ (bound "
          f"{int(1e-4 * b.numel())}), all within one ulp: {ulp_ok}")
    check(ulp_ok and n_diff <= 1e-4 * b.numel(),
          f"{tag} w: {n_diff} bf16 slots differ, within one ulp: {ulp_ok}")
    return err


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
        eng, want = case.kern(), case.plain()
        bad = int((eng.nbr != want.nbr).sum())
        print(f"    {case.key} nbr: {bad} of {eng.nbr.numel()} slots differ "
              f"(want 0)")
        check(bad == 0, f"{case.key}: {bad} nbr mismatches")
        return compare_w(case.key, eng.w, want.w, torch)
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

    sims = {dev: Simulation(parse_config(copy.deepcopy(TINY)), device=dev)
            for dev in ("cuda", "cpu")}
    for step in range(1, 7):
        for s in sims.values():
            s.step()
        a, b = (sims[d].state for d in ("cuda", "cpu"))
        err = float(np.abs(oid_sorted(a) - oid_sorted(b)).max())
        da, db = a.diag.cpu().tolist(), b.diag.cpu().tolist()
        print(f"[agree] step {step}: pos err {err:.3e}  iters cuda "
              f"{da[0]:.0f}/{da[2]:.0f} cpu {db[0]:.0f}/{db[2]:.0f}  dt "
              f"{float(a.dt):.6e} / {float(b.dt):.6e}")
        check(err <= 5e-6, f"TINY step {step}: cuda vs cpu pos err {err}")
        check(abs(float(a.dt) - float(b.dt)) <= 1e-5 * float(b.dt),
              f"TINY step {step}: dt differs")
        check((da[0], da[2]) == (db[0], db[2]),
              f"TINY step {step}: iteration counts differ")


# ---------------------------------------------------------------------------
# The DFSPH runs
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


def iter_summary(diags) -> str:
    div = [d[0] for d in diags]
    den = [d[2] for d in diags]
    return (f"div iters mean {statistics.mean(div):.2f} max {max(div):.0f}; "
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
    residual = diags[-1][3]
    print(f"[{tag}] {iter_summary(diags)}")
    print(f"[{tag}] kernel (launches, plain calls): {counts}")
    print(f"[{tag}] last density residual {residual}; peak device memory "
          f"{peak:.3f} GiB")
    for name, (launches, plain) in counts.items():
        check(plain == 0, f"{tag}: plain version of {name} ran")
        check(launches > 0 or name not in path,
              f"{tag}: {name} never launched")
    check_state(sim, tag)
    return dict(steps_per_sec=rates, last_diag=diags[-1], peak_gib=peak,
                launches={k: c[0] for k, c in counts.items()})


def phase_main(torch, sims: dict, results: dict) -> None:
    from cfd_taichi_tpu_torch import Simulation
    from cfd_taichi_tpu_torch.perf import inputs

    sim = sims["30k"] = Simulation(
        inputs.dfsph_config("breaking_dam_30k.json"), device="cuda")
    run = drive(sim, "main", [100], COEF_PATH, torch)
    for name in ("matvec", "matvec_dot"):
        check(run["launches"][name] == 0,
              f"main: recompute {name} launched on the coef engine")
    tele = sim.telemetry()
    print(f"[main] telemetry {json.dumps(tele)}")
    check(tele["nan_particles"] == 0, "main: NaN particles")
    residual = run["last_diag"][3]
    check(residual <= 1.0, f"main: density residual {residual} > 1.0")
    for name in COEF_PATH:
        results[name]["launches"] = run["launches"][name]
    results["_runs"]["30k_coef_f32"] = run


def one_million(torch, sims: dict):
    from cfd_taichi_tpu_torch import Simulation
    from cfd_taichi_tpu_torch.perf import inputs

    if "1m" not in sims:
        t0 = time.perf_counter()
        sims["1m"] = Simulation(inputs.dfsph_config("breaking_dam_1m.json"),
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

        t0 = time.perf_counter()
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
        phase_scale_bf16(torch, sims, results)
    except (SmokeFailure, RuntimeError, subprocess.SubprocessError,
            OSError) as e:
        print(f"FAIL: {type(e).__name__}: {e}", file=sys.stderr)
        return 1

    print("[runs] " + json.dumps(results.pop("_runs")))
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
