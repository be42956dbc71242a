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
                calls. The fluid-rigid kernels (rigid_terms,
                rigid_contact_dot, rigid_viscosity, rigid_side_force, and
                pcisph_predict_rho with its walk over the body at the
                inputs' positions shifted by ~0.3 r, named
                pcisph_predict_rho_rigid) run on a body in water
                (perf/inputs.body_inputs: the 30k and 1M blocks,
                jittered, with a builtin:cube1 body of ~3,200 and ~40k
                voxels at their centre, the fluid in its voxels taken out)
                and on the half-immersed torus scene (perf/inputs.
                torus_inputs), with random rigid and fluid
                velocities, densities and u, to 1e-5 of scale;
                rigid_side_force and pcisph_predict_rho_rigid must also
                repeat bit for bit over two launches, and the body's walk
                is timed as the call less the call without the body. Each
                kernel's bound (perf/bounds.py: the bytes and
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
                5e-6 (WCSPH 6.0e-8 and IISPH 1.2e-7, what the same kernels
                gave before), dt to rtol 1e-5, equal iteration counts every
                step; the errors are printed. Then the coupled scene of
                tests/test_rigid.py:12-21 (RIGID_CFG) as DFSPH, PCISPH,
                IISPH and WCSPH with the body in the water, squeezed by
                0.97 about its mean, 4 steps with a rigid step after each:
                positions to 5e-6, equal counts, the centroid to 1e-5.
5. loops      - ops/loops.py: the pressure loops' graph trips against
                eager trips (`while_loop_unrolled_plain`) on the card, on the
                carry of tests/test_loops.py:15-33 (U in 1, 2, 3, 4, 7;
                stop at 1, 5, 12, 100 iterations; every leaf bit for bit,
                ceil(n / U) trips, one capture where a second trip runs)
                and on 20 steps of breaking_dam_30k as DFSPH at the scene's
                U, at another U and with eager loops: positions, oid and
                diag bit for bit, coef_matvec launched 1 + trips x U times
                a step; prints host reads (trips), captures and their host
                ms a step. Every later phase counts a loop's launches as
                trips x U of its sub-iterations, masked ones included
                (`looped`), where it counts them.
6. main       - configs/breaking_dam_30k.json as DFSPH, 100 steps from rest
                through Simulation.step on the default engine (stored
                coefficients, f32). fluid_terms, boundary_terms, viscosity,
                coef_build, coef_matvec and coef_matvec_dot must have
                launched and no plain version may have run; positions
                finite; the last step's density residual at most 1.0 (0.1%
                rho0, the loop's threshold); the last residuals and the mean
                density iterations a step, as printed, the ones the kernels
                gave before (DFSPH_30K).
7. recompute  - the same 30k run with the coef budget at 0: the recompute
                engine's matvec and matvec_dot must launch, residual <= 1.0,
                diagnostics as in main (DFSPH_30K); then breaking_dam_1m
                for 15 steps on it.
8. scale      - configs/breaking_dam_1m.json as DFSPH on the default
                engine, steps 1-5 and 6-15: coef kernels launched, finite,
                last density residual <= 1.0.
9. pcisph     - breaking_dam_30k as PCISPH, steps 1-100 from rest, and
                breaking_dam_1m as PCISPH, steps 6-15, on the scenes that
                main and scale built: fluid_terms, boundary_terms,
                viscosity, coef_build, coef_matvec and pcisph_predict_rho
                launched and no plain version; finite; every particle
                inside the box +- 2r; the last residual <= 1.0 unless the
                step hit 80 iterations; iterations a step printed.
10. pbf       - the same runs as PBF: pbf_terms, pbf_lambda and pbf_xsph
                launched (pbf_terms twice a step: fluid and boundary
                entries) and no plain version; finite; inside the box +-
                2r.
11. scale-bf16 - 1M and 30k with bf16 coefficient storage: iterations and
                residual printed, positions finite.
12. wcsph     - breaking_dam_30k as WCSPH, steps 1-100 from rest, and
                breaking_dam_1m as WCSPH, steps 6-15: fluid_terms,
                boundary_terms and wcsph_forces launched once a step and
                no plain version; finite; every particle inside the box
                +- 2r; density within (100, 2000) (tests/test_wcsph.py:
                53-58), and its range, to two decimals, the one the
                kernels gave before (WCSPH_RHO).
13. iisph     - configs/breaking_dam_30k.json as written (IISPH, on the
                card by default), steps 1-50 from rest on the coef engine
                and on the recompute engine: that engine's kernels
                launched, no plain version, finite, at most 180 Jacobi
                iterations a step; from rest, one iteration every step and
                a last residual of 0, as before. The 0.1 % contract is not
                required: the reference's break on a rising residual may
                stop above it.
14. export    - configs/torus_flush.json through runner.run with PLY
                export, 40 frames: ceil(t / frame_time) PLY frames and an
                OBJ of the torus beside each, named as the JAX runner names
                them, read back (every fluid particle, finite, in the box
                +- 2r, the fluid's RGBA; the torus' vertices and faces),
                and the final state written and read back to %.6g; then
                the host time of one 1M-particle PLY. (PNG frames need
                matplotlib and PIL, which this script does not require.)
15. rigid     - configs/torus_flush.json as written (DFSPH, a torus beside
                the water), 200 frames, each a fluid step and a rigid step
                (Simulation.frame), its variant with the torus moved to
                start half immersed in the water (perf/inputs.
                torus_immersed; the offset is printed), 24 frames, then 36
                frames each of configs/coupling_demo.json at full size
                (55,200 fluid and 3,200 rigid particles, PCISPH),
                dam_flush_cube.json (PCISPH), experiment1.json (IISPH) and
                experiment2.json (WCSPH): the solid kernels launched as
                often as the solver's step calls them (rigid_launches)
                beside its own pair kernels, no plain version; the
                reaction force non-zero in the torus variant's first three
                steps; fluid and body finite and inside the box +- 2r;
                DFSPH's last density residual <= 1.0 unless the step hit
                the 500-iteration cap, PCISPH's <= 1.0 unless it hit 80,
                IISPH at most 180 iterations. Prints steps/s, device time a
                step and busy share (3 profiled frames each, after all six
                runs: a process that has profiled launches slower), peak
                memory, iterations a step, max |F| of the first steps
                (sampled before each rigid step) and the centroid's path.

16. shard     - the slab decomposition (cfd_taichi_tpu_torch/parallel),
                its ranks started by parallel/launch.spawn with the rank
                programs of perf/shard_rates.py. NCCL, one rank a card
                (world = torch.cuda.device_count(), 1 here):
                configs/breaking_dam_1m.json as DFSPH, 5 sharded steps from
                rest against 5 single-device steps on the same scene in
                the same process: equal iteration counts every step, dt to
                rtol 1e-5, the largest position difference through oid
                printed and held to 5e-6, the particle count kept, overflow
                0; each rank's launches (stencil.KERNELS) reach every
                kernel of the coef path and no plain version; the loops'
                captures, host reads, rates, device time, the
                decomposition's pieces and peak memory a rank printed.
                With one card, prints that NCCL over several cards did not
                run. Then four gloo ranks sharing the card, their messages
                staged through host memory (eager trips, printed):
                breaking_dam_1m with make_spec(..., slack=2.2), so slabs
                0-3 hold 480,000 / 500,000 / 20,000 / 0 of the 1,000,000
                particles at rest against a cap of 550,000, as DFSPH and
                as WCSPH for 3 steps each against the single-device steps
                run here: counts, dt and positions as above, overflow 0,
                the particle count kept, every rank's path kernels launched
                and no plain version on any rank. Then the coupled
                sharded step, a frame being a sharded fluid step and
                domain.make_sharded_rigid_step: NCCL one rank a card on
                configs/coupling_demo.json as written (PCISPH, 55,200
                fluid and 3,200 rigid particles; 30 frames) and on the
                half-immersed torus (perf/inputs.torus_immersed, DFSPH;
                5 frames) against runner.Simulation's frames on the same
                scene: at world 1 bit for bit (positions through oid,
                dt, diag, the body's largest force and its centroid,
                velocity and angular velocity every frame), launches
                equal to the single-device run's, the solid passes as
                often as rigid_launches says, no plain version, overflow
                0; coupling_demo's frame rates, device time and the two
                sums over the ranks a coupled step adds, timed alone,
                printed. Then four gloo ranks sharing the card on the
                half-immersed torus (slack 2.5: 3,072 / 2,304 / 0 / 0 at
                rest, the body across the 0.5 m slab face), 3 frames
                against the single-device frames run here: the first
                frame at tests/test_torch_sharding_rigid.py's bars
                (equal counts, dt rtol 1e-5, positions 5e-6, the force
                to 1e-5 of its largest component, the body); every frame
                the divergence counts equal, the density counts within
                one, positions to 1e-3 and the centroid to 1e-5
                (SHARD_JAX_BARS says why); the ranks agree on the body
                bit for bit, every rank's launches on the trips x U
                formula, overflow 0.

Each run prints steps/s, iterations per step, the last residuals and
peak device memory; the whole run's wall time comes before the JSON. The line before the last is {"kernels": [...]}
(ms, plain_ms, bound_ms, library_ms at 30k; bound_us_1m, library_ms_1m
and the other sizes and dtypes beside them; launches_shard, the
launches of the NCCL rank 0's sharded run in [shard];
launches_shard_coupled, those of its coupled runs), the last one
{"ok": true, "device": {...}}.
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
# 5e-6, or what the same kernels gave before, 5.960e-08 and 1.192e-07 on
# an H100 80GB HBM3 since the cubic kernels take q = r * f32(1/h), so
# that a kernel that moves it shows; PCISPH and PBF gave 4.470e-07 and
# 1.788e-07 there)
AGREE = (("dfsph", False, 5e-6), ("wcsph", True, 6.0e-8),
         ("iisph", True, 1.2e-7), ("pcisph", True, 5e-6), ("pbf", True, 5e-6))
# [agree]: RIGID_CFG (tests/test_rigid.py:12-21) as DFSPH with the body in
# the water, squeezed by 0.97 about its mean, 4 steps with rigid steps
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
RIGID_PATH = ("rigid_terms", "rigid_contact_dot", "rigid_viscosity",
              "rigid_side_force", "pcisph_predict_rho_rigid")
# [agree]: the solvers that couple a body, each run on RIGID_CFG
AGREE_COUPLED = ("dfsph", "pcisph", "iisph", "wcsph")
# [rigid]: (tag, config, frames) of torus_flush as written (DFSPH) and its
# half-immersed variant, then the four configs whose solvers couple to
# the body since: coupling_demo at full size (55,200 fluid, 3,200 rigid)
# and dam_flush_cube (PCISPH), experiment1 (IISPH), experiment2 (WCSPH),
# whose bodies stand beside the water at the start. The torus variant's
# voxels overlap ~250 fluid particles, whose pressure throws them out: in
# both packages two of them leave the box +- 2r after 30 steps (the JAX
# package at step 33 on the CPU, the port at step 40 or before on an
# H100), so its run stops at 24.
RIGID_RUNS = (("torus_flush", "torus_flush.json", 200),
              ("immersed", None, 24),
              ("coupling_demo", "coupling_demo.json", 36),
              ("dam_flush_cube", "dam_flush_cube.json", 36),
              ("experiment1", "experiment1.json", 36),
              ("experiment2", "experiment2.json", 36))
# [rigid]: the fluid and rigid particles of configs/coupling_demo.json
COUPLING_DEMO_SIZE = (55_200, 3_200)
# [rigid]: the solver's own pair kernels, which each coupled run launches
SOLVER_PATH = {"dfsph": COEF_PATH, "pcisph": PCISPH_PATH,
               "iisph": COEF_PATH, "wcsph": WCSPH_PATH}
# [wcsph]: the density range after the run, as printed (%.2f), that the
# kernels gave before; the same arithmetic in the same order repeats it.
WCSPH_RHO = {"30k": ("293.99", "693.86"), "1m": ("289.52", "684.12")}
# [main] and [recompute] at 30k: the last divergence residual, the mean
# density iterations a step and the last density residual, as printed,
# that the kernels gave before (PERF.md section 5), on an H100 80GB HBM3
# since the cubic kernels take q = r * f32(1/h).
DFSPH_30K = {"main": ("84.84", "8.18", "0.7667"),
             "recompute": ("86.43", "8.22", "0.8785")}
# [loops]: iterations a trip and stop iterations of the synthetic carry
# (tests/test_torch_loops.py), and the 30k DFSPH steps compared
LOOP_UNROLLS = (1, 2, 3, 4, 7)
LOOP_STOPS = (1, 5, 12, 100)
LOOP_STEPS = 20
# [export]: frames of configs/torus_flush.json run with PLY export
EXPORT_FRAMES = 40
# [shard]: the particles each gloo slab of perf/shard_rates.py holds at
# rest (breaking_dam_1m, slack 2.2), their cap, and the positions' bar
SHARD_GLOO_HELD = [480_000, 500_000, 20_000, 0]
SHARD_GLOO_CAP = 550_000
SHARD_POS_TOL = 5e-6
# [shard] coupled, the gloo ranks against the single-device frames: the
# bars of tests/test_torch_sharding_rigid.py (the body's centroid, vel and
# omega to the absolute bar or the relative one of its largest component,
# whichever is larger; the body's force, particle by particle, to
# SHARD_FORCE_TOL of the frame's largest component)
SHARD_BODY_TOL = {"centroid": 1e-5, "vel": 1e-4, "omega": 1e-3}
SHARD_BODY_RTOL = {"centroid": 1e-5, "vel": 1e-5, "omega": 2e-4}
SHARD_FORCE_TOL = 1e-5
# [shard] coupled gloo: the first frame is held to the CPU test's bars.
# Then the four ranks' partial sums (the residual averages', the
# reaction's) round unlike one device's, the torus is violent (dt 1e-3 to
# 8e-5 in three frames, forces to 2.9e6 N), and a density loop that ends
# near its threshold ends one iteration apart (57 against 58 in frame 2
# on an NVIDIA H100 80GB HBM3 at 700 W; ROADMAP.md section 3), which adds or
# drops one iteration's reaction (~1/158 of the force). Every frame: the
# divergence iterations equal and the density iterations within one,
# positions to 1e-3 and the centroid to 1e-5 (the bars of JAX's own test
# of its sharded coupled step, tests/test_sharding.py:306-321); the
# body's velocity and spin after the first frame are printed.
SHARD_JAX_BARS = {"pos": 1e-3, "centroid": 1e-5}


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
    rigid_checks(torch, results)
    ragged_checks(torch)
    clustered_checks(torch, results)


def rigid_checks(torch, results: dict) -> None:
    """The fluid-rigid kernels against their plain versions on a body in
    water at 30k and 1M and on the half-immersed torus scene, timed;
    rigid_side_force and pcisph_predict_rho with the body's walk repeat
    bit for bit. The walk's own time is the call's less the same call
    without the body."""
    from cfd_taichi_tpu_torch.models import base
    from cfd_taichi_tpu_torch.ops import stencil as S
    from cfd_taichi_tpu_torch.perf import bounds, cases, inputs, timing

    for tag, make in (
            ("30k", lambda: inputs.body_inputs("breaking_dam_30k.json", 3)),
            ("1m", lambda: inputs.body_inputs("breaking_dam_1m.json", 3)),
            ("torus", lambda: inputs.torus_inputs(3))):
        x = make()
        work = bounds.rigid_work(x)
        print(f"[kernels] body in water, {tag}: {x['p'].shape[0]} fluid "
              f"particles, {x['rpos'].shape[0]} rigid particles")
        for case in cases.rigid_cases(x, work):
            record(results, case, tag,
                   compare(f"{case.name} {tag}", case.kern(), case.plain(),
                           torch))
            if case.name in ("rigid_side_force", "pcisph_predict_rho_rigid"):
                same = torch.equal(case.kern(), case.kern())
                print(f"    {case.name} {tag}: two launches bit-equal "
                      f"{same}")
                check(same, f"{case.name} {tag}: launches differ")
        args = (x["p"], x["st"], x["grid"], x["h"], x["m"], x["shifted"],
                base.walls(x["sc"]), cases.RHO0)
        calls = (lambda: S.pcisph_predict_rho(*args, x["table"]),
                 lambda: S.pcisph_predict_rho(*args))
        # in turns: with, without, without, with
        ms = [timing.event_ms(calls[i]) for i in (0, 1, 1, 0)]
        row = results["pcisph_predict_rho_rigid"]
        row[f"ms_with_body_{tag}"] = (ms[0] + ms[3]) / 2
        row[f"ms_without_body_{tag}"] = (ms[1] + ms[2]) / 2
        row[f"ms_body_walk_{tag}"] = (ms[0] + ms[3] - ms[1] - ms[2]) / 2
        print(f"  pcisph_predict_rho_rigid {tag}: with the body "
              f"{row[f'ms_with_body_{tag}']:.4f} ms, without "
              f"{row[f'ms_without_body_{tag}']:.4f} ms (in turns "
              f"{[round(t, 4) for t in ms]}), so the body's walk "
              f"{row[f'ms_body_walk_{tag}']:.4f} ms")
        del x
        torch.cuda.empty_cache()


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
    agree_coupled(torch)


def agree_coupled(torch) -> None:
    """RIGID_CFG as each solver of AGREE_COUPLED, squeezed by 0.97 about
    its mean, 4 fluid steps each with its rigid step, on the card and on
    the CPU."""
    import numpy as np

    from cfd_taichi_tpu_torch import Simulation
    from cfd_taichi_tpu_torch.config import parse_config

    for solver in AGREE_COUPLED:
        raw = copy.deepcopy(RIGID_CFG)
        raw["solver"]["name"] = solver
        sims = {dev: Simulation(parse_config(raw), device=dev)
                for dev in ("cuda", "cpu")}
        pos = sims["cpu"].state.fluid.pos
        mid = pos.mean(dim=0)
        pos = mid + (pos - mid) * 0.97
        for dev, s in sims.items():
            s.state = s.state._replace(fluid=s.state.fluid._replace(
                pos=pos.to(dev)))
        for step in range(1, 5):
            for s in sims.values():
                s.step()
                s.rigid_step()
            a, b = (sims[d].state for d in ("cuda", "cpu"))
            err = float(np.abs(oid_sorted(a) - oid_sorted(b)).max())
            cerr = float((a.rigid.centroid.cpu()
                          - b.rigid.centroid).abs().max())
            da, db = a.diag.cpu().tolist(), b.diag.cpu().tolist()
            print(f"[agree] coupled {solver} step {step}: pos err "
                  f"{err:.3e}  centroid err {cerr:.3e}  iters cuda "
                  f"{da[0]:.0f}/{da[2]:.0f} cpu {db[0]:.0f}/{db[2]:.0f}")
            tag = f"RIGID_CFG {solver} step {step}"
            check(err <= 5e-6, f"{tag}: cuda vs cpu pos err {err}")
            check(cerr <= 1e-5, f"{tag}: cuda vs cpu centroid err {cerr}")
            check((da[0], da[2]) == (db[0], db[2]),
                  f"{tag}: iteration counts differ")


# ---------------------------------------------------------------------------
# [loops]
# ---------------------------------------------------------------------------

def loop_trips(iters: float, unroll: int) -> int:
    """Trips of a loop of `iters` real iterations at `unroll` a trip."""
    return -(-round(iters) // unroll)


def looped(diags, cols, unroll: int) -> int:
    """Sub-iterations launched (masked ones included) by the loops whose
    iteration counts stand in diag columns `cols`: trips x U, summed."""
    return sum(loop_trips(d[c], unroll) * unroll for d in diags for c in cols)


def phase_loops(torch, results: dict) -> None:
    """ops/loops.py on the card: the graph loop against the eager gated loop
    (`while_loop_unrolled_plain`) on the carry of tests/test_loops.py:15-33
    for U in LOOP_UNROLLS and n_stop in LOOP_STOPS, every leaf bit for bit,
    ceil(n / U) trips and one capture where there is a second trip; then
    breaking_dam_30k as DFSPH on the coef f32 engine, LOOP_STEPS steps from
    rest, at the scene's U, at U = 1 (4 where the scene's is 1) and with
    eager loops at the scene's U: positions, oid and diag bit for bit,
    coef_matvec launched 1 + trips x U times a step (the warm start and
    each loop sub-iteration, masked ones included). Prints the captures,
    their host ms and the host reads (trips) a step."""
    from cfd_taichi_tpu_torch import Simulation
    from cfd_taichi_tpu_torch.models import dfsph
    from cfd_taichi_tpu_torch.ops import loops, stencil
    from cfd_taichi_tpu_torch.perf import inputs

    dev = torch.device("cuda")

    def cond(c):
        _, _, _, resid, stop, it = c
        return (resid > 1.0) & (it < 50) & ~stop

    def make_body(n_stop):
        def body(c):
            x, y, z, resid, _, it = c
            return (x * 0.5, y + 1.0, z - x, resid * 0.6, it + 1 >= n_stop,
                    it + 1)
        return body

    for u in LOOP_UNROLLS:
        for n_stop in LOOP_STOPS:
            init = (torch.arange(4.0, device=dev), torch.ones(4, device=dev),
                    torch.zeros(4, device=dev),
                    torch.tensor(100.0, device=dev),
                    torch.zeros((), dtype=torch.bool, device=dev),
                    torch.zeros((), dtype=torch.int32, device=dev))
            pool = loops.GraphPool()
            got = loops.while_loop_unrolled(cond, make_body(n_stop), init, u,
                                            pool)
            want = loops.while_loop_unrolled_plain(cond, make_body(n_stop),
                                                   init, u)
            same = all(torch.equal(a, b) for a, b in zip(got, want))
            its = int(got[-1])
            check(same, f"loops: U={u} n_stop={n_stop}: graph and eager "
                  f"loops differ")
            check(pool.trips == loop_trips(its, u)
                  and pool.captures == (pool.trips > 1),
                  f"loops: U={u} n_stop={n_stop}: {pool.trips} trips, "
                  f"{pool.captures} captures for {its} iterations")
    print(f"[loops] synthetic carry: graph loop bit-equal to the eager loop "
          f"for U {LOOP_UNROLLS} x n_stop {LOOP_STOPS}; trips ceil(n / U)")

    sim = Simulation(inputs.solver_config("breaking_dam_30k.json"),
                     device="cuda")
    own = dfsph.loop_unroll(sim.scene)
    other = 1 if own != 1 else 4
    runs = {}
    for tag, pins in ((f"graph U={own}", {}),
                      (f"graph U={other}", {"unroll": other}),
                      (f"eager U={own}", {"eager": True})):
        graphs = sim.scene.loop_graphs
        with inputs.loop_mode(**pins):
            sim.state = sim.solver.init_state(sim.scene)
            u = dfsph.loop_unroll(sim.scene)
            graphs.reset()
            stencil.reset_counts()
            diags = []
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(LOOP_STEPS):
                sim.step()
                diags.append(sim.state.diag)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        diags = [d.tolist() for d in diags]
        want = LOOP_STEPS + looped(diags, (0, 2), u)
        mv = stencil.KERNELS["coef_matvec"].launches
        print(f"[loops] DFSPH 30k {tag}: {LOOP_STEPS / wall:.2f} steps/s; a "
              f"step {graphs.trips / LOOP_STEPS:.2f} host reads (trips), "
              f"{graphs.captures / LOOP_STEPS:.2f} captures, "
              f"{graphs.capture_s * 1e3 / LOOP_STEPS:.3f} ms capturing "
              f"({graphs.instantiate_s * 1e3 / LOOP_STEPS:.3f} ms in "
              f"capture_end); coef_matvec {mv} launches (want {want})")
        check(mv == want, f"loops: {tag}: coef_matvec launched {mv} times, "
              f"not {want}")
        check(graphs.trips == sum(loop_trips(d[c], u) for d in diags
                                  for c in (0, 2)),
              f"loops: {tag}: {graphs.trips} trips")
        runs[tag] = (sim.state, diags)
        results["_runs"][f"loops_30k_{tag.replace(' ', '_')}"] = dict(
            steps_per_sec=LOOP_STEPS / wall,
            reads_per_step=graphs.trips / LOOP_STEPS,
            captures_per_step=graphs.captures / LOOP_STEPS,
            capture_ms_per_step=graphs.capture_s * 1e3 / LOOP_STEPS)
    (ref, dref), *others = runs.values()
    for tag, (st, d) in list(runs.items())[1:]:
        same = (d == dref and torch.equal(st.fluid.pos, ref.fluid.pos)
                and torch.equal(st.fluid.oid, ref.fluid.oid))
        print(f"[loops] DFSPH 30k {tag} against graph U={own}: positions, "
              f"oid and diag bit-equal {same}")
        check(same, f"loops: DFSPH 30k {tag} differs from graph U={own}")


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
    from cfd_taichi_tpu_torch.models import dfsph
    from cfd_taichi_tpu_torch.ops import stencil

    graphs = sim.scene.loop_graphs
    sim.state = sim.solver.init_state(sim.scene)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    stencil.reset_counts()
    graphs.reset()
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
    reserved = torch.cuda.max_memory_reserved() / 2**30
    unroll = dfsph.loop_unroll(sim.scene)
    print(f"[{tag}] {iter_summary(sim.cfg.solver.name, diags)}; "
          f"{unroll} iteration(s) a trip, {graphs.trips / done:.2f} host "
          f"reads (trips), {graphs.captures / done:.2f} captures "
          f"({graphs.capture_s * 1e3 / done:.3f} ms, "
          f"{graphs.instantiate_s * 1e3 / done:.3f} instantiating) a step")
    print(f"[{tag}] kernel (launches, plain calls): {counts}")
    print(f"[{tag}] last diag {diags[-1]}; peak device memory {peak:.3f} "
          f"GiB ({reserved:.3f} reserved)")
    for name, (launches, plain) in counts.items():
        check(plain == 0, f"{tag}: plain version of {name} ran")
        check(launches > 0 or name not in path,
              f"{tag}: {name} never launched")
    check_state(sim, tag)
    return dict(steps_per_sec=rates, last_diag=diags[-1],
                max_diag=[max(col) for col in zip(*diags)],
                mean_diag=[statistics.mean(col) for col in zip(*diags)],
                total_diag=[sum(col) for col in zip(*diags)],
                peak_gib=peak, peak_reserved_gib=reserved, unroll=unroll,
                # trips x U of the loops in diag columns 0 and 2
                looped=[looped(diags, (c,), unroll) for c in (0, 2)],
                reads_per_step=graphs.trips / done,
                captures_per_step=graphs.captures / done,
                capture_ms_per_step=graphs.capture_s * 1e3 / done,
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
        # each loop sub-iteration, masked ones included: trips x U
        loop = run["looped"][0]
        want = dict.fromkeys(path, steps)
        if solver == "pcisph":
            want.update(coef_matvec=loop, pcisph_predict_rho=loop + steps)
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


def rigid_launches(solver: str, diags, unroll: int) -> dict:
    """The solid passes a coupled step of `solver` launches over the
    steps with these diags, at `unroll` loop iterations a trip, by kernel:
    the sums and the solid viscosity once a step; the reaction once a
    density sub-iteration (DFSPH), once a loop sub-iteration (PCISPH) or
    once a step (IISPH, WCSPH); the contact dot once in each DFSPH loop
    and once an IISPH step; PCISPH's walk over the body once a predict, a
    sub-iteration and once before its loop. A loop's sub-iterations, the
    masked ones included, are its trips x U."""
    steps = len(diags)
    loop = looped(diags, (2,) if solver == "dfsph" else (0,), unroll)
    want = dict(rigid_terms=steps, rigid_viscosity=steps)
    if solver == "dfsph":
        want.update(rigid_contact_dot=2 * steps, rigid_side_force=loop)
    elif solver == "pcisph":
        want.update(rigid_side_force=loop,
                    pcisph_predict_rho_rigid=loop + steps)
    elif solver == "iisph":
        want.update(rigid_contact_dot=steps, rigid_side_force=steps)
    else:
        want.update(rigid_side_force=steps)
    return want


def phase_rigid(torch, results: dict) -> None:
    """configs/torus_flush.json and its half-immersed variant (DFSPH), then
    the coupled configs of PCISPH, IISPH and WCSPH, on the card: each
    frame a fluid step and a rigid step (Simulation.frame; every config
    steps once a frame), the body's largest force sampled between them."""
    from cfd_taichi_tpu_torch import Simulation, read_config
    from cfd_taichi_tpu_torch.models import dfsph, iisph, pcisph
    from cfd_taichi_tpu_torch.ops import stencil
    from cfd_taichi_tpu_torch.perf import inputs, timing

    sims = {}
    for tag, cfg_name, steps in RIGID_RUNS:
        t0 = time.perf_counter()
        if cfg_name is None:
            cfg = inputs.torus_immersed()
            print(f"[rigid] immersed: torus_flush with solid.pos_offset "
                  f"{list(cfg.solid.pos_offset)}")
        else:
            cfg = read_config(str(inputs.CONFIGS / cfg_name))
        sim = Simulation(cfg)
        solver = cfg.solver.name
        check(sim.scene.coupled and sim.device.type == "cuda"
              and sim.iter_cnt == 1 and sim.scene.fs_couple,
              f"rigid {tag}: not a two-way coupled scene on the card that "
              f"steps once a frame")
        if tag == "coupling_demo":
            size = (sim.scene.n_fluid, sim.scene.n_rigid)
            check(size == COUPLING_DEMO_SIZE,
                  f"rigid {tag}: {size} fluid and rigid particles, not "
                  f"{COUPLING_DEMO_SIZE}")
        print(f"[rigid] {tag}: {solver}, scene built in "
              f"{time.perf_counter() - t0:.1f} s")
        forces = []
        rigid_step = sim.rigid_step

        def sampled_rigid_step():
            forces.append(sim.state.rigid.force.abs().max())
            rigid_step()

        sim.rigid_step = sampled_rigid_step
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        stencil.reset_counts()
        diags, path = [], []
        t0 = time.perf_counter()
        for k in range(steps):
            sim.frame()
            diags.append(sim.state.diag)
            if k % (steps // 8) == 0 or k == steps - 1:
                path.append(sim.state.rigid.centroid)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {k.name: (k.launches, k.plain_calls)
                  for k in stencil.KERNELS.values()}
        peak = torch.cuda.max_memory_allocated() / 2**30
        diags = [d.tolist() for d in diags]
        forces = [float(f) for f in forces]
        print(f"[rigid] {tag}: n={sim.scene.n_fluid} rigid="
              f"{sim.scene.n_rigid}: {steps} frames (fluid + rigid step) in "
              f"{wall:.3f} s = {steps / wall:.3f} steps/s; peak device "
              f"memory {peak:.3f} GiB")
        print(f"[rigid] {tag}: {iter_summary(solver, diags)}")
        print(f"[rigid] {tag}: kernel (launches, plain calls): {counts}")
        print(f"[rigid] {tag}: max |F| first steps "
              f"{[f'{f:.4e}' for f in forces[:3]]}, over the run "
              f"{max(forces):.4e}")
        print(f"[rigid] {tag}: centroid path "
              f"{[[round(c, 4) for c in p.tolist()] for p in path]}")
        want = rigid_launches(solver, diags, dfsph.loop_unroll(sim.scene))
        for name, (launches, plain) in counts.items():
            check(plain == 0, f"rigid {tag}: plain version of {name} ran")
            if name in RIGID_PATH:
                check(launches == want.get(name, 0),
                      f"rigid {tag}: {name} launched {launches} times, not "
                      f"{want.get(name, 0)}")
            elif name in SOLVER_PATH[solver]:
                check(launches > 0, f"rigid {tag}: {name} never launched")
        if tag == "immersed":
            check(min(forces[:3]) > 0.0,
                  f"rigid {tag}: no reaction force in the first steps")
        check_state(sim, f"rigid {tag}")
        bad = int(sum((~torch.isfinite(t)).sum() for t in sim.state.rigid))
        check(bad == 0, f"rigid {tag}: {bad} non-finite body values")
        outside = outside_box(sim, torch)
        margin = 2.0 * sim.scene.particle_radius
        rp = sim.state.rigid.pos
        lo = torch.tensor(sim.scene.box_min, device=rp.device) - margin
        hi = torch.tensor(sim.scene.box_max, device=rp.device) + margin
        body_out = int((~((rp >= lo) & (rp <= hi)).all(dim=1)).sum())
        print(f"[rigid] {tag}: {outside} fluid and {body_out} body particles "
              f"outside the box +- 2r")
        check(outside == 0 and body_out == 0, f"rigid {tag}: escaped")
        last = diags[-1]
        if solver == "dfsph":
            check(last[3] <= 1.0 or last[2] == dfsph.MAX_ITER_DENSITY,
                  f"rigid {tag}: density residual {last[3]} after "
                  f"{last[2]} iterations")
        elif solver == "pcisph":
            check(last[1] <= 1.0 or last[0] == pcisph.MAX_ITER,
                  f"rigid {tag}: residual {last[1]} after {last[0]} "
                  f"iterations")
        elif solver == "iisph":
            iters = max(d[0] for d in diags)
            check(iters <= iisph.MAX_ITER,
                  f"rigid {tag}: {iters} Jacobi iterations")
        if tag == "torus_flush":
            for name in RIGID_PATH[:4]:
                results[name]["launches"] = counts[name][0]
        elif tag == "coupling_demo":
            results["pcisph_predict_rho_rigid"]["launches"] = \
                counts["pcisph_predict_rho_rigid"][0]
        results["_runs"][f"rigid_{tag}"] = dict(
            steps_per_sec=steps / wall, peak_gib=peak,
            mean_diag=[statistics.mean(c) for c in zip(*diags)],
            last_diag=last, max_force=max(forces),
            launches={k: c[0] for k, c in counts.items()})
        sims[tag] = sim
    # The profiles last: a process that has run torch.profiler launches
    # slower on the host clock, replayed graphs most of all.
    for tag, sim in sims.items():
        run = results["_runs"][f"rigid_{tag}"]
        found, pwall = timing.profile_kernels(
            lambda: [sim.frame() for _ in range(3)])
        dev_ms = sum(t for _, t in found.values()) / 1e3 / 3
        run.update(device_ms_per_step=dev_ms, busy=dev_ms * 3 / 1e3 / pwall,
                   busy_at_rate=dev_ms / 1e3 * run["steps_per_sec"])
        print(f"[rigid] {tag}: device time {dev_ms:.3f} ms a step, busy "
              f"{dev_ms * 3 / 1e3 / pwall:.3f} of {pwall:.3f} s (3 "
              f"profiled steps; {run['busy_at_rate']:.3f} at the "
              f"unprofiled rate)")


def read_ply(path: str):
    """(positions, RGBA rows) of an ascii PLY as write_ply_ascii writes it."""
    import numpy as np

    with open(path) as f:
        head = []
        while not head or head[-1] != "end_header":
            head.append(f.readline().strip())
        rows = np.loadtxt(f, ndmin=2)
    n = int(next(h for h in head if h.startswith("element vertex"))
            .split()[-1])
    check(rows.shape[0] == n, f"{path}: {rows.shape[0]} rows, header {n}")
    return rows[:, :3], rows[:, 3:]


def read_obj(path: str):
    """(vertices, 0-based faces) of an OBJ as write_obj writes it."""
    import numpy as np

    with open(path) as f:
        lines = [ln.split() for ln in f]
    verts = np.array([ln[1:] for ln in lines if ln[0] == "v"], np.float64)
    faces = np.array([ln[1:] for ln in lines if ln[0] == "f"], np.int64) - 1
    return verts, faces


def phase_export(torch) -> None:
    """configs/torus_flush.json through `runner.run` on the card with
    scene.is_output_ply, EXPORT_FRAMES frames: a PLY of the fluid each time
    t passes another 1 / output_fps and an OBJ of the torus beside it,
    ceil(t / frame_time) of each, named as the JAX runner names them; each
    PLY read back holds every fluid particle, finite and inside the box +-
    2r, in the fluid's RGBA, each OBJ the torus' vertices and faces; the
    final state written and read back equals it to %.6g. Then the time of
    one 1M-particle PLY with RGBA (the host's, no card work)."""
    import dataclasses
    import math
    import shutil
    from pathlib import Path

    import numpy as np

    from cfd_taichi_tpu_torch import read_config, runner
    from cfd_taichi_tpu_torch.perf import inputs
    from cfd_taichi_tpu_torch.utils import io as io_utils

    out = Path("build/smoke_export")
    shutil.rmtree(out, ignore_errors=True)
    cfg = read_config(str(inputs.CONFIGS / "torus_flush.json"))
    cfg = dataclasses.replace(cfg, scene=dataclasses.replace(
        cfg.scene, is_output_ply=True))
    sim = runner.run(cfg, frames=EXPORT_FRAMES, output_dir=str(out),
                     quiet=True)
    sc = sim.scene
    frames = math.ceil(sim.t * cfg.scene.output_fps)
    names = sorted(p.name for p in out.iterdir())
    want = sorted([f"output_{k:06d}.ply" for k in range(frames)]
                  + [f"obj_{k:06d}.obj" for k in range(frames)])
    print(f"[export] torus_flush {EXPORT_FRAMES} frames to t {sim.t:.5f}: "
          f"{names}")
    check(names == want, f"export: files {names}, not {want}")
    margin = 2.0 * sc.particle_radius
    lo, hi = np.array(sc.box_min) - margin, np.array(sc.box_max) + margin
    nv, nf = sc.rigid0.vertices.shape[0], sc.rigid0.faces.shape[0]
    for k in range(frames):
        pos, rgba = read_ply(str(out / f"output_{k:06d}.ply"))
        check(pos.shape == (sc.n_fluid, 3) and np.isfinite(pos).all()
              and ((pos >= lo) & (pos <= hi)).all(),
              f"export: frame {k}: {pos.shape} positions, or outside the box")
        check((rgba == [0, 66, 173, 255]).all(), f"export: frame {k}: RGBA")
        verts, faces = read_obj(str(out / f"obj_{k:06d}.obj"))
        check(verts.shape == (nv, 3) and np.isfinite(verts).all()
              and np.array_equal(faces, sc.rigid0.faces),
              f"export: frame {k}: OBJ {verts.shape}, faces differ")
    pos = sim.state.fluid.pos.cpu().numpy()
    verts = sim.state.rigid.vertices.cpu().numpy()
    io_utils.write_ply_ascii(str(out / "last.ply"), pos)
    io_utils.write_obj(str(out / "last.obj"), verts, sc.rigid0.faces)
    got, _ = read_ply(str(out / "last.ply"))
    gverts, _ = read_obj(str(out / "last.obj"))
    err = max(float(np.abs(got - pos).max() / np.abs(pos).max()),
              float(np.abs(gverts - verts).max() / np.abs(verts).max()))
    print(f"[export] {frames} PLY and OBJ frames read back; the final state "
          f"read back to {err:.2e} of scale (%.6g: at most 5e-6)")
    check(err <= 5e-6, f"export: read back {err} of scale")
    big = np.random.default_rng(0).uniform(0.0, 1.0, (1_000_000, 3)).astype(
        np.float32)
    rgba = np.tile(np.array([[0.0, 0.26, 0.68, 1.0]], np.float32),
                   (big.shape[0], 1))
    t0 = time.perf_counter()
    io_utils.write_ply_ascii(str(out / "big.ply"), big, rgba)
    secs = time.perf_counter() - t0
    mb = (out / "big.ply").stat().st_size / 1e6
    print(f"[export] a 1M-particle PLY with RGBA: {secs:.3f} s, {mb:.1f} MB "
          f"(host)")
    shutil.rmtree(out, ignore_errors=True)


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


# ---------------------------------------------------------------------------
# [shard]
# ---------------------------------------------------------------------------

def shard_launches(solver: str, diags, unroll: int) -> dict:
    """The launches of a fluid-only run of `solver` (DFSPH on the stored-
    coefficient engine, or WCSPH) over the steps with these diags, at
    `unroll` loop iterations a trip, by kernel: each one-shot pass once a
    step; coef_matvec and coef_matvec_dot once a step (the warm start, the
    first density rate) and once a loop sub-iteration, the masked ones
    included."""
    steps = len(diags)
    if solver == "wcsph":
        return dict.fromkeys(WCSPH_PATH, steps)
    loop = steps + looped(diags, (0, 2), unroll)
    return dict(fluid_terms=steps, boundary_terms=steps, viscosity=steps,
                coef_build=steps, coef_matvec=loop, coef_matvec_dot=loop)


def shard_counts(tag: str, counts: dict, want: dict) -> None:
    """A rank's (launches, plain calls) by kernel: each kernel launched as
    often as `want` says (0 where it does not name it), no plain
    version."""
    for name, (launches, plain) in counts.items():
        check(plain == 0, f"{tag}: plain version of {name} ran")
        check(launches == want.get(name, 0),
              f"{tag}: {name} launched {launches} times, not "
              f"{want.get(name, 0)}")


def shard_agree(tag: str, diags, dts, want_diags, want_dts, err) -> None:
    its = [(d[0], d[2]) for d in diags]
    want = [(d[0], d[2]) for d in want_diags]
    print(f"[shard] {tag}: iterations {its} (single-device {want}); max "
          f"|pos - single| through oid {err:.3e}; dt {dts}")
    check(its == want, f"{tag}: iteration counts {its}, not {want}")
    for a, b in zip(dts, want_dts):
        check(abs(a - b) <= 1e-5 * abs(b), f"{tag}: dt {a} against {b}")
    check(err <= SHARD_POS_TOL, f"{tag}: positions differ by {err}")


def phase_shard(torch, results: dict) -> None:
    import numpy as np

    from cfd_taichi_tpu_torch import Simulation
    from cfd_taichi_tpu_torch.models import dfsph
    from cfd_taichi_tpu_torch.parallel import launch
    from cfd_taichi_tpu_torch.perf import inputs, shard_rates

    world = torch.cuda.device_count()
    t0 = time.perf_counter()
    nccl = launch.spawn(shard_rates.nccl_rank, world, backend="nccl",
                        device="cuda")
    print(f"[shard] NCCL, {world} rank(s), one a card: "
          f"{time.perf_counter() - t0:.1f} s, ranks' scenes built in "
          f"{[round(r['build_s'], 1) for r in nccl]} s")
    if world < 2:
        print("[shard] NCCL with one rank on each of several cards: not run "
              f"(this machine has {world} card)")
    for r in nccl:
        s = r["sharded"]
        tag = f"nccl rank {r['rank']}/{r['world']}"
        shard_rates.print_nccl(r)
        check(r["loops"] == "graph", f"{tag}: loops run {r['loops']}")
        check(s["overflow"] == 0, f"{tag}: overflow {s['overflow']}")
        check(s["count"] == r["n_fluid"], f"{tag}: {s['count']} particles")
        shard_counts(tag, s["counts"],
                     shard_launches("dfsph", s["diag"], r["unroll"]))
        if "single" in r:
            shard_agree(tag, s["diag"], s["dt"], r["single"]["diag"],
                        r["single"]["dt"], r["max_pos_err"])
            check(s["counts"] == r["single"]["counts"],
                  f"{tag}: launches {s['counts']}, single-device "
                  f"{r['single']['counts']}")
    results["shard_launches"] = {k: c[0] for k, c in
                                 nccl[0]["sharded"]["counts"].items()}
    t0 = time.perf_counter()
    gloo = launch.spawn(shard_rates.gloo_rank, shard_rates.GLOO_WORLD,
                        backend="gloo", device="cuda")
    print(f"[shard] gloo, {shard_rates.GLOO_WORLD} ranks sharing one card: "
          f"{time.perf_counter() - t0:.1f} s")
    check(gloo[0]["spec"]["cap"] == SHARD_GLOO_CAP,
          f"gloo: cap {gloo[0]['spec']['cap']}")
    runs = {"nccl": nccl, "gloo": []}
    for solver in shard_rates.GLOO_SOLVERS:
        sim = Simulation(inputs.solver_config(shard_rates.CONFIG, solver),
                         device="cuda")
        unroll = dfsph.loop_unroll(sim.scene)
        dts, diags = [], []
        for _ in range(shard_rates.GLOO_STEPS):
            sim.step()
            dts.append(float(sim.state.dt))
            diags.append(sim.state.diag.tolist())
        ref = oid_sorted(sim.state)
        del sim
        torch.cuda.empty_cache()
        rows = [r[solver] for r in gloo]
        pos = np.concatenate([g["pos"] for g in rows])
        oid = np.concatenate([g["oid"] for g in rows])
        check(pos.shape[0] == ref.shape[0],
              f"gloo {solver}: {pos.shape[0]} particles")
        err = float(np.abs(pos[np.argsort(oid)] - ref).max())
        tag = f"gloo {solver}"
        print(f"[shard] {tag}: trips {rows[0]['loops']} (gloo stages its "
              f"messages through host memory: no graph); held at rest "
              f"{rows[0]['held_at_rest']}; 4 ranks sharing one card, "
              f"host-staged: {[round(g['steps_per_sec'], 3) for g in rows]}"
              f" steps/s; peak {[round(g['peak_gib'], 3) for g in rows]} "
              f"GiB a rank; {rows[0]['reads_per_step']:.2f} host reads a "
              f"step besides the staged messages")
        check(rows[0]["held_at_rest"] == SHARD_GLOO_HELD,
              f"{tag}: held {rows[0]['held_at_rest']}")
        shard_agree(tag, rows[0]["diag"], rows[0]["dt"], diags, dts, err)
        for g in rows:
            check(g["loops"] == "eager", f"{tag}: loops {g['loops']}")
            check(g["overflow"] == 0, f"{tag}: overflow {g['overflow']}")
            check(g["count"] == ref.shape[0], f"{tag}: {g['count']} kept")
            check(g["diag"] == rows[0]["diag"], f"{tag}: ranks disagree")
            shard_counts(f"{tag} rank", g["counts"],
                         shard_launches(solver, g["diag"], unroll))
            g.pop("pos")
            g.pop("oid")
        runs["gloo"].append(rows)
    results["_runs"]["shard"] = runs
    shard_coupled(torch, results)


def shard_coupled(torch, results: dict) -> None:
    """The coupled sharded step: NCCL at one rank a card on the coupled
    cells of perf/shard_rates.py against the single-device frames in the
    rank's process, then gloo ranks sharing the card on the half-immersed
    torus against the single-device frames run here."""
    import numpy as np

    from cfd_taichi_tpu_torch import Simulation
    from cfd_taichi_tpu_torch.models import dfsph
    from cfd_taichi_tpu_torch.parallel import launch
    from cfd_taichi_tpu_torch.perf import shard_rates

    world = torch.cuda.device_count()
    t0 = time.perf_counter()
    nccl = launch.spawn(shard_rates.nccl_coupled_rank, world,
                        backend="nccl", device="cuda")
    print(f"[shard] coupled, NCCL, {world} rank(s), one a card: "
          f"{time.perf_counter() - t0:.1f} s")
    total: dict = {}
    for r in nccl:
        shard_rates.print_nccl_coupled(r)
        for tag, solver, frames in shard_rates.COUPLED_CELLS:
            c, name = r[tag], f"coupled {tag} nccl rank {r['rank']}"
            s = c["sharded"]
            check(c["loops"] == "graph", f"{name}: loops run {c['loops']}")
            check(s["overflow"] == 0, f"{name}: overflow {s['overflow']}")
            check(s["count"] == c["n_fluid"],
                  f"{name}: {s['count']} particles")
            want = rigid_launches(solver, s["diag"], c["unroll"])
            for kname, (launches, plain) in s["counts"].items():
                check(plain == 0, f"{name}: plain version of {kname} ran")
                if kname in RIGID_PATH:
                    check(launches == want.get(kname, 0),
                          f"{name}: {kname} launched {launches} times, not "
                          f"{want.get(kname, 0)}")
                elif kname in SOLVER_PATH[solver]:
                    check(launches > 0, f"{name}: {kname} never launched")
            if r["rank"] == 0:
                for kname, (launches, _) in s["counts"].items():
                    total[kname] = total.get(kname, 0) + launches
            if "single" not in c:
                continue
            g = c["single"]
            check(s["counts"] == g["counts"],
                  f"{name}: launches {s['counts']}, single-device "
                  f"{g['counts']}")
            if world == 1:      # bit for bit
                for key in ("dt", "diag", "fmax", "centroid", "vel",
                            "omega"):
                    check(s[key] == g[key], f"{name}: {key} {s[key]} "
                          f"against the single-device {g[key]}")
                check(c["max_pos_err"] == 0.0 and c["body_equal"],
                      f"{name}: positions {c['max_pos_err']}, body equal "
                      f"{c['body_equal']}")
            else:               # JAX's own bars (SHARD_JAX_BARS)
                check([d[0] for d in s["diag"]] == [d[0] for d in g["diag"]],
                      f"{name}: iterations {s['diag']}, single-device "
                      f"{g['diag']}")
                check(c["max_pos_err"] <= SHARD_JAX_BARS["pos"],
                      f"{name}: positions differ by {c['max_pos_err']}")
    results["shard_coupled_launches"] = total
    runs = {"nccl": nccl}

    t0 = time.perf_counter()
    gloo = launch.spawn(shard_rates.gloo_coupled_rank,
                        shard_rates.GLOO_WORLD, backend="gloo",
                        device="cuda")
    print(f"[shard] coupled, gloo, {shard_rates.GLOO_WORLD} ranks sharing "
          f"one card: {time.perf_counter() - t0:.1f} s")
    sim = Simulation(shard_rates.coupled_config("immersed"), device="cuda")
    unroll = dfsph.loop_unroll(sim.scene)
    want = []
    for _ in range(shard_rates.GLOO_COUPLED_FRAMES):
        sim.step()
        force = sim.state.rigid.force.cpu().numpy()
        sim.rigid_step()
        want.append(dict(dt=float(sim.state.dt),
                         diag=sim.state.diag.tolist(), force=force,
                         pos=oid_sorted(sim.state),
                         **{k: getattr(sim.state.rigid, k).cpu().numpy()
                            for k in SHARD_BODY_TOL}))
    del sim
    torch.cuda.empty_cache()
    tag = "coupled gloo immersed"
    g0 = gloo[0]
    print(f"[shard] {tag}: held at rest {g0['held_at_rest']} (cap "
          f"{g0['spec']['cap']}); "
          f"{[round(g['frames_per_sec'], 3) for g in gloo]} frames/s a "
          f"rank, host-staged; peak "
          f"{[round(g['peak_gib'], 3) for g in gloo]} GiB")
    scale = float(np.abs(np.stack([w["force"] for w in want])).max())
    check(scale > 0.0, f"{tag}: no reaction on the body")
    for k, (got, ref) in enumerate(zip(g0["frames"], want)):
        pos = np.concatenate([g["frames"][k]["pos"] for g in gloo])
        oid = np.concatenate([g["frames"][k]["oid"] for g in gloo])
        check(pos.shape == ref["pos"].shape,
              f"{tag}: {pos.shape[0]} particles")
        err = float(np.abs(pos[np.argsort(oid)] - ref["pos"]).max())
        ferr = float(np.abs(got["force"] - ref["force"]).max())
        berr = {b: float(np.abs(np.asarray(got[b]) - ref[b]).max())
                for b in SHARD_BODY_TOL}
        its, its_want = ((d[0], d[2]) for d in (got["diag"],
                                                 ref["diag"]))
        print(f"[shard] {tag} frame {k}: iterations {its} (single-device "
              f"{its_want}); max |pos - single| through oid {err:.3e}; dt "
              f"{got['dt']!r} ({ref['dt']!r}); force err {ferr:.3e} of "
              f"{scale:.6e}; body err {berr}")
        check(its[0] == its_want[0] and abs(its[1] - its_want[1]) <= 1,
              f"{tag} frame {k}: iterations {its}, not {its_want}")
        check(err <= SHARD_JAX_BARS["pos"], f"{tag} frame {k}: positions "
              f"differ by {err}")
        check(berr["centroid"] <= SHARD_JAX_BARS["centroid"],
              f"{tag} frame {k}: centroid differs by {berr['centroid']}")
        if k == 0:        # the first frame: the CPU test's bars
            check(its == its_want, f"{tag}: iteration counts {its}, not "
                  f"{its_want}")
            check(abs(got["dt"] - ref["dt"]) <= 1e-5 * abs(ref["dt"]),
                  f"{tag}: dt {got['dt']} against {ref['dt']}")
            check(err <= SHARD_POS_TOL, f"{tag}: positions differ by {err}")
            check(ferr <= SHARD_FORCE_TOL * float(np.abs(ref["force"])
                                                  .max()),
                  f"{tag}: force err {ferr}")
            for b, tol in SHARD_BODY_TOL.items():
                bar = max(tol, SHARD_BODY_RTOL[b]
                          * float(np.abs(ref[b]).max()))
                check(berr[b] <= bar, f"{tag}: body {b} differs by "
                      f"{berr[b]}")
    for g in gloo:
        rank = f"{tag} rank {g['rank']}"
        check(g["loops"] == "eager", f"{rank}: loops {g['loops']}")
        check(g["overflow"] == 0, f"{rank}: overflow {g['overflow']}")
        check(g["count"] == want[0]["pos"].shape[0],
              f"{rank}: {g['count']} kept")
        for a, b in zip(g["frames"], g0["frames"]):
            check(a["diag"] == b["diag"] and a["dt"] == b["dt"]
                  and np.array_equal(a["force"], b["force"])
                  and all(a[k] == b[k] for k in SHARD_BODY_TOL),
                  f"{rank}: the ranks disagree")
        diags = [f["diag"] for f in g["frames"]]
        shard_counts(rank, g["counts"],
                     {**shard_launches("dfsph", diags, unroll),
                      **rigid_launches("dfsph", diags, unroll)})
    for g in gloo:
        g.pop("frames")
    runs["gloo"] = gloo
    results["_runs"]["shard_coupled"] = runs


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
        phase_loops(torch, results)
        phase_main(torch, sims, results)
        phase_recompute(torch, sims, results)
        phase_scale(torch, sims, results)
        for solver in ("pcisph", "pbf"):
            phase_solver(torch, sims, results, solver)
        phase_scale_bf16(torch, sims, results)
        phase_wcsph(torch, results)
        phase_iisph(torch, results)
        phase_export(torch)
        phase_rigid(torch, results)
        sims.clear()
        torch.cuda.empty_cache()
        phase_shard(torch, results)
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
            library_ms_1m=row.pop("library_ms_1m", None),
            launches_shard=results["shard_launches"][k.name],
            launches_shard_coupled=results["shard_coupled_launches"][
                k.name])
        kernels.append({**head, **dict(sorted(row.items()))})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
