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
                sources, 1000 and 1003 rows), f32 and bf16. DFSPH's loop
                kernels, dfsph_kick and dfsph_rate (the contraction with
                the loops' algebra in its epilogue; the rate gathers the
                source record [v, x . v] that the kick writes, packed
                here by the plain version), run at 30k, 1M and
                on the clustered cloud, f32 and bf16, in the forms the
                density and divergence loops call them (f32 also with a
                rank's masks and a contact dot; perf/cases.dfsph_cases):
                each output to 1e-5 of its terms' magnitude against the
                plain version (perf/cases.fused_error: the rate's
                selection may differ only where its value sits that close
                to the average's threshold, the rows printed), and bit for
                bit against the parent's composition (the contraction's
                kernel, then the torch ops; the kick's record against the
                plain pack of its v_out) and over two launches; dfsph_pack
                (the record of a v that no kick wrote) bit for bit against
                its plain version at 30k and 1M and on the clustered
                cloud. coef_build
                (f32 and bf16, nbr exactly), viscosity, matvec, matvec_dot,
                wcsph_forces, fluid_terms (count exactly) and
                boundary_terms also run on a clustered cloud
                of 100k particles (perf/inputs.py: a blob of ~200 a cell,
                empty cells, pairs at exactly r = h on cell faces,
                particles clamped into edge cells; boundary_terms over its
                boundary cloud: a wall sheet on cell faces, a dense patch,
                boundary particles clamped into edge cells, none near
                most queries); wcsph_forces is timed there too.
                pcisph_predict_rho (the stencil form) and
                pcisph_predict_rho_list (the stream form, over the
                inputs' pair store), pbf_terms (PBF's constraint pass in
                one launch: the fluid walk, the walls' walk and the rows'
                constraint, lambda, gsum and ssum against the plain
                composition; the pair list its fluid walk stores against
                the plain version's exactly: each row's count and its
                sources in order), pbf_lambda and pbf_xsph (streams over
                that list, which perf/cases.py makes once) run at 30k, 1M
                and on the clustered cloud, with walls, their predicted or
                updated positions the inputs' shifted by ~0.3 r (pairs
                cross r = h both ways) and a random negative lambda; the
                predicted density's two forms' outputs are compared bit
                for bit (printed), and pbf_terms, pbf_lambda and pbf_xsph
                must repeat bit for bit over two launches; pbf_terms is
                also held to its plain version at a rest density of 800,
                with walls and without, where rows are constrained (at
                1000 the lattices' are not: their constraint and lambda
                are 0), and fails unless some are.
                Kernel and plain times: CUDA events, median of 10 after 3
                warm-up calls. The fluid-rigid kernels (rigid_terms,
                rigid_contact_dot, rigid_viscosity, rigid_side_force (the
                reaction's walk), rigid_side_rows (the reaction list's
                warp offsets, exactly), rigid_side_list (the reaction's
                list, each row's count and fluid indices exactly, its pair
                vectors to 1e-5 of scale; then its bases, counts and
                records bit for bit) and rigid_side_force_list (the
                list's stream of k and the scale m, as DFSPH's density
                loop calls it, timed beside torch.addmv and @ of the
                list's CSR matrix and u = k m, the library yardstick),
                and
                the predicted density with its walk over the body at the
                inputs' positions shifted by ~0.3 r, in its stream form
                named pcisph_predict_rho_rigid and in its stencil form
                under the key pcisph_predict_rho_body) run on a body in water
                (perf/inputs.body_inputs: the 30k and 1M blocks,
                jittered, with a builtin:cube1 body of ~3,200 and ~40k
                voxels at their centre, the fluid in its voxels taken out)
                and on the half-immersed torus scene (perf/inputs.
                torus_inputs), with random rigid and fluid
                velocities, densities and u, to 1e-5 of scale;
                rigid_side_force, rigid_side_list, rigid_side_force_list
                and pcisph_predict_rho_rigid must also repeat bit for bit
                over two launches, the stream must give the walk's bits on
                the same inputs (of u, and of k and m against the walk of
                u = k m; with a rank's mask, the stream of where(owned,
                k m, 0)), each form with its
                body gate must give the bits of the same launch ungated
                (every warp walking the body), and the body's walk is
                timed as the call less the call without the body, gated
                and ungated (events around 20 calls); so must
                rigid_terms, rigid_contact_dot and rigid_viscosity, which
                take the same gate (its queries inside printed; the
                reaction's walk runs a group of lanes a body particle and
                adds its terms in walk order), each timed gated and
                ungated in turns (events around 20 calls, and
                torch.profiler); the gate's kernel, body_box, must give
                its plain version's bits. Each
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
                5e-6 (WCSPH 6.0e-8, IISPH 1.2e-7, PCISPH 7.2e-7 and PBF
                PBF_AGREE, what the same kernels gave before), dt to rtol
                1e-5, equal iteration counts every
                step; the errors are printed. PBF again with one of its
                pair passes (pbf_terms, the constraint pass, pbf_lambda
                or pbf_xsph) at a time, then all but one, then all three,
                run by the plain version on the CPU on the card's inputs:
                the drift each leaves, printed (which kernel adds it).
                Then the coupled scene of
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
                diag bit for bit, dfsph_kick and dfsph_rate launched 1 +
                trips x U times a step each, dfsph_pack once a step, and
                the contraction alone never; prints host reads (trips),
                captures and their host ms a step. Every later phase
                counts a loop's launches as trips x U of its
                sub-iterations, masked ones included (`looped`), where it
                counts them.
6. main       - configs/breaking_dam_30k.json as DFSPH, 100 steps from rest
                through Simulation.step on the default engine (stored
                coefficients, f32). fluid_terms, boundary_terms, viscosity,
                coef_build, dfsph_kick, dfsph_rate and dfsph_pack must have
                launched (the kick and the rate 1 + trips x U times a step
                each, the pack once a step, and coef_matvec,
                coef_matvec_dot, matvec and matvec_dot never) and no
                plain version may have run; positions
                finite; the last step's density residual at most 1.0 (0.1%
                rho0, the loop's threshold); the last residuals and the mean
                density iterations a step, as printed, the ones the kernels
                gave before (DFSPH_30K).
7. recompute  - the same 30k run with the coef budget at 0: the recompute
                engine's matvec and matvec_dot must launch (coef_build,
                the contraction and dfsph_kick / dfsph_rate / dfsph_pack
                never),
                residual <= 1.0, diagnostics as in main (DFSPH_30K); then
                breaking_dam_1m
                for 15 steps on it.
8. scale      - configs/breaking_dam_1m.json as DFSPH on the default
                engine, steps 1-5 and 6-15: coef kernels launched (dfsph_kick
                and dfsph_rate as in main), finite, last density residual
                <= 1.0.
9. pcisph     - breaking_dam_30k as PCISPH, steps 1-100 from rest, and
                breaking_dam_1m as PCISPH, steps 6-15, on the scenes that
                main and scale built: fluid_terms, boundary_terms,
                viscosity, coef_build, coef_matvec and
                pcisph_predict_rho_list (the predicted density's stream
                form) launched and no plain version; finite; every
                particle inside the box +- 2r; the last residual <= 1.0
                unless the step hit 80 iterations; iterations a step
                printed. Then breaking_dam_30k as PCISPH on the recompute
                engine, steps 1-100: matvec and pcisph_predict_rho (the
                stencil form) launched instead, as often as the step
                calls them.
10. pbf       - the same runs as PBF: pbf_terms, pbf_lambda and pbf_xsph
                launched once a step each (pbf_terms: the constraint pass,
                walls included) and no plain version; one host
                read a step (the pair list's size), printed with the peak
                device memory; finite; inside the box +- 2r.
11. scale-bf16 - 1M and 30k with bf16 coefficient storage: iterations and
                residual printed, positions finite, dfsph_kick and
                dfsph_rate launched as in main.
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
                often as the solver's step calls them (rigid_launches:
                DFSPH's and PCISPH's reaction streams its list once a loop
                sub-iteration, the list's rows and the list built once a
                step; IISPH's and WCSPH's walks once a step) beside its
                own pair kernels, no
                plain version; one host read a step outside the loops'
                trips (the pair count, with the list's size) on DFSPH,
                PCISPH and IISPH, none on WCSPH, printed; before each
                DFSPH and PCISPH run, its first RIGID_WALK_FRAMES frames
                stepped twice, streaming the list and walking the reaction
                (`dfsph.walked_reaction`), bit for bit (fluid, body, dt,
                diag and the body's force), outside the timed frames; the
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
                run. Then PBF the same way (perf/shard_rates.
                nccl_pbf_rank, 5 steps): at world 1 the positions through
                oid and dt bit for bit, the launches equal. Then four gloo
                ranks sharing the card, their messages
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
# Kernels each run must launch (and no plain version may run). DFSPH's
# loops on the coef engine run the contraction with their algebra in its
# epilogue (dfsph_kick, dfsph_rate; dfsph_pack readies the density loop's
# first rate), IISPH's and PCISPH's the contraction alone.
COEF_PATH = ("fluid_terms", "boundary_terms", "viscosity", "coef_build",
             "dfsph_kick", "dfsph_rate", "dfsph_pack")
IISPH_COEF_PATH = COEF_PATH[:4] + ("coef_matvec", "coef_matvec_dot")
# The kernels that DFSPH's coef-engine loops do not launch
DFSPH_IDLE = ("coef_matvec", "coef_matvec_dot", "matvec", "matvec_dot")
RECOMPUTE_PATH = ("fluid_terms", "boundary_terms", "viscosity", "matvec",
                  "matvec_dot")
WCSPH_PATH = ("fluid_terms", "boundary_terms", "wcsph_forces")
PCISPH_PATH = IISPH_COEF_PATH[:5] + ("pcisph_predict_rho_list",)
PCISPH_RECOMPUTE_PATH = RECOMPUTE_PATH[:4] + ("pcisph_predict_rho",)
PBF_PATH = ("pbf_terms", "pbf_lambda", "pbf_xsph")
# The kernels that must repeat bit for bit over two launches in [kernels]
REPEATED = ("rigid_side_force", "rigid_side_list", "rigid_side_force_list",
            "pcisph_predict_rho_rigid", "pbf_terms", "pbf_lambda", "pbf_xsph")
# [agree]: (solver, whether to start from TINY's squeezed block, the
# largest card-vs-CPU position error allowed over its 6 steps: the bar
# 5e-6, or what the same kernels gave before, 5.960e-08 and 1.192e-07 on
# an H100 80GB HBM3 since the cubic kernels take q = r * f32(1/h), so
# that a kernel that moves it shows; PCISPH 7.153e-07 there since its
# predicted density streams the stored pair list (the card adds a row's
# terms in 4 strided partial sums, the CPU in pair order); PBF 1.788e-07
# there, all of it from pbf_terms' walk (its streams add their terms in
# pair order, as the CPU does: [agree]'s pbf_drift shows it))
PBF_AGREE = 1.8e-7
AGREE = (("dfsph", False, 5e-6), ("wcsph", True, 6.0e-8),
         ("iisph", True, 1.2e-7), ("pcisph", True, 7.2e-7),
         ("pbf", True, PBF_AGREE))
# [agree]: PBF's pair passes, each run by its plain version on the CPU in
# turn (then all three) to show which adds the card's drift
PBF_PASSES = ("pbf_terms", "pbf_lambda", "pbf_xsph")
# the wrapper (ops/stencil.py) through which the step launches each
PBF_WRAPPERS = {"pbf_terms": "pbf_constraint", "pbf_lambda": "pbf_lambda",
                "pbf_xsph": "pbf_xsph"}
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
              "rigid_side_force", "rigid_side_rows", "rigid_side_list",
              "rigid_side_force_list", "pcisph_predict_rho_rigid",
              "body_box")
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
# [rigid]: the frames of each DFSPH and PCISPH run held bit for bit to the
# same frames stepped with the reaction's walk
RIGID_WALK_FRAMES = 3
# [rigid]: the solver's own pair kernels, which each coupled run launches
SOLVER_PATH = {"dfsph": COEF_PATH, "pcisph": PCISPH_PATH,
               "iisph": IISPH_COEF_PATH, "wcsph": WCSPH_PATH}
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
        if not b.dtype.is_floating_point:
            bad = int((a != b).sum())
            print(f"    {name}[{i}] {b.dtype}: {bad} mismatches (want 0)")
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


def check_fused(case, torch) -> float:
    """dfsph_kick or dfsph_rate: against its plain version, each output to
    1e-5 of its terms' magnitude (perf/cases.fused_error; the rate's
    selection may differ only where the value sits that close to the
    average's threshold), and bit for bit against the parent's composition
    on the same inputs (the contraction's kernel and the torch ops) and
    over two launches; the rate also with its k written into a buffer
    given (`k_out`, as DFSPH's loops call it). Its max_abs_err against the
    plain version."""
    from cfd_taichi_tpu_torch.perf import cases

    got = case.kern()
    e = cases.fused_error(case.name, got, case.plain(), case.scales(), TOL)
    errs = "  ".join(f"{k[4:]} {v:.3e}" for k, v in e.items()
                     if k.startswith("err_"))
    parent = cases.bit_equal(got, case.parent())
    again = cases.bit_equal(got, case.kern())
    into = ""
    if case.name == "dfsph_rate":
        buf = torch.full_like(got.k, float("nan"))
        out = case.kern(k_out=buf)
        same = out.k is buf and cases.bit_equal(got, out)
        into = f", into a buffer {same}"
        check(same, f"{case.key}: its k written into k_out differs")
    n = case.kern.args[1].shape[0]
    print(f"    {case.key}: against plain {errs}; selection differs on "
          f"{e['flips']} of {n} rows (at the threshold); bit-equal to the "
          f"parent's composition {parent}, over two launches {again}{into}")
    check(e["ok"], f"{case.key}: against plain {e}")
    check(parent, f"{case.key}: not bit-equal to the parent's composition")
    check(again, f"{case.key}: two launches differ")
    return e["max_abs_err"]


def check_case(case, pos, torch) -> float:
    """Compare a case's kernel with its plain version; its max_abs_err."""
    from cfd_taichi_tpu_torch.perf import cases

    if case.name == "dfsph_pack":
        return check_pack(case.key, case, torch)
    if case.parent is not None:
        return check_fused(case, torch)
    if case.name == "coef_build":
        return check_build(case.key, case.kern(), case.plain())
    if case.name in ("coef_matvec", "coef_matvec_dot"):
        return compare_contraction(
            case.key, case.kern(lane_sums=True), case.plain(lane_sums=True),
            case.kern(), case.plain(), pos, case.name == "coef_matvec_dot",
            torch)
    return compare(case.key, *cases.compared(case), torch)


def check_pack(tag: str, case, torch) -> float:
    """dfsph_pack against its plain version bit for bit (one rounding an
    operation on both sides), and over two launches."""
    from cfd_taichi_tpu_torch.perf import cases

    got = case.kern()
    same = cases.bit_equal(got, case.plain())
    again = cases.bit_equal(got, case.kern())
    print(f"    {tag}: bit-equal to the plain version {same}, over two "
          f"launches {again}")
    check(same and again, f"{tag}: not bit-equal")
    return 0.0


def repeats(case, tag: str, torch) -> None:
    """The case's kernel gives the same bits over two launches."""
    from cfd_taichi_tpu_torch.perf import cases

    view = case.view or cases.tensors
    same = cases.same_bits(view(case.kern()), view(case.kern()))
    print(f"    {case.name} {tag}: two launches bit-equal {same}")
    check(same, f"{case.name} {tag}: launches differ")


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
    """coef_build (f32 and bf16), dfsph_kick and dfsph_rate (in f32 and
    bf16; also bit for bit against the parent's composition), viscosity,
    matvec, matvec_dot, wcsph_forces, fluid_terms, boundary_terms and the
    PCISPH and PBF kernels on the clustered cloud, kernel against plain:
    a blob of ~200 particles a cell, empty cells, pairs at exactly r = h
    on cell faces, particles clamped into edge cells; boundary_terms over the
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
    d = cases.dfsph_inputs(p, st, g, h, m, x["rho"], seed=13)
    for dtype, sfx in ((torch.float32, ""), (torch.bfloat16, "_bf16")):
        eng = coef.build_coef(p, st, g, h, m, off, dtype)
        print(f"[kernels] clustered cloud: DFSPH's loop kernels, {dtype} "
              f"storage")
        for case in cases.dfsph_cases(eng, p, x["v"], x["k"], d, sfx,
                                      cases.DFSPH_FORMS[sfx]):
            results.setdefault(case.name, {})[
                "max_abs_err_clustered" + case.key[len(case.name):]] = \
                check_fused(case, torch)
        del eng
    pack = cases.Case("dfsph_pack", "dfsph_pack",
                      functools.partial(coef.dfsph_pack, p, x["v"]),
                      functools.partial(coef.dfsph_pack_plain, p, x["v"]),
                      None)
    results.setdefault("dfsph_pack", {})["max_abs_err_clustered"] = \
        check_pack("dfsph_pack clustered", pack, torch)
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
            f"{case.name} clustered", *cases.compared(case), torch)
        if case.name in REPEATED:
            repeats(case, "clustered", torch)
        if case.name == "pbf_terms":
            _, pl = case.kern()
            print(f"    pbf_terms clustered: {int(pl.cnt.sum())} pairs "
                  f"stored in {pl.nbr.numel()} slots")
    pbf_constrained(torch, results, x, walls, "clustered")


def record(results: dict, case, key: str, err: float) -> None:
    """Time the case (perf/cases.py: kernel, bound, library call) and its
    plain version; store them under `key`."""
    from cfd_taichi_tpu_torch.perf import cases, timing

    row = cases.measure(case)
    row["plain_ms"], row["max_abs_err"] = timing.event_ms(case.plain), err
    results.setdefault(case.name, {}).update(
        {f"{k}_{key}": val for k, val in row.items()})
    lib = ""
    if case.library and row["library_ms"] is None:
        lib = "  torch.sparse not available"
    elif case.library:
        layout = row["library_layout"]
        lib = (f"  torch.sparse {row['library_ms']:.4f} ms ({layout}, "
               f"error {row[f'library_err_{layout}']:.3e}"
               + (f"; kernel lane sums {row['lane_sums_ms']:.4f} ms)"
                  if "lane_sums_ms" in row else ")"))
    print(f"  {case.name:15s} {key}: kernel {row['ms']:.4f} ms  plain "
          f"{row['plain_ms']:.4f} ms  max_abs_err {err:.3e}  bound "
          f"{row['bound_ms'] * 1e3:.2f} us ({row['bound_by']}), share "
          f"{row['share']:.3f}{lib}")


def phase_kernels(torch, results: dict) -> None:
    from cfd_taichi_tpu_torch.models import base
    from cfd_taichi_tpu_torch.perf import cases, inputs

    for tag, cfg_name in CONFIGS:
        x = inputs.lattice_inputs(cfg_name, seed=7)
        pairs = cases.fluid_pairs(x)
        print(f"[kernels] {cfg_name}: {x['sc'].n_fluid} fluid particles, "
              f"{pairs} pairs")
        outs = {}
        for case in cases.scene_cases(x, pairs):
            record(results, case, tag + case.key[len(case.name):],
                   check_case(case, x["p"], torch))
            if case.name.startswith("pcisph_predict_rho"):
                outs[case.name] = case.kern()
            if case.name in REPEATED:
                repeats(case, tag, torch)
        forms_bits(results, tag, outs, torch)
        pbf_constrained(torch, results, x, base.walls(x["sc"]), tag)
        del x
        torch.cuda.empty_cache()
    rigid_checks(torch, results)
    ragged_checks(torch)
    clustered_checks(torch, results)


def pbf_constrained(torch, results: dict, x: dict, walls, tag: str) -> None:
    """PBF's constraint pass (pbf_terms' one launch) on inputs `x` at a rest
    density of 800 (perf/cases.LOW_RHO0: the lattices' rows are all
    unconstrained at 1000, so that there the constraint and lambda are 0 in
    the kernel and the plain version alike), with `walls` and without,
    against the plain version: constraint, lambda, gsum and ssum to TOL of
    scale, the list (counts and sources) exactly; it fails unless some
    rows are constrained."""
    from cfd_taichi_tpu_torch.ops import stencil as S
    from cfd_taichi_tpu_torch.ops.neighbors import cell_id
    from cfd_taichi_tpu_torch.perf import cases

    g, h, m = (x["sc"].grid, x["sc"].h, x["sc"].particle_m) if "sc" in x \
        else (x["grid"], x["h"], x["m"])
    p, st = x["p"], x["st"]
    rows = S.pair_rows(st, g, cell_id(p, g))
    for label, wall in (("walls", walls), ("clamp", None)):
        args = cases.pbf_constraint_args(p, st, g, h, m, rows, wall,
                                         cases.LOW_RHO0)
        got = cases.pbf_terms_view(S.pbf_constraint(*args))
        key = f"pbf_terms {tag} {label} rho0 800"
        n_con = int((got[1] != 0).sum())
        print(f"    {key}: {n_con} of {got[1].numel()} rows constrained")
        check(n_con > 0, f"{key}: no row constrained")
        err = compare(key, got, cases.pbf_terms_view(
            S.pbf_constraint_plain(*args)), torch)
        results["pbf_terms"][f"rho800_{label}_{tag}"] = dict(
            max_abs_err=err, constrained=n_con)


def forms_bits(results: dict, tag: str, outs: dict, torch) -> None:
    """How the predicted density's stream form differs from its stencil
    form on the same inputs: the elements that differ and the largest
    difference (a group of lanes a row sums in another order)."""
    a, b = outs["pcisph_predict_rho_list"], outs["pcisph_predict_rho"]
    row = dict(differ=int((a != b).sum()),
               max_abs=float((a - b).abs().max()))
    results["pcisph_predict_rho_list"][f"against_stencil_{tag}"] = row
    print(f"  pcisph_predict_rho_list {tag}: against the stencil form "
          f"{row['differ']} of {a.numel()} elements differ, largest "
          f"{row['max_abs']:.3e}")


def rigid_checks(torch, results: dict) -> None:
    """The fluid-rigid kernels against their plain versions on a body in
    water at 30k and 1M and on the half-immersed torus scene, timed;
    rigid_side_force, its list, the list's stream and the stream form
    with the body's walk repeat bit for bit; the list is its plain
    version's bit for bit and its stream gives the walk's bits
    (`stream_bits`); the body gate of the predicted density (`body_gate`)
    and of the contact dot and the solid viscosity (`rigid_gate`); the
    gate's kernel at the edge sizes (`box_edges`)."""
    from cfd_taichi_tpu_torch.ops import stencil as S
    from cfd_taichi_tpu_torch.perf import bounds, cases, inputs

    build = S.body_walk_build()
    results.setdefault("pcisph_predict_rho_rigid", {})["body_walk_build"] = \
        build
    print(f"[kernels] the predicted density's body walk: the queued walk, "
          f"one thread a row, {build['chunk']} candidates between votes; "
          + "; ".join(
              f"{form} {b['registers']} registers, {b['local_bytes']} B "
              f"local (spills), {b['shared_bytes']} B shared, "
              f"{b['blocks_per_sm']} blocks an SM"
              for form, b in build.items() if isinstance(b, dict)))
    box_edges(torch, results)
    for tag, make in (
            ("30k", lambda: inputs.body_inputs("breaking_dam_30k.json", 3)),
            ("1m", lambda: inputs.body_inputs("breaking_dam_1m.json", 3)),
            ("torus", lambda: inputs.torus_inputs(3))):
        x = make()
        work = bounds.rigid_work(x)
        print(f"[kernels] body in water, {tag}: {x['p'].shape[0]} fluid "
              f"particles, {x['rpos'].shape[0]} rigid particles")
        for case in cases.rigid_cases(x, work):
            record(results, case, tag + case.key[len(case.name):],
                   compare(f"{case.key} {tag}", *cases.compared(case),
                           torch))
            if case.name in REPEATED:
                repeats(case, tag, torch)
        stream_bits(torch, results, x, tag)
        body_gate(torch, results, x, tag)
        rigid_gate(torch, results, x, tag)
        del x
        torch.cuda.empty_cache()


def stream_bits(torch, results: dict, x: dict, tag: str) -> None:
    """The reaction list that the list's kernel built on coupled inputs
    `x` against its plain version's, bit for bit (each row's base, count
    and records); its stream against the walk on the same inputs, bit for
    bit: of x["u"], and of x["k"] and the scale m against the walk of
    u = k m; with a rank's mask (half the rows, numpy-seeded) against the
    stream of where(owned, k m, 0)."""
    import numpy as np

    from cfd_taichi_tpu_torch.ops import rigid as R
    from cfd_taichi_tpu_torch.ops.smoothing import f32
    from cfd_taichi_tpu_torch.perf import cases

    build, side = cases.side_list(x)
    plain = R.rigid_side_list_plain(*build)
    same = torch.equal(side.base, plain.base) and all(
        torch.equal(a.view(torch.int32), b.view(torch.int32)) for a, b in
        zip(cases.side_list_view(side), cases.side_list_view(plain)))
    results["rigid_side_list"][f"bits_{tag}"] = same
    print(f"  rigid_side_list {tag}: bases, counts and records bit-equal "
          f"to the plain list {same}")
    check(same, f"rigid_side_list {tag}: not the plain list's bits")

    def walk(u):
        return R.rigid_side_force(x["rpos"], x["rvol"], x["p"], x["st"],
                                  x["grid"], x["h"], cases.RHO0, u,
                                  x["force"])

    m = x["m"]
    km = x["k"] * f32(m)
    owned = torch.from_numpy(np.random.default_rng(5).uniform(
        size=km.shape[0]) < 0.5).to(km.device)
    for form, got, want in (
            ("u", R.rigid_side_force_list(side, x["u"], x["force"]),
             walk(x["u"])),
            ("k_m", R.rigid_side_force_list(side, x["k"], x["force"], m),
             walk(km)),
            ("owned", R.rigid_side_force_list(side, x["k"], x["force"], m,
                                              owned),
             R.rigid_side_force_list(
                 side, torch.where(owned, km, torch.zeros_like(km)),
                 x["force"]))):
        differ = int((got.view(torch.int32) != want.view(torch.int32)).sum())
        results["rigid_side_force_list"][f"against_walk_{form}_{tag}"] = \
            differ
        print(f"  rigid_side_force_list {tag}, {form}: against "
              f"{'the walk' if form != 'owned' else 'where(owned, k m, 0)'} "
              f"{differ} of {got.numel()} elements differ")
        check(differ == 0, f"rigid_side_force_list {tag} {form}: not the "
              "walk's bits")
    print(f"  rigid_side_force_list {tag}: {int(side.cnt.sum())} pairs in "
          f"{side.rec.shape[0]} slots ({side.rec.numel() * 4 / 2**20:.3f} "
          f"MiB)")


# body_box's edge sizes (perf/coef_compare.BOX_EDGES: one particle, less
# than a warp, a block's threads, its two passes less and more one, the
# most it takes alone and one more, the first a cluster folds, and the 1M
# block's body)
BOX_EDGES = (1, 31, 1024, 8191, 8193, 16_384, 16_385, 39_146)


def box_edges(torch, results: dict) -> None:
    """body_box on numpy-seeded clouds of BOX_EDGES particles (coordinates
    uniform in [-3, 5) m), each box bit for bit with its plain version's;
    the blocks that fold each printed."""
    import numpy as np

    from cfd_taichi_tpu_torch.ops import stencil as S

    rng = np.random.default_rng(13)
    for nr in BOX_EDGES:
        bpos = torch.from_numpy(rng.uniform(-3.0, 5.0, size=(nr, 3)).astype(
            np.float32)).cuda()
        same = torch.equal(S.make_body_box(bpos, 0.1),
                           S.make_body_box_plain(bpos, 0.1))
        blocks = S.body_box_blocks(nr)
        row = results.setdefault("body_box", {})
        row[f"edge_bits_{nr}"], row[f"fold_blocks_{nr}"] = same, blocks
        fold = "one block" if blocks == 1 else f"a cluster of {blocks} blocks"
        print(f"  body_box, {nr} particles: {fold}; bit-equal to its plain "
              f"version {same}")
        check(same, f"body_box at {nr} particles: not its plain version's "
              "bits")


def body_gate(torch, results: dict, x: dict, tag: str) -> None:
    """The predicted density's body gate on coupled inputs `x`: each form
    with the gate (the box made once, as a step makes it) against the same
    launch ungated, bit for bit; then the body's walk timed as the call
    less the call without the body, gated and ungated, in turns (CUDA
    events around 20 back-to-back calls, over the count: the device time
    where it outlasts a call's host work, as at 1M)."""
    from cfd_taichi_tpu_torch.models import base
    from cfd_taichi_tpu_torch.ops import stencil as S
    from cfd_taichi_tpu_torch.perf import cases, timing

    card = timing.card()
    args = (x["p"], x["st"], x["grid"], x["h"], x["m"], x["shifted"],
            base.walls(x["sc"]), cases.RHO0)
    eng = cases.pair_store(x["p"], x["st"], x["grid"], x["h"], x["m"])
    box = S.make_body_box(x["table"].pos, x["h"])
    inside = int(S.in_body_box(x["p"], box).sum())
    print(f"  body gate {tag}: {inside} of {x['p'].shape[0]} queries inside")
    for form, store in (("pcisph_predict_rho_rigid", eng),
                        ("pcisph_predict_rho", None)):
        def call(b, body=x["table"], store=store):
            return S.pcisph_predict_rho(*args, body, store, b)
        open_box = cases.ungated_box(box.device)
        same = torch.equal(call(box), call(open_box))
        print(f"    {form} {tag}: gated bit-equal to ungated {same}")
        check(same, f"{form} {tag}: the body gate changed the output")
        calls = (lambda: call(box), lambda: call(open_box),
                 lambda: call(None, None))
        # in turns: gated, ungated, without, without, ungated, gated
        ms = [timing.batch_ms(calls[i]) for i in (0, 1, 2, 2, 1, 0)]
        gated, ungated, none = ((ms[i] + ms[5 - i]) / 2 for i in range(3))
        row = results[form]
        row.update({f"ms_with_body_{tag}": gated,
                    f"ms_with_body_ungated_{tag}": ungated,
                    f"ms_without_body_{tag}": none,
                    f"ms_body_walk_{tag}": gated - none,
                    f"ms_body_walk_ungated_{tag}": ungated - none,
                    f"gate_inside_{tag}": inside})
        print(f"  {form} {tag}: with the body {gated:.4f} ms (ungated "
              f"{ungated:.4f}), without {none:.4f} ms (in turns "
              f"{[round(t, 4) for t in ms]}), so the body's walk "
              f"{gated - none:.4f} ms (ungated {ungated - none:.4f}); "
              f"{card}")


def rigid_gate(torch, results: dict, x: dict, tag: str) -> None:
    """The body gate of the solid sums, the contact dot and the solid
    viscosity on coupled inputs `x`: each with the gate made once, as a
    step makes it, against
    the same launch ungated, bit for bit; then both timed in turns (gated,
    ungated, ungated, gated: CUDA events around 20 back-to-back calls, over
    the count) and by torch.profiler's device time a launch; and the gate
    (body_box) against its plain version bit for bit, the plain version's
    kernels timed by torch.profiler."""
    from cfd_taichi_tpu_torch.ops import stencil as S
    from cfd_taichi_tpu_torch.perf import cases, timing

    box = cases.gate_box(x)
    open_box = cases.ungated_box(box.device)
    inside = int(S.in_body_box(x["p"], box).sum())
    same = torch.equal(box, S.make_body_box_plain(x["table"].pos, x["h"]))
    found, _ = timing.profile_kernels(lambda: [
        S.make_body_box_plain(x["table"].pos, x["h"]) for _ in range(20)])
    plain_us = sum(t for _, t in found.values()) / 20
    print(f"  body gate {tag}: {inside} of {x['p'].shape[0]} queries "
          f"inside; body_box bit-equal to its plain version {same}; the "
          f"plain version's {sum(c for c, _ in found.values()) / 20:.0f} "
          f"kernels {plain_us:.2f} device us a call")
    check(same, f"body_box {tag}: not its plain version's bits")
    results["body_box"][f"plain_device_us_{tag}"] = plain_us
    for name, (call, _) in cases.gated_calls(x).items():
        same = cases.same_bits(call(box), call(open_box))
        print(f"    {name} {tag}: gated bit-equal to ungated {same}")
        check(same, f"{name} {tag}: the body gate changed the output")
        ms = [timing.batch_ms(lambda b=b: call(b))
              for b in (box, open_box, open_box, box)]
        us = [timing.kernel_device_us(lambda b=b: call(b), name)
              for b in (box, open_box)]
        row = results[name]
        row.update({f"ms_gated_{tag}": (ms[0] + ms[3]) / 2,
                    f"ms_ungated_{tag}": (ms[1] + ms[2]) / 2,
                    f"device_us_gated_{tag}": us[0],
                    f"device_us_ungated_{tag}": us[1],
                    f"gate_inside_{tag}": inside})
        print(f"  {name} {tag}: gated {(ms[0] + ms[3]) / 2:.4f} ms, "
              f"ungated {(ms[1] + ms[2]) / 2:.4f} ms (in turns "
              f"{[round(t, 4) for t in ms]}); device {us[0]:.2f} us "
              f"gated, {us[1]:.2f} ungated; {inside} queries inside")


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
    pbf_drift(torch)
    agree_coupled(torch)


def on_cpu(fn, torch):
    """`fn` run on CPU copies of its arguments (tensors, and the tuples
    that hold them), its outputs brought back to the arguments' card:
    a wrapper so called runs its plain version."""
    def move(x, dev):
        if isinstance(x, torch.Tensor):
            return x.to(dev)
        if isinstance(x, tuple):
            items = [move(v, dev) for v in x]
            return type(x)(*items) if hasattr(x, "_fields") else tuple(items)
        return x

    def call(*args):
        dev = next(a.device for a in args if isinstance(a, torch.Tensor))
        return move(fn(*move(args, "cpu")), dev)
    return call


def pbf_drift(torch) -> None:
    """PBF from TINY's squeezed block, 6 steps on the card against the CPU,
    with one pair pass at a time (PBF_PASSES) run by its plain version on
    the CPU on the card's inputs, then all but one, then all three: the
    largest position difference each step, printed. A pass whose swap
    takes the drift away, or which alone on the card brings it back, is
    one that adds it."""
    import numpy as np

    from cfd_taichi_tpu_torch import Simulation
    from cfd_taichi_tpu_torch.config import parse_config
    from cfd_taichi_tpu_torch.ops import stencil
    from cfd_taichi_tpu_torch.perf import inputs

    raw = copy.deepcopy(TINY)
    raw["solver"]["name"] = "pbf"
    wrappers = {name: getattr(stencil, name)
                for name in PBF_WRAPPERS.values()}
    swaps = ([(name,) for name in PBF_PASSES]
             + [tuple(p for p in PBF_PASSES if p != name)
                for name in PBF_PASSES] + [PBF_PASSES])
    for swap in swaps:
        names = [PBF_WRAPPERS[name] for name in swap]
        try:
            for name in names:
                setattr(stencil, name, on_cpu(wrappers[name], torch))
            sims = {dev: Simulation(parse_config(raw), device=dev)
                    for dev in ("cuda", "cpu")}
            for sim in sims.values():
                sim.state = inputs.squeezed(sim.state)
            errs = []
            for _ in range(6):
                for sim in sims.values():
                    sim.step()
                a, b = (sims[d].state for d in ("cuda", "cpu"))
                errs.append(float(np.abs(oid_sorted(a)
                                         - oid_sorted(b)).max()))
        finally:
            for name in names:
                setattr(stencil, name, wrappers[name])
        kept = [p for p in PBF_PASSES if p not in swap]
        print(f"[agree] pbf with {' + '.join(swap)} run by the plain "
              f"version on the CPU ({' + '.join(kept) or 'none'} on the "
              f"card): pos err by step {' '.join(f'{e:.3e}' for e in errs)}")


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
    dfsph_kick and dfsph_rate each launched 1 + trips x U times a step
    (the warm start or the first rate, and each loop sub-iteration, masked
    ones included), dfsph_pack once a step, coef_matvec and
    coef_matvec_dot never. Prints the
    captures, their host ms and the host reads (trips) a step."""
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
        got = {name: stencil.KERNELS[name].launches
               for name in ("dfsph_kick", "dfsph_rate", "dfsph_pack",
                            "coef_matvec", "coef_matvec_dot")}
        print(f"[loops] DFSPH 30k {tag}: {LOOP_STEPS / wall:.2f} steps/s; a "
              f"step {graphs.trips / LOOP_STEPS:.2f} host reads (trips), "
              f"{graphs.captures / LOOP_STEPS:.2f} captures, "
              f"{graphs.capture_s * 1e3 / LOOP_STEPS:.3f} ms capturing "
              f"({graphs.instantiate_s * 1e3 / LOOP_STEPS:.3f} ms in "
              f"capture_end); launches {got} (want {want} of dfsph_kick "
              f"and dfsph_rate, {LOOP_STEPS} of dfsph_pack, 0 of the "
              f"contraction alone)")
        check(got == dict(dfsph_kick=want, dfsph_rate=want,
                          dfsph_pack=LOOP_STEPS, coef_matvec=0,
                          coef_matvec_dot=0),
              f"loops: {tag}: launches {got}, want {want} of dfsph_kick and "
              f"dfsph_rate")
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
    reads = (graphs.trips + graphs.reads) / done
    print(f"[{tag}] {iter_summary(sim.cfg.solver.name, diags)}; "
          f"{unroll} iteration(s) a trip, {reads:.2f} host reads a step "
          f"({graphs.trips / done:.2f} trips, {graphs.reads / done:.2f} "
          f"outside them), {graphs.captures / done:.2f} captures "
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
    return dict(steps=done, steps_per_sec=rates, last_diag=diags[-1],
                max_diag=[max(col) for col in zip(*diags)],
                mean_diag=[statistics.mean(col) for col in zip(*diags)],
                total_diag=[sum(col) for col in zip(*diags)],
                peak_gib=peak, peak_reserved_gib=reserved, unroll=unroll,
                # trips x U of the loops in diag columns 0 and 2
                looped=[looped(diags, (c,), unroll) for c in (0, 2)],
                trips_per_step=graphs.trips / done,
                reads_per_step=reads,
                captures_per_step=graphs.captures / done,
                capture_ms_per_step=graphs.capture_s * 1e3 / done,
                launches={k: c[0] for k, c in counts.items()})


def check_dfsph_30k(tag: str, run: dict) -> None:
    """The 30k run's diagnostics repeat DFSPH_30K[tag] digit for digit."""
    last, mean = run["last_diag"], run["mean_diag"]
    got = (f"{last[1]:.2f}", f"{mean[2]:.2f}", f"{last[3]:.4f}")
    check(got == DFSPH_30K[tag],
          f"{tag}: 30k diagnostics {got}, not {DFSPH_30K[tag]}")


def dfsph_launches(tag: str, run: dict) -> None:
    """A DFSPH run on the coef engine launched dfsph_kick and dfsph_rate
    1 + trips x U times a step each (the warm start or the first rate, and
    every loop sub-iteration, masked ones included), dfsph_pack once a
    step, and neither the contraction alone nor the recompute kernels."""
    want = dict.fromkeys(("dfsph_kick", "dfsph_rate"),
                         run["steps"] + sum(run["looped"]))
    want["dfsph_pack"] = run["steps"]
    want.update(dict.fromkeys(DFSPH_IDLE, 0))
    got = {name: run["launches"][name] for name in want}
    check(got == want, f"{tag}: launches {got}, want {want}")


def phase_main(torch, sims: dict, results: dict) -> None:
    from cfd_taichi_tpu_torch import Simulation
    from cfd_taichi_tpu_torch.perf import inputs

    sim = sims["30k"] = Simulation(
        inputs.solver_config("breaking_dam_30k.json"), device="cuda")
    run = drive(sim, "main", [100], COEF_PATH, torch)
    dfsph_launches("main", run)
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
        for name in ("coef_build", "coef_matvec", "coef_matvec_dot",
                     "dfsph_kick", "dfsph_rate", "dfsph_pack"):
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
    dfsph_launches("scale", run)
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
            want.update(coef_matvec=loop,
                        pcisph_predict_rho_list=loop + steps)
            check(diag[1] <= 1.0 or diag[0] == pcisph.MAX_ITER,
                  f"{solver} {tag}: residual {diag[1]} after {diag[0]} "
                  f"iterations")
        else:
            # the size of the pair list, read after the sort
            check(run["reads_per_step"] == 1.0,
                  f"{solver} {tag}: {run['reads_per_step']} reads a step")
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
    if solver == "pcisph":
        pcisph_recompute(torch, sims, results)


def pcisph_recompute(torch, sims: dict, results: dict) -> None:
    """breaking_dam_30k as PCISPH on the recompute engine, steps 1-100:
    matvec and the predicted density's stencil form launched as often as
    the step calls them, no coef kernel and no plain version."""
    from cfd_taichi_tpu_torch.perf.inputs import engine

    with engine(budget=0):
        run = drive(with_solver(sims["30k"], "pcisph"), "pcisph-recompute",
                    [100], PCISPH_RECOMPUTE_PATH, torch)
    loop, steps = run["looped"][0], 100
    want = dict.fromkeys(PCISPH_RECOMPUTE_PATH, steps)
    want.update(matvec=loop, pcisph_predict_rho=loop + steps)
    for name, launches in run["launches"].items():
        check(launches == want.get(name, 0),
              f"pcisph-recompute 30k: {name} launched {launches} times, "
              f"not {want.get(name, 0)}")
    results["pcisph_predict_rho"]["launches"] = \
        run["launches"]["pcisph_predict_rho"]
    results["_runs"]["30k_pcisph_recompute"] = run


def phase_scale_bf16(torch, sims: dict, results: dict) -> None:
    from cfd_taichi_tpu_torch.perf.inputs import engine

    with engine(dtype=torch.bfloat16):
        results["_runs"]["1m_coef_bf16"] = drive(
            one_million(torch, sims), "scale-bf16", [5, 10], COEF_PATH, torch)
        dfsph_launches("scale-bf16 1m", results["_runs"]["1m_coef_bf16"])
        # Free the 1M state, so that the 30k run's peak memory is its own.
        del sims["1m"]
        torch.cuda.empty_cache()
        results["_runs"]["30k_coef_bf16"] = drive(
            sims["30k"], "scale-bf16", [100], COEF_PATH, torch)
        dfsph_launches("scale-bf16 30k", results["_runs"]["30k_coef_bf16"])


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
    the sums, the body's gate and the solid viscosity once a step; the
    reaction list's rows
    and the list once a step and its stream once a density sub-iteration
    (DFSPH) or once a
    loop sub-iteration (PCISPH), or its walk once a step (IISPH, WCSPH);
    the contact dot once in each DFSPH loop and once an IISPH step;
    PCISPH's walk over the body once a predict, a sub-iteration and once
    before its loop. A loop's sub-iterations, the masked ones included,
    are its trips x U."""
    steps = len(diags)
    loop = looped(diags, (2,) if solver == "dfsph" else (0,), unroll)
    want = dict(rigid_terms=steps, rigid_viscosity=steps, body_box=steps)
    if solver in ("dfsph", "pcisph"):
        want.update(rigid_side_rows=steps, rigid_side_list=steps,
                    rigid_side_force_list=loop)
    if solver == "dfsph":
        want.update(rigid_contact_dot=2 * steps)
    elif solver == "pcisph":
        want.update(pcisph_predict_rho_rigid=loop + steps)
    elif solver == "iisph":
        want.update(rigid_contact_dot=steps, rigid_side_force=steps)
    else:
        want.update(rigid_side_force=steps)
    return want


def walk_frames(sim, frames: int, tag: str, torch) -> None:
    """`frames` frames of `sim` from its state, stepped twice: streaming the
    reaction's list, and within `dfsph.walked_reaction` walking it; every
    tensor of the fluid and the body, dt, diag and the body's force after
    each fluid step bit for bit. `sim` is put back to its state."""
    import contextlib

    from cfd_taichi_tpu_torch.models import dfsph

    start, runs = sim.state, []
    for walk in (False, True):
        sim.state, out = start, []
        for _ in range(frames):
            with (dfsph.walked_reaction() if walk
                  else contextlib.nullcontext()):
                sim.state = sim.solver.step(sim.scene, sim.state)
            force = sim.state.rigid.force
            sim.rigid_step()
            out.append((sim.state, force))
        runs.append(out)
    sim.state = start
    for k, ((a, fa), (b, fb)) in enumerate(zip(*runs)):
        pairs = [*zip(a.fluid, b.fluid), *zip(a.rigid, b.rigid),
                 (a.dt, b.dt), (a.diag, b.diag), (fa, fb)]
        check(all(torch.equal(x, y) for x, y in pairs),
              f"rigid {tag} frame {k}: the stream's frame is not the "
              f"walk's, bit for bit")
    print(f"[rigid] {tag}: frames 1-{frames} bit for bit with the "
          f"reaction's walk (dfsph.walked_reaction)")


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

        if solver in ("dfsph", "pcisph"):
            walk_frames(sim, RIGID_WALK_FRAMES, tag, torch)
        sim.rigid_step = sampled_rigid_step
        graphs = sim.scene.loop_graphs
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        stencil.reset_counts()
        graphs.reset()
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
        reads = graphs.reads / steps
        print(f"[rigid] {tag}: host reads a step {reads:.2f} outside the "
              f"loops' trips (the pair count and the reaction list's size "
              f"in one), {graphs.trips / steps:.2f} trips")
        check(reads == (0.0 if solver == "wcsph" else 1.0),
              f"rigid {tag}: {reads} host reads a step outside the trips")
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
        results["_runs"][f"rigid_{tag}"] = dict(
            steps_per_sec=steps / wall, peak_gib=peak,
            mean_diag=[statistics.mean(c) for c in zip(*diags)],
            last_diag=last, max_force=max(forces), reads_per_step=reads,
            launches={k: c[0] for k, c in counts.items()})
        sims[tag] = sim
    # The solid kernels' launches: over all the runs, each kernel's
    # solvers among them.
    for name in RIGID_PATH:
        results[name]["launches"] = sum(
            results["_runs"][f"rigid_{tag}"]["launches"][name]
            for tag, _, _ in RIGID_RUNS)
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
            ("coef", {}, IISPH_COEF_PATH,
             ("matvec", "matvec_dot", "dfsph_kick", "dfsph_rate",
              "dfsph_pack")),
            ("recompute", {"budget": 0}, RECOMPUTE_PATH,
             ("coef_build", "coef_matvec", "coef_matvec_dot", "dfsph_kick",
              "dfsph_rate", "dfsph_pack"))):
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
        if engine == "coef":
            # DFSPH's loops take the contraction's kernels no more: their
            # launches are IISPH's (PCISPH's are printed in [pcisph])
            for name in path[-2:]:
                results[name]["launches"] = run["launches"][name]


# ---------------------------------------------------------------------------
# [shard]
# ---------------------------------------------------------------------------

def shard_launches(solver: str, diags, unroll: int) -> dict:
    """The launches of a fluid-only run of `solver` (DFSPH on the stored-
    coefficient engine, or WCSPH) over the steps with these diags, at
    `unroll` loop iterations a trip, by kernel: each one-shot pass once a
    step; dfsph_kick and dfsph_rate once a step (the warm start, the
    first density rate) and once a loop sub-iteration, the masked ones
    included; dfsph_pack once a step."""
    steps = len(diags)
    if solver == "wcsph":
        return dict.fromkeys(WCSPH_PATH, steps)
    loop = steps + looped(diags, (0, 2), unroll)
    return dict(fluid_terms=steps, boundary_terms=steps, viscosity=steps,
                coef_build=steps, dfsph_kick=loop, dfsph_rate=loop,
                dfsph_pack=steps)


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
    shard_pbf(world)
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


def shard_pbf(world: int) -> None:
    """PBF on breaking_dam_1m sharded over NCCL, one rank a card, against
    the single-device steps: at world 1 bit for bit (positions through
    oid, dt) with equal launches; else within SHARD_POS_TOL."""
    from cfd_taichi_tpu_torch.parallel import launch
    from cfd_taichi_tpu_torch.perf import shard_rates

    t0 = time.perf_counter()
    ranks = launch.spawn(shard_rates.nccl_pbf_rank, world, backend="nccl",
                         device="cuda")
    r = ranks[0]
    tag = f"nccl pbf rank 0/{world}"
    print(f"[shard] {tag}: {time.perf_counter() - t0:.1f} s; max |pos - "
          f"single| through oid {r['max_pos_err']:.3e}; dt {r['dt']} "
          f"(single-device {r['single']['dt']}); {r['reads_per_step']:.2f} "
          f"host reads a step (single-device "
          f"{r['single']['reads_per_step']:.2f})")
    for rank in ranks:
        check(rank["overflow"] == 0, f"{tag}: overflow {rank['overflow']}")
        shard_counts(f"nccl pbf rank {rank['rank']}", rank["counts"],
                     dict.fromkeys(PBF_PATH, shard_rates.STEPS))
    if world == 1:
        check(r["max_pos_err"] == 0.0 and r["dt"] == r["single"]["dt"],
              f"{tag}: not the single-device step bit for bit")
        check(r["counts"] == r["single"]["counts"], f"{tag}: launches")
    else:
        check(r["max_pos_err"] <= SHARD_POS_TOL, f"{tag}: positions")


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
