"""The kernel table of PERF.md and the step rates of the ported solvers on
their loop engines, measured on one card:

    python -m cfd_taichi_tpu_torch.perf.kernel_table [--out PATH]
        [--profiles SOLVER/TAG/ENGINE ...]

1. For every hand-written kernel, on the jittered seed lattices of
   breaking_dam_30k and breaking_dam_1m (perf/inputs.py, seed 7): the
   measurement chip_smoke.py makes too (perf/cases.py: CUDA-event time,
   bound, share; for coef_matvec and coef_matvec_dot, f32 and bf16
   storage, the kernel's `lane_sums=True` call beside the one PyTorch
   call that computes the same sums, `torch.sparse_csr_tensor(offsets,
   nbr, w, (N, N)) @ lanes` with (N, 4) lanes made before timing,
   row-major and column-major), and what chip_smoke does not take: the
   device time per launch (torch.profiler, 20 launches) of the kernel and
   of each kernel the library call runs.
2. First of all (a process that has run the profiler steps slower on the
   host clock), after the kernel build and three untimed steps, each
   solver from rest: breaking_dam_1m steps 6-15 and breaking_dam_30k steps
   1-100, host clock around work that ends in a synchronize, with kernel
   launches per step. DFSPH on the coef f32, recompute and coef bf16
   engines in the order coef, recompute, recompute, coef (bf16 once);
   WCSPH and PBF, which have no loop engine; IISPH at 30k and PCISPH at
   30k and 1M on the coef f32 and recompute engines in the same
   alternation. Last, 3 profiled steps of each run in `PROFILES` (PCISPH
   and PBF at 1M among them) for device time by kernel, every kernel by
   name, the device ms and kernels a step split into the hand-written
   kernels and the rest (PyTorch's own: the loops' algebra, sort, scans,
   copies), and the busy share (device time over wall time); for WCSPH
   also the record build of wcsph_forces on the step's state (CUDA
   events, 20 calls). `--profiles` runs only these profiles, of the runs
   it names (e.g. dfsph/1m/coef_f32; dfsph/body_1m/coef_f32 profiles the
   frames, a fluid step and a rigid step, of breaking_dam_1m's block with
   a body at its centre, perf/inputs.body_scene, steps 6-8).
3. The coupled DFSPH step (a fluid step and a rigid step) on
   configs/torus_flush.json as written and on a body in water
   (perf/inputs.body_scene: breaking_dam_30k's block with a ~3,200-voxel
   box at its centre), steps 1-100 from rest on the coef f32 engine: the
   rate with the other rates, then 3 profiled steps (steps 101-103) with
   the other profiles. The fluid-rigid kernels' rows of step 1 (PCISPH's
   predicted density with its walk over the body among them) run on
   perf/inputs.body_inputs at 30k and 1M.

Prints one line per number and writes them all as JSON (--out).
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import torch

from cfd_taichi_tpu_torch.ops import _build
from cfd_taichi_tpu_torch.ops import stencil as S
from cfd_taichi_tpu_torch.perf import bounds, cases, inputs, timing

CONFIGS = (("30k", "breaking_dam_30k.json"), ("1m", "breaking_dam_1m.json"))


def kernel_rows(res: dict, tag: str, cfg_name: str) -> None:
    """perf/cases.py's measurement of every case of the config's lattice,
    plus device times: the kernel's (and, for the contraction, its lane-sum
    call's) and, where a case has a library yardstick (the contraction,
    the body's reaction stream), each library kernel's, per call."""
    x = inputs.lattice_inputs(cfg_name, seed=7)
    pairs = cases.fluid_pairs(x)
    print(f"[{tag}] n {x['sc'].n_fluid}, pairs {pairs}")
    rigid = inputs.body_inputs(cfg_name, seed=3)
    for case in [*cases.scene_cases(x, pairs),
                 *cases.rigid_cases(rigid, bounds.rigid_work(rigid))]:
        row = cases.measure(case)
        # the kernel's time a launch, and all the call's kernels
        # (wcsph_forces' record build)
        row["device_us"], row["call_device_us"] = timing.device_us(
            case.kern, cases.DEVICE_KERNEL.get(case.name, case.name))
        row["device_share"] = row["bound_ms"] * 1e3 / row["device_us"]
        lib = ""
        if case.library:
            for layout, call in case.library.items():
                if f"library_ms_{layout}" not in row:
                    continue
                found, _ = timing.profile_kernels(
                    lambda: [call() for _ in range(20)])
                row[f"library_kernels_{layout}"] = {
                    name: dict(launches=c / 20, us=t / 20)
                    for name, (c, t) in found.items()}
                row[f"library_us_{layout}"] = sum(
                    t for _, t in found.values()) / 20
                lib += (f"\n    torch.sparse {layout}: "
                        f"{row[f'library_ms_{layout}']:.4f} ms, "
                        f"{row[f'library_us_{layout}']:.2f} us device "
                        f"{row[f'library_kernels_{layout}']}")
            if "lane_sums_ms" in row:      # the contraction
                row["lane_sums_us"] = timing.kernel_device_us(
                    lambda: case.kern(lane_sums=True), case.name)
                lib = (f"\n    lane sums {row['lane_sums_ms']:.4f} ms "
                       f"({row['lane_sums_us']:.2f} us device);{lib}")
        res.setdefault(case.key, {})[tag] = row
        print(f"[{tag}] {case.key:20s} device {row['device_us']:9.2f} us "
              f"(call {row['call_device_us']:9.2f})  "
              f"bound {row['bound_ms'] * 1e3:8.2f} us ({row['bound_by']}; "
              f"walk {row['walk_bound_ms'] * 1e3:.2f})  share "
              f"{row['device_share']:.3f}{lib}")
    del x
    torch.cuda.empty_cache()


def timed_steps(sim, steps: int) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        sim.step()
    torch.cuda.synchronize()
    return steps / (time.perf_counter() - t0)


ORDER = ("coef_f32", "recompute", "recompute", "coef_f32", "coef_bf16")
PINS = {"coef_f32": {}, "recompute": {"budget": 0},
        "coef_bf16": {"dtype": torch.bfloat16}, "-": {}}
# (solver, config tag, loop engines in the order they run; "-": none)
RATES = (("dfsph", "30k", ORDER), ("dfsph", "1m", ORDER),
         ("wcsph", "30k", ("-",)), ("wcsph", "1m", ("-",)),
         ("iisph", "30k", ORDER[:4]),
         ("pcisph", "30k", ORDER[:4]), ("pcisph", "1m", ORDER[:4]),
         ("pbf", "30k", ("-",)), ("pbf", "1m", ("-",)))
PROFILES = (("dfsph", "1m", "recompute"), ("dfsph", "1m", "coef_f32"),
            ("dfsph", "1m", "coef_bf16"), ("wcsph", "1m", "-"),
            ("iisph", "30k", "coef_f32"), ("pcisph", "1m", "coef_f32"),
            ("pbf", "1m", "-"))
# (untimed steps, timed steps)
WINDOWS = {"30k": (0, 100), "1m": (5, 10), "body_30k": (0, 100),
           "body_1m": (5, 10)}


def simulation(solver: str, tag: str):
    """The run's Simulation on the card; a tag "body_<size>" is that
    block with a body at its centre (perf/inputs.body_scene)."""
    from cfd_taichi_tpu_torch import Simulation

    block = dict(CONFIGS)[tag.removeprefix("body_")]
    return Simulation(inputs.solver_config(block, solver), device="cuda",
                      scene=inputs.body_scene(block)
                      if tag.startswith("body_") else None)


def engine_rates(res: dict) -> None:
    """Host-clock rates of each solver and engine. Taken before any
    profile: a process that has run torch.profiler steps slower on the
    host clock. Three untimed steps on each scene first take the one-time
    costs (the kernel build, PyTorch's lazy set-up) out of the first
    window."""
    for solver, tag, engines in RATES:
        sim = simulation(solver, tag)
        for _ in range(3):
            sim.step()
        warm, steps = WINDOWS[tag]
        for engine in engines:
            with inputs.engine(**PINS[engine]):
                sim.state = sim.solver.init_state(sim.scene)
                for _ in range(warm):
                    sim.step()
                S.reset_counts()
                rate = timed_steps(sim, steps)
                launches = {kk.name: kk.launches / steps
                            for kk in S.KERNELS.values() if kk.launches}
                diag = sim.state.diag.tolist()
            run = res.setdefault("rates", {}).setdefault(
                f"{solver}/{tag}/{engine}", {"steps_per_sec": []})
            run["steps_per_sec"].append(rate)
            run["launches_per_step"], run["last_diag"] = launches, diag
            print(f"[rate] {solver} {tag} {engine:9s} steps {warm + 1}-"
                  f"{warm + steps}: {rate:.3f} steps/s  launches/step "
                  f"{launches}  last diag {diag}")
        del sim
        torch.cuda.empty_cache()


COUPLED = ("torus_flush", "body_30k")
COUPLED_STEPS = 100


def coupled_simulation(tag: str):
    """configs/torus_flush.json, or breaking_dam_30k's block with a body in
    it (perf/inputs.body_scene), as coupled DFSPH on the card."""
    from cfd_taichi_tpu_torch import Simulation, read_config

    if tag == "torus_flush":
        return Simulation(read_config(str(inputs.CONFIGS /
                                          "torus_flush.json")))
    cfg = inputs.solver_config(dict(CONFIGS)["30k"])
    return Simulation(cfg, scene=inputs.body_scene(dict(CONFIGS)["30k"]))


def coupled_step(sim) -> None:
    sim.step()
    sim.rigid_step()


def coupled_rates(res: dict) -> dict:
    """Host-clock rate of the coupled step, steps 1-100 from rest (after 3
    untimed steps), with launches per step. Returns the simulations, which
    `coupled_profiles` continues."""
    sims = {}
    for tag in COUPLED:
        sim = sims[tag] = coupled_simulation(tag)
        for _ in range(3):
            coupled_step(sim)
        sim.state = sim.solver.init_state(sim.scene)
        S.reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(COUPLED_STEPS):
            coupled_step(sim)
        torch.cuda.synchronize()
        rate = COUPLED_STEPS / (time.perf_counter() - t0)
        launches = {kk.name: kk.launches / COUPLED_STEPS
                    for kk in S.KERNELS.values() if kk.launches}
        res.setdefault("rates", {})[f"dfsph-rigid/{tag}/coef_f32"] = dict(
            steps_per_sec=[rate], launches_per_step=launches,
            last_diag=sim.state.diag.tolist(), n_fluid=sim.scene.n_fluid,
            n_rigid=sim.scene.n_rigid)
        print(f"[rate] dfsph-rigid {tag} coef_f32 steps 1-{COUPLED_STEPS}: "
              f"{rate:.3f} steps/s  launches/step {launches}  last diag "
              f"{sim.state.diag.tolist()}")
    return sims


def coupled_profiles(res: dict, sims: dict) -> None:
    """3 profiled coupled steps of each simulation of `coupled_rates`."""
    for tag, sim in sims.items():
        found, wall = timing.profile_kernels(
            lambda: [coupled_step(sim) for _ in range(3)])
        busy = sum(t for _, t in found.values()) / 1e6 / wall
        top = sorted(found.items(), key=lambda kv: -kv[1][1])[:14]
        res.setdefault("profiles", {})[f"dfsph-rigid/{tag}/coef_f32"] = \
            dict(busy=busy, wall_s=wall,
                 device_ms_per_step=sum(t for _, t in found.values())
                 / 3e3, kernels={
                     name: dict(launches_per_step=c / 3, us_per_launch=t / c)
                     for name, (c, t) in top})
        print(f"[profile] dfsph-rigid {tag} coef_f32: busy {busy:.3f} of "
              f"{wall:.3f} s; " + "; ".join(
                  f"{name} {c / 3:.1f} x {t / c:.1f} us"
                  for name, (c, t) in top))


def step_profiles(res: dict, runs=PROFILES) -> None:
    """3 profiled steps per run of `runs` (1M steps 6-8, 30k steps 1-3):
    device time by kernel, split into the hand-written kernels and the
    rest, and the busy share."""
    sims: dict = {}
    for solver, tag, engine in runs:
        if (solver, tag) not in sims:
            sims.clear()
            torch.cuda.empty_cache()
            sims[(solver, tag)] = simulation(solver, tag)
        sim = sims[(solver, tag)]
        advance = sim.frame if tag.startswith("body_") else sim.step
        with inputs.engine(**PINS[engine]):
            sim.state = sim.solver.init_state(sim.scene)
            for _ in range(WINDOWS[tag][0]):
                advance()
            found, wall = timing.profile_kernels(
                lambda: [advance() for _ in range(3)])
        busy = sum(t for _, t in found.values()) / 1e6 / wall
        ranked = sorted(found.items(), key=lambda kv: -kv[1][1])
        ours = [(c, t) for name, (c, t) in ranked if name in S.KERNELS]
        rest = [(c, t) for name, (c, t) in ranked if name not in S.KERNELS]
        res.setdefault("profiles", {})[f"{solver}/{tag}/{engine}"] = dict(
            busy=busy, wall_s=wall,
            device_ms_per_step=sum(t for _, t in found.values()) / 3e3,
            kernels_per_step=sum(c for c, _ in found.values()) / 3,
            handwritten_ms_per_step=sum(t for _, t in ours) / 3e3,
            handwritten_per_step=sum(c for c, _ in ours) / 3,
            other_ms_per_step=sum(t for _, t in rest) / 3e3,
            other_per_step=sum(c for c, _ in rest) / 3,
            kernels={name: dict(launches_per_step=c / 3, us_per_launch=t / c)
                     for name, (c, t) in ranked})
        row = res["profiles"][f"{solver}/{tag}/{engine}"]
        print(f"[profile] {solver} {tag} {engine}: busy {busy:.3f} of "
              f"{wall:.3f} s; device {row['device_ms_per_step']:.3f} ms a "
              f"step in {row['kernels_per_step']:.1f} kernels: hand-written "
              f"{row['handwritten_ms_per_step']:.3f} ms in "
              f"{row['handwritten_per_step']:.1f}, the rest "
              f"{row['other_ms_per_step']:.3f} ms in "
              f"{row['other_per_step']:.1f}; " + "; ".join(
                  f"{name} {c / 3:.1f} x {t / c:.1f} us"
                  for name, (c, t) in ranked[:12]))
        if solver == "wcsph":
            # wcsph_forces' record build, once a step, at the step's size
            f = sim.state.fluid
            rho = torch.ones_like(f.pos[:, 0])
            us = timing.batch_ms(
                lambda: S.wcsph_records(f.pos, f.vel, rho, rho)) * 1e3
            res["profiles"][f"{solver}/{tag}/{engine}"]["records_us"] = us
            print(f"[profile] {solver} {tag} {engine}: record build {us:.2f}"
                  f" us a step")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="build/perf/kernel_table.json")
    ap.add_argument("--profiles", nargs="+", default=None,
                    metavar="SOLVER/TAG/ENGINE",
                    help="only the step profiles of these runs")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA card")
    res: dict = {"card": timing.card()}
    print(f"[table] card: {res['card']}")
    lib = _build.library()
    print(f"[table] kernels built in {lib.build_seconds:.1f} s")
    if args.profiles:
        step_profiles(res, [tuple(run.split("/")) for run in args.profiles])
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(res, indent=1))
        return 0
    engine_rates(res)
    coupled = coupled_rates(res)
    for tag, cfg_name in CONFIGS:
        kernel_rows(res, tag, cfg_name)
    step_profiles(res)
    coupled_profiles(res, coupled)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(res, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
