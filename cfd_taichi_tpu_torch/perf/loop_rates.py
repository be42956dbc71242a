"""Step rates, device time, capture cost and peak memory of the solvers
whose pressure loops run as graph trips (ops/loops.py), at U = 1, 2 and 4
iterations a trip and with eager loops, on one card:

    python -m cfd_taichi_tpu_torch.perf.loop_rates [--out PATH]

Rows: DFSPH on the coef f32 engine, breaking_dam_30k steps 1-100 and
breaking_dam_1m steps 6-15; IISPH on breaking_dam_30k as written, steps
1-100; PCISPH at 30k and 1M; configs/coupling_demo.json (PCISPH with its
body, a fluid and a rigid step a frame), frames 1-36; the half-immersed
torus (perf/inputs.torus_immersed, DFSPH coupled both ways, hundreds of
density iterations a step), frames 1-12. All from rest.

Each row runs its modes in turns, `MODES`: "eager" (every trip launched
from Python at one iteration a trip, one host read an iteration: the loop
as the port ran it before it had graphs; perf/inputs.loop_mode) and U =
1, 2, 4 (graph trips), then back. A window starts from rest, takes its
untimed steps, then the timed ones: host clock around work that ends in a
synchronize, with the trips, captures and host seconds in captures of
its steps (Scene.loop_graphs) and its peak device memory, allocated and
reserved by the caching allocator. Rates come
first: a process that has run torch.profiler steps slower on the host
clock. Last, each row's 3 profiled steps (after the window's untimed and
timed steps) in eager mode and at the scene's own U (models/dfsph.
loop_unroll): device ms a step and the busy share, over the profiled
wall and at the mode's mean unprofiled rate (the profiler slows graph
launches most: the host us of each `cudaGraphLaunch` under it is
printed).

Prints one line per number and writes them all as JSON (--out).
"""

from __future__ import annotations

import argparse
import json
import statistics
import time
from pathlib import Path

import torch

from cfd_taichi_tpu_torch.models import dfsph
from cfd_taichi_tpu_torch.ops import _build
from cfd_taichi_tpu_torch.ops import stencil as S
from cfd_taichi_tpu_torch.perf import inputs, timing

MODES = ("eager", 1, 2, 4, 4, 2, 1, "eager")
# (row, solver, config, untimed steps, timed steps)
ROWS = (("dfsph/30k", "dfsph", "breaking_dam_30k.json", 0, 100),
        ("dfsph/1m", "dfsph", "breaking_dam_1m.json", 5, 10),
        ("iisph/30k", "iisph", "breaking_dam_30k.json", 0, 100),
        ("pcisph/30k", "pcisph", "breaking_dam_30k.json", 0, 100),
        ("pcisph/1m", "pcisph", "breaking_dam_1m.json", 5, 10),
        ("coupling_demo", "pcisph", "coupling_demo.json", 0, 36),
        ("immersed", "dfsph", "torus_immersed", 0, 12))


def simulation(solver: str, cfg_name: str, scenes: dict):
    """The row's Simulation on the card, on a scene shared by the rows of
    one config (a scene does not depend on the solver)."""
    from cfd_taichi_tpu_torch import Simulation, build_scene, read_config

    if cfg_name == "coupling_demo.json":
        return Simulation(read_config(str(inputs.CONFIGS / cfg_name)))
    if cfg_name == "torus_immersed":
        return Simulation(inputs.torus_immersed())
    cfg = inputs.solver_config(cfg_name, solver)
    if cfg_name not in scenes:
        scenes.clear()
        torch.cuda.empty_cache()
        scenes[cfg_name] = build_scene(cfg, device="cuda")
    return Simulation(cfg, device="cuda", scene=scenes[cfg_name])


def _mode(mode):
    return inputs.loop_mode(eager=True, unroll=1) if mode == "eager" \
        else inputs.loop_mode(unroll=mode)


def window(sim, mode, warm: int, steps: int) -> dict:
    """One window of `sim` from rest in loop `mode`."""
    graphs = sim.scene.loop_graphs
    with _mode(mode):
        sim.state = sim.solver.init_state(sim.scene)
        for _ in range(warm):
            sim.frame()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        graphs.reset()
        S.reset_counts()
        diags = []
        t0 = time.perf_counter()
        for _ in range(steps):
            sim.frame()
            diags.append(sim.state.diag)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    diags = [d.tolist() for d in diags]
    return dict(
        steps_per_sec=steps / wall,
        trips_per_step=graphs.trips / steps,
        captures_per_step=graphs.captures / steps,
        capture_ms_per_step=graphs.capture_s * 1e3 / steps,
        instantiate_ms_per_step=graphs.instantiate_s * 1e3 / steps,
        peak_gib=torch.cuda.max_memory_allocated() / 2**30,
        peak_reserved_gib=torch.cuda.max_memory_reserved() / 2**30,
        mean_diag=[statistics.mean(c) for c in zip(*diags)],
        last_diag=diags[-1],
        launches_per_step={k.name: k.launches / steps
                           for k in S.KERNELS.values() if k.launches})


def profile(sim, mode) -> dict:
    """3 profiled frames in loop `mode`, where the last window left off,
    with the host time of their graph launches under the profiler."""
    host = {"cudaGraphLaunch": (0, 0.0)}
    with _mode(mode):
        found, wall = timing.profile_kernels(
            lambda: [sim.frame() for _ in range(3)], host)
    dev_ms = sum(t for _, t in found.values()) / 1e3 / 3
    calls, us = host["cudaGraphLaunch"]
    return dict(device_ms_per_step=dev_ms, busy=dev_ms * 3e-3 / wall,
                wall_s=wall, graph_launches=calls,
                graph_launch_us=us / calls if calls else None)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="build/perf/loop_rates.json")
    ap.add_argument("--rows", default=",".join(r[0] for r in ROWS),
                    help="comma-separated rows to run (default: all)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA card")
    res: dict = {"card": timing.card(), "rows": {}}
    print(f"[loops] card: {res['card']}")
    print(f"[loops] kernels built in {_build.library().build_seconds:.1f} s")
    rows = [r for r in ROWS if r[0] in args.rows.split(",")]
    scenes: dict = {}
    for tag, solver, cfg_name, warm, steps in rows:
        sim = simulation(solver, cfg_name, scenes)
        for _ in range(3):      # the kernel build and lazy set-up
            sim.frame()
        own = dfsph.loop_unroll(sim.scene)
        row = res["rows"][tag] = dict(n_fluid=sim.scene.n_fluid,
                                      own_unroll=own, windows=[])
        for mode in MODES:
            w = window(sim, mode, warm, steps)
            row["windows"].append(dict(mode=mode, **w))
            print(f"[loops] {tag} {mode!s:5s} steps {warm + 1}-"
                  f"{warm + steps}: {w['steps_per_sec']:.2f} steps/s, "
                  f"{w['trips_per_step']:.2f} trips, "
                  f"{w['captures_per_step']:.2f} captures "
                  f"({w['capture_ms_per_step']:.3f} ms, "
                  f"{w['instantiate_ms_per_step']:.3f} in capture_end) a "
                  f"step, peak {w['peak_gib']:.3f} GiB ("
                  f"{w['peak_reserved_gib']:.3f} reserved), mean diag "
                  f"{[round(d, 3) for d in w['mean_diag']]}")
    for tag, solver, cfg_name, warm, steps in rows:
        sim = simulation(solver, cfg_name, scenes)
        own = res["rows"][tag]["own_unroll"]
        for mode in ("eager", own):
            window(sim, mode, warm, steps)
            p = res["rows"][tag].setdefault("profiles", {})[str(mode)] = \
                profile(sim, mode)
            # the profiler slows launches, a graph's most: the busy share
            # at the mode's unprofiled rate too
            rate = statistics.mean(w["steps_per_sec"]
                                   for w in res["rows"][tag]["windows"]
                                   if w["mode"] == mode)
            p["busy_at_rate"] = p["device_ms_per_step"] / 1e3 * rate
            launch = (f"; {p['graph_launches']} graph launches, "
                      f"{p['graph_launch_us']:.1f} host us each"
                      if p["graph_launches"] else "")
            print(f"[loops] {tag} profile {mode!s:5s}: "
                  f"{p['device_ms_per_step']:.3f} device ms a step, busy "
                  f"{p['busy']:.3f} of {p['wall_s']:.3f} s; at the "
                  f"unprofiled {rate:.2f} steps/s {p['busy_at_rate']:.3f}"
                  f"{launch}")
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(res, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
