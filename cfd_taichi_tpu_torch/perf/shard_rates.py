"""The sharded step (parallel/domain.py) against the single-device step on
the card: agreement, launches, host reads, captures, rates, device time,
the decomposition's own device time and memory per rank.

    python -m cfd_taichi_tpu_torch.perf.shard_rates [--out PATH]

Two runs, each started with parallel/launch.spawn:

* `nccl_rank`: NCCL with one rank a card (world = the card count). DFSPH
  from rest on the config, STEPS steps sharded (counts, trips, captures
  and peak memory read over them) and STEPS single-device steps on the
  same scene, compared through `oid` (rank 0 holds the single-device
  run); then WINDOWS timed windows of each in turns (steps/s, host
  clock), PROFILE profiled steps of each (device ms a step, busy share),
  and the decomposition's pieces timed alone by CUDA events on the last
  state: the band plan with the positional halo trade, the value trade of
  an iteration (pack, trade, unpack into the sorted set) and migration,
  each with its five longest kernels.
* `gloo_rank`: GLOO_WORLD gloo ranks that share card 0, their messages
  staged through host memory (so their trips are eager), make_spec's
  slack GLOO_SLACK: DFSPH and WCSPH GLOO_STEPS steps each from rest,
  counts, rates and peak memory per rank; each rank returns its rows with
  `oid` for the caller to hold against the single-device step. Not a
  scaling figure: four processes take turns on one card.

Prints one line per number and writes them all as JSON (--out). The
ranks return what chip_smoke.py's [shard] phase checks.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np
import torch

CONFIG = "breaking_dam_1m.json"
STEPS = 5
WINDOWS = (5, 5, 5, 5)      # sharded, single, sharded, single
PROFILE = 3
GLOO_WORLD = 4
GLOO_STEPS = 3
GLOO_SLACK = 2.2
GLOO_SOLVERS = ("dfsph", "wcsph")


def _counts():
    from cfd_taichi_tpu_torch.ops import stencil

    return {k.name: (k.launches, k.plain_calls)
            for k in stencil.KERNELS.values()}


def _reset(scene) -> None:
    from cfd_taichi_tpu_torch.ops import stencil

    torch.cuda.synchronize()
    stencil.reset_counts()
    scene.loop_graphs.reset()
    torch.cuda.reset_peak_memory_stats()


def _run(stepper, state, steps: int):
    """`steps` steps of `stepper`; (state, per-step dt, diag, wall s)."""
    dts, diags = [], []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        state = stepper(state)
        dts.append(state.dt)
        diags.append(state.diag)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return (state, [float(d) for d in dts], [d.tolist() for d in diags],
            wall)


def _by_oid(pos, oid):
    return np.asarray(pos)[np.argsort(np.asarray(oid))]


def _loop_reads(pool, steps: int) -> dict:
    """Host reads and captures a step, as the scene's GraphPool counted
    them: one read a loop trip (its condition) and the reads outside the
    trips (the pair count, the sharded step's compaction). gloo on a card
    also reads every message it stages, not counted here."""
    return dict(trips_per_step=pool.trips / steps,
                reads_per_step=(pool.trips + pool.reads) / steps,
                captures_per_step=pool.captures / steps,
                capture_ms_per_step=pool.capture_s * 1e3 / steps)


def nccl_rank(ring) -> dict:
    """DFSPH sharded over the NCCL ring against the single-device step
    (module note)."""
    from cfd_taichi_tpu_torch import Simulation
    from cfd_taichi_tpu_torch.models import dfsph
    from cfd_taichi_tpu_torch.parallel import domain
    from cfd_taichi_tpu_torch.perf import inputs, timing

    t0 = time.perf_counter()
    sim = Simulation(inputs.solver_config(CONFIG, "dfsph"),
                     device=ring.device)
    scene = sim.scene
    build_s = time.perf_counter() - t0
    spec = domain.make_spec(scene, ring.world)
    step = domain.make_sharded_solver_step(scene, ring, spec, "dfsph")
    state = domain.init_sharded_solver(ring, spec, scene, scene.fluid_pos0,
                                       "dfsph")
    _reset(scene)
    state, dts, diags, wall = _run(step, state, STEPS)
    out = dict(rank=ring.rank, world=ring.world, backend=ring.backend,
               device=str(ring.device), loops=step.loops, spec=vars(spec),
               unroll=dfsph.loop_unroll(scene), n_fluid=scene.n_fluid,
               build_s=build_s,
               sharded=dict(dt=dts, diag=diags, first_steps_s=wall,
                            counts=_counts(),
                            peak_gib=torch.cuda.max_memory_allocated()
                            / 2**30,
                            reserved_gib=torch.cuda.max_memory_reserved()
                            / 2**30,
                            overflow=int(state.overflow),
                            **_loop_reads(scene.loop_graphs, STEPS)))
    pos, _, oid = domain.unshard(ring, state.fluid, with_oid=True)
    out["sharded"]["count"] = int(pos.shape[0])

    def single(s):
        sim.state = s
        sim.step()
        return sim.state

    if ring.rank == 0:
        _reset(scene)
        s0, sdts, sdiags, swall = _run(single, sim.solver.init_state(scene),
                                       STEPS)
        out["single"] = dict(dt=sdts, diag=sdiags, first_steps_s=swall,
                             counts=_counts(),
                             peak_gib=torch.cuda.max_memory_allocated()
                             / 2**30,
                             **_loop_reads(scene.loop_graphs, STEPS))
        ref = _by_oid(s0.fluid.pos.cpu().numpy(), s0.fluid.oid.cpu().numpy())
        out["max_pos_err"] = float(np.abs(_by_oid(pos, oid) - ref).max())
    else:
        s0 = None

    # --- rates, in turns, then profiles (a profiled process is slower) --
    rates = {"sharded": [], "single": []}
    for i, steps in enumerate(WINDOWS):
        if i % 2 == 0:
            state, _, _, w = _run(step, state, steps)
            rates["sharded"].append(steps / w)
        elif s0 is not None:
            s0, _, _, w = _run(single, s0, steps)
            rates["single"].append(steps / w)
    out["steps_per_sec"] = rates
    prof = {}
    runs = [("sharded", step, state)] + (
        [("single", single, s0)] if s0 is not None else [])
    for tag, stepper, st in runs:
        holder = [st]

        def go(stepper=stepper, holder=holder):
            for _ in range(PROFILE):
                holder[0] = stepper(holder[0])

        found, pwall = timing.profile_kernels(go)
        dev_ms = sum(t for _, t in found.values()) / 1e3 / PROFILE
        prof[tag] = dict(device_ms_per_step=dev_ms,
                         busy=dev_ms * PROFILE / 1e3 / pwall)
        if tag == "sharded":
            state = holder[0]
    out["profile"] = prof

    # --- the decomposition's pieces alone, by CUDA events ---------------
    comm = domain.Comm(ring)
    f = state.fluid
    plan = domain._band_plan(spec, ring, f.pos, f.mask, scene.h)
    vals = torch.zeros(spec.cap, dtype=torch.float32, device=ring.device)
    perm = torch.nonzero(f.mask).squeeze(1)
    pieces = dict(
        halo=lambda: domain._halo_exchange(spec, comm, f.pos, f.vel, f.mask,
                                           scene.h),
        value_trade=lambda: torch.cat(
            [vals, domain._plan_exchange(comm, plan, vals)])[perm],
        migrate=lambda: domain._migrate(spec, comm,
                                        [f.pos, f.vel, f.oid, vals], f.mask))
    out["pieces_ms"] = {k: timing.event_ms(fn) for k, fn in pieces.items()}
    out["pieces_device_ms"], out["pieces_kernels"] = {}, {}
    for k, fn in pieces.items():
        out["pieces_device_ms"][k], out["pieces_kernels"][k] = \
            _device_ms(fn)
    return out


def _device_ms(fn, calls: int = 10):
    """Device ms of all the kernels one call of `fn` runs (profiled), and
    the five longest: {kernel: (launches, device us) a call}."""
    from cfd_taichi_tpu_torch.perf import timing

    fn()
    found, _ = timing.profile_kernels(lambda: [fn() for _ in range(calls)])
    top = sorted(found.items(), key=lambda kv: -kv[1][1])[:5]
    return (sum(t for _, t in found.values()) / 1e3 / calls,
            {name[:60]: (c / calls, round(t / calls, 2))
             for name, (c, t) in top})


def gloo_rank(ring) -> dict:
    """Gloo ranks sharing a card (module note): per solver, GLOO_STEPS
    steps from rest; the rank's rows with oid."""
    from cfd_taichi_tpu_torch import build_scene
    from cfd_taichi_tpu_torch.parallel import domain
    from cfd_taichi_tpu_torch.perf import inputs

    t0 = time.perf_counter()
    scene = build_scene(inputs.solver_config(CONFIG), device=ring.device)
    build_s = time.perf_counter() - t0
    spec = domain.make_spec(scene, ring.world, GLOO_SLACK)
    comm = domain.Comm(ring)
    out = dict(rank=ring.rank, world=ring.world, backend=ring.backend,
               device=str(ring.device), spec=vars(spec), build_s=build_s)
    for solver in GLOO_SOLVERS:
        state = domain.init_sharded_solver(ring, spec, scene,
                                           scene.fluid_pos0, solver)
        step = domain.make_sharded_solver_step(scene, ring, spec, solver)
        held = [int(n) for n in comm.all_gather(
            state.fluid.mask.sum().reshape(1))]
        _reset(scene)
        state, dts, diags, wall = _run(step, state, GLOO_STEPS)
        f = state.fluid
        out[solver] = dict(
            loops=step.loops, held_at_rest=held, dt=dts, diag=diags,
            steps_per_sec=GLOO_STEPS / wall, counts=_counts(),
            overflow=int(state.overflow),
            count=int(comm.sum(f.mask.sum())[0]),
            peak_gib=torch.cuda.max_memory_allocated() / 2**30,
            **_loop_reads(scene.loop_graphs, GLOO_STEPS),
            pos=f.pos[f.mask].cpu().numpy(), oid=f.oid[f.mask].cpu().numpy())
    return out


def print_nccl(r: dict) -> None:
    s = r["sharded"]
    print(f"[shard] nccl world {r['world']} ({r['loops']} trips): DFSPH "
          f"n={r['n_fluid']} cap {r['spec']['cap']} hcap "
          f"{r['spec']['hcap']}; iterations (div, density) sharded "
          f"{[(d[0], d[2]) for d in s['diag']]}")
    if "single" in r:
        its = [(d[0], d[2]) for d in r["single"]["diag"]]
        print(f"[shard] single-device {its}; max |pos - single| through "
              f"oid {r['max_pos_err']:.3e}")
        print(f"[shard] host reads a step: sharded "
              f"{s['reads_per_step']:.2f} ({s['trips_per_step']:.2f} in "
              f"loop trips), single {r['single']['reads_per_step']:.2f} "
              f"({r['single']['trips_per_step']:.2f}); "
              f"captures a step sharded {s['captures_per_step']:.2f} "
              f"({s['capture_ms_per_step']:.3f} ms), single "
              f"{r['single']['captures_per_step']:.2f}")
    print(f"[shard] steps/s {json.dumps(r['steps_per_sec'])}; profile "
          f"{json.dumps(r['profile'])}; peak {s['peak_gib']:.3f} GiB "
          f"({s['reserved_gib']:.3f} reserved) a rank; pieces ms "
          f"{json.dumps(r['pieces_ms'])}, device ms "
          f"{json.dumps(r['pieces_device_ms'])}, by kernel "
          f"{json.dumps(r['pieces_kernels'])}")


def main() -> int:
    from cfd_taichi_tpu_torch.ops import _build
    from cfd_taichi_tpu_torch.parallel import launch
    from cfd_taichi_tpu_torch.perf import timing

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="build/perf/shard_rates.json")
    args = ap.parse_args()
    card = timing.card()
    print(f"[shard] card: {card}")
    _build.library()       # built once, before the ranks load it
    world = torch.cuda.device_count()
    res = dict(card=card, config=CONFIG)
    t0 = time.perf_counter()
    res["nccl"] = launch.spawn(nccl_rank, world, backend="nccl",
                               device="cuda")
    res["nccl_s"] = time.perf_counter() - t0
    for r in res["nccl"]:
        print_nccl(r)
    t0 = time.perf_counter()
    gl = launch.spawn(gloo_rank, GLOO_WORLD, backend="gloo", device="cuda")
    res["gloo_s"] = time.perf_counter() - t0
    for solver in GLOO_SOLVERS:
        rates = [r[solver]["steps_per_sec"] for r in gl]
        print(f"[shard] gloo {GLOO_WORLD} ranks sharing one card, "
              f"host-staged, {solver}: {min(rates):.3f} steps/s (slowest "
              f"rank), held at rest {gl[0][solver]['held_at_rest']}, "
              f"peak {[round(r[solver]['peak_gib'], 3) for r in gl]} GiB")
        for r in gl:
            r[solver].pop("pos")
            r[solver].pop("oid")
    res["gloo"] = gl
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(res, indent=1, default=float))
    print(f"[shard] wrote {out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
