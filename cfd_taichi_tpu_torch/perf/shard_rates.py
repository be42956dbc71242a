"""The sharded step (parallel/domain.py) against the single-device step on
the card: agreement, launches, host reads, captures, rates, device time,
the decomposition's own device time and memory per rank.

    python -m cfd_taichi_tpu_torch.perf.shard_rates [--out PATH]

Four runs, each started with parallel/launch.spawn:

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
* `nccl_coupled_rank`: NCCL, one rank a card, on the coupled cells
  (COUPLED_CELLS): configs/coupling_demo.json as written (PCISPH, 55,200
  fluid and 3,200 rigid particles) and torus_flush with the torus half in
  the water (perf/inputs.torus_immersed, DFSPH), their frames (a sharded
  fluid step, then domain.make_sharded_rigid_step) against
  runner.Simulation's frames on the same scene (rank 0), with the body
  after each frame; on coupling_demo also the rates and profiles of
  `nccl_rank`, and the two sums over the ranks that a coupled step adds
  (the rho quirk's table and the body's reaction) timed alone;
* `gloo_coupled_rank`: GLOO_WORLD gloo ranks sharing card 0 on the
  half-immersed torus (the body across the x = 0.5 slab face, water on
  both sides), GLOO_COUPLED_FRAMES frames; each rank returns its rows
  with `oid`, the body's force of each frame and its launches.

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
# the coupled cells: (tag, solver, frames sharded and single-device)
COUPLED_CELLS = (("coupling_demo", "pcisph", 30), ("immersed", "dfsph", 5))
COUPLED_WINDOWS = (10, 10, 10, 10)   # frames: sharded, single, ...
GLOO_COUPLED_FRAMES = 3
# slab 0 of torus_flush holds 8 of the water's 14 columns: 2.29 x even
GLOO_COUPLED_SLACK = 2.5


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


def coupled_config(tag: str):
    """The SimConfig of a coupled cell."""
    from cfd_taichi_tpu_torch import read_config
    from cfd_taichi_tpu_torch.perf import inputs

    if tag == "immersed":
        return inputs.torus_immersed()
    return read_config(str(inputs.CONFIGS / f"{tag}.json"))


def _frames(step, rstep, state, frames: int):
    """`frames` frames, each a fluid step and a rigid step; (state, per
    frame dt, diag and the body's largest force before its step, and
    centroid, vel and omega after it, wall s)."""
    rec = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(frames):
        state = step(state)
        row = [state.dt, state.diag, state.rigid.force.abs().max()]
        state = rstep(state)
        rec.append(row + [state.rigid.centroid, state.rigid.vel,
                          state.rigid.omega])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    keys = ("dt", "diag", "fmax", "centroid", "vel", "omega")
    return state, {k: [r[i].tolist() for r in rec]
                   for i, k in enumerate(keys)}, wall


def _sim_stepper(sim):
    """A single-device frame of `sim` as a state -> state function."""
    def go(state, fluid):
        sim.state = state
        if fluid:
            sim.step()
        else:
            sim.rigid_step()
        return sim.state
    return (lambda s: go(s, True)), (lambda s: go(s, False))


def nccl_coupled_rank(ring) -> dict:
    """The coupled cells sharded over the NCCL ring against the
    single-device frames (module note)."""
    from cfd_taichi_tpu_torch import Simulation
    from cfd_taichi_tpu_torch.models import dfsph
    from cfd_taichi_tpu_torch.parallel import domain

    out = dict(rank=ring.rank, world=ring.world, backend=ring.backend,
               device=str(ring.device))
    for tag, solver, frames in COUPLED_CELLS:
        t0 = time.perf_counter()
        sim = Simulation(coupled_config(tag), device=ring.device)
        scene = sim.scene
        build_s = time.perf_counter() - t0
        spec = domain.make_spec(scene, ring.world)
        step = domain.make_sharded_solver_step(scene, ring, spec, solver)
        rstep = domain.make_sharded_rigid_step(scene)
        state = domain.init_sharded_solver(ring, spec, scene,
                                           scene.fluid_pos0, solver)
        _reset(scene)
        state, rec, wall = _frames(step, rstep, state, frames)
        cell = dict(solver=solver, frames=frames, build_s=build_s,
                    loops=step.loops, spec=vars(spec),
                    unroll=dfsph.loop_unroll(scene), n_fluid=scene.n_fluid,
                    n_rigid=scene.n_rigid,
                    sharded=dict(rec, first_frames_s=wall, counts=_counts(),
                                 peak_gib=torch.cuda.max_memory_allocated()
                                 / 2**30, overflow=int(state.overflow),
                                 **_loop_reads(scene.loop_graphs, frames)))
        pos, _, oid = domain.unshard(ring, state.fluid, with_oid=True)
        cell["sharded"]["count"] = int(pos.shape[0])
        fstep, frstep = _sim_stepper(sim)
        s0 = None
        if ring.rank == 0:
            s0 = sim.solver.init_state(scene)   # PCISPH's delta: a launch
            _reset(scene)
            s0, srec, swall = _frames(fstep, frstep, s0, frames)
            cell["single"] = dict(srec, first_frames_s=swall,
                                  counts=_counts(),
                                  peak_gib=torch.cuda.max_memory_allocated()
                                  / 2**30,
                                  **_loop_reads(scene.loop_graphs, frames))
            ref = _by_oid(s0.fluid.pos.cpu().numpy(),
                          s0.fluid.oid.cpu().numpy())
            cell["max_pos_err"] = float(np.abs(_by_oid(pos, oid)
                                               - ref).max())
            cell["body_equal"] = all(
                torch.equal(a, b) for a, b in zip(state.rigid, s0.rigid))
        if tag == "coupling_demo":
            cell.update(_coupled_rates(ring, scene, (step, rstep, state),
                                       (fstep, frstep, s0)))
        out[tag] = cell
        del sim, scene, state, s0
        torch.cuda.empty_cache()
    return out


def _coupled_rates(ring, scene, sharded, single) -> dict:
    """Frames/s of COUPLED_WINDOWS in turns, then PROFILE profiled frames
    of each (device ms a frame, busy share), then the two sums over the
    ranks that a coupled step adds, each timed alone on its shapes."""
    from cfd_taichi_tpu_torch.parallel import domain
    from cfd_taichi_tpu_torch.perf import timing

    runs = {"sharded": list(sharded)}
    if single[2] is not None:
        runs["single"] = list(single)
    rates = {k: [] for k in runs}
    for i, frames in enumerate(COUPLED_WINDOWS):
        tag = "sharded" if i % 2 == 0 else "single"
        if tag in runs:
            step, rstep, st = runs[tag]
            runs[tag][2], _, w = _frames(step, rstep, st, frames)
            rates[tag].append(frames / w)
    prof = {}
    for tag, (step, rstep, st) in runs.items():
        holder = [st]

        def go(step=step, rstep=rstep, holder=holder):
            for _ in range(PROFILE):
                holder[0] = rstep(step(holder[0]))

        found, pwall = timing.profile_kernels(go)
        dev_ms = sum(t for _, t in found.values()) / 1e3 / PROFILE
        prof[tag] = dict(device_ms_per_frame=dev_ms,
                         busy=dev_ms * PROFILE / 1e3 / pwall)
    comm = domain.Comm(ring)
    dev = ring.device
    n_quirk = min(scene.n_rigid, scene.n_fluid)
    pieces = dict(
        quirk_sum=lambda: comm.total(torch.zeros(n_quirk, device=dev)),
        reaction_sum=lambda: comm.total(torch.zeros(scene.n_rigid, 3,
                                                    device=dev)))
    out = dict(frames_per_sec=rates, profile=prof,
               sums_ms={k: timing.event_ms(fn) for k, fn in pieces.items()})
    out["sums_device_ms"], out["sums_kernels"] = {}, {}
    for k, fn in pieces.items():
        out["sums_device_ms"][k], out["sums_kernels"][k] = _device_ms(fn)
    return out


def gloo_coupled_rank(ring) -> dict:
    """Gloo ranks sharing a card on the half-immersed torus (module note):
    GLOO_COUPLED_FRAMES frames; after each, the rank's rows with oid, the
    body's force (before the rigid step) and the body."""
    from cfd_taichi_tpu_torch import build_scene
    from cfd_taichi_tpu_torch.parallel import domain

    scene = build_scene(coupled_config("immersed"), device=ring.device)
    spec = domain.make_spec(scene, ring.world, GLOO_COUPLED_SLACK)
    comm = domain.Comm(ring)
    state = domain.init_sharded_solver(ring, spec, scene, scene.fluid_pos0,
                                       "dfsph")
    step = domain.make_sharded_solver_step(scene, ring, spec, "dfsph")
    rstep = domain.make_sharded_rigid_step(scene)
    held = [int(n) for n in comm.all_gather(
        state.fluid.mask.sum().reshape(1))]
    _reset(scene)
    frames = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(GLOO_COUPLED_FRAMES):
        state = step(state)
        force = state.rigid.force.cpu().numpy()
        state = rstep(state)
        f, r = state.fluid, state.rigid
        frames.append(dict(dt=float(state.dt), diag=state.diag.tolist(),
                           force=force,
                           pos=f.pos[f.mask].cpu().numpy(),
                           oid=f.oid[f.mask].cpu().numpy(),
                           **{k: getattr(r, k).tolist()
                              for k in ("centroid", "vel", "omega")}))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return dict(rank=ring.rank, loops=step.loops, held_at_rest=held,
                spec=vars(spec), frames=frames,
                frames_per_sec=GLOO_COUPLED_FRAMES / wall, counts=_counts(),
                overflow=int(state.overflow),
                count=int(comm.sum(state.fluid.mask.sum())[0]),
                peak_gib=torch.cuda.max_memory_allocated() / 2**30)


def print_nccl_coupled(r: dict) -> None:
    for tag, _, _ in COUPLED_CELLS:
        c = r[tag]
        s = c["sharded"]
        its = [(d[0], d[2]) for d in s["diag"]]
        print(f"[shard] nccl world {r['world']} coupled {tag} "
              f"({c['solver']}, n={c['n_fluid']} rigid={c['n_rigid']}, "
              f"{c['loops']} trips): {c['frames']} frames, iterations "
              f"{its}; max |F| first frames "
              f"{[f'{x:.4e}' for x in s['fmax'][:3]]}; peak "
              f"{s['peak_gib']:.3f} GiB")
        if "single" in c:
            g = c["single"]
            print(f"[shard] coupled {tag}: max |pos - single| through oid "
                  f"{c['max_pos_err']:.3e}; body equal {c['body_equal']}; "
                  f"reads a frame sharded {s['reads_per_step']:.2f}, single "
                  f"{g['reads_per_step']:.2f}; captures a frame "
                  f"{s['captures_per_step']:.2f} / "
                  f"{g['captures_per_step']:.2f}")
        if "frames_per_sec" in c:
            print(f"[shard] coupled {tag}: frames/s "
                  f"{json.dumps(c['frames_per_sec'])}; profile "
                  f"{json.dumps(c['profile'])}; the sums over the ranks "
                  f"alone: ms {json.dumps(c['sums_ms'])}, device ms "
                  f"{json.dumps(c['sums_device_ms'])}, by kernel "
                  f"{json.dumps(c['sums_kernels'])}")


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
    t0 = time.perf_counter()
    res["nccl_coupled"] = launch.spawn(nccl_coupled_rank, world,
                                       backend="nccl", device="cuda")
    res["nccl_coupled_s"] = time.perf_counter() - t0
    for r in res["nccl_coupled"]:
        print_nccl_coupled(r)
    t0 = time.perf_counter()
    gc = launch.spawn(gloo_coupled_rank, GLOO_WORLD, backend="gloo",
                      device="cuda")
    res["gloo_coupled_s"] = time.perf_counter() - t0
    print(f"[shard] gloo {GLOO_WORLD} ranks sharing one card, host-staged, "
          f"coupled immersed (DFSPH): "
          f"{min(r['frames_per_sec'] for r in gc):.3f} frames/s (slowest "
          f"rank), held at rest {gc[0]['held_at_rest']}, iterations "
          f"{[(f['diag'][0], f['diag'][2]) for f in gc[0]['frames']]}")
    for r in gc:
        r.pop("frames")
    res["gloo_coupled"] = gc
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(res, indent=1, default=float))
    print(f"[shard] wrote {out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
