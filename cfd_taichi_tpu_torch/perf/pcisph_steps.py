"""PCISPH's (or PBF's, or DFSPH's) step from rest on one card, on
breaking_dam_30k and breaking_dam_1m with the default (stored-coefficient,
f32) engine, or the coupled frames of a body in water: the numbers by
which two trees of the port are compared in one call.

    PYTHONPATH=<tree> python cfd_taichi_tpu_torch/perf/pcisph_steps.py \\
        --label NAME [--solver pcisph|pbf|dfsph|coupled] [--cells TAG ...]
        [--out PATH]

With --solver coupled the cells are frames (a fluid step and a rigid
step) from rest of the half-immersed torus (perf/inputs.torus_immersed,
DFSPH), configs/torus_flush.json as written ("torus_flush", DFSPH: the
torus beside the water, which reaches it in the later frames),
breaking_dam_30k's and breaking_dam_1m's blocks with a body at
their centre (perf/inputs.body_scene) as DFSPH, IISPH and WCSPH (the two
whose step walks the body's reaction) and PCISPH (whose predicted density
walks the body in every iteration, the body in water from the first
step), and configs/coupling_demo.json (PCISPH: from rest its body stands
beside the water, so the gate takes no warp), each measured as a step
below (`--cells` picks some, in the order given); the digest
also covers the body's particles, velocity and spin, and the device
times of the body's reaction (its walk, or its list's rows, the list and
the list's stream) and of the fluid side's passes over the body (the
solid sums, and the contact dot and solid viscosity, which a tree since
their gate walks only near the body) are printed.

The package is imported from PYTHONPATH, so that the same script measures
an older tree unpacked beside this one (`git archive`); run the trees in
turns (older, newer, newer, older), each in its own process. For each
scene: 3 untimed steps and a restart from rest (the kernel build and
PyTorch's set-up), steps 1-5 untimed and 6-15 timed on the host clock
around work that ends in a synchronize (steps/s, iterations a step, host
reads a step: the loops' trips and the reads outside them, peak device
memory, and a digest of the positions after step 15, equal between two
trees whose steps are bit for bit), then 3 profiled steps (16-18): device
ms a step, device kernels a step (graph replays included), busy share,
and each kernel's launches a step and device us a launch
(torch.profiler). With --solver pbf also the rows with lambda !=
0 in each timed step, counted on a replay of steps 1-15 from rest (its
positions' digest equal to the timed run's), and digests of PBF's three
pair passes on the scene's jittered lattice (perf/inputs.lattice_inputs,
seed 7) with the scene's walls: the constraint pass at cases.LOW_RHO0,
where most rows are constrained (its constraint, lambda, gsum and ssum,
and the count of constrained rows), and pbf_lambda and pbf_xsph over its
list, equal between two trees whose kernels give the same bits (a tree
from before the constraint pass' one launch has neither: its steps are
compared by their positions). Prints one line per number and writes
them as JSON (--out).
"""

from __future__ import annotations

import argparse
import hashlib
import json
import time
from pathlib import Path

import torch

from cfd_taichi_tpu_torch import Simulation, read_config
from cfd_taichi_tpu_torch.models import base
from cfd_taichi_tpu_torch.ops import _build
from cfd_taichi_tpu_torch.ops import stencil as S
from cfd_taichi_tpu_torch.perf import inputs, timing

SCENES = (("30k", "breaking_dam_30k.json"), ("1m", "breaking_dam_1m.json"))
COUPLED = ("torus", "body_30k", "coupling_demo", "body_1m", "body_30k_iisph",
           "body_1m_iisph", "body_30k_wcsph", "body_1m_wcsph", "torus_flush",
           "body_30k_pcisph", "body_1m_pcisph")
# (block, solver) of a body-in-water cell
BODY_BLOCKS = {"body_30k": ("breaking_dam_30k.json", "dfsph"),
               "body_1m": ("breaking_dam_1m.json", "dfsph"),
               "body_30k_iisph": ("breaking_dam_30k.json", "iisph"),
               "body_1m_iisph": ("breaking_dam_1m.json", "iisph"),
               "body_30k_wcsph": ("breaking_dam_30k.json", "wcsph"),
               "body_1m_wcsph": ("breaking_dam_1m.json", "wcsph"),
               "body_30k_pcisph": ("breaking_dam_30k.json", "pcisph"),
               "body_1m_pcisph": ("breaking_dam_1m.json", "pcisph")}
# The reaction's kernels, whose device times a coupled cell prints
REACTION = ("rigid_side_force", "rigid_side_rows", "rigid_side_list",
            "rigid_side_force_list")
# The body's gate and the predicted density (whose call walks the body in
# a coupled PCISPH step), whose device times it prints too
GATE = ("body_box", "pcisph_predict_rho", "pcisph_predict_rho_list")
# The fluid side's passes over the body, whose device times it prints too
FLUID_SIDE = ("rigid_terms", "rigid_contact_dot", "rigid_viscosity")
UNTIMED, TIMED, PROFILED = 5, 10, 3


def _digest(t: torch.Tensor) -> str:
    return hashlib.sha256(t.cpu().numpy().tobytes()).hexdigest()[:16]


def _listed(kernels: dict, names: tuple) -> str:
    """Launches a step and device us a launch of the kernels `names`."""
    return "; ".join(f"{name} {k['launches_per_step']:.1f} x "
                     f"{k['us_per_launch']:.2f} us"
                     for name, k in kernels.items() if name in names)


def pbf_digests(cfg_name: str) -> dict:
    """Digests of the outputs of PBF's three pair passes on the config's
    jittered lattice, lambda and shifted positions of perf/inputs: the
    constraint pass with the scene's walls at cases.LOW_RHO0 and the count
    of its constrained rows, then pbf_lambda and pbf_xsph over its list."""
    from cfd_taichi_tpu_torch.perf import cases

    x = inputs.lattice_inputs(cfg_name, seed=7)
    sc = x["sc"]
    p, st, g = x["p"], x["st"], sc.grid
    rows, pairs = S.pbf_constraint(*cases.pbf_constraint_args(
        p, st, g, sc.h, sc.particle_m, None, base.walls(sc),
        cases.LOW_RHO0))
    lam = S.pbf_lambda(p, pairs, sc.h, x["lam"])
    xsph = S.pbf_xsph(pairs, sc.h, x["shifted"], x["v"])
    return dict({f"constraint.{k}": _digest(t)
                 for k, t in rows._asdict().items()},
                constrained=int((rows.lam != 0).sum()),
                pbf_lambda=_digest(lam), pbf_xsph=_digest(xsph))


def constrained_rows(sim, advance, digest: str) -> list[int]:
    """The rows with lambda != 0 in each of PBF's timed steps: steps 1-15
    from rest replayed with every constraint pass counted, the positions
    after them checked against the timed run's `digest`."""
    found = []
    launch = S.pbf_constraint

    def counted(*args):
        out = launch(*args)
        found.append((out[0].lam != 0).sum())
        return out

    sim.state = sim.solver.init_state(sim.scene)
    S.pbf_constraint = counted
    try:
        for _ in range(UNTIMED + TIMED):
            advance()
    finally:
        S.pbf_constraint = launch
    if _digest(sim.state.fluid.pos.flatten()) != digest:
        raise RuntimeError("the replay parted from the timed steps")
    return [int(c) for c in found[UNTIMED:]]


def simulation(tag: str, solver: str):
    """(the cell's Simulation on the card, what a step of it is)."""
    if solver != "coupled":
        sim = Simulation(inputs.solver_config(dict(SCENES)[tag], solver),
                         device="cuda")
        return sim, sim.step
    if tag == "torus":
        sim = Simulation(inputs.torus_immersed(), device="cuda")
    elif tag in ("coupling_demo", "torus_flush"):
        sim = Simulation(read_config(str(inputs.CONFIGS / f"{tag}.json")),
                         device="cuda")
    else:
        block, body_solver = BODY_BLOCKS[tag]
        sim = Simulation(inputs.solver_config(block, body_solver),
                         device="cuda", scene=inputs.body_scene(block))
    return sim, sim.frame


def measure(sim, advance) -> dict:
    """The cell's numbers, `advance` (a step or a frame of `sim`) being
    its step."""
    for _ in range(3):
        advance()
    sim.state = sim.solver.init_state(sim.scene)
    for _ in range(UNTIMED):
        advance()
    S.reset_counts()
    pool = sim.scene.loop_graphs
    pool.reset()
    torch.cuda.reset_peak_memory_stats()
    diags = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(TIMED):
        advance()
        diags.append(sim.state.diag)
    torch.cuda.synchronize()
    rate = TIMED / (time.perf_counter() - t0)
    launches = {k.name: k.launches / TIMED for k in S.KERNELS.values()
                if k.launches}
    reads = (pool.trips + pool.reads) / TIMED
    outside = pool.reads / TIMED
    peak = torch.cuda.max_memory_allocated() / 2**30
    body = sim.state.rigid
    digest = _digest(torch.cat([sim.state.fluid.pos.flatten()] + (
        [body.pos.flatten(), body.vel, body.omega] if sim.scene.coupled
        else [])))
    found, wall = timing.profile_kernels(
        lambda: [advance() for _ in range(PROFILED)])
    device_ms = sum(t for _, t in found.values()) / 1e3 / PROFILED
    return dict(steps_per_sec=rate, iters=[float(d[0]) for d in diags],
                kernels_per_step=sum(c for c, _ in found.values())
                / PROFILED,
                diags=[d.tolist() for d in diags],
                launches_per_step=launches, reads_per_step=reads,
                reads_outside_trips=outside,
                peak_gib=peak, pos_digest=digest,
                device_ms_per_step=device_ms,
                busy=device_ms * PROFILED / 1e3 / wall,
                kernels={name: dict(launches_per_step=c / PROFILED,
                                    us_per_launch=t / c)
                         for name, (c, t) in sorted(
                             found.items(), key=lambda kv: -kv[1][1])})


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--label", required=True)
    ap.add_argument("--solver", choices=("pcisph", "pbf", "dfsph",
                                         "coupled"),
                    default="pcisph")
    ap.add_argument("--cells", nargs="+", default=None, metavar="TAG",
                    help="only these cells (default: every cell of the "
                         "solver)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA card")
    solver = args.solver
    res = {"label": args.label, "solver": solver, "card": timing.card(),
           "package": str(Path(S.__file__).resolve().parents[1])}
    print(f"[{solver}] {args.label}: {res['package']} on {res['card']}")
    print(f"[{solver}] kernels built in "
          f"{_build.library().build_seconds:.1f} s")
    for tag in args.cells or (COUPLED if solver == "coupled"
                              else dict(SCENES)):
        sim, advance = simulation(tag, solver)
        row = res[tag] = measure(sim, advance)
        if solver == "pbf" and hasattr(S, "pbf_constraint"):
            row["constrained"] = constrained_rows(sim, advance,
                                                  row["pos_digest"])
            row["pass_digests"] = pbf_digests(dict(SCENES)[tag])
            print(f"[pbf] {args.label} {tag}: rows constrained in the timed "
                  f"steps {row['constrained']}; pass digests "
                  f"{row['pass_digests']}")
        del sim, advance
        top = list(row["kernels"].items())[:6]
        print(f"[{solver}] {args.label} {tag}: {row['steps_per_sec']:.3f} "
              f"steps/s, iterations {row['iters']}, {row['reads_per_step']} "
              f"reads a step, peak {row['peak_gib']:.3f} GiB, positions "
              f"{row['pos_digest']}, device "
              f"{row['device_ms_per_step']:.4f} ms a step in "
              f"{row['kernels_per_step']:.1f} kernels, busy "
              f"{row['busy']:.3f}; " + "; ".join(
                  f"{name} {k['launches_per_step']:.1f} x "
                  f"{k['us_per_launch']:.2f} us" for name, k in top))
        if solver == "coupled":
            print(f"[coupled] {args.label} {tag}: diag of the last step "
                  f"{row['diags'][-1]}; reaction "
                  f"{_listed(row['kernels'], REACTION)}; fluid side "
                  f"{_listed(row['kernels'], FLUID_SIDE)}; gate and "
                  f"predicted density {_listed(row['kernels'], GATE)}")
        torch.cuda.empty_cache()
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(res, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
