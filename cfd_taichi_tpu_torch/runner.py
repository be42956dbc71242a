"""Simulation driver: config -> scene -> solver steps -> telemetry and
checkpoints.

Counterpart of `cfd_taichi_tpu/runner.py` (reference main.py:47-211): the
same JSON configs, frame structure (iter_cnt fluid steps, then iter_cnt
rigid-body steps where a body takes part, per frame) and
stopping rules (sim time > `max_sim_time`, frame cap), `--profile-dir`
and `check_nan`. PLY/GIF export and `--color-by` are not ported yet
(ROADMAP.md, queue 1): `run` refuses a config that asks for either export.

    python -m cfd_taichi_tpu_torch.runner --config configs/dfsph_basic.json \
        --frames 20 --device cuda
    python -m cfd_taichi_tpu_torch.runner --config configs/torus_flush.json \
        --frames 20 --device cuda      # a torus in water (DFSPH, coupled)
"""

from __future__ import annotations

import argparse
import json
import os
import time

import torch

from cfd_taichi_tpu_torch import models
from cfd_taichi_tpu_torch.config import SimConfig, read_config
from cfd_taichi_tpu_torch.models import base
from cfd_taichi_tpu_torch.models import rigid as rigid_mod
from cfd_taichi_tpu_torch.ops import rigid as rigid_ops
from cfd_taichi_tpu_torch.scene import RHO_0, build_scene
from cfd_taichi_tpu_torch.utils import io as io_utils
from cfd_taichi_tpu_torch.utils import telemetry

MAX_FRAMES = 100_000     # reference main.py:98
MAX_SIM_TIME = 4.0       # reference main.py:205


class Simulation:
    """Owns the scene, the solver state and the step function."""

    def __init__(self, cfg: SimConfig, check_nan: bool = False,
                 device="cuda", scene=None):
        """`scene`: one built beforehand on `device` (e.g. perf/inputs.
        body_scene), else build_scene(cfg)."""
        self.cfg = cfg
        self.device = torch.device(device)
        self.scene = scene if scene is not None else build_scene(
            cfg, device=self.device)
        self.solver = models.get_solver(cfg.solver.name)
        print(f"\033[32m[Solver]: {cfg.solver.name}\033[0m")  # solver_base.py:39
        self.state = self.solver.init_state(self.scene)
        self.iter_cnt = cfg.solver.iter_cnt
        self.timer = telemetry.StepTimer()
        self.check_nan = check_nan
        # An inactive body (solid.active false) is built and left alone.
        self.rigid_enabled = self.scene.has_rigid and self.scene.rigid_active

    def step(self):
        """One fluid solver step."""
        self.state = self.solver.step(self.scene, self.state)
        self.timer.tick(1)

    def rigid_step(self):
        """One rigid-body step under the fluid's forces, with the dt the
        last fluid step chose (`cfd_taichi_tpu/runner.py:61-65`)."""
        if self.rigid_enabled:
            self.state = self.state._replace(rigid=rigid_mod.step(
                self.scene, self.state.rigid, self.state.dt))

    def frame(self):
        """One frame: iter_cnt fluid steps, then iter_cnt rigid steps
        (reference main.py:165-173)."""
        for _ in range(self.iter_cnt):
            self.step()
        for _ in range(self.iter_cnt):
            self.rigid_step()
        if self.check_nan:
            f = self.state.fluid
            bad = int(telemetry.check_valid(f.pos, f.vel, f.acc))
            if bad:
                raise FloatingPointError(f"{bad} particles went NaN/Inf")
            bad = int(telemetry.rigid_invalid(self.state.rigid))
            if bad:
                raise FloatingPointError(
                    f"the rigid body went NaN/Inf ({bad} bad values)")

    @property
    def t(self) -> float:
        return float(self.state.t)

    def density(self) -> torch.Tensor:
        """(N,) density in state order from the port's own fluid and
        boundary passes: 0.001 + sum_f m W + sum_b rho0 V_b W, and + sum_s
        rho0 V_s W over a body coupled both ways, as the JAX package's
        density counts it (`cfd_taichi_tpu/models/base.py:481-491`)."""
        sc = self.scene
        perm, pos, _, rho, _ = base.sorted_density(sc, self.state.fluid.pos)
        if sc.coupled and sc.fs_couple:
            table = rigid_ops.rigid_table(sc.grid, self.state.rigid.pos,
                                          sc.rigid_volume)
            rho = rho + rigid_ops.rigid_terms(pos, table, sc.grid, sc.h,
                                              RHO_0).rho
        return torch.empty_like(rho).index_put_((perm,), rho)

    def telemetry(self) -> dict:
        self.timer.sim_time = self.t
        out = dict(self.timer.summary())
        out.update(telemetry.density_stats(self.density(), RHO_0))
        f = self.state.fluid
        out["dt"] = float(self.state.dt)
        out["t"] = self.t
        out["nan_particles"] = int(telemetry.check_valid(f.pos, f.vel, f.acc))
        out["window_overflow"] = int(self.state.overflow)
        if self.scene.has_rigid:
            out["rigid_invalid"] = int(telemetry.rigid_invalid(
                self.state.rigid))
        diag = self.state.diag.cpu().tolist()
        out["solver_iters"] = [round(diag[0], 1), round(diag[2], 1)]
        out["solver_residuals"] = [round(diag[1], 4), round(diag[3], 4)]
        return out


def run(cfg: SimConfig, frames: int | None = None, output_dir: str = "./output",
        profile_dir: str | None = None, checkpoint_every: int = 0,
        resume: str | None = None, quiet: bool = False,
        max_sim_time: float = MAX_SIM_TIME, device="cuda") -> Simulation:
    for flag in ("is_output_ply", "is_output_gif"):
        if getattr(cfg.scene, flag):
            raise NotImplementedError(
                f"scene.{flag} is set, but frame export is not ported yet: "
                f"this run would write no frames")
    sim = Simulation(cfg, device=device)
    if resume:
        sim.state = io_utils.load_checkpoint(resume, device=sim.device)
        print(f"Resumed from {resume} at t={sim.t:.4f}")
    os.makedirs(output_dir, exist_ok=True)
    frame_limit = frames if frames is not None else MAX_FRAMES

    with telemetry.profile_trace(profile_dir):
        frame_cnt = 0
        while frame_cnt < frame_limit:
            if cfg.scene.is_simulate:
                sim.frame()
            frame_cnt += 1
            if not quiet and frame_cnt % 20 == 0:
                stats = sim.telemetry()
                print(f"frame {frame_cnt}  t={stats['t']:.4f}  "
                      f"dt={stats['dt']:.2e}  "
                      f"steps/s={stats['steps_per_sec']:.2f}  "
                      f"rho_avg={stats['rho_avg']:.1f}")
            t = sim.t
            if checkpoint_every and frame_cnt % checkpoint_every == 0:
                io_utils.save_checkpoint(
                    os.path.join(output_dir, f"ckpt_{frame_cnt:06d}.npz"),
                    sim.state, meta={"frame": frame_cnt, "t": t})
            if t > max_sim_time:  # main.py:205-206
                break

    if not quiet:
        print("Final telemetry:", json.dumps(sim.telemetry()))
    return sim


def main(argv=None):
    parser = argparse.ArgumentParser(description="SPH on CUDA (PyTorch)")
    parser.add_argument("--config", type=str, default="default.json",
                        help="scene config json file")  # main.py:13-15 parity
    parser.add_argument("--frames", type=int, default=None)
    parser.add_argument("--output-dir", type=str, default="./output")
    parser.add_argument("--profile-dir", type=str, default=None,
                        help="write a torch.profiler Chrome trace of the "
                             "run into this directory")
    parser.add_argument("--checkpoint-every", type=int, default=0)
    parser.add_argument("--resume", type=str, default=None)
    parser.add_argument("--quiet", action="store_true")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device: cuda runs the CUDA kernels, "
                             "cpu their plain PyTorch versions")
    args = parser.parse_args(argv)

    cfg = read_config(args.config)
    t0 = time.time()
    run(cfg, frames=args.frames, output_dir=args.output_dir,
        profile_dir=args.profile_dir, checkpoint_every=args.checkpoint_every,
        resume=args.resume, quiet=args.quiet, device=args.device)
    print(f"Simulation time: {time.time() - t0}")  # main.py:211 parity


if __name__ == "__main__":
    main()
