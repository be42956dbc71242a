"""Simulation driver: config -> scene -> solver steps -> frames, telemetry
and checkpoints.

Counterpart of `cfd_taichi_tpu/runner.py` (reference main.py:47-211): the
same JSON configs, frame structure (iter_cnt fluid steps, then iter_cnt
rigid-body steps where a body takes part, per frame), stopping rules (sim
time > `max_sim_time`, frame cap), `--profile-dir`, `check_nan` and
export cadence (main.py:184-201): with `scene.is_output_ply` a PLY of the
fluid each time the simulated time passes another 1 / output_fps, and an
OBJ of the body's mesh beside it where the scene has a body; with
`scene.is_output_gif` a PNG frame at the same cadence (utils/render.py,
false-coloured by `--color-by rho | neighbors`), and video.gif and
video.mp4 at the end. Frames need matplotlib and PIL, which a run that
asks for them imports before its first step.

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

import numpy as np
import torch

from cfd_taichi_tpu_torch import models
from cfd_taichi_tpu_torch.config import SimConfig, read_config
from cfd_taichi_tpu_torch.models import base
from cfd_taichi_tpu_torch.models import rigid as rigid_mod
from cfd_taichi_tpu_torch.ops import neighbors as nb
from cfd_taichi_tpu_torch.ops import rigid as rigid_ops
from cfd_taichi_tpu_torch.ops import stencil
from cfd_taichi_tpu_torch.scene import RHO_0, build_scene
from cfd_taichi_tpu_torch.utils import io as io_utils
from cfd_taichi_tpu_torch.utils import render, telemetry

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

    def particle_colors(self, mode: str) -> np.ndarray:
        """(N, 3) f32 colours of the fluid in state order: false colours by
        density or by neighbour count, the reference's visualize_rho /
        visualize_neighbour views (solver_base.py:219-245), or the fluid
        blue (ParticleSystem.py:117). mode: 'rho' | 'neighbors' | 'none'
        (`cfd_taichi_tpu/runner.py:85-107`)."""
        if mode == "rho":
            scalar = self.density().cpu().numpy()
        elif mode == "neighbors":
            scalar = self.neighbor_counts().cpu().numpy()
        else:
            rgb = np.zeros((self.scene.n_fluid, 3), np.float32)
            rgb[:, 1] = 0.28
            rgb[:, 2] = 1.0
            return rgb
        return telemetry.rgb_by_scalar(scalar)

    def neighbor_counts(self) -> torch.Tensor:
        """(N,) int32 neighbours of each fluid particle in state order: its
        fluid pairs (fluid_terms' count) and, where the body takes part in
        the step, the body's particles within h, as the JAX package's
        build_nbh counts them (`cfd_taichi_tpu/models/base.py:202-282`)."""
        sc = self.scene
        scid, perm, pos, _ = base.sort_by_cells(sc.grid, self.state.fluid.pos)
        starts = nb.csr_starts(scid, sc.grid.num_cells)
        count = stencil.fluid_terms(pos, starts, sc.grid, sc.h,
                                    sc.particle_m).count
        if sc.coupled:
            table = rigid_ops.rigid_table(sc.grid, self.state.rigid.pos,
                                          sc.rigid_volume)
            count = count + rigid_ops.rigid_counts(pos, table, sc.grid, sc.h)
        return torch.empty_like(count).index_put_((perm,), count)

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
        max_sim_time: float = MAX_SIM_TIME, color_by: str = "none",
        device="cuda") -> Simulation:
    sc = cfg.scene
    if sc.is_output_gif:
        render.require()
    sim = Simulation(cfg, device=device)
    if resume:
        sim.state = io_utils.load_checkpoint(resume, device=sim.device)
        print(f"Resumed from {resume} at t={sim.t:.4f}")
    os.makedirs(output_dir, exist_ok=True)
    frame_time = 1.0 / sc.output_fps           # main.py:81
    ply_cnt = 0
    gif_frames: list[str] = []
    output_frame_cnt = 0
    frame_limit = frames if frames is not None else MAX_FRAMES
    rgba = np.tile(np.array([[0.0, 0.26, 0.68, 1.0]], np.float32),
                   (sim.scene.n_fluid, 1))  # main.py:76, the first colour

    with telemetry.profile_trace(profile_dir):
        frame_cnt = 0
        while frame_cnt < frame_limit:
            if sc.is_simulate:
                sim.frame()
            frame_cnt += 1
            if not quiet and frame_cnt % 20 == 0:
                stats = sim.telemetry()
                print(f"frame {frame_cnt}  t={stats['t']:.4f}  "
                      f"dt={stats['dt']:.2e}  "
                      f"steps/s={stats['steps_per_sec']:.2f}  "
                      f"rho_avg={stats['rho_avg']:.1f}")
            t = sim.t
            if sc.is_output_ply and (t / frame_time) > ply_cnt:
                io_utils.write_ply_ascii(
                    os.path.join(output_dir, f"output_{ply_cnt:06d}.ply"),
                    sim.state.fluid.pos.cpu().numpy(), rgba)
                if sim.scene.rigid0 is not None:
                    io_utils.write_obj(
                        os.path.join(output_dir, f"obj_{ply_cnt:06d}.obj"),
                        sim.state.rigid.vertices.cpu().numpy(),
                        sim.scene.rigid0.faces)
                ply_cnt += 1
            if sc.is_output_gif and (t / frame_time) > output_frame_cnt:
                fluid_color = ((0.0, 0.28, 1.0) if color_by == "none"
                               else sim.particle_colors(color_by))
                clouds = [(sim.state.fluid.pos.cpu().numpy(), fluid_color,
                           sc.particle_radius)]
                if sim.rigid_enabled:
                    clouds.append((sim.state.rigid.pos.cpu().numpy(),
                                   (1.0, 0.0, 0.0), sc.particle_radius))
                fp = os.path.join(output_dir,
                                  f"frame_{output_frame_cnt:06d}.png")
                render.render_frame(fp, clouds, sc.cam_pos, sc.cam_look_at,
                                    sc.cam_up, sc.box_min, sc.box_max)
                gif_frames.append(fp)
                output_frame_cnt += 1
            if checkpoint_every and frame_cnt % checkpoint_every == 0:
                io_utils.save_checkpoint(
                    os.path.join(output_dir, f"ckpt_{frame_cnt:06d}.npz"),
                    sim.state, meta={"frame": frame_cnt, "t": t})
            if t > max_sim_time:  # main.py:205-206
                break

    if gif_frames:
        # video.gif and video.mp4 at exit (main.py:208-209)
        render.assemble_gif(gif_frames, os.path.join(output_dir, "video.gif"),
                            fps=sc.output_fps)
        render.assemble_mp4(gif_frames, os.path.join(output_dir, "video.mp4"),
                            fps=sc.output_fps)
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
    parser.add_argument("--color-by", type=str, default="none",
                        choices=["none", "rho", "neighbors"],
                        help="false-colour the PNG frames by density or "
                             "neighbour count (visualize_rho / "
                             "visualize_neighbour)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device: cuda runs the CUDA kernels, "
                             "cpu their plain PyTorch versions")
    args = parser.parse_args(argv)

    cfg = read_config(args.config)
    t0 = time.time()
    run(cfg, frames=args.frames, output_dir=args.output_dir,
        profile_dir=args.profile_dir, checkpoint_every=args.checkpoint_every,
        resume=args.resume, quiet=args.quiet, color_by=args.color_by,
        device=args.device)
    print(f"Simulation time: {time.time() - t0}")  # main.py:211 parity


if __name__ == "__main__":
    main()
