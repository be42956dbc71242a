"""Observability: steps/sec counter, NaN/Inf validation, density
statistics, a torch.profiler trace scope and false colours by a scalar.

Counterpart of `cfd_taichi_tpu/utils/telemetry.py:20-121` (reference
main.py:22, 89-124, 174-176, solver_base.py:145-164, 219-245 and the
solvers' residual prints).
"""

from __future__ import annotations

import contextlib
import os
import time

import numpy as np
import torch


class StepTimer:
    """Wall-clock steps/sec with pause accounting (main.py:89-124 analogue)."""

    def __init__(self):
        self.start = time.perf_counter()
        self.steps = 0
        self.sim_time = 0.0
        self._paused_total = 0.0
        self._pause_start = None

    def pause(self):
        if self._pause_start is None:
            self._pause_start = time.perf_counter()

    def resume(self):
        if self._pause_start is not None:
            self._paused_total += time.perf_counter() - self._pause_start
            self._pause_start = None

    def tick(self, n_steps: int = 1, sim_dt: float = 0.0):
        self.steps += n_steps
        self.sim_time += sim_dt

    @property
    def wall(self) -> float:
        end = self._pause_start or time.perf_counter()
        return end - self.start - self._paused_total

    @property
    def steps_per_sec(self) -> float:
        w = self.wall
        return self.steps / w if w > 0 else 0.0

    def summary(self) -> dict:
        return {
            "steps": self.steps,
            "wall_s": round(self.wall, 3),
            "steps_per_sec": round(self.steps_per_sec, 3),
            "sim_time_s": round(self.sim_time, 5),
        }


def check_valid(pos: torch.Tensor, vel: torch.Tensor,
                acc: torch.Tensor) -> torch.Tensor:
    """Count of particles with NaN/Inf in any (N, 3) pos/vel/acc row
    (reference check_valid, solver_base.py:145-164)."""
    bad = None
    for arr in (pos, vel, acc):
        b = ~torch.isfinite(arr).all(dim=-1)
        bad = b if bad is None else (bad | b)
    return bad.sum()


def rigid_invalid(rigid) -> torch.Tensor:
    """Count of NaN/Inf values in a rigid body's state (models/base.
    RigidBodyState): its particles, forces and body quantities."""
    return sum((~torch.isfinite(t)).sum() for t in rigid)


def density_stats(rho, rho_0: float = 1000.0) -> dict:
    """Residual telemetry matching the reference's per-step prints
    (dfsph_solver.py:233,416)."""
    rho = np.asarray(rho.cpu() if isinstance(rho, torch.Tensor) else rho)
    err = np.maximum(rho - rho_0, 0.0)
    pos_cnt = int((err > 0).sum())
    return {
        "rho_min": float(rho.min()),
        "rho_max": float(rho.max()),
        "rho_avg": float(rho.mean()),
        "avg_pos_err": float(err.sum() / pos_cnt) if pos_cnt else 0.0,
        "avg_err_pct": float(np.abs(rho - rho_0).mean() / rho_0 * 100.0),
    }


@contextlib.contextmanager
def profile_trace(log_dir: str | None):
    """torch.profiler trace scope (counterpart of Taichi's kernel profiler,
    main.py:22,174-176): writes `trace.json`, a Chrome trace of the host
    and, where a card is present, its kernels, into `log_dir`. No-op when
    log_dir is None."""
    if log_dir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def rgb_by_scalar(value: np.ndarray) -> np.ndarray:
    """(N, 3) f32 false colours by a scalar normalised to [0, 1] (density or
    neighbour count), the reference's visualize_rho / visualize_neighbour
    (solver_base.py:219-245): rgb = (0, 0.28, normalised); all 1 where the
    scalar is constant."""
    value = np.asarray(value, np.float32)
    vmin, vmax = value.min(), value.max()
    b = (value - vmin) / (vmax - vmin) if vmax > vmin else np.ones_like(value)
    rgb = np.zeros((value.shape[0], 3), np.float32)
    rgb[:, 1] = 0.28
    rgb[:, 2] = b
    return rgb
