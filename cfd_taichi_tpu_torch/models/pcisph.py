"""PCISPH: predictive-corrective incompressible SPH.

Counterpart of `cfd_taichi_tpu/models/pcisph.py` (reference
pcisph_solver.py:1-241) for fluid-only scenes, as its dense step
(`_step_dense`, `cfd_taichi_tpu/models/pcisph.py:170-333`):

* the stiffness delta, once at init, from the particle with the most fluid
  neighbours (the first such in cell-sorted order, as `jnp.argmax` takes
  it), beta = 2 dt0^2 m^2 / rho0^2; checkpoints carry it as the state's
  one extra leaf;
* the external force gravity + tension + viscosity (c_s 13, alpha 0.08),
  from the one-shot passes DFSPH has (fluid_terms, boundary_terms on
  walls, viscosity);
* the pressure force, linear in p:
      F(p) = -(m / rho0^2) (p S_f + mv(p)) - S_b (m p / rho_i^2)
  with mv the DFSPH loop engine's matvec (`dfsph.loop_engine`: the
  stored-coefficient kernels when the pair store fits, the recompute
  kernel beyond that);
* the predict pass: v, x from the force, the clamp at a radius' margin
  with -0.5 decay on clamp scenes, then the density at the predicted
  positions over the start-of-step pair set (`stencil.pcisph_predict_rho`)
  less rho0;
* the loop p <- max(p + err delta, 0) while the average positive density
  error exceeds 0.1 % of rho0, 1 to 80 iterations; integration with 0.9999
  damping.

The loop runs on the host, as DFSPH's and IISPH's do: each iteration reads
its residual back with one `.item()` and compares in np.float32.
"""

from __future__ import annotations

import numpy as np
import torch

from cfd_taichi_tpu_torch.models import base
from cfd_taichi_tpu_torch.models.dfsph import dot, loop_engine
from cfd_taichi_tpu_torch.ops import neighbors as nb
from cfd_taichi_tpu_torch.ops import stencil
from cfd_taichi_tpu_torch.ops.smoothing import (CubicConstants,
                                                cubic_grad_coeff, f32,
                                                true_div)
from cfd_taichi_tpu_torch.scene import RHO_0, Scene

RHO_MAX_ERR_PERCENT = 0.1   # pcisph_solver.py:19
MIN_ITER = 1
MAX_ITER = 80
VISCOSITY_C_S = 13.0        # solver_base.py:24-26
VISCOSITY_ALPHA = 0.08
TENSION_K = 0.5


def stiffness(scene: Scene) -> torch.Tensor:
    """() f32 delta = 1 / ((|sum grad W|^2 + sum |grad W|^2) beta) of the
    seed lattice's particle with the most fluid neighbours
    (`cfd_taichi_tpu/models/pcisph.py:43-58`, pcisph_solver.py:28-45)."""
    grid, h, m = scene.grid, scene.h, scene.particle_m
    scid, _, pos, _ = base.sort_by_cells(grid, scene.fluid_pos0)
    starts = nb.csr_starts(scid, grid.num_cells)
    count = stencil.fluid_terms(pos, starts, grid, h, m).count
    i = int(torch.argmax(count))     # the first of the densest
    x = pos[i] - pos
    r2 = x[:, 0] * x[:, 0] + x[:, 1] * x[:, 1] + x[:, 2] * x[:, 2]
    pairs = r2 <= CubicConstants.of(h).h2
    pairs[i] = False
    x = x[pairs]
    gradw = x * cubic_grad_coeff(torch.sqrt(r2[pairs]), h)[:, None]
    grad_sum = gradw.sum(dim=0, keepdim=True)
    grad_sq_sum = dot(gradw, gradw).sum()
    beta = scene.dt0**2 * m**2 * 2.0 / RHO_0**2
    one = torch.ones((), dtype=torch.float32, device=pos.device)
    return one / ((dot(grad_sum, grad_sum)[0] + grad_sq_sum) * f32(beta))


def init_state(scene: Scene) -> base.SimState:
    return base.init_sim_state(scene, extra=(stiffness(scene),))


def positive_avg(err: torch.Tensor) -> torch.Tensor:
    """Average of the strictly positive density errors, 0 where there is
    none (`cfd_taichi_tpu/models/pcisph.py:61-71`)."""
    sel = err > 0.0
    cnt = sel.sum()
    total = torch.where(sel, err, torch.zeros_like(err)).sum()
    return torch.where(cnt > 0, total / cnt, torch.zeros_like(total))


def step(scene: Scene, state: base.SimState) -> base.SimState:
    fluid, dt = state.fluid, state.dt
    (delta,) = state.extra
    grid, h, m = scene.grid, scene.h, scene.particle_m
    scid, _, pos, (vel, oid, acc) = base.sort_by_cells(
        grid, fluid.pos, (fluid.vel, fluid.oid, fluid.acc))
    starts = nb.csr_starts(scid, grid.num_cells)

    ft, bt = base.one_shot_terms(scene, pos, starts)
    rho = f32(base.DENSITY_EPS) + ft.rho
    if bt is not None:
        rho = rho + bt.rho
    inv_rho2 = torch.reciprocal(rho * rho)
    mv, _ = loop_engine(scene, pos, starts, ft)
    walls = base.walls(scene)

    # --- external forces (pcisph_solver.py:220-226) -------------------------
    tension = ft.tvec * f32(-TENSION_K * m)
    viscosity = stencil.viscosity(pos, starts, grid, h, m, vel, rho,
                                  VISCOSITY_C_S, VISCOSITY_ALPHA)
    ext_force = base.gravity_acc(scene) + tension + viscosity
    dt_over_m = true_div(dt, f32(m))

    def press_force_of(p):
        """(pcisph_solver.py:109-119, 169-198)"""
        f = (ft.s * p[:, None] + mv(p)) * f32(-m / RHO_0**2)
        if bt is not None:
            f = f + bt.s * (-m * p * inv_rho2)[:, None]
        return f

    def predict(press_force):
        """Density error at the predicted positions (pcisph_solver.py:
        72-101, 135-154)."""
        vel_p = vel + (ext_force + press_force) * dt_over_m
        pos_p = pos + vel_p * dt
        if walls is None:
            pos_p, _ = base.clamp_to_box(scene, pos_p, vel_p,
                                         margin=scene.particle_radius,
                                         decay_mul=-base.V_DECAY)
        return stencil.pcisph_predict_rho(pos, starts, grid, h, m, pos_p,
                                          walls, RHO_0) - RHO_0

    # --- predictive-corrective loop (pcisph_solver.py:47-70) ----------------
    err_thresh = np.float32(RHO_0 * RHO_MAX_ERR_PERCENT * 0.01)
    p = torch.zeros_like(rho)
    press_force = torch.zeros_like(pos)
    rho_err = predict(press_force)
    res = np.float32(positive_avg(rho_err).item())
    it = 0
    while (res > err_thresh or it < MIN_ITER) and it < MAX_ITER:
        p = torch.clamp(p + rho_err * delta, min=0.0)
        press_force = press_force_of(p)
        rho_err = predict(press_force)
        res = np.float32(positive_avg(rho_err).item())
        it += 1

    # --- integration (pcisph_solver.py:200-217) -----------------------------
    new_vel = ((vel + (ext_force + press_force) * dt_over_m)
               * f32(base.ARTIFICIAL_FRICTION))
    new_pos = pos + new_vel * dt
    if walls is None:
        new_pos, new_vel = base.clamp_to_box(
            scene, new_pos, new_vel, margin=scene.particle_radius,
            decay_mul=-base.V_DECAY)

    return state._replace(
        # acc is the previous step's, in sorted order, as JAX returns it.
        fluid=base.FluidState(pos=new_pos, vel=new_vel, acc=acc, oid=oid),
        t=state.t + dt,
        step_count=state.step_count + 1,
        extra=(delta,),
        # [iterations, average positive density error, 0, 0]
        # (pcisph_solver.py:70).
        diag=torch.tensor([it, res, 0.0, 0.0], dtype=torch.float32,
                          device=new_pos.device))
