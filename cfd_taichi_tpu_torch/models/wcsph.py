"""WCSPH: weakly compressible SPH with the Tait equation of state.

Counterpart of `cfd_taichi_tpu/models/wcsph.py` (reference
wcsph_solver.py:1-144), as its dense step (`_step_dense`,
`cfd_taichi_tpu/models/wcsph.py:58-153`):

* Tait pressure p = B ((rho/rho0)^gamma - 1), gamma 7, B 70000, with
  rho clamped to rho0 from below (wcsph_solver.py:21-22, 86-90);
* one pair pass for the symmetric pressure gradient, Monaghan viscosity
  (c_s 10) and cohesion (k 0.2): the `wcsph_forces` kernel;
* the Akinci boundary pressure acceleration -p'_i sum_b rho0 V_b gc x_ib,
  which is -p' times boundary_terms' row sum s (wcsph_solver.py:92-100);
* semi-implicit Euler with 0.9998 damping, and on clamp scenes the box
  clamp at a diameter's margin with -0.5 velocity decay
  (wcsph_solver.py:49-63);
* a rigid body as JAX's dense coupled path has it (`cfd_taichi_tpu/models/
  wcsph.py:96-136`; ops/rigid.py): its density sum after the walls', the
  solid pressure acceleration -p' S_s and viscosity branch, and in a
  two-way coupled scene the fluid's reaction u = p' m on the body's force
  (wcsph_solver.py:102-129).

No loop and no host read: a step is the cell sort, three pair passes
(fluid_terms, boundary_terms on walls, wcsph_forces), with a body its
three passes (rigid_terms, rigid_viscosity, rigid_side_force) and
elementwise work.
rho is fluid_terms' sum m W over pairs j != i, the sum JAX's
`dense_rho_count` takes (self excluded, bandmat.py:1201).
"""

from __future__ import annotations

import torch

from cfd_taichi_tpu_torch.models import base
from cfd_taichi_tpu_torch.ops import stencil
from cfd_taichi_tpu_torch.ops.smoothing import f32, true_div
from cfd_taichi_tpu_torch.scene import RHO_0, Scene

GAMMA = 7.0
B_STIFF = 70000.0
VISCOSITY_C_S = 10.0
VISCOSITY_ALPHA = 0.08
TENSION_K = 0.2
WCSPH_DAMPING = 0.9998  # wcsph_solver.py:51


def init_state(scene: Scene) -> base.SimState:
    return base.init_sim_state(scene, extra=())


def tait_pressure(rho: torch.Tensor) -> torch.Tensor:
    rho_c = torch.clamp(rho, min=RHO_0)
    return B_STIFF * (torch.pow(true_div(rho_c, RHO_0), GAMMA) - 1.0)


def step(scene: Scene, state: base.SimState) -> base.SimState:
    fluid, rigid, dt = state.fluid, state.rigid, state.dt
    perm, pos, starts, rho, bt = base.sorted_density(scene, fluid.pos)
    oid = fluid.oid[perm]
    new_pos, new_vel, acc, rigid_force = solve(
        scene, pos, starts, fluid.vel[perm], rho, bt, dt, rigid, oid)
    return state._replace(
        fluid=base.FluidState(pos=new_pos, vel=new_vel, acc=acc, oid=oid),
        rigid=rigid._replace(force=rigid_force),
        t=state.t + dt,
        step_count=state.step_count + 1)


def solve(scene: Scene, pos: torch.Tensor, starts: torch.Tensor,
          vel: torch.Tensor, rho: torch.Tensor,
          bt: stencil.BoundaryTerms | None, dt: torch.Tensor,
          rigid: base.RigidBodyState, oid: torch.Tensor | None = None,
          shard: base.Shard | None = None):
    """The step on cell-sorted rows with CSR `starts` and their density
    (`base.density`): the new positions and velocities, the acceleration
    and the body's force. Also the sharded step's: with no loop, each
    owned row's neighbourhood lies in the 2h halo (`cfd_taichi_tpu/
    parallel/domain.py:1307-1399`); the rank's hooks (`shard`) serve the
    rho quirk's table and the reaction of its owned rows, summed over the
    ranks."""
    grid, h, m = scene.grid, scene.h, scene.particle_m
    table, rt, box = base.body_terms(scene, rigid, pos)
    if rt is not None:
        rho = rho + rt.rho

    # --- pressure phase (reference wcsph_solver.py:32-38) -------------------
    p = tait_pressure(rho)
    p_over_rho2 = p / (rho * rho)
    acc = base.gravity_acc(scene) + stencil.wcsph_forces(
        pos, starts, grid, h, m, vel, rho, p_over_rho2, VISCOSITY_C_S,
        VISCOSITY_ALPHA, TENSION_K)
    if bt is not None:
        acc = acc - bt.s * p_over_rho2[:, None]
    rigid_force = rigid.force
    if table is not None:
        # The solid pressure term -p' S_s, the solid viscosity and the
        # reaction p' m (wcsph_solver.py:117-129).
        acc = acc - rt.s * p_over_rho2[:, None]
        acc = acc + base.solid_viscosity(scene, rigid, table, box, pos, vel,
                                         rho, oid, VISCOSITY_C_S,
                                         VISCOSITY_ALPHA, shard)
        if scene.fs_couple:
            rigid_force = base.step_reaction(scene, rigid, pos, starts,
                                             p_over_rho2 * f32(m), shard)

    # --- kinematic phase (reference wcsph_solver.py:40-63) ------------------
    new_vel = (vel + acc * dt) * f32(WCSPH_DAMPING)
    new_pos = pos + new_vel * dt
    if not scene.akinci:
        new_pos, new_vel = base.clamp_to_box(
            scene, new_pos, new_vel, margin=2.0 * scene.particle_radius,
            decay_mul=-base.V_DECAY)
    return new_pos, new_vel, acc, rigid_force


def density_error(scene: Scene, state: base.SimState) -> torch.Tensor:
    """Average |rho - rho0| / rho0 (`cfd_taichi_tpu/models/wcsph.py:233`)."""
    rho = base.sorted_density(scene, state.fluid.pos)[3]
    return true_div(torch.mean(torch.abs(rho - RHO_0)), RHO_0)
