"""PCISPH: predictive-corrective incompressible SPH.

Counterpart of `cfd_taichi_tpu/models/pcisph.py` (reference
pcisph_solver.py:1-241), as its dense step (`_step_dense`,
`cfd_taichi_tpu/models/pcisph.py:170-333`), on fluid-only scenes and on
scenes with a rigid body:

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
* a rigid body enters as JAX's dense coupled path has it (`cfd_taichi_tpu/
  models/pcisph.py:212-287`; ops/rigid.py, as in models/dfsph.py): its
  density sum joins the fluid's after the walls', its viscosity branch the
  external force, the pressure force gains -S_s u with u = p m / rho^2,
  the predicted density a third walk over the body (which keeps its
  positions through the step), and in a two-way coupled scene each
  iteration adds the fluid's reaction u to the body's force;
* the loop p <- max(p + err delta, 0) while the average positive density
  error exceeds 0.1 % of rho0, 1 to 80 iterations; integration with 0.9999
  damping.

The loop runs on the device, as DFSPH's and IISPH's do
(ops/loops.while_loop_unrolled: one host read of its condition a trip),
and compares in f32 tensors.
"""

from __future__ import annotations

import torch

from cfd_taichi_tpu_torch.models import base, dfsph
from cfd_taichi_tpu_torch.models.dfsph import dot, loop_engine
from cfd_taichi_tpu_torch.ops import loops
from cfd_taichi_tpu_torch.ops import neighbors as nb
from cfd_taichi_tpu_torch.ops import rigid as rigid_ops
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
    seed lattice's particle with the most neighbours
    (`cfd_taichi_tpu/models/pcisph.py:43-58`, pcisph_solver.py:28-45).
    Where a body takes part in the step, its particles as built are
    neighbours too, each counted and its grad W summed as a fluid
    particle's, as JAX's neighbour list holds them (`cfd_taichi_tpu/
    models/base.py:215-221`; the reference's grid, ParticleSystem.py:
    399-407)."""
    grid, h, m = scene.grid, scene.h, scene.particle_m
    scid, _, pos, _ = base.sort_by_cells(grid, scene.fluid_pos0)
    starts = nb.csr_starts(scid, grid.num_cells)
    count = stencil.fluid_terms(pos, starts, grid, h, m).count
    nbrs, rows = pos, torch.arange(pos.shape[0], device=pos.device)
    if scene.coupled:
        body = scene.rigid0.pos
        table = rigid_ops.rigid_table(grid, body, scene.rigid_volume)
        count = count + rigid_ops.rigid_counts(pos, table, grid, h)
        # summed in the order of JAX's list, which gives its delta bit for
        # bit: cell by cell, a cell's fluid particles, then its body's
        nbrs = torch.cat([pos, body])
        rows = torch.sort(nb.cell_id(nbrs, grid), stable=True)[1]
        nbrs = nbrs[rows]
    i = int(torch.argmax(count))     # the first of the densest
    x = pos[i] - nbrs
    r2 = x[:, 0] * x[:, 0] + x[:, 1] * x[:, 1] + x[:, 2] * x[:, 2]
    pairs = (r2 <= CubicConstants.of(h).h2) & (rows != i)
    x = x[pairs]
    gradw = x * cubic_grad_coeff(torch.sqrt(r2[pairs]), h)[:, None]
    grad_sum = gradw.sum(dim=0, keepdim=True)
    grad_sq_sum = dot(gradw, gradw).sum()
    beta = scene.dt0**2 * m**2 * 2.0 / RHO_0**2
    one = torch.ones((), dtype=torch.float32, device=pos.device)
    return one / ((dot(grad_sum, grad_sum)[0] + grad_sq_sum) * f32(beta))


def init_state(scene: Scene) -> base.SimState:
    return base.init_sim_state(scene, extra=(stiffness(scene),))


def positive_avg(err: torch.Tensor,
                 shard: base.Shard | None = None) -> torch.Tensor:
    """Average of the strictly positive density errors, 0 where there is
    none (`cfd_taichi_tpu/models/pcisph.py:61-71`). On a rank of a sharded
    step (`shard`) it counts the rows the rank owns, its count and total
    summed over the ranks."""
    sel = err > 0.0
    if shard is not None:
        sel = sel & shard.owned
    cnt = sel.sum()
    total = torch.where(sel, err, torch.zeros_like(err)).sum()
    if shard is not None:
        cnt, total = shard.sum(cnt, total)
    return torch.where(cnt > 0, total / cnt, torch.zeros_like(total))


def step(scene: Scene, state: base.SimState) -> base.SimState:
    fluid, rigid, dt = state.fluid, state.rigid, state.dt
    (delta,) = state.extra
    scid, _, pos, (vel, oid, acc) = base.sort_by_cells(
        scene.grid, fluid.pos, (fluid.vel, fluid.oid, fluid.acc))
    starts = nb.csr_starts(scid, scene.grid.num_cells)
    new_pos, new_vel, diag, rigid_force = solve(scene, pos, starts, vel,
                                                delta, dt, rigid, oid)
    return state._replace(
        # acc is the previous step's, in sorted order, as JAX returns it.
        fluid=base.FluidState(pos=new_pos, vel=new_vel, acc=acc, oid=oid),
        rigid=rigid._replace(force=rigid_force),
        t=state.t + dt,
        step_count=state.step_count + 1,
        diag=diag)


def solve(scene: Scene, pos: torch.Tensor, starts: torch.Tensor,
          vel: torch.Tensor, delta: torch.Tensor, dt: torch.Tensor,
          rigid: base.RigidBodyState, oid: torch.Tensor | None = None,
          shard: base.Shard | None = None):
    """The step on cell-sorted rows with CSR `starts`: the new positions
    and velocities, the diag and the body's force. On a rank of a sharded
    step (`shard`, `cfd_taichi_tpu/parallel/domain.py:1039-1194`) each
    iteration's pressure reaches the ghost rows from their owners, the
    residual is taken over the ranks, and on a coupled scene the reaction
    of the rank's owned rows accumulates from zeros in the loop and is
    summed over the ranks after it (`base.reaction_total`)."""
    grid, h, m = scene.grid, scene.h, scene.particle_m
    ft, bt = base.one_shot_terms(scene, pos, starts)
    rho = f32(base.DENSITY_EPS) + ft.rho
    if bt is not None:
        rho = rho + bt.rho
    table, rt = base.body_terms(scene, rigid, pos)
    if rt is not None:
        rho = rho + rt.rho
    inv_rho2 = torch.reciprocal(rho * rho)
    mv, _ = loop_engine(scene, pos, starts, ft)
    walls = base.walls(scene)

    # --- external forces (pcisph_solver.py:220-226) -------------------------
    tension = ft.tvec * f32(-TENSION_K * m)
    viscosity = stencil.viscosity(pos, starts, grid, h, m, vel, rho,
                                  VISCOSITY_C_S, VISCOSITY_ALPHA)
    if table is not None:
        viscosity = viscosity + base.solid_viscosity(
            scene, rigid, table, pos, vel, rho, oid, VISCOSITY_C_S,
            VISCOSITY_ALPHA, shard)
    ext_force = base.gravity_acc(scene) + tension + viscosity
    dt_over_m = true_div(dt, f32(m))

    def press_force_of(p, rigid_force):
        """The pressure force and the body's force with the fluid's
        reaction (pcisph_solver.py:109-119, 169-198)."""
        f = (ft.s * p[:, None] + mv(p)) * f32(-m / RHO_0**2)
        if rt is not None:
            # Solid pairs: -S_s u, with the reaction of the same u charged
            # once a pair from the rigid side.
            u = p * inv_rho2 * f32(m)
            f = f - rt.s * u[:, None]
            if scene.fs_couple:
                rigid_force = base.body_reaction(scene, rigid, pos, starts,
                                                 u, rigid_force, shard)
        if bt is not None:
            f = f + bt.s * (-m * p * inv_rho2)[:, None]
        return f, rigid_force

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
                                          walls, RHO_0, table) - RHO_0

    # --- predictive-corrective loop (pcisph_solver.py:47-70) ----------------
    err_thresh = f32(RHO_0 * RHO_MAX_ERR_PERCENT * 0.01)
    force0 = torch.zeros_like(pos)
    rho_err0 = predict(force0)

    def cond(c):
        _, _, _, res, _, it = c
        return ((res > err_thresh) | (it < MIN_ITER)) & (it < MAX_ITER)

    def body(c):
        p, _, rho_err, _, rigid_force, it = c
        p = base.synced(shard, torch.clamp(p + rho_err * delta, min=0.0))
        force, rigid_force = press_force_of(p, rigid_force)
        rho_err = predict(force)
        return (p, force, rho_err, positive_avg(rho_err, shard), rigid_force,
                it + 1)

    _, press_force, _, res, rigid_force, iters = loops.while_loop_unrolled(
        cond, body,
        (torch.zeros_like(rho), force0, rho_err0,
         positive_avg(rho_err0, shard),
         base.reaction_start(scene, rigid, shard),
         torch.zeros((), dtype=torch.int32, device=pos.device)),
        **dfsph.loop_args(scene, shard))
    rigid_force = base.reaction_total(scene, rigid, rigid_force, shard)

    # --- integration (pcisph_solver.py:200-217) -----------------------------
    new_vel = ((vel + (ext_force + press_force) * dt_over_m)
               * f32(base.ARTIFICIAL_FRICTION))
    new_pos = pos + new_vel * dt
    if walls is None:
        new_pos, new_vel = base.clamp_to_box(
            scene, new_pos, new_vel, margin=scene.particle_radius,
            decay_mul=-base.V_DECAY)

    zero = torch.zeros_like(res)
    # [iterations, average positive density error, 0, 0]
    # (pcisph_solver.py:70).
    return new_pos, new_vel, torch.stack([iters.float(), res, zero, zero]), \
        rigid_force
