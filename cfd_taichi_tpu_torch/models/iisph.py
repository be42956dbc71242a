"""IISPH: implicit incompressible SPH, a relaxed Jacobi pressure solve.

Counterpart of `cfd_taichi_tpu/models/iisph.py` (reference
iisph_solver.py:1-349), as its dense step (`_step_dense`,
`cfd_taichi_tpu/models/iisph.py:284-401`): every pair sum
reduces to the one-shot passes the port has (fluid_terms, boundary_terms,
viscosity) and to the DFSPH loop engine's two products
(`dfsph.loop_engine`: the stored-coefficient kernels when the pair store
fits, the recompute kernels beyond that):

  d_ii    = -dt^2/rho^2 (S_f + S_b)
  rho_adv = rho + dt [v_adv . (S_f + S_b) - mvd(v_adv)]
  a_ii    = d_ii . (S_f + S_b) - dt^2 m/rho^2 (qsum/m + g2_b)
  d_ij(p) = -dt^2 mv(p/rho^2)
  r_sum   = d_ij . (S_f + S_b) - mvd(d_ij) - mvd(d_ii p) + dt^2 qsum/rho^2 p

so an iteration is one matvec and two matvec_dots. The loop runs on the
device as DFSPH's does (ops/loops.while_loop_unrolled: one host read of
its condition a trip), compares in f32 tensors and follows JAX's control
flow (`jacobi_loop`): the warm start p0 = 0.5 p_past, the residual of the
post-update p against the pre-update r_sum, the reference's hard-coded
1000 in it, and the break on any rise of the residual from the second
iteration on (which may stop the loop above its 0.1 % contract, as the
reference does).

A rigid body enters as JAX's dense coupled path has it (`cfd_taichi_tpu/
models/iisph.py:327-383`; ops/rigid.py, as in models/dfsph.py): its sums
fold into rho, S_all and g2 before the walls' (so S_s joins d_ii, a_ii and
r_sum), its viscosity branch the advection force, the contact dot of the
body's velocity (alpha dt included) rho_adv, and in a two-way coupled
scene the fluid's reaction u = p m / rho^2 of the solved pressure the
body's force, once a step.
"""

from __future__ import annotations

from typing import Callable

import torch

from cfd_taichi_tpu_torch.models import base, dfsph
from cfd_taichi_tpu_torch.models.dfsph import dot, loop_engine
from cfd_taichi_tpu_torch.ops import loops
from cfd_taichi_tpu_torch.ops import neighbors as nb
from cfd_taichi_tpu_torch.ops import rigid as rigid_ops
from cfd_taichi_tpu_torch.ops import stencil
from cfd_taichi_tpu_torch.ops.smoothing import f32, true_div
from cfd_taichi_tpu_torch.scene import RHO_0, Scene

OMEGA = 0.5              # relaxation (iisph_solver.py:26)
MAX_ITER = 180           # iisph_solver.py:27
MIN_ITER = 1
RHO_ERR_PERCENT = 0.1    # iisph_solver.py:29
RESIDUAL_REF = 1000.0    # hard-coded in the residual (iisph_solver.py:109)
VISCOSITY_C_S = 13.0
VISCOSITY_ALPHA = 0.08
TENSION_K = 0.5


def init_state(scene: Scene) -> base.SimState:
    p_past = torch.zeros(scene.n_fluid, dtype=torch.float32,
                         device=scene.device)
    return base.init_sim_state(scene, extra=(p_past,))


def dense_pre_terms(scene: Scene, ft: stencil.FluidTerms,
                    bt: stencil.BoundaryTerms | None,
                    rt: rigid_ops.RigidTerms | None = None):
    """rho, the self-side sum S_f (+ S_s) + S_b, the solid and boundary g2
    sum and the tension force from the one-shot sums (`cfd_taichi_tpu/
    models/iisph.py:169-189`): the rigid sums `rt` of a coupled scene
    before the walls', in JAX's order."""
    rho = f32(base.DENSITY_EPS) + ft.rho
    S_all = ft.s
    g2_sb = torch.zeros_like(rho)
    if rt is not None:
        rho = rho + rt.rho
        S_all = S_all + rt.s
        g2_sb = g2_sb + rt.g2
    if bt is not None:
        rho = rho + bt.rho
        S_all = S_all + bt.s
        g2_sb = g2_sb + bt.g2
    tension = ft.tvec * f32(-TENSION_K * scene.particle_m)
    return rho, S_all, g2_sb, tension


def dense_jacobi_ops(mv: Callable, mvd: Callable, qsum: torch.Tensor,
                     S_all: torch.Tensor, inv_rho2: torch.Tensor,
                     d_ii: torch.Tensor, dt2: torch.Tensor):
    """d_ij_of(p) and r_sum_of(p, d_ij) of an iteration (`cfd_taichi_tpu/
    models/iisph.py:192-204`), the two matvec_dots kept apart and
    bracketed as JAX brackets them."""
    cP = dt2 * inv_rho2 * qsum  # the d_ji correction's row constant

    def d_ij_of(p):
        return mv(p * inv_rho2) * (-dt2)

    def r_sum_of(p, d_ij):
        return (dot(d_ij, S_all) - mvd(d_ij) - mvd(d_ii * p[:, None])
                + cP * p)

    return d_ij_of, r_sum_of


def dense_residual_fn(a_ii: torch.Tensor, rho_adv: torch.Tensor,
                      shard: base.Shard | None = None):
    """The positive-pressure residual average (`cfd_taichi_tpu/models/
    iisph.py:266-281`; RESIDUAL_REF keeps the hard-coded 1000). On a rank
    of a sharded step (`shard`) it counts the rows the rank owns, its
    count and total summed over the ranks."""
    def residual_of(p, r_sum):
        active = p > 0.0
        if shard is not None:
            active = active & shard.owned
        cnt = active.to(torch.float32).sum()
        total = torch.where(active, a_ii * p + r_sum + rho_adv - RESIDUAL_REF,
                            torch.zeros_like(p)).sum()
        if shard is not None:
            cnt, total = shard.sum(cnt, total)
        return torch.where(cnt > 0, total / cnt, torch.zeros_like(total))

    return residual_of


def jacobi_loop(d_ij_of: Callable, r_sum_of: Callable, residual_of: Callable,
                p0: torch.Tensor, a_ii: torch.Tensor, rho_adv: torch.Tensor,
                unroll: int = 1, pool: loops.GraphPool | None = None,
                shard: base.Shard | None = None):
    """The reference's `pressure_solve` (iisph_solver.py:78-99) with JAX's
    control flow (`cfd_taichi_tpu/models/iisph.py:207-263`), on the device
    (ops/loops.while_loop_unrolled, `unroll` iterations a trip). Per
    iteration: d_ij <- d_ij_of(p); r_sum <- r_sum_of(p, d_ij); p <-
    max(relaxed Jacobi update, 0); res <- residual_of(p, r_sum), the
    post-update p against the pre-update r_sum; stop on res rising from
    the second iteration on. Returns (p, d_ij, r_sum, res, iterations),
    the last two 0-d tensors. On a rank of a sharded step (`shard`) the
    updated p reaches the ghost rows from their owners."""
    err_thresh = f32(RHO_ERR_PERCENT * RHO_0 * 0.01)
    solvable = torch.abs(a_ii) > f32(1e-7)

    def cond(c):
        _, _, _, res, stop, it = c
        return ((res > err_thresh) | (it < MIN_ITER)) & (it < MAX_ITER) & ~stop

    def body(c):
        p, _, _, res, _, it = c
        d_ij = d_ij_of(p)
        r_sum = r_sum_of(p, d_ij)
        p_new = torch.where(solvable,
                            (1.0 - OMEGA) * p
                            + OMEGA * (RHO_0 - rho_adv - r_sum) / a_ii,
                            torch.zeros_like(p))
        p = base.synced(shard, torch.clamp(p_new, min=0.0))
        new_res = residual_of(p, r_sum)
        stop = (it >= 1) & (new_res - res > 0.0)
        return p, d_ij, r_sum, new_res, stop, it + 1

    dev = p0.device
    p, d_ij, r_sum, res, _, it = loops.while_loop_unrolled(
        cond, body,
        (p0, torch.zeros(p0.shape[0], 3, dtype=p0.dtype, device=dev),
         torch.zeros_like(p0),
         torch.full((), float("inf"), dtype=torch.float32, device=dev),
         torch.zeros((), dtype=torch.bool, device=dev),
         torch.zeros((), dtype=torch.int32, device=dev)), unroll, pool,
        **(shard.loop if shard is not None else {}))
    return p, d_ij, r_sum, res, it


def step(scene: Scene, state: base.SimState) -> base.SimState:
    fluid, rigid, dt = state.fluid, state.rigid, state.dt
    (p_past,) = state.extra
    scid, _, pos, (vel, oid, p_past, acc) = base.sort_by_cells(
        scene.grid, fluid.pos, (fluid.vel, fluid.oid, p_past, fluid.acc))
    starts = nb.csr_starts(scid, scene.grid.num_cells)
    new_pos, new_vel, p_iter, diag, rigid_force = solve(
        scene, pos, starts, vel, p_past, dt, rigid, oid)
    return state._replace(
        # acc is the previous step's, in sorted order, as JAX returns it.
        fluid=base.FluidState(pos=new_pos, vel=new_vel, acc=acc, oid=oid),
        rigid=rigid._replace(force=rigid_force),
        t=state.t + dt,
        step_count=state.step_count + 1,
        extra=(p_iter,),
        diag=diag)


def solve(scene: Scene, pos: torch.Tensor, starts: torch.Tensor,
          vel: torch.Tensor, p_past: torch.Tensor, dt: torch.Tensor,
          rigid: base.RigidBodyState, oid: torch.Tensor | None = None,
          shard: base.Shard | None = None):
    """The step on cell-sorted rows with CSR `starts`: the new positions,
    velocities and pressures, the diag and the body's force. On a rank of
    a sharded step (`shard`, `cfd_taichi_tpu/parallel/domain.py:
    1197-1304`) the warm start and each iteration's pressure reach the
    ghost rows from their owners, the residual is taken over the ranks,
    and the reaction of the rank's owned rows is summed over the ranks."""
    grid, m = scene.grid, scene.particle_m
    dt2 = dt * dt
    ft, bt = base.one_shot_terms(scene, pos, starts)
    table, rt = base.body_terms(scene, rigid, pos)
    rho, S_all, g2_sb, tension = dense_pre_terms(scene, ft, bt, rt)
    inv_rho2 = torch.reciprocal(rho * rho)
    mv, mvd = loop_engine(scene, pos, starts, ft)

    # --- predict advection (iisph_solver.py:36-75) ---------------------------
    viscosity = stencil.viscosity(pos, starts, grid, scene.h, m, vel, rho,
                                  VISCOSITY_C_S, VISCOSITY_ALPHA)
    if table is not None:
        viscosity = viscosity + base.solid_viscosity(
            scene, rigid, table, pos, vel, rho, oid, VISCOSITY_C_S,
            VISCOSITY_ALPHA, shard)
    f_adv = base.gravity_acc(scene) + tension + viscosity
    v_adv = vel + f_adv * true_div(dt, f32(m))

    d_ii = S_all * (-dt2 * inv_rho2)[:, None]
    rho_adv = rho + dt * (dot(v_adv, S_all) - mvd(v_adv))
    if table is not None:
        # The solid velocity term of rho_adv, the body's contact velocity
        # with alpha dt (iisph_solver.py:325-334).
        rho_adv = rho_adv - dt * rigid_ops.rigid_contact_dot(
            pos, table, grid, scene.h, RHO_0,
            base.rigid_contact_vel(rigid, dt, include_alpha=True))
    a_ii = (dot(d_ii, S_all)
            - dt2 * f32(m) * inv_rho2 * (true_div(ft.qsum, f32(m)) + g2_sb))

    # --- relaxed Jacobi solve (iisph_solver.py:78-147) ----------------------
    p0 = base.synced(shard, 0.5 * p_past)  # warm start (iisph_solver.py:67)
    d_ij_of, r_sum_of = dense_jacobi_ops(mv, mvd, ft.qsum, S_all, inv_rho2,
                                         d_ii, dt2)
    p_iter, d_ij, _, res, iters = jacobi_loop(
        d_ij_of, r_sum_of, dense_residual_fn(a_ii, rho_adv, shard), p0, a_ii,
        rho_adv, dfsph.loop_unroll(scene), scene.loop_graphs, shard)

    # --- integration (iisph_solver.py:150-206) ------------------------------
    m_over_dt2 = torch.full_like(dt2, f32(m)) / dt2
    f_press = (d_ij + d_ii * p_iter[:, None]) * m_over_dt2
    rigid_force = rigid.force
    if table is not None and scene.fs_couple:
        # compute_rigid_force (iisph_solver.py:150-160), once a step
        rigid_force = base.step_reaction(scene, rigid, pos, starts,
                                         p_iter * inv_rho2 * f32(m), shard)
    new_vel = ((v_adv + f_press * true_div(dt, f32(m)))
               * f32(base.ARTIFICIAL_FRICTION))
    new_pos = pos + new_vel * dt
    if not scene.akinci:
        new_pos, new_vel = base.clamp_to_box(
            scene, new_pos, new_vel, margin=scene.particle_radius,
            decay_mul=-base.V_DECAY)

    zero = torch.zeros_like(res)
    # [iterations, residual, 0, 0] (iisph_solver.py:96).
    return new_pos, new_vel, p_iter, \
        torch.stack([iters.float(), res, zero, zero]), rigid_force
