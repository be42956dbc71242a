"""DFSPH: divergence-free SPH with warm start and adaptive CFL timestep.

Counterpart of `cfd_taichi_tpu/models/dfsph.py` (reference
dfsph_solver.py:1-445), its dense path: fluid-only scenes, and scenes with
a rigid body coupled both ways. The one-shot pair sums are CSR-stencil
passes of ops/stencil.py. The two loop matvecs run on one of
two engines, chosen per step by the JAX package's policy (store when it
fits, recompute beyond that; `cfd_taichi_tpu/models/dfsph.py:101-114`):

* the stored-coefficient engine (ops/coef.py, the counterpart of
  bandmat.CoefEngine): each step stores w = m gc(r) for every pair, in
  CSR form, and each loop iteration streams it. It runs whenever the
  store fits `COEF_BYTE_BUDGET`;
* the recompute engine (stencil.matvec / matvec_dot, the counterpart of
  the JAX window engine, bandmat.py:508-616): every iteration recomputes
  the coefficients from positions and stores nothing per pair.

A rigid body enters as JAX's dense coupled path has it
(`cfd_taichi_tpu/models/dfsph.py:499-583, 686-790`; ops/rigid.py): its
step-constant sums fold into the fluid's before the alpha factor, the
solid viscosity joins the external force, the loop-constant contact dot
C_s joins both loops' density rate, the body's speed joins the CFL
velocity, and in a two-way coupled scene each density iteration adds the
fluid's reaction to the body's per-particle force. The body moves in
models/rigid.step, after the fluid step.

The two pressure loops run on the device as JAX's do, through
ops/loops.while_loop_unrolled: `loop_unroll(scene)` gated iterations a
trip, each trip after the first a replay of one CUDA graph, and one host
read of the loop condition a trip. The conditions compare f32 tensors, and
the loop conditions, the f32 arithmetic and its quirks are the JAX
package's, line for line (`solve`); the diagnostics are built on
the device from the carried counters and residuals.
"""

from __future__ import annotations

import functools
from typing import Callable, NamedTuple

import torch

from cfd_taichi_tpu_torch.models import base
from cfd_taichi_tpu_torch.ops import coef, loops
from cfd_taichi_tpu_torch.ops import neighbors as nb
from cfd_taichi_tpu_torch.ops import rigid as rigid_ops
from cfd_taichi_tpu_torch.ops import stencil
from cfd_taichi_tpu_torch.ops.smoothing import f32, true_div
from cfd_taichi_tpu_torch.scene import RHO_0, Scene

MIN_ITER_DENSITY = 2          # dfsph_solver.py:21
DENSITY_THRESHOLD = 0.1       # percent of rho0 (dfsph_solver.py:22)
MAX_ITER_DENSITY = 500        # explicit cap for the reference's uncapped loop
MIN_ITER_DIV = 1              # dfsph_solver.py:23
MAX_ITER_DIV = 15             # dfsph_solver.py:24
DIV_THRESHOLD = 10.0          # dfsph_solver.py:25
STALL_EPS = 1e-5              # dfsph_solver.py:410
MIN_NEIGHBORS = 20            # dfsph_solver.py:259
MAX_DT = 1e-3                 # dfsph_solver.py:28
MIN_DT = 1e-5                 # dfsph_solver.py:29
VISCOSITY_C_S = 13.0
VISCOSITY_ALPHA = 0.08
TENSION_K = 0.5

# Byte budget for the stored-coefficient engine's pair store, P pairs of
# (int32 nbr, w): 12 GB is 15 % of the H100's 80 GB. breaking_dam_1m needs
# ~0.23 GB in f32 (28 M pairs from rest), so only scenes of tens of
# millions of particles fall back to the recompute engine. The budget also
# keeps P below 2^31 for the int32 offsets (12e9 / 6 bytes = 2e9 pairs).
COEF_BYTE_BUDGET = 12e9
# Storage dtype of w, the counterpart of the JAX package's BAND_DTYPE
# (bf16 there, chosen to fit a 16 GB chip). f32 here: under the engine's
# absolute-coordinate split, bf16 lanes amplify rounding by ~|x| / |x_ij|
# (~100x on breaking_dam_1m), and the store fits the card in f32.
# torch.bfloat16 is supported and held to the JAX bf16 engine.
COEF_DTYPE = torch.float32

# Gated iterations a trip of the pressure loops of DFSPH, IISPH and PCISPH
# (ops/loops.py), the counterpart of JAX's `LOOP_UNROLL` and `loop_unroll`
# (`cfd_taichi_tpu/models/dfsph.py:84-88`). One: with the trips after the
# first replayed from a graph, a trip costs a graph launch and a host read
# (tens of us), while every further iteration a trip is paid U times over
# where it is issued from Python (the first trip and the capture) and once
# in device time for each masked iteration after the last real one. On an
# NVIDIA H100 80GB HBM3 at 700 W (perf/loop_rates.py, PERF.md section 5),
# DFSPH on breaking_dam_30k stepped fastest at U = 1 in each of three runs
# (68.8-116.2 steps/s, 47.3-98.7 at 2, 44.1-72.0 at 4); at 1M U = 2 led
# U = 1 by 3-10 % for DFSPH and trailed it by 9-17 % for PCISPH, whose
# loop takes one iteration a step from rest. The tests set U = 3 through
# `loop_unroll`.
LOOP_UNROLL = 1


def loop_unroll(scene: Scene) -> int:
    """Iterations a trip of the scene's pressure loops."""
    return LOOP_UNROLL


def loop_args(scene: Scene, shard: base.Shard | None = None) -> dict:
    """Keyword arguments of ops/loops.while_loop_unrolled for the scene's
    pressure loops, on a rank of a sharded step its `agree` and `eager`."""
    return dict(unroll=loop_unroll(scene), pool=scene.loop_graphs,
                **(shard.loop if shard is not None else {}))


def coef_bytes(n_pairs: int, dtype: torch.dtype) -> int:
    return n_pairs * (4 + dtype.itemsize)


def use_coef_engine(n_pairs: int, dtype: torch.dtype) -> bool:
    return coef_bytes(n_pairs, dtype) <= COEF_BYTE_BUDGET


def init_state(scene: Scene) -> base.SimState:
    warm_k = torch.zeros(scene.n_fluid, dtype=torch.float32,
                         device=scene.device)
    return base.init_sim_state(scene, extra=(warm_k,))


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Row dot product of (N, 3) tensors, summed x + y + z like V3.dot."""
    return a[:, 0] * b[:, 0] + a[:, 1] * b[:, 1] + a[:, 2] * b[:, 2]


def dense_pre_terms(scene: Scene, ft: stencil.FluidTerms,
                    bt: stencil.BoundaryTerms | None,
                    rt: rigid_ops.RigidTerms | None = None):
    """rho, the alpha factor, the self-side loop coefficient S and the
    tension force from the one-shot sums (`cfd_taichi_tpu/models/
    dfsph.py:470-496`). The rigid sums `rt` of a coupled scene fold into
    the fluid's before the square (a pair is fluid or solid, as the
    reference's alpha_terms sums them). The boundary vector sum is squared
    separately from the fluid one: a reference quirk (dfsph_solver.py:
    32-51), kept."""
    rho = f32(base.DENSITY_EPS) + ft.rho
    S, qsum = ft.s, ft.qsum
    if rt is not None:
        rho = rho + rt.rho
        S = S + rt.s
        qsum = qsum + rt.qsum
    denom = dot(S, S) + qsum
    if bt is not None:
        rho = rho + bt.rho
        denom = denom + bt.qsum + dot(bt.s, bt.s)
        S = S + bt.s
    alpha = torch.where(torch.abs(denom) < f32(1e-6), torch.zeros_like(rho),
                        rho / denom)
    tension = ft.tvec * f32(-TENSION_K * scene.particle_m)
    return rho, alpha, S, tension


def loop_operators(matvec: Callable, matvec_dot: Callable, S: torch.Tensor,
                   counts: torch.Tensor, shard: base.Shard | None = None):
    """The DFSPH loop algebra (`cfd_taichi_tpu/models/dfsph.py:174-222`):

      stiff_vel_delta(k) = k S + matvec(k)     velocity change per unit dt
      rho_derivative(v, c_s) -> (dr, avg)      clamped density rate and its
                                               positive average
      rho_adv_residual(rho, dt, v, c_s) -> (rho_adv, avg)   clamped
                                               predicted density and its
                                               average
    c_s is the loop-constant solid contact dot of a coupled scene, which
    the density rate subtracts, or None (fluid-only: nothing subtracted).
    On a rank of a sharded step (`shard`) an average counts the rows the
    rank owns, its count and total summed over the ranks.
    """
    def average(sel, vals, empty):
        if shard is not None:
            sel = sel & shard.owned
        cnt = sel.sum()
        tot = torch.where(sel, vals, torch.zeros_like(vals)).sum()
        if shard is not None:
            cnt, tot = shard.sum(cnt, tot)
        return torch.where(cnt > 0, tot / cnt, empty(tot))

    def stiff_vel_delta(k_over_rho):
        return S * k_over_rho[:, None] + matvec(k_over_rho)

    def vel_dot_terms(v, c_s):
        d = dot(v, S) - matvec_dot(v)
        return d if c_s is None else d - c_s

    def rho_derivative(v, c_s=None):
        dr = vel_dot_terms(v, c_s)
        dr = torch.where(counts < MIN_NEIGHBORS, torch.zeros_like(dr),
                         torch.clamp(dr, min=0.0))
        return dr, average(dr > 0.0, dr, torch.zeros_like)

    def rho_adv_residual(rho, dt, v_adv, c_s=None):
        d = vel_dot_terms(v_adv, c_s)
        rho_adv = torch.clamp(rho + dt * d, min=RHO_0)
        return rho_adv, average(rho_adv != RHO_0, rho_adv,
                                lambda t: torch.full_like(t, RHO_0))

    return stiff_vel_delta, rho_derivative, rho_adv_residual


class _Pre(NamedTuple):
    """Sorted state and step-constant terms handed to `_finish_step`."""
    pos: torch.Tensor        # (N, 3) sorted positions
    oid: torch.Tensor | None
    vel: torch.Tensor
    acc: torch.Tensor | None
    warm_k: torch.Tensor
    rho: torch.Tensor
    alpha: torch.Tensor
    count: torch.Tensor      # fluid-only pair count (the < 20 skip)
    S: torch.Tensor          # (N, 3) self-side loop coefficient
    mv: Callable             # matvec
    mvd: Callable            # matvec_dot
    ext_force_fn: Callable   # vel -> (N, 3) tension + viscosity
    # (include_alpha, dt) -> (N,) the solid contact dot C_s; None without
    # a coupled body
    cs_fn: Callable | None = None
    # (k_over_rho, force) -> the body's (Nr, 3) force plus the fluid's
    # reaction; None unless the coupling is two-way
    scatter_fn: Callable | None = None


def loop_engine(scene: Scene, pos: torch.Tensor, starts: torch.Tensor,
                ft: stencil.FluidTerms) -> tuple[Callable, Callable]:
    """(matvec, matvec_dot) of a step's loops over the cell-sorted `pos`:
    the stored-coefficient engine when its pair store fits
    `COEF_BYTE_BUDGET` in `COEF_DTYPE`, else the recompute kernels. The
    counterpart of JAX's `build_dense_engine` (`cfd_taichi_tpu/models/
    dfsph.py:332`), which DFSPH and IISPH share."""
    grid, h, m = scene.grid, scene.h, scene.particle_m
    # The one host read of the prepare: the pair count sizes nbr and w.
    # (The loops read their condition once a trip anyway; an upper bound
    # from the count maximum would need a read too.) Summed in int64, so
    # that a scene far beyond the budget cannot wrap it.
    n_pairs = int(ft.count.sum(dtype=torch.int64))
    scene.loop_graphs.reads += 1
    if use_coef_engine(n_pairs, COEF_DTYPE):
        eng = coef.build_coef(pos, starts, grid, h, m,
                              coef.csr_offsets(ft.count), COEF_DTYPE,
                              n_pairs=n_pairs)
        return (functools.partial(coef.coef_matvec, eng, pos),
                functools.partial(coef.coef_matvec_dot, eng, pos))
    return (functools.partial(stencil.matvec, pos, starts, grid, h, m),
            functools.partial(stencil.matvec_dot, pos, starts, grid, h, m))


def prepare(scene: Scene, state: base.SimState) -> _Pre:
    """Cell sort plus the one-shot pair passes of a step; on a coupled
    scene also the body's cell table, its solid sums and the closures of
    the solid terms (`cfd_taichi_tpu/models/dfsph.py:499-583`)."""
    fluid = state.fluid
    (warm_k,) = state.extra
    scid, _, pos, (vel, warm_s, oid, acc) = base.sort_by_cells(
        scene.grid, fluid.pos, (fluid.vel, warm_k, fluid.oid, fluid.acc))
    starts = nb.csr_starts(scid, scene.grid.num_cells)
    return prepare_sorted(scene, state.rigid, pos, starts, vel, warm_s, oid,
                          acc)


def prepare_sorted(scene: Scene, rigid: base.RigidBodyState,
                   pos: torch.Tensor, starts: torch.Tensor,
                   vel: torch.Tensor, warm_k: torch.Tensor,
                   oid: torch.Tensor | None = None,
                   acc: torch.Tensor | None = None,
                   shard: base.Shard | None = None) -> _Pre:
    """`prepare` on rows already cell-sorted, with CSR `starts`: also the
    sharded step's (no `acc` to carry; `oid` -1 on the ghost rows), whose
    rho quirk table and reaction take the rank's hooks (`shard`)."""
    grid, h, m = scene.grid, scene.h, scene.particle_m
    ft, bt = base.one_shot_terms(scene, pos, starts)
    table, rt = base.body_terms(scene, rigid, pos)
    rho, alpha, S, tension = dense_pre_terms(scene, ft, bt, rt)
    mv, mvd = loop_engine(scene, pos, starts, ft)

    def ext_force_fn(v):
        visc = stencil.viscosity(pos, starts, grid, h, m, v, rho,
                                 VISCOSITY_C_S, VISCOSITY_ALPHA)
        if table is not None:
            visc = visc + base.solid_viscosity(scene, rigid, table, pos, v,
                                               rho, oid, VISCOSITY_C_S,
                                               VISCOSITY_ALPHA, shard)
        return tension + visc

    cs_fn = scatter_fn = None
    if table is not None:
        def cs_fn(include_alpha, dt):
            return rigid_ops.rigid_contact_dot(
                pos, table, grid, h, RHO_0,
                base.rigid_contact_vel(rigid, dt, include_alpha))

        if scene.fs_couple:
            def scatter_fn(k_over_rho, force):
                return base.body_reaction(scene, rigid, pos, starts,
                                          k_over_rho * f32(m), force, shard)

    return _Pre(pos=pos, oid=oid, vel=vel, acc=acc, warm_k=warm_k, rho=rho,
                alpha=alpha, count=ft.count, S=S, mv=mv, mvd=mvd,
                ext_force_fn=ext_force_fn, cs_fn=cs_fn,
                scatter_fn=scatter_fn)


def step(scene: Scene, state: base.SimState) -> base.SimState:
    return _finish_step(scene, state, prepare(scene, state))


def _finish_step(scene: Scene, state: base.SimState,
                 pre: _Pre) -> base.SimState:
    pos, vel, warm_k, dt, diag, rigid_force = solve(scene, pre, state.dt,
                                                    state.rigid)
    return state._replace(
        fluid=base.FluidState(pos=pos, vel=vel, acc=pre.acc, oid=pre.oid),
        rigid=state.rigid._replace(force=rigid_force),
        dt=dt,
        t=state.t + dt,
        step_count=state.step_count + 1,
        extra=(warm_k,),
        diag=diag)


def solve(scene: Scene, pre: _Pre, dt: torch.Tensor,
          rigid: base.RigidBodyState, shard: base.Shard | None = None):
    """Warm start, divergence solve, external forces and adaptive CFL dt,
    density solve, integration: the reference's step order
    (dfsph_solver.py:428-445) with the JAX package's arithmetic
    (`cfd_taichi_tpu/models/dfsph.py:686-790`). Returns the sorted rows'
    positions, velocities and warm-start stiffness, the new dt, the diag
    and the body's force.

    On a rank of a sharded step (`shard`, `cfd_taichi_tpu/parallel/
    domain.py:830-1036`) each stiffness reaches the ghost rows from their
    owners before it is applied, a loop updates the rows of `shard.upd`
    only, v_adv is traded once, and the averages and the CFL velocity are
    taken over the ranks. On a coupled scene the reaction of the rank's
    owned rows accumulates from zeros in the density loop and is summed
    over the ranks after it (`base.reaction_total`); the body is the same
    on every rank, so its speed joins the CFL velocity after the max over
    the ranks, and every rank takes one dt."""
    vel, warm_k = pre.vel, pre.warm_k
    rho, alpha = pre.rho, pre.alpha
    stiff_vel_delta, rho_derivative, rho_adv_residual = loop_operators(
        pre.mv, pre.mvd, pre.S, pre.count, shard)

    def kick(v, k_over_rho, dt):
        new = v - stiff_vel_delta(base.synced(shard, k_over_rho)) * dt
        return new if shard is None else torch.where(shard.upd[:, None],
                                                     new, v)

    # --- divergence solve (dfsph_solver.py:393-416) -------------------------
    # Warm start with the previous step's dt.
    vel = kick(vel, (warm_k / dt) / rho, dt)
    cs_div = pre.cs_fn(False, dt) if pre.cs_fn is not None else None
    dr0, avg0 = rho_derivative(vel, cs_div)
    loop_kw = loop_args(scene, shard)

    def div_cond(c):
        _, _, _, avg, stop, it = c
        return (((it < MIN_ITER_DIV) | (avg > f32(DIV_THRESHOLD)))
                & (it < MAX_ITER_DIV) & ~stop)

    def div_body(c):
        v, wk, dr, avg, _, it = c
        v = kick(v, (dr * alpha / dt) / rho, dt)
        wk = wk + dr * alpha    # sum_up_stiff (dfsph_solver.py:381)
        new_dr, new_avg = rho_derivative(v, cs_div)
        stop = torch.abs(new_avg - avg) < f32(STALL_EPS)
        return v, wk, new_dr, new_avg, stop, it + 1

    zero_i = torch.zeros((), dtype=torch.int32, device=vel.device)
    vel, warm_k, _, div_avg, _, div_iters = loops.while_loop_unrolled(
        div_cond, div_body,
        (vel, torch.zeros_like(warm_k), dr0, avg0,
         torch.zeros((), dtype=torch.bool, device=vel.device), zero_i),
        **loop_kw)

    # --- external forces + v_adv + adaptive dt (dfsph_solver.py:91-122) -----
    # Reference quirk kept: gravity joins the force and is divided by m.
    force_ext = base.gravity_acc(scene) + pre.ext_force_fn(vel)
    vel_adv = vel + force_ext * true_div(dt, f32(scene.particle_m))
    speed = torch.sqrt(dot(vel_adv, vel_adv))
    vel_adv = base.synced(shard, vel_adv)
    max_vel = speed.max() if shard is None else shard.max(speed)
    if scene.coupled:
        # The body's fastest particle joins the CFL velocity.
        spin = base.cross(rigid.omega, rigid.pos - rigid.centroid)
        max_vel = max_vel + (torch.sqrt((rigid.vel * rigid.vel).sum())
                             + torch.sqrt(dot(spin, spin))).max()
    cfl_dt = f32(0.4 * (2.0 * scene.particle_radius)) / max_vel * f32(0.2)
    dt = torch.clamp(cfl_dt, min=f32(MIN_DT), max=f32(MAX_DT))
    dt2 = dt * dt

    # --- density solve (dfsph_solver.py:221-233) ----------------------------
    # The contact dot with alpha dt, at the new dt; the body's force
    # gathers the fluid's reaction once an iteration (dfsph_solver.py:
    # 204-212). The residual carried is the one before the iteration's
    # update.
    cs_den = pre.cs_fn(True, dt) if pre.cs_fn is not None else None
    den_thresh = f32(DENSITY_THRESHOLD * RHO_0 * 0.01)

    def den_cond(c):
        _, avg, _, it = c
        return (((it < MIN_ITER_DENSITY) | (avg - RHO_0 > den_thresh))
                & (it < MAX_ITER_DENSITY))

    def den_body(c):
        v_adv, _, rforce, it = c
        rho_adv, avg = rho_adv_residual(rho, dt, v_adv, cs_den)
        k_over_rho = ((rho_adv - RHO_0) * alpha / dt2) / rho
        if pre.scatter_fn is not None:
            rforce = pre.scatter_fn(k_over_rho, rforce)
        v_adv = kick(v_adv, k_over_rho, dt)
        return v_adv, avg, rforce, it + 1

    vel_adv, den_avg, rigid_force, den_iters = loops.while_loop_unrolled(
        den_cond, den_body,
        (vel_adv, torch.full((), float("inf"), dtype=torch.float32,
                             device=vel.device),
         base.reaction_start(scene, rigid, shard), zero_i), **loop_kw)
    rigid_force = base.reaction_total(scene, rigid, rigid_force, shard)

    # --- position update (dfsph_solver.py:235-250) --------------------------
    new_pos = pre.pos + vel_adv * (dt * f32(base.ARTIFICIAL_FRICTION))
    new_vel = vel_adv * f32(base.ARTIFICIAL_FRICTION)
    if not scene.akinci:
        new_pos, new_vel = base.clamp_to_box(
            scene, new_pos, new_vel, margin=scene.particle_radius,
            decay_mul=-base.V_DECAY)
    # [divergence iters, divergence residual, density iters, density
    #  error] (dfsph_solver.py:233,416).
    diag = torch.stack([div_iters.float(), div_avg, den_iters.float(),
                        den_avg - RHO_0])
    return new_pos, new_vel, warm_k, dt, diag, rigid_force
