"""PBF: position-based fluids (Macklin & Mueller), one constraint pass.

Counterpart of `cfd_taichi_tpu/models/pbf.py` (reference pbf_solver.py:
1-187), as its dense step (`_step_dense`, `cfd_taichi_tpu/models/pbf.py:
57-141`). Like JAX's, it has no rigid coupling: the fluid steps as if a
body were not there, and the body falls or rests under gravity alone in
its own step (`cfd_taichi_tpu/models/pbf.py:21, 53`). The step:

* predicted positions from gravity (pbf_solver.py:26-30);
* density by poly6, C = max(rho / rho0 - 1, 0), lambda = -C / (|grad C_i|^2
  + sum_j |grad C_j|^2 + 1e-6) with spiky gradients over rho0, all at the
  start-of-step positions: one launch of the kernel `pbf_terms`
  (`stencil.pbf_constraint`), its fluid walk, its walls' walk, where the
  volume weights the density only (JAX's quirk, kept), and each row's C
  and lambda. Its fluid walk also stores the pairs it finds
  (`stencil.PairList`), which the two later passes stream;
* the position change (lambda_i gsum + sum_j lambda_j spiky_c x_ij + ssum)
  / rho0 with the quartic s_corr (k 1e-7 at 0.3 h) in ssum: the kernel
  `pbf_lambda` takes the one sum that depends on lambda_j;
* v = (x~ - x) / dt, on clamp scenes the clamp at a radius' margin with a
  POSITIVE 0.5 decay (pbf_solver.py:74-82, unlike the other solvers);
* XSPH viscosity c = 9e-6 over the start-of-step pairs with poly6 at the
  updated positions: the kernel `pbf_xsph`.

No loop, and one host read: the size of the pair list (`stencil.
pair_rows`), read right after the cell sort, so that the host waits on the
sort alone. A step is the cell sort, three pair passes and elementwise
work. JAX's dense step takes w_ref = poly6(0.3 h) as
a host double closed form and uses f32(1 / w_ref) (`cfd_taichi_tpu/models/
pbf.py:74-75`); so does this one.
"""

from __future__ import annotations

import math

import torch

from cfd_taichi_tpu_torch.models import base
from cfd_taichi_tpu_torch.ops import neighbors as nb
from cfd_taichi_tpu_torch.ops import stencil
from cfd_taichi_tpu_torch.ops.smoothing import f32
from cfd_taichi_tpu_torch.scene import RHO_0, Scene

EPSILON = 1.0e-6          # pbf_solver.py:17
TENSION_K = 1e-7          # s_corr strength k (pbf_solver.py:19)
XSPH_C = 9e-6             # viscosity c (pbf_solver.py:20)
S_CORR_FACTOR = 0.3       # pbf_solver.py:21
# rho0, epsilon and the density's seed of the constraint pass
# (stencil.pbf_constraint's last three arguments)
ROW_CONSTANTS = (RHO_0, EPSILON, base.DENSITY_EPS)


def init_state(scene: Scene) -> base.SimState:
    return base.init_sim_state(scene, extra=())


def w_ref(h: float) -> float:
    """poly6(0.3 h) in Python double, as JAX's dense step takes it."""
    t = 1.0 - S_CORR_FACTOR**2
    return 315.0 / (64.0 * math.pi * h**3) * t**3


def step(scene: Scene, state: base.SimState) -> base.SimState:
    fluid, dt = state.fluid, state.dt
    scid, _, pos, (vel_s, oid, acc) = base.sort_by_cells(
        scene.grid, fluid.pos, (fluid.vel, fluid.oid, fluid.acc))
    starts = nb.csr_starts(scid, scene.grid.num_cells)
    rows = stencil.pair_rows(starts, scene.grid, scid)
    scene.loop_graphs.reads += 1
    new_pos, new_vel, _ = solve(scene, pos, starts, vel_s, dt, rows=rows)
    return state._replace(
        # acc is the previous step's, in sorted order, as JAX returns it.
        fluid=base.FluidState(pos=new_pos, vel=new_vel, acc=acc, oid=oid),
        t=state.t + dt,
        step_count=state.step_count + 1)


def solve(scene: Scene, pos: torch.Tensor, starts: torch.Tensor,
          vel_s: torch.Tensor, dt: torch.Tensor,
          shard: base.Shard | None = None,
          rows: stencil.PairRows | None = None):
    """The step on cell-sorted rows with CSR `starts`: the new positions
    and velocities, and the density constraint. `rows` is where the pair
    list goes (`stencil.pair_rows`), made here, with its host read, where
    the caller has none. On a rank of a sharded
    step (`shard`, `cfd_taichi_tpu/parallel/domain.py:1402-1493`) the
    constraint pass needs no trade (its chain from an owned row is two
    hops, inside the 2h halo), and the updated positions and velocities
    reach the ghost rows from their owners before XSPH reads them."""
    grid, h, m = scene.grid, scene.h, scene.particle_m
    wr = w_ref(h)
    if rows is None:
        rows = stencil.pair_rows(starts, grid, nb.cell_id(pos, grid))
        scene.loop_graphs.reads += 1

    # --- external force + predicted positions (pbf_solver.py:26-30) ---------
    vel = vel_s + base.gravity_acc(scene) * dt
    pos_predict = pos + vel * dt

    # --- density, constraint and lambda (pbf_solver.py:32-52, 127-130,
    # 166-174): one launch, the rows' algebra in its epilogue -------------
    walls = base.walls(scene)
    (constraint, lam, gsum, ssum), pairs = stencil.pbf_constraint(
        pos, starts, grid, h, m, wr, TENSION_K, rows, walls,
        *ROW_CONSTANTS)

    # --- delta positions with s_corr (pbf_solver.py:55-65, 144-164) ---------
    # Fluid pairs: sum (lam_i + lam_j + s_corr) spiky_c x_ij
    #            = lam_i gsum + pbf_lambda(lam) + ssum; boundary pairs carry
    #              lam_i (+ s_corr) only, folded into gsum and ssum.
    delta_pos = ((gsum * lam[:, None]
                  + stencil.pbf_lambda(pos, pairs, h, lam) + ssum)
                 * f32(1.0 / RHO_0))

    # --- position/velocity update + XSPH (pbf_solver.py:67-96) --------------
    pos_predict = pos_predict + delta_pos
    new_vel = (pos_predict - pos) * torch.reciprocal(dt)
    if walls is None:
        pos_predict, new_vel = base.clamp_to_box(
            scene, pos_predict, new_vel, margin=scene.particle_radius,
            decay_mul=base.V_DECAY)  # positive decay (pbf_solver.py:78, 82)
    new_pos = pos_predict
    if shard is not None:
        pv = shard.sync(torch.cat([new_pos, new_vel], dim=1))
        new_pos, new_vel = pv[:, :3].contiguous(), pv[:, 3:].contiguous()
    new_vel = new_vel + f32(XSPH_C) * stencil.pbf_xsph(pairs, h, new_pos,
                                                       new_vel)
    return new_pos, new_vel, constraint
