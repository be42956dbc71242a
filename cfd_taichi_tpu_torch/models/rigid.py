"""Impulse-based rigid body step with box-collision response.

Counterpart of `cfd_taichi_tpu/models/rigid.py` (reference rigid_solver.py:
1-234), in plain PyTorch on the body's device: the body holds 10^2-10^4
particles, and the JAX package computes the step with XLA reductions, not a
Pallas kernel.

  * torque from the fluid's forces, alpha = I^-1 tau, omega += alpha dt
    (compute_attitude, rigid_solver.py:118-128);
  * incremental rotation of the particles, vertices and I^-1 about the
    centroid, with the reference's swapped-Euler rotation (rotation,
    rigid_solver.py:130-141);
  * kinematics: F = the sum of the (then zeroed) fluid forces, a = F/M + g,
    box collision with the displacement clamped (the reference's atomic
    max/min, rigid_solver.py:53-77, as masked reductions), impulse
    response j = K^-1 (v' - v) with K = 1/M - r~ I^-1 r~, friction 0.8,
    restitution decay 0.1 (rigid_solver.py:87-116).

The impulse is computed every step and selected where a particle collided
(JAX's `lax.cond(cnt > 0, ...)` becomes a masked select), so that a step
reads nothing back to the host.
"""

from __future__ import annotations

import torch

from cfd_taichi_tpu_torch.models.base import RigidBodyState, cross
from cfd_taichi_tpu_torch.ops.smoothing import f32, ieee_sqrt
from cfd_taichi_tpu_torch.scene import Scene, rotation3d_swapped

MU_T = 0.8       # friction (rigid_solver.py:108)
MU_N = 0.1       # restitution decay v_decay_proportion (rigid_solver.py:24)


def _skew(v: torch.Tensor) -> torch.Tensor:
    zero = torch.zeros_like(v[0])
    return torch.stack([torch.stack([zero, -v[2], v[1]]),
                        torch.stack([v[2], zero, -v[0]]),
                        torch.stack([-v[1], v[0], zero])])


def _norm(v: torch.Tensor) -> torch.Tensor:
    return ieee_sqrt((v * v).sum())


def _collision_response(v: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """New contact-point velocity: tangential friction scaling and normal
    restitution (reference compute_new_vel, rigid_solver.py:106-116)."""
    v_n = (v * n).sum() * n
    v_t = v - v_n
    vt_norm = torch.clamp(_norm(v_t), min=f32(1e-12))
    a = torch.clamp(1.0 - f32(MU_T * (1.0 + MU_N)) * _norm(v_n) / vt_norm,
                    min=0.0)
    return a * v_t - f32(MU_N) * v_n


def _matvec(rot: torch.Tensor, rel: torch.Tensor) -> torch.Tensor:
    """(Nr, 3) rows rot @ rel_i, each component r_a0 x + r_a1 y + r_a2 z
    as the JAX package sums it (`ops/vec.py` matvec)."""
    return (rel[:, 0, None] * rot[:, 0] + rel[:, 1, None] * rot[:, 1]
            + rel[:, 2, None] * rot[:, 2])


def body_bbox(rigid: RigidBodyState, particle_radius: float):
    """The body's AABB relative to its centroid (reference init_boundary,
    rigid_solver.py:194-210), with its quirk: the intended one-diameter
    shrink of the upper corner subtracts and adds back the same vector."""
    rel = rigid.pos - rigid.centroid
    lo, hi = rel.min(dim=0).values, rel.max(dim=0).values
    d = f32(2.0 * particle_radius)
    hi = hi - d + d  # rigid_solver.py:207-208 (intended shrink; a no-op)
    return lo, hi


def check_penetration(scene: Scene, rigid: RigidBodyState,
                      fluid_pos: torch.Tensor, bbox=None) -> torch.Tensor:
    """() int32: fluid particles inside the body's AABB, the reference's
    debug penetration count (check_penetrate, rigid_solver.py:164-192,
    disabled at rigid_solver.py:234)."""
    if scene.n_rigid == 0:
        return torch.zeros((), dtype=torch.int32, device=fluid_pos.device)
    lo, hi = bbox if bbox is not None else body_bbox(
        rigid, scene.particle_radius)
    rel = fluid_pos - rigid.centroid
    inside = ((rel > lo) & (rel < hi)).all(dim=1)
    return inside.sum().to(torch.int32)


def step(scene: Scene, rigid: RigidBodyState,
         dt: torch.Tensor) -> RigidBodyState:
    """One step of the body under the forces the fluid step left in
    `rigid.force`, with the fluid step's dt."""
    if scene.n_rigid == 0:
        return rigid
    g = scene.gravity_acc
    mass = scene.rigid_mass_total
    c0 = rigid.centroid

    # --- compute_attitude (rigid_solver.py:118-128) -------------------------
    rel = rigid.pos - c0
    torque = cross(rel, rigid.force).sum(dim=0)
    alpha = rigid.inertia_inv @ torque
    omega = rigid.omega + alpha * dt
    attitude = omega * dt

    # --- rotation (rigid_solver.py:130-141) ---------------------------------
    rot = rotation3d_swapped(-attitude)
    pos = _matvec(rot, rel) + c0
    vertices = _matvec(rot, rigid.vertices - c0) + c0
    inertia_inv = rot @ rigid.inertia_inv @ rot.T

    # --- kinematic (rigid_solver.py:33-104) ---------------------------------
    acc = rigid.force.sum(dim=0) / mass + g
    vel = rigid.vel + acc * dt
    ori_disp = vel * dt
    lo, hi = scene.rigid_box

    # Contact-point velocities v = vel + omega x (x + ori_disp - centroid).
    vc = cross(omega, (pos - c0) + ori_disp) + vel
    predicted = pos + ori_disp
    viol_lo = predicted <= lo
    viol_hi = predicted >= hi
    # Displacement clamping (the reference's atomic max/min,
    # rigid_solver.py:58, 67) as masked reductions, per axis.
    inf = torch.full_like(pos, float("inf"))
    disp = torch.maximum(
        ori_disp, torch.where(viol_lo, lo - pos, -inf).max(dim=0).values)
    disp = torch.minimum(
        disp, torch.where(viol_hi, hi - pos, inf).min(dim=0).values)
    col_lo = viol_lo & (vc < 0.0)
    col_hi = viol_hi & (vc > 0.0)
    col_any = col_lo | col_hi                            # (Nr, 3)
    cnt = col_any.sum()
    # Collision normal per axis: +1 for a hit on the upper side, else -1
    # for the lower side (the reference's last-writer race resolved with
    # the upper side first, as JAX does).
    one = torch.ones_like(vel)
    norm = torch.where(col_hi.any(dim=0), one,
                       torch.where(col_lo.any(dim=0), -one,
                                   torch.zeros_like(vel)))
    # Mean collision point, with the reference's arithmetic: (sum of the
    # colliding positions + ori_disp) / cnt - centroid (rigid_solver.py:81),
    # a particle counted once for each axis it hit on.
    psum = torch.where(col_any[:, :, None], pos[:, None, :],
                       torch.zeros_like(pos[:, None, :])).sum(dim=(0, 1))
    col_point = (psum + ori_disp) / torch.clamp(cnt, min=1) - c0

    v = vel + cross(omega, col_point)
    v_new = _collision_response(v, norm)
    pm = _skew(col_point)
    k = torch.eye(3, dtype=torch.float32, device=vel.device) / mass \
        - pm @ inertia_inv @ pm
    imp = torch.linalg.solve_ex(k, v_new - v)[0]
    hit = cnt > 0
    vel = torch.where(hit, vel + imp / mass, vel)
    omega = torch.where(hit, omega + inertia_inv @ cross(col_point, imp),
                        omega)

    return rigid._replace(
        pos=pos + disp, vertices=vertices + disp, vel=vel, omega=omega,
        alpha=alpha, acc=acc, force=torch.zeros_like(rigid.force),
        centroid=c0 + disp, inertia_inv=inertia_inv)
