"""The fluid-rigid pair passes of a coupled step: the counterpart of
`cfd_taichi_tpu/ops/rigid_dense.py`.

A rigid body is a small particle set (10^2-10^4 voxels against 10^4-10^6
fluid particles) that moves, so every fluid step sorts it anew on the
fluid's grid (`rigid_table`: cell-sorted positions and volumes, their CSR
offsets, and `lid`, the original rigid index of each sorted slot). Four
passes walk it, each a hand-written CUDA kernel with a plain PyTorch
version and a wrapper, as in ops/stencil.py (whose note says how the three
fit together; the launch counts are rows of `stencil.KERNELS`):

* `rigid_terms` (csrc/rigid_terms.cu): each cell-sorted fluid query's
  step-constant solid sums over the rigid particles in its stencil,
  w_s = rho0 V_j, c the gradient factor:
      rho_s = sum w_s W,  S_s = sum w_s c x_ij,  qsum_s = sum (w_s c r)^2,
      g2_s = sum w_s c^2 r^2 (IISPH's; computed here so that IISPH's
      coupling reuses the pass);
* `rigid_contact_dot` (second entry of csrc/rigid_terms.cu): the solid
  velocity dot sum w_s c x_ij . v_r[lid_j] of a rigid per-particle
  velocity in original order, DFSPH's loop-constant C_s;
* `rigid_viscosity` (csrc/rigid_viscosity.cu): the solid branch of the
  Monaghan viscosity, the body's linear velocity on the rigid side and
  the neighbour density read through `lid` from a per-rigid table (the
  reference's rho quirk, models/dfsph.py says which);
* `rigid_side_force` (csrc/rigid_side_force.cu): the fluid's reaction on
  each rigid particle, in original order, over the cell-sorted fluid's CSR
  table: F_j += sum_i rho0 V_j c (x_i - x_j) u_i. JAX computes it from the
  rigid side, one pair once, with no scatter; so does the kernel, one
  thread a rigid particle and no atomics, so that a run repeats bit for
  bit and the card can be held to the CPU.

Pairs are those with r2 <= f32(h)^2 at the start-of-step positions, r =
sqrt(max(r2, 1e-24)) (`_geom0`, rigid_dense.py:118-127); the reaction
also needs r <= h, as JAX's list does (rigid_dense.py:272). W and c take
q = r * f32(1/h), the product XLA makes of JAX's jitted r / h
(smoothing.cubic_w, cubic_grad_coeff).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from cfd_taichi_tpu_torch.ops import neighbors as nb
from cfd_taichi_tpu_torch.ops.smoothing import (CubicConstants,
                                                cubic_grad_coeff, cubic_w,
                                                f32)
from cfd_taichi_tpu_torch.ops.stencil import (KERNELS, _check, _launch,
                                              _on_cuda, _pair_chunks,
                                              _params, _rowsum, _rowsum3)


class RigidTable(NamedTuple):
    """A rigid body cell-sorted on the fluid's grid."""
    pos: torch.Tensor     # (Nr, 3) f32 sorted positions
    vol: torch.Tensor     # (Nr,) f32 V_j, same order
    lid: torch.Tensor     # (Nr,) int32 original rigid index of each slot
    starts: torch.Tensor  # (num_cells + 1,) int32 CSR offsets


class RigidTerms(NamedTuple):
    """Step-constant solid sums of each cell-sorted fluid query."""
    rho: torch.Tensor    # (N,)  sum w_s W
    s: torch.Tensor      # (N, 3) sum w_s c x_ij
    qsum: torch.Tensor   # (N,)  sum (w_s c r)^2
    g2: torch.Tensor     # (N,)  sum w_s c^2 r^2


def rigid_table(grid: nb.GridSpec, pos: torch.Tensor,
                vol: torch.Tensor) -> RigidTable:
    """Stable sort of the body's (Nr, 3) `pos` by (clamped) cell id, with
    its volumes, `lid` and CSR offsets (rigid_dense.py:78, 94-102)."""
    table = nb.build_cell_table(pos, grid)
    return RigidTable(pos=pos[table.order], vol=vol[table.order],
                      lid=table.order.to(torch.int32), starts=table.starts)


def _check_table(t: RigidTable, grid: nb.GridSpec,
                 device: torch.device) -> int:
    nr = t.pos.shape[0]
    _check("rigid pos", t.pos, torch.float32, (nr, 3), device)
    _check("rigid vol", t.vol, torch.float32, (nr,), device)
    _check("rigid lid", t.lid, torch.int32, (nr,), device)
    _check("rigid starts", t.starts, torch.int32, (grid.num_cells + 1,),
           device)
    return nr


def _rigid_viscosity_constants(h: float, c_s: float, alpha: float,
                               eps: float) -> tuple[float, float]:
    """nu = f32(2 alpha h c_s) and (f32(eps) h) h in f32, as
    rigid_dense.py:216, 224 form them."""
    hf = CubicConstants.of(h).h
    return f32(2.0 * alpha * h * c_s), f32(f32(f32(eps) * hf) * hf)


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------

def rigid_terms(pos: torch.Tensor, table: RigidTable, grid: nb.GridSpec,
                h: float, rho0: float) -> RigidTerms:
    """R1: the four solid sums of the cell-sorted fluid `pos` over the
    body's `table` (replaces rigid_dense.build_rigid_windows +
    rigid_terms)."""
    if not _on_cuda("rigid_terms", pos):
        return rigid_terms_plain(pos, table, grid, h, rho0)
    n = pos.shape[0]
    _check("pos", pos, torch.float32, (n, 3), pos.device)
    nr = _check_table(table, grid, pos.device)
    out = RigidTerms(rho=pos.new_empty(n), s=pos.new_empty(n, 3),
                     qsum=pos.new_empty(n), g2=pos.new_empty(n))
    _launch("rigid_terms", pos.device, pos, n, table.pos, table.vol,
            table.starts, nr, ctypes.byref(_params(grid, h)), f32(rho0),
            *out)
    return out


def rigid_contact_dot(pos: torch.Tensor, table: RigidTable,
                      grid: nb.GridSpec, h: float, rho0: float,
                      v_r: torch.Tensor) -> torch.Tensor:
    """R2: (N,) sum_j w_s c x_ij . v_r[lid_j] of the (Nr, 3) rigid
    velocities `v_r` in original order (replaces rigid_dense.
    contact_dot_op)."""
    if not _on_cuda("rigid_contact_dot", pos):
        return rigid_contact_dot_plain(pos, table, grid, h, rho0, v_r)
    n = pos.shape[0]
    _check("pos", pos, torch.float32, (n, 3), pos.device)
    nr = _check_table(table, grid, pos.device)
    _check("v_r", v_r, torch.float32, (nr, 3), pos.device)
    out = pos.new_empty(n)
    _launch("rigid_contact_dot", pos.device, pos, n, table.pos, table.vol,
            table.lid, table.starts, nr, ctypes.byref(_params(grid, h)),
            f32(rho0), v_r, out)
    return out


def rigid_viscosity(pos: torch.Tensor, table: RigidTable, grid: nb.GridSpec,
                    h: float, rho0: float, m: float, vel: torch.Tensor,
                    rho: torch.Tensor, rho_quirk: torch.Tensor,
                    body_vel: torch.Tensor, c_s: float, alpha: float,
                    eps: float = 0.01) -> torch.Tensor:
    """R3: (N, 3) the solid branch of the Monaghan viscosity under
    compression, already scaled by m: the body's linear velocity
    `body_vel` (3,) on the rigid side and the neighbour density
    rho_quirk[lid_j] of the (Nr,) table in original order (replaces
    rigid_dense.viscosity_op)."""
    if not _on_cuda("rigid_viscosity", pos):
        return rigid_viscosity_plain(pos, table, grid, h, rho0, m, vel, rho,
                                     rho_quirk, body_vel, c_s, alpha, eps)
    n = pos.shape[0]
    _check("pos", pos, torch.float32, (n, 3), pos.device)
    nr = _check_table(table, grid, pos.device)
    _check("vel", vel, torch.float32, (n, 3), pos.device)
    _check("rho", rho, torch.float32, (n,), pos.device)
    _check("rho_quirk", rho_quirk, torch.float32, (nr,), pos.device)
    _check("body_vel", body_vel, torch.float32, (3,), pos.device)
    out = pos.new_empty(n, 3)
    _launch("rigid_viscosity", pos.device, pos, n, table.pos, table.vol,
            table.lid, table.starts, nr, ctypes.byref(_params(grid, h)),
            f32(rho0), f32(m),
            *_rigid_viscosity_constants(h, c_s, alpha, eps), vel, rho,
            rho_quirk, body_vel, out)
    return out


def rigid_side_force(rpos: torch.Tensor, rvol: torch.Tensor,
                     pos: torch.Tensor, starts: torch.Tensor,
                     grid: nb.GridSpec, h: float, rho0: float,
                     u: torch.Tensor, force: torch.Tensor) -> torch.Tensor:
    """R4: (Nr, 3) force + sum_i rho0 V_j c (x_i - x_j) u_i of each rigid
    particle j in original order (`rpos`, `rvol`) over the cell-sorted
    fluid `pos` with CSR `starts`, pairs with r <= h (replaces
    rigid_dense.build_rigid_side + rigid_side_force)."""
    if not _on_cuda("rigid_side_force", rpos):
        return rigid_side_force_plain(rpos, rvol, pos, starts, grid, h, rho0,
                                      u, force)
    nr, n = rpos.shape[0], pos.shape[0]
    _check("rigid pos", rpos, torch.float32, (nr, 3), rpos.device)
    _check("rigid vol", rvol, torch.float32, (nr,), rpos.device)
    _check("pos", pos, torch.float32, (n, 3), rpos.device)
    _check("starts", starts, torch.int32, (grid.num_cells + 1,), rpos.device)
    _check("u", u, torch.float32, (n,), rpos.device)
    _check("force", force, torch.float32, (nr, 3), rpos.device)
    out = torch.empty_like(force)
    _launch("rigid_side_force", rpos.device, rpos, rvol, nr, pos, starts, n,
            ctypes.byref(_params(grid, h)), f32(rho0), u, force,
            out)
    return out


def rigid_counts(pos: torch.Tensor, table: RigidTable, grid: nb.GridSpec,
                 h: float) -> torch.Tensor:
    """(N,) int32 rigid particles within h of each cell-sorted fluid query,
    in plain PyTorch on either device: the neighbour colour view's
    (runner.Simulation.neighbor_counts), on no step's path."""
    out = torch.zeros(pos.shape[0], dtype=torch.int32, device=pos.device)
    for rows, pr in _pair_chunks(pos, table.pos, table.starts, grid, h,
                                 exclude_self=False):
        out[rows] = pr.valid.sum(dim=1, dtype=torch.int32)
    return out


# ---------------------------------------------------------------------------
# Plain PyTorch versions (ops/stencil.py's chunked candidates)
# ---------------------------------------------------------------------------

def _solid_pairs(pos: torch.Tensor, table: RigidTable, grid: nb.GridSpec,
                 h: float, rho0: float):
    """(rows, pairs, w_s, c) of each chunk of fluid queries against the
    sorted body."""
    for rows, pr in _pair_chunks(pos, table.pos, table.starts, grid, h,
                                 exclude_self=False):
        yield (rows, pr, f32(rho0) * table.vol[pr.slot],
               cubic_grad_coeff(pr.r, h))


def rigid_terms_plain(pos: torch.Tensor, table: RigidTable,
                      grid: nb.GridSpec, h: float,
                      rho0: float) -> RigidTerms:
    KERNELS["rigid_terms"].plain_calls += 1
    n = pos.shape[0]
    out = RigidTerms(rho=pos.new_zeros(n), s=pos.new_zeros(n, 3),
                     qsum=pos.new_zeros(n), g2=pos.new_zeros(n))
    for rows, pr, ws, gc in _solid_pairs(pos, table, grid, h, rho0):
        v = pr.valid
        wg = ws * gc
        wr = wg * pr.r
        out.rho[rows] = _rowsum(v, ws * cubic_w(pr.r, h))
        out.s[rows] = _rowsum3(v, pr, wg)
        out.qsum[rows] = _rowsum(v, wr * wr)
        out.g2[rows] = _rowsum(v, wg * gc * pr.r * pr.r)
    return out


def rigid_contact_dot_plain(pos: torch.Tensor, table: RigidTable,
                            grid: nb.GridSpec, h: float, rho0: float,
                            v_r: torch.Tensor) -> torch.Tensor:
    KERNELS["rigid_contact_dot"].plain_calls += 1
    out = pos.new_zeros(pos.shape[0])
    for rows, pr, ws, gc in _solid_pairs(pos, table, grid, h, rho0):
        vj = v_r[table.lid.long()[pr.slot]]
        dx, dy, dz = pr.d
        out[rows] = _rowsum(pr.valid, (ws * gc) * (
            dx * vj[..., 0] + dy * vj[..., 1] + dz * vj[..., 2]))
    return out


def rigid_viscosity_plain(pos: torch.Tensor, table: RigidTable,
                          grid: nb.GridSpec, h: float, rho0: float, m: float,
                          vel: torch.Tensor, rho: torch.Tensor,
                          rho_quirk: torch.Tensor, body_vel: torch.Tensor,
                          c_s: float, alpha: float,
                          eps: float = 0.01) -> torch.Tensor:
    KERNELS["rigid_viscosity"].plain_calls += 1
    nu_num, q2e_add = _rigid_viscosity_constants(h, c_s, alpha, eps)
    # A 0-d numerator: `float / tensor` would round as a reciprocal times
    # the float (ops/stencil.wcsph_forces_plain).
    nu = torch.full((), nu_num, dtype=torch.float32, device=pos.device)
    out = pos.new_zeros(pos.shape[0], 3)
    for rows, pr, ws, gc in _solid_pairs(pos, table, grid, h, rho0):
        dx, dy, dz = pr.d
        vi = vel[rows] - body_vel
        shear = (vi[:, 0, None] * dx + vi[:, 1, None] * dy
                 + vi[:, 2, None] * dz)
        rho_j = rho_quirk[table.lid.long()[pr.slot]]
        pi = -(nu / (rho[rows, None] + rho_j)) * shear \
            / (pr.r * pr.r + q2e_add)
        out[rows] = _rowsum3(pr.valid & (shear < 0.0), pr, -ws * pi * gc)
    return out * f32(m)


def rigid_side_force_plain(rpos: torch.Tensor, rvol: torch.Tensor,
                           pos: torch.Tensor, starts: torch.Tensor,
                           grid: nb.GridSpec, h: float, rho0: float,
                           u: torch.Tensor,
                           force: torch.Tensor) -> torch.Tensor:
    KERNELS["rigid_side_force"].plain_calls += 1
    out = force.clone()
    hf = CubicConstants.of(h).h
    for rows, pr in _pair_chunks(rpos, pos, starts, grid, h,
                                 exclude_self=False):
        coeff = (f32(rho0) * rvol[rows, None]) * cubic_grad_coeff(pr.r, h)
        ui = u[pr.slot]
        valid = pr.valid & (pr.r <= hf)
        # x_i - x_j: the chunks' d is query (rigid) minus source (fluid).
        out[rows] += torch.stack([_rowsum(valid, ((-d) * coeff) * ui)
                                  for d in pr.d], dim=1)
    return out
