"""The pair passes of the solver steps over the cell-sorted CSR stencil:
the one-shot sums and loop products of DFSPH and IISPH, WCSPH's force
pass, PCISPH's predicted density and PBF's three passes.

Each pass has three parts:

* a hand-written CUDA kernel (`csrc/*.cu`, built by ops/_build.py) that
  walks each cell-sorted query's 27-cell stencil of the source CSR table
  and sums in registers: one thread per query that queues its hits and
  runs the pair term outside the candidate loop in fluid_terms,
  boundary_terms, matvec, matvec_dot, wcsph_forces, pcisph_predict_rho,
  pbf_terms (PBF's constraint pass: its fluid walk, its walls' walk and
  each row's lambda in one launch) and the fluid-rigid passes of
  ops/rigid.py
  (`csrc/stencil.cuh`, queued_walk),
  a group of lanes per query in viscosity and coef_build (group_walk);
  pcisph_predict_rho_list streams the rows of the step's stored pair list
  (ops/coef.py) and walks no stencil for its fluid pairs, and pbf_lambda
  and pbf_xsph stream the pair list that pbf_terms stores (`PairList`,
  stream_rows).
  The walk of ~27 x occupancy candidates, not DRAM bandwidth
  or FLOPs, sets their time: as measured on an NVIDIA H100 80GB HBM3
  (PERF.md section 6), the warps' instruction slots at breaking_dam_1m,
  where the card is full, and the latency of a thread's serial loads at
  30k particles and on dense cells. The note atop each `.cu` file says what
  bounds it and what its design does about that;
* a plain PyTorch version of the same function, `*_plain`, which walks the
  same stencil as (Q, 27 * max_occupancy) masked candidates, chunked over
  queries so that it fits at 1M particles (the stream forms sum over the
  stored pair list instead: `*_list_plain`);
* a wrapper that launches the kernel for CUDA tensors and calls the plain
  version for CPU tensors. There is no fallback: a CUDA tensor either
  reaches its kernel or the wrapper raises.

The pair set is every source j in the 27 cells around the query's clamped
cell with r2 = |x_i - x_j|^2 <= f32(h)^2 (and j != i for fluid sources).
Where a pass evaluates its term at other positions (PCISPH's predicted
ones, PBF's updated ones), the pair set is still taken at the cell-sorted
start-of-step positions and their CSR table, as JAX pins it.
With no capacity anywhere this is exactly the JAX package's pair set when
its block plans do not overflow (cfd_taichi_tpu/ops/bandmat.py:32-38).

`KERNELS` counts launches and plain calls of these passes, of the
stored-coefficient engine's (ops/coef.py) and of the fluid-rigid passes
(ops/rigid.py), so a run can show which path carried it.
"""

from __future__ import annotations

import ctypes
from typing import TYPE_CHECKING, Iterator, NamedTuple

import torch

from cfd_taichi_tpu_torch.ops import _build
from cfd_taichi_tpu_torch.ops.neighbors import (GridSpec, cell_coords,
                                                  cell_id, stencil_counts)
from cfd_taichi_tpu_torch.ops.smoothing import (CubicConstants,
                                                SpikyPoly6Constants,
                                                cubic_grad_coeff, cubic_w,
                                                f32, ieee_sqrt, poly6_w,
                                                spiky_grad_coeff)

if TYPE_CHECKING:
    from cfd_taichi_tpu_torch.ops.coef import CoefEngine
    from cfd_taichi_tpu_torch.ops.rigid import RigidTable

_CSRC = "cfd_taichi_tpu_torch/csrc/"


class Kernel:
    """Bookkeeping of one hand-written kernel: its source, the JAX pass it
    replaces, and two plain-integer counters."""

    def __init__(self, name: str, source: str, replaces: str):
        self.name = name
        self.source = source
        self.replaces = replaces
        self.launches = 0      # kernel launches (counted by the wrapper)
        self.plain_calls = 0   # calls of the plain PyTorch version


KERNELS = {k.name: k for k in (
    Kernel("fluid_terms", _CSRC + "fluid_terms.cu",
           "cfd_taichi_tpu/ops/bandmat.py:431"),
    Kernel("boundary_terms", _CSRC + "boundary_terms.cu",
           "cfd_taichi_tpu/ops/bandmat.py:1527"),
    Kernel("matvec", _CSRC + "matvec.cu",
           "cfd_taichi_tpu/ops/bandmat.py:1964"),
    Kernel("matvec_dot", _CSRC + "matvec.cu",
           "cfd_taichi_tpu/ops/bandmat.py:1975"),
    Kernel("viscosity", _CSRC + "viscosity.cu",
           "cfd_taichi_tpu/ops/bandmat.py:975"),
    Kernel("wcsph_forces", _CSRC + "wcsph_forces.cu",
           "cfd_taichi_tpu/ops/bandmat.py:1867"),
    # PCISPH's predicted density in two forms: the stencil form (the
    # recompute engine's) and the stream form over the stored-coefficient
    # engine's pair list (ops/coef.py).
    Kernel("pcisph_predict_rho", _CSRC + "pcisph_predict.cu",
           "cfd_taichi_tpu/ops/bandmat.py:1626, :1674"),
    Kernel("pcisph_predict_rho_list", _CSRC + "pcisph_predict.cu",
           "cfd_taichi_tpu/ops/bandmat.py:1626, :1674"),
    # The body's walk of either form: the launches (and plain calls) that
    # walk a rigid table, counted here as well.
    Kernel("pcisph_predict_rho_rigid", _CSRC + "pcisph_predict.cu",
           "cfd_taichi_tpu/ops/rigid_dense.py:179"),
    # PBF's constraint pass in one launch (pbf_constraint: the fluid walk,
    # which also stores the step's pair list, the walls' walk and the rows'
    # lambda).
    Kernel("pbf_terms", _CSRC + "pbf_terms.cu",
           "cfd_taichi_tpu/ops/bandmat.py:1735-1792, :1811"),
    # PBF's two later passes: stream forms over pbf_terms' pair list.
    Kernel("pbf_lambda", _CSRC + "pbf_lambda.cu",
           "cfd_taichi_tpu/ops/bandmat.py:1794-1796"),
    Kernel("pbf_xsph", _CSRC + "pbf_xsph.cu",
           "cfd_taichi_tpu/ops/bandmat.py:1798-1806"),
    # The fluid-rigid passes (ops/rigid.py).
    Kernel("rigid_terms", _CSRC + "rigid_terms.cu",
           "cfd_taichi_tpu/ops/rigid_dense.py:63, :143"),
    Kernel("rigid_contact_dot", _CSRC + "rigid_terms.cu",
           "cfd_taichi_tpu/ops/rigid_dense.py:161"),
    Kernel("rigid_viscosity", _CSRC + "rigid_viscosity.cu",
           "cfd_taichi_tpu/ops/rigid_dense.py:202"),
    # The reaction's walk (IISPH, WCSPH: once a step); the list's rows and
    # the list, built once a step, and the list's stream (DFSPH's density
    # loop, PCISPH's loop).
    Kernel("rigid_side_force", _CSRC + "rigid_side_force.cu",
           "cfd_taichi_tpu/ops/rigid_dense.py:255, :281"),
    Kernel("rigid_side_rows", _CSRC + "rigid_side_force.cu",
           "cfd_taichi_tpu/ops/rigid_dense.py:255"),
    Kernel("rigid_side_list", _CSRC + "rigid_side_force.cu",
           "cfd_taichi_tpu/ops/rigid_dense.py:255"),
    Kernel("rigid_side_force_list", _CSRC + "rigid_side_force.cu",
           "cfd_taichi_tpu/ops/rigid_dense.py:281"),
    # The body's gate, made once a coupled step (`make_body_box`): it
    # stands in for JAX's selection of the fluid groups near the body.
    Kernel("body_box", _CSRC + "body_box.cu",
           "cfd_taichi_tpu/ops/rigid_dense.py:63"),
    # The stored-coefficient engine (ops/coef.py).
    Kernel("coef_build", _CSRC + "coef_build.cu",
           "cfd_taichi_tpu/ops/bandmat.py:682"),
    Kernel("coef_matvec", _CSRC + "coef_matvec.cu",
           "tools/perf_r5_mv3.py:66-69/72-77/97-125, "
           "cfd_taichi_tpu/ops/bandmat.py:817"),
    Kernel("coef_matvec_dot", _CSRC + "coef_matvec.cu",
           "tools/perf_r5_mv3.py:66-69/72-77/97-125, "
           "cfd_taichi_tpu/ops/bandmat.py:817"),
    # DFSPH's loop algebra in the contraction's epilogue (the kick, and the
    # density rate with its residual's inputs): the coef engine's DFSPH
    # loops call these in place of coef_matvec and coef_matvec_dot.
    Kernel("dfsph_kick", _CSRC + "coef_matvec.cu",
           "tools/perf_r5_mv3.py:66-69/72-77/97-125, "
           "cfd_taichi_tpu/models/dfsph.py:192-193"),
    Kernel("dfsph_rate", _CSRC + "coef_matvec.cu",
           "tools/perf_r5_mv3.py:66-69/72-77/97-125, "
           "cfd_taichi_tpu/models/dfsph.py:195-221"),
    # The rate's source record [v, x . v] from a v that no kick wrote (the
    # kick's epilogue writes it otherwise): the JAX engine's product table
    # of its dot, formed once a source.
    Kernel("dfsph_pack", _CSRC + "coef_matvec.cu",
           "cfd_taichi_tpu/ops/bandmat.py:958-959"),
)}


def reset_counts() -> None:
    for k in KERNELS.values():
        k.launches = 0
        k.plain_calls = 0


class FluidTerms(NamedTuple):
    rho: torch.Tensor    # (N,)  sum m W
    count: torch.Tensor  # (N,)  int32 pairs j != i with r <= h
    s: torch.Tensor      # (N, 3) sum m gc x_ij
    qsum: torch.Tensor   # (N,)  sum (m gc r)^2
    tvec: torch.Tensor   # (N, 3) sum W x_ij


class BoundaryTerms(NamedTuple):
    rho: torch.Tensor    # (N,)  sum w_b W,  w_b = rho0 V_b
    s: torch.Tensor      # (N, 3) sum w_b gc x_ib
    qsum: torch.Tensor   # (N,)  sum (w_b gc r)^2
    g2: torch.Tensor     # (N,)  sum w_b gc^2 r^2


class PbfTerms(NamedTuple):
    """PBF's one-shot sums at the start-of-step positions, spiky_c the
    spiky gradient factor, s_corr = -k (poly6 / w_ref)^4
    (`cfd_taichi_tpu/ops/bandmat.py:1723-1732`)."""
    rho: torch.Tensor     # (N,)  m sum poly6 (fluid), sum rho0 V_b poly6
    gsum: torch.Tensor    # (N, 3) sum spiky_c x_ij
    around: torch.Tensor  # (N,)  sum (r spiky_c)^2
    ssum: torch.Tensor    # (N, 3) sum s_corr spiky_c x_ij


class PbfConstraint(NamedTuple):
    """PBF's constraint pass per row: C = max(rho / rho0 - 1, 0) with rho
    the fluid's and the walls' density, lambda, and the fluid's plus the
    walls' gsum and ssum (`PbfTerms`), which the position change reads."""
    constraint: torch.Tensor  # (N,)
    lam: torch.Tensor         # (N,)
    gsum: torch.Tensor        # (N, 3)
    ssum: torch.Tensor        # (N, 3)


# Slots between a row's pairs in the pair list: the 32 rows of a warp
# interleave (csrc/stencil.cuh's kListStride, stream_rows).
LIST_STRIDE = 32


class PairRows(NamedTuple):
    """Where pbf_terms stores each cell-sorted row's fluid pairs: pair t of
    row i in slot base[i] + LIST_STRIDE t (`pair_rows`)."""
    base: torch.Tensor  # (N,) int32: its warp's base, plus its lane
    size: int           # the list's slots


class PairList(NamedTuple):
    """The fluid pairs j != i with r2 <= h2 at the start-of-step positions,
    as pbf_terms stores them: row i's sources are nbr[base[i] + LIST_STRIDE
    t], t = 0, ..., cnt[i] - 1, in walk order. The slots of a row past
    cnt[i] are never written or read."""
    base: torch.Tensor  # (N,) int32
    cnt: torch.Tensor   # (N,) int32
    nbr: torch.Tensor   # (PairRows.size,) int32


class Walls(NamedTuple):
    """A static boundary set, cell-sorted on the fluid's grid: positions,
    volumes V_b, CSR offsets and the per-cell count of boundary particles
    in each cell's stencil (`stencil_counts`; Scene.boundary_*)."""
    pos: torch.Tensor     # (Nb, 3) f32
    vol: torch.Tensor     # (Nb,) f32
    starts: torch.Tensor  # (num_cells + 1,) int32
    near: torch.Tensor    # (num_cells,) int32


# ---------------------------------------------------------------------------
# Launch plumbing
# ---------------------------------------------------------------------------

def _params(grid: GridSpec, h: float) -> _build.StencilParams:
    fast, mid, slow = grid.axes_by_stride
    if grid.strides[fast] != 1:
        raise ValueError(f"grid {grid} has no stride-1 axis")
    c = CubicConstants.of(h)
    return _build.StencilParams(
        (ctypes.c_int * 3)(*grid.dims), (ctypes.c_int * 3)(*grid.strides),
        fast, mid, slow, f32(1.0 / grid.cell), c.h, c.h2, c.kw, c.kw2,
        c.kg6, c.kgm6, c.inv_h)


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, shape: tuple,
           device: torch.device) -> None:
    if t.dtype != dtype or tuple(t.shape) != shape or t.device != device \
            or not t.is_contiguous():
        raise ValueError(
            f"{name}: want contiguous {dtype} {shape} on {device}, got "
            f"{t.dtype} {tuple(t.shape)} on {t.device} "
            f"(contiguous={t.is_contiguous()})")


def _on_cuda(name: str, t: torch.Tensor) -> bool:
    """True: launch the kernel. False: the tensor is on the CPU, run the
    plain version. Any other device raises."""
    if t.is_cuda:
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"{name}: no kernel for device {t.device}")


def _launch(name: str, device: torch.device, *args,
            entry: str | None = None) -> None:
    """Launch `<entry>_launch` (`entry` defaults to the kernel's name) on
    the device's current stream and count it under `name`; tensors in
    `args` are passed as their data pointers."""
    lib = _build.library()
    cargs = [ctypes.c_void_p(a.data_ptr()) if isinstance(a, torch.Tensor)
             else a for a in args]
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        lib.call(f"{entry or name}_launch", *cargs, ctypes.c_void_p(stream))
    KERNELS[name].launches += 1


def _check_pos_starts(pos: torch.Tensor, starts: torch.Tensor,
                      grid: GridSpec) -> int:
    n = pos.shape[0]
    _check("pos", pos, torch.float32, (n, 3), pos.device)
    _check("starts", starts, torch.int32, (grid.num_cells + 1,), pos.device)
    return n


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------

def fluid_terms(pos: torch.Tensor, starts: torch.Tensor, grid: GridSpec,
                h: float, m: float) -> FluidTerms:
    """K1: one-shot fluid-fluid sums (replaces bandmat.build_band_terms)."""
    if not _on_cuda("fluid_terms", pos):
        return fluid_terms_plain(pos, starts, grid, h, m)
    n = _check_pos_starts(pos, starts, grid)
    out = FluidTerms(rho=pos.new_empty(n), count=torch.empty(
        n, dtype=torch.int32, device=pos.device), s=pos.new_empty(n, 3),
        qsum=pos.new_empty(n), tvec=pos.new_empty(n, 3))
    _launch("fluid_terms", pos.device, pos, starts, n,
            ctypes.byref(_params(grid, h)), f32(m), *out)
    return out


def boundary_terms(pos: torch.Tensor, bpos: torch.Tensor, bvol: torch.Tensor,
                   bstarts: torch.Tensor, grid: GridSpec, h: float,
                   rho0: float, bnear: torch.Tensor | None = None
                   ) -> BoundaryTerms:
    """K2: Akinci boundary sums of each fluid query over the cell-sorted
    boundary shell (replaces bandmat.dense_boundary_terms). `bnear` is the
    static shell's `stencil_counts(bstarts, grid)` (Scene.boundary_near),
    with which the kernel lets interior queries skip the walk; it is made
    here where the caller has none. The plain version walks without it."""
    if not _on_cuda("boundary_terms", pos):
        return boundary_terms_plain(pos, bpos, bvol, bstarts, grid, h, rho0)
    n, nb = pos.shape[0], bpos.shape[0]
    _check("pos", pos, torch.float32, (n, 3), pos.device)
    _check_pos_starts(bpos, bstarts, grid)
    _check("bvol", bvol, torch.float32, (nb,), pos.device)
    if bnear is None:
        bnear = stencil_counts(bstarts, grid)
    _check("bnear", bnear, torch.int32, (grid.num_cells,), pos.device)
    out = BoundaryTerms(rho=pos.new_empty(n), s=pos.new_empty(n, 3),
                        qsum=pos.new_empty(n), g2=pos.new_empty(n))
    _launch("boundary_terms", pos.device, pos, n, bpos, bvol, bstarts, bnear,
            nb, ctypes.byref(_params(grid, h)), f32(rho0), *out)
    return out


def matvec(pos: torch.Tensor, starts: torch.Tensor, grid: GridSpec, h: float,
           m: float, k: torch.Tensor) -> torch.Tensor:
    """K3a: (N, 3) sum_j m gc x_ij k_j (replaces bandmat.matvec)."""
    if not _on_cuda("matvec", pos):
        return matvec_plain(pos, starts, grid, h, m, k)
    n = _check_pos_starts(pos, starts, grid)
    _check("k", k, torch.float32, (n,), pos.device)
    out = pos.new_empty(n, 3)
    _launch("matvec", pos.device, pos, starts, n,
            ctypes.byref(_params(grid, h)), f32(m), k, out)
    return out


def matvec_dot(pos: torch.Tensor, starts: torch.Tensor, grid: GridSpec,
               h: float, m: float, v: torch.Tensor) -> torch.Tensor:
    """K3b: (N,) sum_j m gc x_ij . v_j (replaces bandmat.matvec_dot)."""
    if not _on_cuda("matvec_dot", pos):
        return matvec_dot_plain(pos, starts, grid, h, m, v)
    n = _check_pos_starts(pos, starts, grid)
    _check("v", v, torch.float32, (n, 3), pos.device)
    out = pos.new_empty(n)
    _launch("matvec_dot", pos.device, pos, starts, n,
            ctypes.byref(_params(grid, h)), f32(m), v, out)
    return out


def viscosity(pos: torch.Tensor, starts: torch.Tensor, grid: GridSpec,
              h: float, m: float, vel: torch.Tensor, rho: torch.Tensor,
              c_s: float, alpha: float, eps: float = 0.01) -> torch.Tensor:
    """K4: (N, 3) Monaghan viscosity under compression, already scaled by m
    (replaces bandmat.dense_viscosity)."""
    if not _on_cuda("viscosity", pos):
        return viscosity_plain(pos, starts, grid, h, m, vel, rho, c_s, alpha,
                               eps)
    n = _check_pos_starts(pos, starts, grid)
    _check("vel", vel, torch.float32, (n, 3), pos.device)
    _check("rho", rho, torch.float32, (n,), pos.device)
    out = pos.new_empty(n, 3)
    nu_num, q2e_add = _viscosity_constants(h, c_s, alpha, eps)
    _launch("viscosity", pos.device, pos, starts, n,
            ctypes.byref(_params(grid, h)), f32(m), nu_num, q2e_add, vel, rho,
            out)
    return out


def _viscosity_constants(h: float, c_s: float, alpha: float, eps: float):
    """nu = f32(2 alpha h c_s) and f32(eps) * h2, as bandmat.py:1033-1035."""
    h2 = CubicConstants.of(h).h2
    return f32(2.0 * alpha * h * c_s), f32(f32(eps) * h2)


def wcsph_forces(pos: torch.Tensor, starts: torch.Tensor, grid: GridSpec,
                 h: float, m: float, vel: torch.Tensor, rho: torch.Tensor,
                 p_over_rho2: torch.Tensor, c_s: float, alpha: float,
                 tension_k: float, eps: float = 0.01) -> torch.Tensor:
    """K5: (N, 3) WCSPH pair acceleration, the Tait pressure gradient with
    p' = p / rho^2, Monaghan viscosity under compression and cohesion in
    one coefficient per pair (replaces bandmat.dense_wcsph_forces)."""
    if not _on_cuda("wcsph_forces", pos):
        return wcsph_forces_plain(pos, starts, grid, h, m, vel, rho,
                                  p_over_rho2, c_s, alpha, tension_k, eps)
    n = _check_pos_starts(pos, starts, grid)
    _check("vel", vel, torch.float32, (n, 3), pos.device)
    _check("rho", rho, torch.float32, (n,), pos.device)
    _check("p_over_rho2", p_over_rho2, torch.float32, (n,), pos.device)
    return wcsph_forces_packed(wcsph_records(pos, vel, rho, p_over_rho2),
                               starts, grid, h, m, c_s, alpha, tension_k, eps)


class WcsphRecords(NamedTuple):
    """The packed particle records that wcsph_forces' kernel reads, one
    16-byte load each."""
    a: torch.Tensor  # (N, 4) f32: x, y, z, p'
    b: torch.Tensor  # (N, 4) f32: vx, vy, vz, rho


def wcsph_records(pos: torch.Tensor, vel: torch.Tensor, rho: torch.Tensor,
                  p_over_rho2: torch.Tensor) -> WcsphRecords:
    """Pack (pos, p') and (vel, rho) into fresh (N, 4) records: 32 bytes a
    particle written once, which the kernel then reads in two loads."""
    return WcsphRecords(torch.cat([pos, p_over_rho2[:, None]], dim=1),
                        torch.cat([vel, rho[:, None]], dim=1))


def wcsph_forces_packed(rec: WcsphRecords, starts: torch.Tensor,
                        grid: GridSpec, h: float, m: float, c_s: float,
                        alpha: float, tension_k: float,
                        eps: float = 0.01) -> torch.Tensor:
    """wcsph_forces on records already packed (`wcsph_records`). Each
    record must be a contiguous (N, 4) f32 tensor at a 16-byte aligned
    address, on either device: the kernel loads a row as one float4."""
    a, b = rec
    n = a.shape[0]
    for name, t in (("a", a), ("b", b)):
        _check(f"record {name}", t, torch.float32, (n, 4), a.device)
        if t.data_ptr() % 16:
            raise ValueError(f"record {name}: want a 16-byte aligned address, "
                             f"got {t.data_ptr():#x}")
    if not _on_cuda("wcsph_forces", a):
        return wcsph_forces_plain(a[:, :3], starts, grid, h, m, b[:, :3],
                                  b[:, 3], a[:, 3], c_s, alpha, tension_k,
                                  eps)
    _check("starts", starts, torch.int32, (grid.num_cells + 1,), a.device)
    out = a.new_empty(n, 3)
    nu_num, q2e_add = _viscosity_constants(h, c_s, alpha, eps)
    _launch("wcsph_forces", a.device, a, b, starts, n,
            ctypes.byref(_params(grid, h)), f32(m), nu_num, q2e_add,
            _tension_mk(tension_k, m), out)
    return out


def _tension_mk(tension_k: float, m: float) -> float:
    """The cohesion factor -f32(k) f32(m) in f32, as bandmat.py:1946."""
    return f32(-f32(tension_k) * f32(m))


def _check_walls(walls: Walls, n_cells: int, device: torch.device) -> int:
    nb = walls.pos.shape[0]
    _check("walls.pos", walls.pos, torch.float32, (nb, 3), device)
    _check("walls.vol", walls.vol, torch.float32, (nb,), device)
    _check("walls.starts", walls.starts, torch.int32, (n_cells + 1,), device)
    _check("walls.near", walls.near, torch.int32, (n_cells,), device)
    return nb


def pcisph_predict_rho(pos: torch.Tensor, starts: torch.Tensor,
                       grid: GridSpec, h: float, m: float,
                       pos_p: torch.Tensor, walls: Walls | None = None,
                       rho0: float = 0.0, body: "RigidTable | None" = None,
                       eng: "CoefEngine | None" = None,
                       body_box: torch.Tensor | None = None) -> torch.Tensor:
    """K6: (N,) PCISPH's predicted density m sum_j W(|x~_i - x~_j|) (+ with
    a rigid body's cell-sorted `body` table sum_s rho0 V_s W(|x~_i - x_s|),
    + on walls sum_b rho0 V_b W(|x~_i - x_b|)) over the pairs valid at the
    start-of-step `pos`, W at the predicted `pos_p`, the body and walls
    where they stand (replaces bandmat.predicted_rho_op +
    rigid_dense.predict_rho_op + boundary_predict_op).

    With `eng`, the step's pair store (ops/coef.py: its rows are exactly
    the fluid pairs valid at `pos`, in walk order), the stream form
    pcisph_predict_rho_list sums over the stored rows; without one the
    stencil form pcisph_predict_rho walks the 27-cell stencil of `starts`.
    Only queries inside `body_box` walk the body (`make_body_box`; made
    here from the table where the caller has none)."""
    name = "pcisph_predict_rho" if eng is None else "pcisph_predict_rho_list"
    if not _on_cuda(name, pos):
        if eng is None:
            return pcisph_predict_rho_plain(pos, starts, grid, h, m, pos_p,
                                            walls, rho0, body)
        return pcisph_predict_rho_list_plain(eng, pos, grid, h, m, pos_p,
                                             walls, rho0, body)
    n = pos.shape[0]
    _check("pos", pos, torch.float32, (n, 3), pos.device)
    _check("pos_p", pos_p, torch.float32, (n, 3), pos.device)
    if eng is None:
        _check_pos_starts(pos, starts, grid)
    else:
        _check("offsets", eng.offsets, torch.int32, (n + 1,), pos.device)
        _check("nbr", eng.nbr, torch.int32, (eng.nbr.shape[0],), pos.device)
    bnd = (None, None, None, None, 0)
    if walls is not None:
        bnd = (*walls, _check_walls(walls, grid.num_cells, pos.device))
    rig = (None, None, None, None, 0)
    if body is not None:
        nr = body.pos.shape[0]
        _check("body pos", body.pos, torch.float32, (nr, 3), pos.device)
        _check("body vol", body.vol, torch.float32, (nr,), pos.device)
        _check("body starts", body.starts, torch.int32,
               (grid.num_cells + 1,), pos.device)
        if body_box is None:
            body_box = make_body_box(body.pos, h)
        _check("body box", body_box, torch.float32, (2, 3), pos.device)
        rig = (body.pos, body.vol, body.starts, body_box, nr)
    out = pos.new_empty(n)
    params = ctypes.byref(_params(grid, h))
    if eng is None:
        _launch(name, pos.device, pos, starts, n, params, f32(m), pos_p,
                *bnd, *rig, f32(rho0), out)
    else:
        _launch(name, pos.device, pos, n, eng.offsets, eng.nbr, params,
                f32(m), pos_p, *bnd, *rig, f32(rho0), out)
    if body is not None:
        KERNELS["pcisph_predict_rho_rigid"].launches += 1
    return out


def body_walk_build() -> dict:
    """How the card's predicted density walks the body (csrc/
    pcisph_predict.cu): one thread a row on the queued walk, `chunk`
    candidates between two votes, and for each form its registers and
    local memory a thread, static shared memory a block and resident
    blocks an SM."""
    out = (ctypes.c_int * 9)()
    _build.library().call("pcisph_predict_attributes", out)
    forms = {form: dict(zip(("registers", "local_bytes", "shared_bytes",
                             "blocks_per_sm"), out[1 + 4 * k:5 + 4 * k]))
             for k, form in enumerate(("pcisph_predict_rho",
                                       "pcisph_predict_rho_list"))}
    return dict(chunk=out[0], **forms)


def body_box_blocks(nr: int) -> int:
    """The blocks that the card's body_box launch folds a body of `nr` > 0
    particles with: one, or a cluster of them (csrc/body_box.cu,
    box_blocks)."""
    return int(_build.library().lib.body_box_blocks(nr))


# The body gate's margin beyond h, relative: a pair's f32 test
# |x_i - x_s|^2 <= f32(h)^2 holds only within h (1 + 3 eps) on each axis,
# and the box's corners round at the coordinates' own scale (BOX_SLACK of
# the largest |coordinate|, some sixteen ulps).
BOX_MARGIN = 2.0**-10
BOX_SLACK = 2.0**-20


def make_body_box(bpos: torch.Tensor, h: float) -> torch.Tensor:
    """R5: (2, 3) f32 corners lo, hi of the body's gate: the box of its
    (Nr, 3) positions `bpos` grown by h (1 + BOX_MARGIN) and BOX_SLACK of
    each axis' largest |coordinate|, made on the device with no host read
    (csrc/body_box.cu, one launch). A query with a body pair lies inside it
    (`in_body_box`); on a body of no particles it holds nothing."""
    nr = bpos.shape[0]
    if nr == 0:
        inf = float("inf")
        return torch.tensor([[inf] * 3, [-inf] * 3], dtype=torch.float32,
                            device=bpos.device)
    if not _on_cuda("body_box", bpos):
        return make_body_box_plain(bpos, h)
    _check("body pos", bpos, torch.float32, (nr, 3), bpos.device)
    box = bpos.new_empty(2, 3)
    _launch("body_box", bpos.device, bpos, nr, _box_grow(h),
            f32(BOX_SLACK), box)
    return box


def _box_grow(h: float) -> float:
    """f32(h (1 + BOX_MARGIN)), the part of the gate's margin common to
    every axis."""
    return f32(CubicConstants.of(h).h * (1.0 + BOX_MARGIN))


def make_body_box_plain(bpos: torch.Tensor, h: float) -> torch.Tensor:
    KERNELS["body_box"].plain_calls += 1
    lo, hi = bpos.amin(dim=0), bpos.amax(dim=0)
    grow = _box_grow(h) + torch.maximum(lo.abs(), hi.abs()) * f32(BOX_SLACK)
    return torch.stack([lo - grow, hi + grow])


def in_body_box(pos: torch.Tensor, box: torch.Tensor) -> torch.Tensor:
    """(N,) bool: the queries at `pos` that the kernels let walk the body,
    by the same f32 comparisons as theirs (csrc/stencil.cuh, in_body_box)."""
    return ((pos >= box[0]) & (pos <= box[1])).all(dim=1)


def _spiky_poly6(h: float) -> _build.SpikyPoly6:
    return _build.SpikyPoly6(*SpikyPoly6Constants.of(h))


def _s_corr_constants(w_ref: float, k_corr: float) -> tuple[float, float]:
    """f32(1 / w_ref) and f32(-k), as bandmat.py:1785-1787."""
    return f32(1.0 / w_ref), f32(-k_corr)


def warp_offsets(counts: torch.Tensor) -> torch.Tensor:
    """(warps + 1,) int64 offsets of a pair list whose N rows hold at most
    `counts` ((N,) int) pairs each: 0, then the running sum of each warp's
    room, its 32 rows' largest count, so that warp w's first slot is
    LIST_STRIDE offs[w] and the list holds LIST_STRIDE offs[-1] slots."""
    n = counts.shape[0]
    warps = -(-n // LIST_STRIDE)
    room = torch.nn.functional.pad(counts, (0, warps * LIST_STRIDE - n)).view(
        warps, LIST_STRIDE).amax(dim=1)
    return torch.nn.functional.pad(torch.cumsum(room, 0, dtype=torch.int64),
                                   (1, 0))


def warp_bases(offs: torch.Tensor, n: int) -> torch.Tensor:
    """(n,) int32 first slot of each row of a list with warp offsets `offs`
    (`warp_offsets`): its warp's, plus its lane, the warp's rows
    interleaved (row i's pair t in slot base[i] + LIST_STRIDE t)."""
    lane = torch.arange(LIST_STRIDE, dtype=torch.int32, device=offs.device)
    return (offs[:-1].to(torch.int32)[:, None] * LIST_STRIDE
            + lane).reshape(-1)[:n]


def checked_slots(size: int, n: int) -> int:
    """A pair list's size read on the host; raises where its slots pass
    what int32 offsets address."""
    if size > torch.iinfo(torch.int32).max:
        raise ValueError(f"the pair list of {n} rows needs {size} slots, "
                         f"more than int32 offsets address")
    return size


def pair_rows(starts: torch.Tensor, grid: GridSpec,
              cells: torch.Tensor) -> PairRows:
    """The rows of the pair list that pbf_terms stores, for cell-sorted
    fluid rows in the cells `cells` ((N,) ids, the sort's) of the CSR table
    `starts`. A row's pairs are a subset of its walk's candidates,
    `stencil_counts(starts, grid)` at its cell; each warp of 32 rows gets
    room for its rows' largest count (`warp_offsets`), so that no row can
    overflow. One host read: the size. Raises where the slots pass what
    int32 offsets address."""
    n = cells.shape[0]
    offs = warp_offsets(stencil_counts(starts, grid).index_select(0, cells))
    size = checked_slots(LIST_STRIDE * int(offs[-1]), n)
    return PairRows(warp_bases(offs, n), size)


def _rows_constants(rho0: float, epsilon: float,
                    rho_seed: float) -> tuple[float, ...]:
    """f32(rho_seed), f32(1 / rho0), f32(1 / rho0^2), f32(epsilon): the
    scalars of the rows' algebra (`pbf_rows_plain`)."""
    return (f32(rho_seed), f32(1.0 / rho0), f32(1.0 / rho0**2),
            f32(epsilon))


def pbf_constraint(pos: torch.Tensor, starts: torch.Tensor, grid: GridSpec,
                   h: float, m: float, w_ref: float, k_corr: float,
                   rows: PairRows | None, walls: Walls | None, rho0: float,
                   epsilon: float, rho_seed: float
                   ) -> tuple[PbfConstraint, PairList]:
    """K7: PBF's constraint pass in one launch of pbf_terms' kernel: the
    fluid walk, which stores the pairs it finds in `rows` (`pair_rows`;
    made here, with its host read, where the caller has none) for
    pbf_lambda and pbf_xsph, the walls' walk where there are `walls`
    (`None`: the clamp scenes), and each row's constraint and lambda
    (`pbf_rows_plain`, bit for bit), rho0 the density of the constraint and
    of the walls' weights, epsilon lambda's regulariser, rho_seed the
    density's seed."""
    cuda = _on_cuda("pbf_terms", pos)
    if rows is None:
        rows = pair_rows(starts, grid, cell_id(pos, grid))
    if not cuda:
        return pbf_constraint_plain(pos, starts, grid, h, m, w_ref, k_corr,
                                    rows, walls, rho0, epsilon, rho_seed)
    n = _check_pos_starts(pos, starts, grid)
    _check("rows.base", rows.base, torch.int32, (n,), pos.device)
    bnd = (None, None, None, None, 0)
    if walls is not None:
        bnd = (*walls, _check_walls(walls, grid.num_cells, pos.device))
    out = PbfConstraint(pos.new_empty(n), pos.new_empty(n),
                        pos.new_empty(n, 3), pos.new_empty(n, 3))
    pairs = PairList(rows.base, torch.empty_like(rows.base),
                     torch.empty(rows.size, dtype=torch.int32,
                                 device=pos.device))
    _launch("pbf_terms", pos.device, pos, starts, n,
            ctypes.byref(_params(grid, h)), ctypes.byref(_spiky_poly6(h)),
            f32(m), *_s_corr_constants(w_ref, k_corr), *pairs, *bnd,
            f32(rho0), *_rows_constants(rho0, epsilon, rho_seed), *out,
            entry="pbf_constraint")
    return out, pairs


def _check_pairs(pairs: PairList, n: int, device: torch.device) -> None:
    _check("pairs.base", pairs.base, torch.int32, (n,), device)
    _check("pairs.cnt", pairs.cnt, torch.int32, (n,), device)
    _check("pairs.nbr", pairs.nbr, torch.int32, (pairs.nbr.shape[0],),
           device)


def pbf_lambda(pos: torch.Tensor, pairs: PairList, h: float,
               lam: torch.Tensor) -> torch.Tensor:
    """K8: (N, 3) sum_j lambda_j spiky_c x_ij at the start-of-step
    positions `pos`, over the stored `pairs` (pbf_terms') (replaces lam_mv
    of bandmat.dense_pbf_ops)."""
    if not _on_cuda("pbf_lambda", pos):
        return pbf_lambda_list_plain(pairs, pos, h, lam)
    n = pos.shape[0]
    _check("pos", pos, torch.float32, (n, 3), pos.device)
    _check_pairs(pairs, n, pos.device)
    _check("lam", lam, torch.float32, (n,), pos.device)
    out = pos.new_empty(n, 3)
    _launch("pbf_lambda", pos.device, pos, n, *pairs,
            ctypes.byref(_spiky_poly6(h)), lam, out)
    return out


def pbf_xsph(pairs: PairList, h: float, new_pos: torch.Tensor,
             new_vel: torch.Tensor) -> torch.Tensor:
    """K9: (N, 3) sum_j v'_j w - v'_i sum_j w, w = poly6(|x'_i - x'_j|) at
    the updated positions, over the stored `pairs` (pbf_terms', valid at
    the start-of-step positions) (replaces xsph of bandmat.dense_pbf_ops)."""
    if not _on_cuda("pbf_xsph", new_pos):
        return pbf_xsph_list_plain(pairs, h, new_pos, new_vel)
    n = new_pos.shape[0]
    _check("new_pos", new_pos, torch.float32, (n, 3), new_pos.device)
    _check("new_vel", new_vel, torch.float32, (n, 3), new_pos.device)
    _check_pairs(pairs, n, new_pos.device)
    out = new_pos.new_empty(n, 3)
    _launch("pbf_xsph", new_pos.device, n, *pairs,
            ctypes.byref(_spiky_poly6(h)), new_pos, new_vel, out)
    return out


# ---------------------------------------------------------------------------
# Plain PyTorch versions
# ---------------------------------------------------------------------------

# Candidates (query x stencil slot) per chunk of the plain versions: about
# 16 MB per f32 temporary, whatever N is.
CHUNK_CANDIDATES = 1 << 22

_OFFSETS = [(dx, dy, dz) for dx in (-1, 0, 1) for dy in (-1, 0, 1)
            for dz in (-1, 0, 1)]


def walk_offsets(grid: GridSpec) -> list[tuple[int, int, int]]:
    """The 27 cell offsets in the kernels' walk order (csrc/stencil.cuh):
    mid axis outermost, then slow, then fast, so that each stencil row's
    three cells, and the slots in them, come in ascending sorted order."""
    fast, mid, slow = grid.axes_by_stride
    out = []
    for dm in (-1, 0, 1):
        for ds in (-1, 0, 1):
            for df in (-1, 0, 1):
                o = [0, 0, 0]
                o[mid], o[slow], o[fast] = dm, ds, df
                out.append(tuple(o))
    return out


class _Pairs(NamedTuple):
    """Masked candidates of a query chunk; every tensor is (Q, W)."""
    slot: torch.Tensor   # int64 index into the sorted source set
    valid: torch.Tensor  # in-grid cell, real slot, r2 <= h2 (and j != i)
    d: tuple             # (dx, dy, dz), x_i - x_j per axis
    r2: torch.Tensor
    r: torch.Tensor      # sqrt(max(r2, 1e-24)) (ieee_sqrt), as JAX takes it


def _pair_chunks(qpos: torch.Tensor, spos: torch.Tensor, starts: torch.Tensor,
                 grid: GridSpec, h: float, exclude_self: bool,
                 offsets: list | None = None
                 ) -> Iterator[tuple[slice, _Pairs]]:
    """Yield (query rows, candidates) over chunks of queries. Candidates
    come cell by cell in the order of `offsets` (default `_OFFSETS`),
    ascending slot within a cell."""
    n, ns = qpos.shape[0], spos.shape[0]
    occ = int((starts[1:] - starts[:-1]).max().item()) if ns else 0
    if n == 0 or occ == 0:
        return
    dev = qpos.device
    width = 27 * occ
    chunk = max(1, CHUNK_CANDIDATES // width)
    off = torch.tensor(offsets or _OFFSETS, dtype=torch.int32, device=dev)
    dims = torch.tensor(grid.dims, dtype=torch.int32, device=dev)
    strides = torch.tensor(grid.strides, dtype=torch.int32, device=dev)
    t = torch.arange(occ, dtype=torch.int32, device=dev)
    h2 = CubicConstants.of(h).h2
    for lo in range(0, n, chunk):
        q = qpos[lo:lo + chunk]
        nq = q.shape[0]
        nc = cell_coords(q, grid)[:, None, :] + off         # (Q, 27, 3)
        inb = ((nc >= 0) & (nc < dims)).all(dim=-1)
        cid = (nc * strides).sum(dim=-1).clamp(0, grid.num_cells - 1)
        st = starts[cid]
        ln = torch.where(inb, starts[cid + 1] - st, 0)
        slot = (st[..., None] + t).reshape(nq, width).long()
        valid = (t < ln[..., None]).reshape(nq, width)
        slot = slot.clamp(max=ns - 1)
        diff = q[:, None, :] - spos[slot]                    # (Q, W, 3)
        d = (diff[..., 0], diff[..., 1], diff[..., 2])
        r2 = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
        valid &= r2 <= h2
        if exclude_self:
            rows = torch.arange(lo, lo + nq, device=dev)[:, None]
            valid &= slot != rows
        r = ieee_sqrt(torch.clamp(r2, min=f32(1e-24)))
        yield slice(lo, lo + nq), _Pairs(slot, valid, d, r2, r)


def count_pairs(qpos: torch.Tensor, spos: torch.Tensor, starts: torch.Tensor,
                grid: GridSpec, h: float, exclude_self: bool) -> int:
    """Pairs within h over the queries' 27-cell stencils: the pairs whose
    terms a stencil pass evaluates."""
    return sum(int(pr.valid.sum()) for _, pr in _pair_chunks(
        qpos, spos, starts, grid, h, exclude_self))


def _rowsum(valid: torch.Tensor, term: torch.Tensor) -> torch.Tensor:
    return torch.where(valid, term, torch.zeros_like(term)).sum(dim=1)


def _rowsum3(valid: torch.Tensor, pr: _Pairs, scale: torch.Tensor,
             vj: torch.Tensor | None = None) -> torch.Tensor:
    """(Q, 3) sums of scale * x_ij per axis, times v_j's axis if given."""
    return torch.stack([
        _rowsum(valid, scale * d if vj is None else (scale * d) * vj[..., a])
        for a, d in enumerate(pr.d)], dim=1)


def fluid_terms_plain(pos: torch.Tensor, starts: torch.Tensor,
                      grid: GridSpec, h: float, m: float) -> FluidTerms:
    KERNELS["fluid_terms"].plain_calls += 1
    n, mf = pos.shape[0], f32(m)
    out = FluidTerms(rho=pos.new_zeros(n), count=torch.zeros(
        n, dtype=torch.int32, device=pos.device), s=pos.new_zeros(n, 3),
        qsum=pos.new_zeros(n), tvec=pos.new_zeros(n, 3))
    for rows, pr in _pair_chunks(pos, pos, starts, grid, h, exclude_self=True):
        v = pr.valid
        w = mf * cubic_grad_coeff(pr.r, h)
        wk = cubic_w(pr.r, h)
        wr = w * pr.r
        out.rho[rows] = _rowsum(v, mf * wk)
        out.count[rows] = v.sum(dim=1).to(torch.int32)
        out.s[rows] = _rowsum3(v, pr, w)
        out.qsum[rows] = _rowsum(v, wr * wr)
        out.tvec[rows] = _rowsum3(v, pr, wk)
    return out


def boundary_terms_plain(pos: torch.Tensor, bpos: torch.Tensor,
                         bvol: torch.Tensor, bstarts: torch.Tensor,
                         grid: GridSpec, h: float,
                         rho0: float) -> BoundaryTerms:
    KERNELS["boundary_terms"].plain_calls += 1
    n = pos.shape[0]
    out = BoundaryTerms(rho=pos.new_zeros(n), s=pos.new_zeros(n, 3),
                        qsum=pos.new_zeros(n), g2=pos.new_zeros(n))
    for rows, pr in _pair_chunks(pos, bpos, bstarts, grid, h,
                                 exclude_self=False):
        v = pr.valid
        wb = f32(rho0) * bvol[pr.slot]
        wk = cubic_w(pr.r, h)
        gcv = cubic_grad_coeff(pr.r, h)
        wg = wb * gcv
        wr = wg * pr.r
        out.rho[rows] = _rowsum(v, wb * wk)
        out.s[rows] = _rowsum3(v, pr, wg)
        out.qsum[rows] = _rowsum(v, wr * wr)
        out.g2[rows] = _rowsum(v, wg * gcv * pr.r2)
    return out


def matvec_plain(pos: torch.Tensor, starts: torch.Tensor, grid: GridSpec,
                 h: float, m: float, k: torch.Tensor) -> torch.Tensor:
    KERNELS["matvec"].plain_calls += 1
    out = pos.new_zeros(pos.shape[0], 3)
    for rows, pr in _pair_chunks(pos, pos, starts, grid, h, exclude_self=True):
        w = f32(m) * cubic_grad_coeff(pr.r, h)
        kj = k[pr.slot][..., None].expand(-1, -1, 3)
        out[rows] = _rowsum3(pr.valid, pr, w, kj)
    return out


def matvec_dot_plain(pos: torch.Tensor, starts: torch.Tensor, grid: GridSpec,
                     h: float, m: float, v: torch.Tensor) -> torch.Tensor:
    KERNELS["matvec_dot"].plain_calls += 1
    out = pos.new_zeros(pos.shape[0])
    for rows, pr in _pair_chunks(pos, pos, starts, grid, h, exclude_self=True):
        w = f32(m) * cubic_grad_coeff(pr.r, h)
        # Per-axis sums added at the end, like JAX's three einsums.
        out[rows] = _rowsum3(pr.valid, pr, w, v[pr.slot]).sum(dim=1)
    return out


def viscosity_plain(pos: torch.Tensor, starts: torch.Tensor, grid: GridSpec,
                    h: float, m: float, vel: torch.Tensor, rho: torch.Tensor,
                    c_s: float, alpha: float, eps: float = 0.01
                    ) -> torch.Tensor:
    KERNELS["viscosity"].plain_calls += 1
    mf = f32(m)
    nu_num, q2e_add = _viscosity_constants(h, c_s, alpha, eps)
    out = pos.new_zeros(pos.shape[0], 3)
    for rows, pr in _pair_chunks(pos, pos, starts, grid, h, exclude_self=True):
        vij = vel[rows, None, :] - vel[pr.slot]
        dx, dy, dz = pr.d
        shear = dx * vij[..., 0] + dy * vij[..., 1] + dz * vij[..., 2]
        gc = cubic_grad_coeff(pr.r, h)
        pi = -(nu_num / (rho[rows, None] + rho[pr.slot])) * shear \
            / (pr.r2 + q2e_add)
        out[rows] = _rowsum3(pr.valid & (shear < 0.0), pr, -mf * pi * gc) * mf
    return out


def wcsph_forces_plain(pos: torch.Tensor, starts: torch.Tensor,
                       grid: GridSpec, h: float, m: float, vel: torch.Tensor,
                       rho: torch.Tensor, p_over_rho2: torch.Tensor,
                       c_s: float, alpha: float, tension_k: float,
                       eps: float = 0.01) -> torch.Tensor:
    KERNELS["wcsph_forces"].plain_calls += 1
    mf = f32(m)
    nu_num, q2e_add = _viscosity_constants(h, c_s, alpha, eps)
    # A 0-d numerator: PyTorch computes `float / tensor` as a reciprocal
    # times the float, which rounds unlike the kernel's and JAX's division.
    nu = torch.full((), nu_num, dtype=torch.float32, device=pos.device)
    mm, tmk = f32(-mf * mf), _tension_mk(tension_k, m)
    out = pos.new_zeros(pos.shape[0], 3)
    for rows, pr in _pair_chunks(pos, pos, starts, grid, h, exclude_self=True):
        dx, dy, dz = pr.d
        vij = vel[rows, None, :] - vel[pr.slot]
        shear = dx * vij[..., 0] + dy * vij[..., 1] + dz * vij[..., 2]
        gc = cubic_grad_coeff(pr.r, h)
        pi = -(nu / (rho[rows, None] + rho[pr.slot])) * shear \
            / (pr.r2 + q2e_add)
        coeff = -mf * (p_over_rho2[rows, None] + p_over_rho2[pr.slot]) * gc
        coeff = coeff + torch.where(shear < 0.0, mm * pi * gc,
                                    torch.zeros_like(pi))
        coeff = coeff + tmk * cubic_w(pr.r, h)
        out[rows] = _rowsum3(pr.valid, pr, coeff)
    return out


def _pair_r(q: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """sqrt(max(|q_i - src_ij|^2, 1e-24)) of (Q, 3) query rows against
    their (Q, W, 3) candidates, summed x + y + z like every JAX pass."""
    d = q[:, None, :] - src
    r2 = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2]
    return ieee_sqrt(torch.clamp(r2, min=f32(1e-24)))


def _predict_solid(pos: torch.Tensor, pos_p: torch.Tensor,
                   spos: torch.Tensor, svol: torch.Tensor,
                   sstarts: torch.Tensor, grid: GridSpec, h: float,
                   rho0: float) -> torch.Tensor:
    """(N,) sum_s rho0 V_s W(|x~_i - x_s|) over the solid particles `spos`
    (cell-sorted, CSR `sstarts`) within h of the start-of-step `pos`."""
    out = pos.new_zeros(pos.shape[0])
    for rows, pr in _pair_chunks(pos, spos, sstarts, grid, h,
                                 exclude_self=False):
        w = cubic_w(_pair_r(pos_p[rows], spos[pr.slot]), h)
        out[rows] = _rowsum(pr.valid, (f32(rho0) * svol[pr.slot]) * w)
    return out


def pcisph_predict_rho_plain(pos: torch.Tensor, starts: torch.Tensor,
                             grid: GridSpec, h: float, m: float,
                             pos_p: torch.Tensor, walls: Walls | None = None,
                             rho0: float = 0.0,
                             body: "RigidTable | None" = None
                             ) -> torch.Tensor:
    KERNELS["pcisph_predict_rho"].plain_calls += 1
    fluid = pos.new_zeros(pos.shape[0])
    for rows, pr in _pair_chunks(pos, pos, starts, grid, h, exclude_self=True):
        fluid[rows] = _rowsum(pr.valid, cubic_w(
            _pair_r(pos_p[rows], pos_p[pr.slot]), h))
    return _predict_solids(f32(m) * fluid, pos, grid, h, pos_p, walls, rho0,
                           body)


def pcisph_predict_rho_list_plain(eng: "CoefEngine", pos: torch.Tensor,
                                  grid: GridSpec, h: float, m: float,
                                  pos_p: torch.Tensor,
                                  walls: Walls | None = None,
                                  rho0: float = 0.0,
                                  body: "RigidTable | None" = None
                                  ) -> torch.Tensor:
    """The stream form: the fluid sum over the stored rows of `eng`, each
    pair's W at the predicted distance added into its row in pair order
    (index_add_); the walls and the body as the stencil form's."""
    KERNELS["pcisph_predict_rho_list"].plain_calls += 1
    n = pos.shape[0]
    rows = torch.repeat_interleave(torch.arange(n, device=pos.device),
                                   eng.offsets.diff())
    w = cubic_w(_pair_r(pos_p[rows], pos_p[eng.nbr.long()][:, None, :]),
                h)[:, 0]
    fluid = pos.new_zeros(n).index_add_(0, rows, w)
    return _predict_solids(f32(m) * fluid, pos, grid, h, pos_p, walls, rho0,
                           body)


def _predict_solids(rho: torch.Tensor, pos: torch.Tensor, grid: GridSpec,
                    h: float, pos_p: torch.Tensor, walls: Walls | None,
                    rho0: float, body: "RigidTable | None") -> torch.Tensor:
    """The fluid sum `rho` plus the body's and the walls' sums."""
    # JAX's order: fluid, body, walls (models/pcisph.py:281-286).
    if body is not None:
        KERNELS["pcisph_predict_rho_rigid"].plain_calls += 1
        rho = rho + _predict_solid(pos, pos_p, body.pos, body.vol,
                                   body.starts, grid, h, rho0)
    if walls is not None:
        rho = rho + _predict_solid(pos, pos_p, walls.pos, walls.vol,
                                   walls.starts, grid, h, rho0)
    return rho


def _pbf_sums(out: PbfTerms, rows: slice, pr: _Pairs, wrho, h: float,
              w_ref: float, k_corr: float) -> None:
    """PBF's four sums of a query chunk into `out`, each pair's density
    term weighted by `wrho` (1, or rho0 V_b on the boundary)."""
    inv_wref, neg_k = _s_corr_constants(w_ref, k_corr)
    v = pr.valid
    spiky = spiky_grad_coeff(pr.r, h)
    poly = poly6_w(pr.r, h)
    s = poly * inv_wref
    s2 = s * s
    sc = neg_k * s2 * s2 * spiky
    rs = pr.r * spiky
    out.rho[rows] = _rowsum(v, wrho * poly)
    out.gsum[rows] = _rowsum3(v, pr, spiky)
    out.around[rows] = _rowsum(v, rs * rs)
    out.ssum[rows] = _rowsum3(v, pr, sc)


def _pbf_zeros(pos: torch.Tensor) -> PbfTerms:
    n = pos.shape[0]
    return PbfTerms(rho=pos.new_zeros(n), gsum=pos.new_zeros(n, 3),
                    around=pos.new_zeros(n), ssum=pos.new_zeros(n, 3))


def pbf_terms_plain(pos: torch.Tensor, starts: torch.Tensor, grid: GridSpec,
                    h: float, m: float, w_ref: float, k_corr: float,
                    rows: PairRows | None = None
                    ) -> tuple[PbfTerms, PairList]:
    """The fluid walk of PBF's constraint pass alone (the terms of
    bandmat.dense_pbf_ops): its four raw sums, and the pairs in the
    kernel's walk order stored in `rows` (`pair_rows`; made here where the
    caller has none) as the kernel stores them (the slots past a row's
    count hold -1), so that each row's nbr compares exactly. A plain
    function only: the step takes the walk in `pbf_constraint`."""
    KERNELS["pbf_terms"].plain_calls += 1
    return _pbf_fluid_sums(pos, starts, grid, h, m, w_ref, k_corr, rows)


def _pbf_fluid_sums(pos: torch.Tensor, starts: torch.Tensor, grid: GridSpec,
                    h: float, m: float, w_ref: float, k_corr: float,
                    rows: PairRows | None) -> tuple[PbfTerms, PairList]:
    if rows is None:
        rows = pair_rows(starts, grid, cell_id(pos, grid))
    n, dev = pos.shape[0], pos.device
    out = _pbf_zeros(pos)
    pairs = PairList(rows.base, torch.zeros(n, dtype=torch.int32, device=dev),
                     torch.full((rows.size,), -1, dtype=torch.int32,
                                device=dev))
    # A chunk's candidates cell by cell in _OFFSETS' order, taken in the
    # walk's order (walk_offsets) for the list.
    walk = torch.tensor([_OFFSETS.index(o) for o in walk_offsets(grid)],
                        device=dev)
    for sl, pr in _pair_chunks(pos, pos, starts, grid, h, exclude_self=True):
        _pbf_sums(out, sl, pr, 1.0, h, w_ref, k_corr)
        occ = pr.valid.shape[1] // 27
        cols = (walk[:, None] * occ
                + torch.arange(occ, device=dev)).reshape(-1)
        valid, slot = pr.valid[:, cols], pr.slot[:, cols]
        pairs.cnt[sl] = valid.sum(dim=1, dtype=torch.int32)
        at = rows.base[sl, None].long() \
            + LIST_STRIDE * (valid.cumsum(dim=1) - 1)
        pairs.nbr[at[valid]] = slot[valid].to(torch.int32)
    # The factor m comes after the sum, as JAX takes it.
    return out._replace(rho=f32(m) * out.rho), pairs


def pbf_boundary_terms_plain(pos: torch.Tensor, walls: Walls, grid: GridSpec,
                             h: float, rho0: float, w_ref: float,
                             k_corr: float) -> PbfTerms:
    """The walls' walk of PBF's constraint pass alone (bandmat.
    pbf_boundary_terms): rho = sum rho0 V_b poly6 and the other three sums
    with the bare spiky factor. A plain function only, as
    `pbf_terms_plain`."""
    KERNELS["pbf_terms"].plain_calls += 1
    return _pbf_wall_sums(pos, walls, grid, h, rho0, w_ref, k_corr)


def _pbf_wall_sums(pos: torch.Tensor, walls: Walls, grid: GridSpec, h: float,
                   rho0: float, w_ref: float, k_corr: float) -> PbfTerms:
    out = _pbf_zeros(pos)
    for rows, pr in _pair_chunks(pos, walls.pos, walls.starts, grid, h,
                                 exclude_self=False):
        _pbf_sums(out, rows, pr, f32(rho0) * walls.vol[pr.slot], h, w_ref,
                  k_corr)
    return out


def pbf_rows_plain(fluid: PbfTerms, walls: PbfTerms | None, rho0: float,
                   epsilon: float, rho_seed: float) -> PbfConstraint:
    """The rows of PBF's constraint pass from the fluid walk's and the
    walls' walk's raw sums (`walls` None: a clamp scene), in f32, each
    product and sum rounded on its own in this order (the kernel's
    epilogue is held to it bit for bit; JAX's, cfd_taichi_tpu/models/
    pbf.py:96-115): rho = (rho_seed + rho_f) + rho_b, C = max(rho / rho0 -
    1, 0) with / rho0 a product with f32(1 / rho0), as XLA takes it; with
    g' = gsum / rho0 likewise, denom = ((g'x g'x + g'y g'y) + g'z g'z) +
    around f32(1 / rho0^2); lambda = -C / (denom + epsilon), 0 where C is
    0."""
    seed, inv_rho0, inv_rho0_sq, eps = _rows_constants(rho0, epsilon,
                                                       rho_seed)
    rho = seed + fluid.rho
    gsum, around, ssum = fluid.gsum, fluid.around, fluid.ssum
    if walls is not None:
        rho = rho + walls.rho
        gsum = gsum + walls.gsum
        around = around + walls.around
        ssum = ssum + walls.ssum
    constraint = torch.clamp(rho * inv_rho0 - 1.0, min=0.0)
    g = gsum * inv_rho0
    denom = (g[:, 0] * g[:, 0] + g[:, 1] * g[:, 1] + g[:, 2] * g[:, 2]
             + around * inv_rho0_sq)
    lam = torch.where(constraint == 0.0, torch.zeros_like(constraint),
                      -constraint / (denom + eps))
    return PbfConstraint(constraint, lam, gsum, ssum)


def pbf_constraint_plain(pos: torch.Tensor, starts: torch.Tensor,
                         grid: GridSpec, h: float, m: float, w_ref: float,
                         k_corr: float, rows: PairRows | None,
                         walls: Walls | None, rho0: float, epsilon: float,
                         rho_seed: float
                         ) -> tuple[PbfConstraint, PairList]:
    """The fluid walk's sums and list (`pbf_terms_plain`), the walls' sums
    (`pbf_boundary_terms_plain`) and the rows' algebra (`pbf_rows_plain`):
    one plain call of pbf_terms."""
    KERNELS["pbf_terms"].plain_calls += 1
    fluid, pairs = _pbf_fluid_sums(pos, starts, grid, h, m, w_ref, k_corr,
                                   rows)
    wall = None if walls is None else _pbf_wall_sums(pos, walls, grid, h,
                                                      rho0, w_ref, k_corr)
    return pbf_rows_plain(fluid, wall, rho0, epsilon, rho_seed), pairs


def stored_pairs(pairs: PairList) -> tuple[torch.Tensor, torch.Tensor]:
    """(rows, sources) of every stored pair, int64, in pair order: row by
    row, each row's in walk order."""
    cnt = pairs.cnt.long()
    rows = torch.repeat_interleave(
        torch.arange(cnt.shape[0], device=cnt.device), cnt)
    first = torch.cumsum(cnt, 0) - cnt
    at = pairs.base.long()[rows] + LIST_STRIDE * (torch.arange(
        rows.shape[0], device=cnt.device) - first[rows])
    return rows, pairs.nbr[at].long()


def pbf_lambda_list_plain(pairs: PairList, pos: torch.Tensor, h: float,
                          lam: torch.Tensor) -> torch.Tensor:
    """The stream form: each stored pair's term added into its row in pair
    order (index_add_)."""
    KERNELS["pbf_lambda"].plain_calls += 1
    rows, j = stored_pairs(pairs)
    d = pos[rows] - pos[j]
    r = ieee_sqrt(torch.clamp(d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1]
                              + d[:, 2] * d[:, 2], min=f32(1e-24)))
    lw = lam[j] * spiky_grad_coeff(r, h)
    return pos.new_zeros(pos.shape[0], 3).index_add_(0, rows, lw[:, None] * d)


def pbf_xsph_list_plain(pairs: PairList, h: float, new_pos: torch.Tensor,
                        new_vel: torch.Tensor) -> torch.Tensor:
    """The stream form: sum w and sum v'_j w of each stored pair added into
    its row in pair order (index_add_), then sum v'_j w - v'_i sum w."""
    KERNELS["pbf_xsph"].plain_calls += 1
    rows, j = stored_pairs(pairs)
    w = poly6_w(_pair_r(new_pos[rows], new_pos[j][:, None, :])[:, 0], h)
    s = new_pos.new_zeros(new_pos.shape[0], 4).index_add_(
        0, rows, torch.cat([w[:, None], new_vel[j] * w[:, None]], dim=1))
    return s[:, 1:] - new_vel * s[:, :1]


def pbf_lambda_plain(pos: torch.Tensor, starts: torch.Tensor, grid: GridSpec,
                     h: float, lam: torch.Tensor) -> torch.Tensor:
    """The walking form, over the 27-cell stencil of `starts`: the tests'
    second reference of the stream form."""
    KERNELS["pbf_lambda"].plain_calls += 1
    out = pos.new_zeros(pos.shape[0], 3)
    for rows, pr in _pair_chunks(pos, pos, starts, grid, h, exclude_self=True):
        out[rows] = _rowsum3(pr.valid, pr,
                             lam[pr.slot] * spiky_grad_coeff(pr.r, h))
    return out


def pbf_xsph_plain(pos: torch.Tensor, starts: torch.Tensor, grid: GridSpec,
                   h: float, new_pos: torch.Tensor,
                   new_vel: torch.Tensor) -> torch.Tensor:
    """The walking form, over the 27-cell stencil of the start-of-step
    `pos` and `starts`: the tests' second reference of the stream form."""
    KERNELS["pbf_xsph"].plain_calls += 1
    out = pos.new_zeros(pos.shape[0], 3)
    for rows, pr in _pair_chunks(pos, pos, starts, grid, h, exclude_self=True):
        w = poly6_w(_pair_r(new_pos[rows], new_pos[pr.slot]), h)
        vj = new_vel[pr.slot]
        sw = _rowsum(pr.valid, w)
        sv = torch.stack([_rowsum(pr.valid, vj[..., a] * w)
                          for a in range(3)], dim=1)
        out[rows] = sv - new_vel[rows] * sw[:, None]
    return out
