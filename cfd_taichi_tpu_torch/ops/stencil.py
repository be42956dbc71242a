"""The four pair passes of a DFSPH step over the cell-sorted CSR stencil.

Each pass has three parts:

* a hand-written CUDA kernel (`csrc/*.cu`, built by ops/_build.py): one
  thread per cell-sorted query walks the 27-cell stencil of the source CSR
  table and sums in registers. What bounds every kernel on the card is
  that serial walk (load latency of ~27 x occupancy candidates), not DRAM
  bandwidth or FLOPs; the note atop each `.cu` file says what its design
  does about it;
* a plain PyTorch version of the same function, `*_plain`, which walks the
  same stencil as (Q, 27 * max_occupancy) masked candidates, chunked over
  queries so that it fits at 1M particles;
* a wrapper that launches the kernel for CUDA tensors and calls the plain
  version for CPU tensors. There is no fallback: a CUDA tensor either
  reaches its kernel or the wrapper raises.

The pair set is every source j in the 27 cells around the query's clamped
cell with r2 = |x_i - x_j|^2 <= f32(h)^2 (and j != i for fluid sources).
With no capacity anywhere this is exactly the JAX package's pair set when
its block plans do not overflow (cfd_taichi_tpu/ops/bandmat.py:32-38).

`KERNELS` counts launches and plain calls of these passes and of the
stored-coefficient engine's (ops/coef.py), so a run can show which path
carried it.
"""

from __future__ import annotations

import ctypes
from typing import Iterator, NamedTuple

import torch

from cfd_taichi_tpu_torch.ops import _build
from cfd_taichi_tpu_torch.ops.neighbors import GridSpec, cell_coords
from cfd_taichi_tpu_torch.ops.smoothing import (CubicConstants,
                                                cubic_grad_coeff, cubic_w,
                                                f32)

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
    # The stored-coefficient engine (ops/coef.py).
    Kernel("coef_build", _CSRC + "coef_build.cu",
           "cfd_taichi_tpu/ops/bandmat.py:682"),
    Kernel("coef_matvec", _CSRC + "coef_matvec.cu",
           "tools/perf_r5_mv3.py:66-69/72-77/97-125, "
           "cfd_taichi_tpu/ops/bandmat.py:817"),
    Kernel("coef_matvec_dot", _CSRC + "coef_matvec.cu",
           "tools/perf_r5_mv3.py:66-69/72-77/97-125, "
           "cfd_taichi_tpu/ops/bandmat.py:817"),
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
        c.kg6, c.kgm6)


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


def _launch(name: str, device: torch.device, *args) -> None:
    """Launch `<name>_launch` on the device's current stream; tensors in
    `args` are passed as their data pointers."""
    lib = _build.library()
    cargs = [ctypes.c_void_p(a.data_ptr()) if isinstance(a, torch.Tensor)
             else a for a in args]
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        lib.call(f"{name}_launch", *cargs, ctypes.c_void_p(stream))
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
                   rho0: float) -> BoundaryTerms:
    """K2: Akinci boundary sums of each fluid query over the cell-sorted
    boundary shell (replaces bandmat.dense_boundary_terms)."""
    if not _on_cuda("boundary_terms", pos):
        return boundary_terms_plain(pos, bpos, bvol, bstarts, grid, h, rho0)
    n, nb = pos.shape[0], bpos.shape[0]
    _check("pos", pos, torch.float32, (n, 3), pos.device)
    _check_pos_starts(bpos, bstarts, grid)
    _check("bvol", bvol, torch.float32, (nb,), pos.device)
    out = BoundaryTerms(rho=pos.new_empty(n), s=pos.new_empty(n, 3),
                        qsum=pos.new_empty(n), g2=pos.new_empty(n))
    _launch("boundary_terms", pos.device, pos, n, bpos, bvol, bstarts,
            ctypes.byref(_params(grid, h)), f32(rho0), *out)
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
    r: torch.Tensor      # sqrt(max(r2, 1e-24)), as every JAX pass takes it


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
        r = torch.sqrt(torch.clamp(r2, min=f32(1e-24)))
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
