"""The stored-coefficient loop engine: per-pair coefficients in CSR form.

Counterpart of `cfd_taichi_tpu/ops/bandmat.py:619-972` (`CoefEngine`,
`build_coef_engine`, `coef_matvec_ops`) and of the three Pallas kernels of
`tools/perf_r5_mv3.py:66-125`, which compute the same contraction. Once per
step `build_coef` stores, for every pair j != i with r2 <= f32(h)^2 (the
stencil passes' pair set, ops/stencil.py),

    nbr[p] = j,  w[p] = m gc(r_ij),   p in [offsets[i], offsets[i+1])

where `offsets` is the exclusive cumsum of `FluidTerms.count`. Each loop
iteration then contracts w against four lanes of the source particle and
finishes with JAX's split over absolute coordinates (bandmat.py:624-629):

    coef_matvec(k)[i, c]  = x_ic s0 - s(1+c),   s = sum_p w [k, xk, yk, zk]_j
    coef_matvec_dot(v)[i] = sum_c x_ic s_c - s3, s = sum_p w [v, x . v]_j

The JAX engine stores w as (QB, B, nbcap * 64) windows over block plans
with capacities; here the rows are exactly the pairs, so nothing can
overflow. w is stored as f32 or bf16; with bf16, each lane value is rounded
to bf16 before it is multiplied by w, as bandmat.py:913-914 and 958-959
round the product table.

DFSPH's pressure loops take the two contractions with their loop algebra
in the epilogue (the counterpart of JAX's `loop_operators`,
`cfd_taichi_tpu/models/dfsph.py:174-222`, which XLA fuses):

    dfsph_kick(k)  v - (S k + coef_matvec(k)) dt  [and wk + dr alpha]
    dfsph_rate(v)  d = v . S - coef_matvec_dot(v) [- c_s], then the
                   divergence rate or the predicted density, the next
                   kick's k and the residual average's inputs

Their plain versions are `kick_composition` and `rate_composition` (the
torch ops DFSPH ran around the contraction) on the plain contraction; the
recompute engine runs the same compositions on its stencil kernels. The
kernels round every operation as those torch ops do, so the two give the
same bits on the card.

The rate reads its lanes [v, x . v] from a source record: an (N, 4) f32
tensor, 16-byte aligned, rec[j] = [v_j, x_j . v_j], formed once a source
(the JAX engine's product table of its dot, bandmat.py:958-959) and
gathered as one 16-byte load a pair. The kick writes the record of the v
it returns; `dfsph_pack` writes it for a v that no kick wrote. The rate
takes the record instead of v, so a caller must hand it the record of the
v it means: models/dfsph.py says why its loops always do. The plain
versions keep that dataflow (the kick's writes the record, the rate's
contracts the record it is given and reads v from it), so a stale record
shows on the CPU too. The rate writes the next kick's k into a buffer
where it is given one (`k_out`, in place), so that a caller can keep the
last rate's k at a fixed address (models/dfsph.py), its plain version and
the composition too.

Each pass has a hand-written CUDA kernel (csrc/coef_build.cu,
csrc/coef_matvec.cu), a plain PyTorch version `*_plain`, and a wrapper that
launches the kernel for CUDA tensors and runs the plain version for CPU
tensors; any other device raises. Launches and plain calls are counted in
`stencil.KERNELS`.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Callable, NamedTuple

import numpy as np
import torch

from cfd_taichi_tpu_torch.ops.neighbors import GridSpec
from cfd_taichi_tpu_torch.ops.smoothing import cubic_grad_coeff, f32
from cfd_taichi_tpu_torch.ops.stencil import (KERNELS, _check,
                                              _check_pos_starts, _launch,
                                              _on_cuda, _pair_chunks,
                                              _params, walk_offsets)

STORAGE_DTYPES = (torch.float32, torch.bfloat16)


class CoefEngine(NamedTuple):
    offsets: torch.Tensor  # (N + 1,) int32: row i is [off[i], off[i + 1])
    nbr: torch.Tensor      # (P,) int32 source slot of each pair
    w: torch.Tensor        # (P,) f32 or bf16, m gc(r) of each pair

    @property
    def n(self) -> int:
        return self.offsets.shape[0] - 1


class Divergence(NamedTuple):
    """dfsph_rate's divergence mode: the rate dr = max(d, 0), 0 on a row
    with fewer than `min_neighbors` fluid pairs (`counts`)."""
    counts: torch.Tensor   # (N,) int32
    min_neighbors: int


class Density(NamedTuple):
    """dfsph_rate's density mode: rho_adv = max(rho + dt d, rho0)."""
    dt2: torch.Tensor      # 0-d f32, dt * dt
    rho0: float


class Rate(NamedTuple):
    """dfsph_rate's outputs."""
    dr: torch.Tensor | None  # (N,) the divergence rate (None in Density)
    k: torch.Tensor          # (N,) the next kick's stiffness over rho
    masked: torch.Tensor     # (N,) the averaged value where sel, else 0
    sel: torch.Tensor        # (N,) bool: the rows the average counts


def csr_offsets(count: torch.Tensor) -> torch.Tensor:
    """(N + 1,) int32 exclusive cumsum of the (N,) int32 pair counts."""
    off = torch.zeros(count.shape[0] + 1, dtype=torch.int32,
                      device=count.device)
    off[1:] = torch.cumsum(count, 0, dtype=torch.int32)
    return off


def _is_bf16(eng: CoefEngine) -> int:
    return int(eng.w.dtype == torch.bfloat16)


def _check_dtype(dtype: torch.dtype) -> None:
    if dtype not in STORAGE_DTYPES:
        raise ValueError(f"coef storage dtype {dtype}: want one of "
                         f"{STORAGE_DTYPES}")


def _check_engine(eng: CoefEngine, pos: torch.Tensor) -> int:
    n = pos.shape[0]
    _check("pos", pos, torch.float32, (n, 3), pos.device)
    _check("offsets", eng.offsets, torch.int32, (n + 1,), pos.device)
    p = eng.nbr.shape[0]
    _check("nbr", eng.nbr, torch.int32, (p,), pos.device)
    _check_dtype(eng.w.dtype)
    _check("w", eng.w, eng.w.dtype, (p,), pos.device)
    return n


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------

def build_coef(pos: torch.Tensor, starts: torch.Tensor, grid: GridSpec,
               h: float, m: float, offsets: torch.Tensor,
               dtype: torch.dtype = torch.float32,
               n_pairs: int | None = None) -> CoefEngine:
    """K5: the step's pair store (replaces bandmat.build_coef_engine).
    `n_pairs` is offsets[-1] when the caller has read it already; else the
    wrapper reads it (one host sync) to allocate nbr and w."""
    _check_dtype(dtype)
    if not _on_cuda("coef_build", pos):
        return build_coef_plain(pos, starts, grid, h, m, offsets, dtype)
    n = _check_pos_starts(pos, starts, grid)
    _check("offsets", offsets, torch.int32, (n + 1,), pos.device)
    p = int(offsets[-1]) if n_pairs is None else n_pairs
    if not 0 <= p <= torch.iinfo(torch.int32).max:
        raise ValueError(f"{p} pairs do not fit the int32 offsets")
    eng = CoefEngine(offsets, torch.empty(p, dtype=torch.int32,
                                          device=pos.device),
                     torch.empty(p, dtype=dtype, device=pos.device))
    _launch("coef_build", pos.device, pos, starts, n,
            ctypes.byref(_params(grid, h)), f32(m), offsets, eng.nbr, eng.w,
            _is_bf16(eng))
    return eng


def coef_matvec(eng: CoefEngine, pos: torch.Tensor, k: torch.Tensor,
                lane_sums: bool = False) -> torch.Tensor:
    """K6a: (N, 3) sum_j m gc x_ij k_j over the stored pairs (replaces the
    coef matvec contraction); with `lane_sums`, the (N, 4) sums s instead."""
    if not _on_cuda("coef_matvec", pos):
        return coef_matvec_plain(eng, pos, k, lane_sums)
    n = _check_engine(eng, pos)
    _check("k", k, torch.float32, (n,), pos.device)
    out = pos.new_empty(n, 4 if lane_sums else 3)
    _launch("coef_matvec", pos.device, pos, n, eng.offsets, eng.nbr, eng.w,
            _is_bf16(eng), k, out, int(lane_sums))
    return out


def coef_matvec_dot(eng: CoefEngine, pos: torch.Tensor, v: torch.Tensor,
                    lane_sums: bool = False) -> torch.Tensor:
    """K6b: (N,) sum_j m gc x_ij . v_j over the stored pairs; with
    `lane_sums`, the (N, 4) sums s instead."""
    if not _on_cuda("coef_matvec_dot", pos):
        return coef_matvec_dot_plain(eng, pos, v, lane_sums)
    n = _check_engine(eng, pos)
    _check("v", v, torch.float32, (n, 3), pos.device)
    out = pos.new_empty((n, 4) if lane_sums else (n,))
    _launch("coef_matvec_dot", pos.device, pos, n, eng.offsets, eng.nbr,
            eng.w, _is_bf16(eng), v, out, int(lane_sums))
    return out


def _check_record(rec: torch.Tensor, n: int, device: torch.device) -> None:
    """The source record: contiguous (n, 4) f32 on `device`, its data 16-byte
    aligned (the rate gathers a row as one float4)."""
    _check("rec", rec, torch.float32, (n, 4), device)
    if rec.data_ptr() % 16:
        raise ValueError(f"rec: want a 16-byte aligned data_ptr(), got "
                         f"{rec.data_ptr():#x}")


def _check_rows(n: int, device: torch.device, **rows) -> None:
    """Each of `rows` (n,) f32, (n, 3) f32 where its name is v or S, (n,)
    bool where it is a mask, or None."""
    for name, t in rows.items():
        if t is None:
            continue
        if name in ("upd", "owned"):
            _check(name, t, torch.bool, (n,), device)
        else:
            _check(name, t, torch.float32,
                   (n, 3) if name in ("v", "S") else (n,), device)


def dfsph_kick(eng: CoefEngine, pos: torch.Tensor, v: torch.Tensor,
               k: torch.Tensor, S: torch.Tensor, dt: torch.Tensor,
               wk: torch.Tensor | None = None,
               dr: torch.Tensor | None = None,
               alpha: torch.Tensor | None = None,
               upd: torch.Tensor | None = None,
               rec: torch.Tensor | None = None
               ) -> tuple[torch.Tensor, torch.Tensor | None, torch.Tensor]:
    """DFSPH's kick over the stored pairs (`kick_composition`): (N, 3)
    v_out = v - (S k + coef_matvec(k)) dt, v itself on the rows where `upd`
    (a rank's rows to update) is False; wk + dr alpha where `wk`, `dr` and
    `alpha` are given (the divergence loop's warm-start sum), else None;
    and the source record of v_out, every row, written into `rec` where it
    is given (in place), else into a new tensor. `dt` is a 0-d tensor on
    the rows' device."""
    on_cuda = _on_cuda("dfsph_kick", pos)
    if rec is not None:
        _check_record(rec, pos.shape[0], pos.device)
    if not on_cuda:
        return dfsph_kick_plain(eng, pos, v, k, S, dt, wk, dr, alpha, upd,
                                rec)
    n = _check_engine(eng, pos)
    if not (wk is None) == (dr is None) == (alpha is None):
        raise ValueError("dfsph_kick: give wk, dr and alpha together")
    _check_rows(n, pos.device, k=k, v=v, S=S, wk=wk, dr=dr, alpha=alpha,
                upd=upd)
    _check("dt", dt, torch.float32, (), pos.device)
    v_out = torch.empty_like(v)
    wk_out = None if wk is None else torch.empty_like(wk)
    rec = pos.new_empty(n, 4) if rec is None else rec
    _launch("dfsph_kick", pos.device, pos, n, eng.offsets, eng.nbr, eng.w,
            _is_bf16(eng), k, v, S, dt, wk, dr, alpha, upd, v_out, wk_out,
            rec)
    return v_out, wk_out, rec


def dfsph_rate(eng: CoefEngine, pos: torch.Tensor, rec: torch.Tensor,
               S: torch.Tensor, alpha: torch.Tensor, rho: torch.Tensor,
               dt: torch.Tensor, mode: Divergence | Density,
               c_s: torch.Tensor | None = None,
               owned: torch.Tensor | None = None,
               k_out: torch.Tensor | None = None) -> Rate:
    """DFSPH's density rate over the stored pairs (`rate_composition`) of
    the velocities v whose source record is `rec` (`dfsph_pack`, or the
    kick's): d = v . S - coef_matvec_dot(v), less the contact dot `c_s` of
    a coupled scene, then `mode`'s value and the next kick's k (written
    into `k_out` where it is given), and the residual average's inputs,
    counted on the rows of `owned` only where it is given (a rank's own
    rows). `dt` (and Density's dt2) 0-d tensors on the rows' device."""
    on_cuda = _on_cuda("dfsph_rate", pos)
    _check_record(rec, pos.shape[0], pos.device)
    if k_out is not None:
        _check("k_out", k_out, torch.float32, (pos.shape[0],), pos.device)
    if not on_cuda:
        return dfsph_rate_plain(eng, pos, rec, S, alpha, rho, dt, mode, c_s,
                                owned, k_out)
    n = _check_engine(eng, pos)
    _check_rows(n, pos.device, S=S, alpha=alpha, rho=rho, c_s=c_s,
                owned=owned)
    _check("dt", dt, torch.float32, (), pos.device)
    div = isinstance(mode, Divergence)
    if div:
        _check("counts", mode.counts, torch.int32, (n,), pos.device)
    else:
        _check("dt2", mode.dt2, torch.float32, (), pos.device)
    out = Rate(pos.new_empty(n) if div else None,
               pos.new_empty(n) if k_out is None else k_out, pos.new_empty(n),
               torch.empty(n, dtype=torch.bool, device=pos.device))
    _launch("dfsph_rate", pos.device, pos, n, eng.offsets, eng.nbr, eng.w,
            _is_bf16(eng), rec, S, c_s, mode.counts if div else None,
            mode.min_neighbors if div else 0, alpha, rho, dt,
            None if div else mode.dt2, 0.0 if div else f32(mode.rho0),
            owned, out.dr, out.k, out.masked, out.sel)
    return out


def dfsph_pack(pos: torch.Tensor, v: torch.Tensor,
               out: torch.Tensor | None = None) -> torch.Tensor:
    """The (N, 4) source record [v, x . v] of velocities `v` at `pos`, for
    a rate whose v no kick wrote; written into `out` where it is given (in
    place), else into a new tensor."""
    on_cuda = _on_cuda("dfsph_pack", pos)
    n = pos.shape[0]
    if out is not None:
        _check_record(out, n, pos.device)
    if not on_cuda:
        return dfsph_pack_plain(pos, v, out)
    _check("pos", pos, torch.float32, (n, 3), pos.device)
    _check("v", v, torch.float32, (n, 3), pos.device)
    out = pos.new_empty(n, 4) if out is None else out
    _launch("dfsph_pack", pos.device, pos, n, v, out)
    return out


# ---------------------------------------------------------------------------
# The loop algebra's torch ops: the plain versions' and the recompute
# engine's
# ---------------------------------------------------------------------------

def kick_composition(matvec: Callable, v: torch.Tensor, k: torch.Tensor,
                     S: torch.Tensor, dt: torch.Tensor,
                     wk: torch.Tensor | None = None,
                     dr: torch.Tensor | None = None,
                     alpha: torch.Tensor | None = None,
                     upd: torch.Tensor | None = None
                     ) -> tuple[torch.Tensor, torch.Tensor | None]:
    """`dfsph_kick` as torch ops around `matvec` (k -> (N, 3)): JAX's
    stiff_vel_delta(k) = S k + matvec(k) times dt off v."""
    new = v - (S * k[:, None] + matvec(k)) * dt
    if upd is not None:
        new = torch.where(upd[:, None], new, v)
    return new, (None if wk is None else wk + dr * alpha)


def rate_composition(matvec_dot: Callable, v: torch.Tensor, S: torch.Tensor,
                     alpha: torch.Tensor, rho: torch.Tensor,
                     dt: torch.Tensor, mode: Divergence | Density,
                     c_s: torch.Tensor | None = None,
                     owned: torch.Tensor | None = None,
                     k_out: torch.Tensor | None = None) -> Rate:
    """`dfsph_rate` as torch ops around `matvec_dot` (v -> (N,)): JAX's
    rho_derivative (Divergence) or rho_adv_residual (Density) up to the
    average, whose count and total are `sel.sum()` and `masked.sum()`; k
    written into `k_out` where it is given."""
    d = (v[:, 0] * S[:, 0] + v[:, 1] * S[:, 1] + v[:, 2] * S[:, 2]
         - matvec_dot(v))
    if c_s is not None:
        d = d - c_s
    if isinstance(mode, Divergence):
        dr = torch.where(mode.counts < mode.min_neighbors,
                         torch.zeros_like(d), torch.clamp(d, min=0.0))
        val, sel = dr, dr > 0.0
        k = torch.div(dr * alpha / dt, rho, out=k_out)
    else:
        dr = None
        val = torch.clamp(rho + dt * d, min=mode.rho0)
        sel = val != mode.rho0
        k = torch.div((val - mode.rho0) * alpha / mode.dt2, rho, out=k_out)
    if owned is not None:
        sel = sel & owned
    return Rate(dr, k, torch.where(sel, val, torch.zeros_like(val)), sel)


# ---------------------------------------------------------------------------
# Plain PyTorch versions
# ---------------------------------------------------------------------------

def dfsph_kick_plain(eng: CoefEngine, pos: torch.Tensor, v: torch.Tensor,
                     k: torch.Tensor, S: torch.Tensor, dt: torch.Tensor,
                     wk: torch.Tensor | None = None,
                     dr: torch.Tensor | None = None,
                     alpha: torch.Tensor | None = None,
                     upd: torch.Tensor | None = None,
                     rec: torch.Tensor | None = None
                     ) -> tuple[torch.Tensor, torch.Tensor | None,
                                torch.Tensor]:
    KERNELS["dfsph_kick"].plain_calls += 1
    v_out, wk_out = kick_composition(
        functools.partial(coef_matvec_plain, eng, pos), v, k, S, dt, wk, dr,
        alpha, upd)
    return v_out, wk_out, _into(rec, _record(pos, v_out))


def dfsph_rate_plain(eng: CoefEngine, pos: torch.Tensor, rec: torch.Tensor,
                     S: torch.Tensor, alpha: torch.Tensor, rho: torch.Tensor,
                     dt: torch.Tensor, mode: Divergence | Density,
                     c_s: torch.Tensor | None = None,
                     owned: torch.Tensor | None = None,
                     k_out: torch.Tensor | None = None) -> Rate:
    """The composition over the record: its lanes contracted as they are,
    v read from its first three columns."""
    KERNELS["dfsph_rate"].plain_calls += 1
    return rate_composition(
        lambda _: _dot_finish(pos, _contract_plain(eng, rec)), rec[:, :3], S,
        alpha, rho, dt, mode, c_s, owned, k_out)


def dfsph_pack_plain(pos: torch.Tensor, v: torch.Tensor,
                     out: torch.Tensor | None = None) -> torch.Tensor:
    KERNELS["dfsph_pack"].plain_calls += 1
    return _into(out, _record(pos, v))


def _record(pos: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """[v, x . v], x . v summed x + y + z as coef_matvec_dot's lanes."""
    xv = pos[:, 0] * v[:, 0] + pos[:, 1] * v[:, 1] + pos[:, 2] * v[:, 2]
    return torch.cat([v, xv[:, None]], dim=1)


def _into(out: torch.Tensor | None, rec: torch.Tensor) -> torch.Tensor:
    return rec if out is None else out.copy_(rec)


def build_coef_plain(pos: torch.Tensor, starts: torch.Tensor,
                     grid: GridSpec, h: float, m: float,
                     offsets: torch.Tensor,
                     dtype: torch.dtype = torch.float32) -> CoefEngine:
    """Pairs in the kernel's walk order, so that nbr compares exactly."""
    KERNELS["coef_build"].plain_calls += 1
    _check_dtype(dtype)
    nbr = [pos.new_zeros(0, dtype=torch.int32)]
    w = [pos.new_zeros(0)]
    for _, pr in _pair_chunks(pos, pos, starts, grid, h, exclude_self=True,
                              offsets=walk_offsets(grid)):
        nbr.append(pr.slot[pr.valid].to(torch.int32))
        w.append((f32(m) * cubic_grad_coeff(pr.r, h))[pr.valid])
    eng = CoefEngine(offsets, torch.cat(nbr), torch.cat(w).to(dtype))
    if eng.nbr.shape[0] != int(offsets[-1]):
        raise ValueError(f"offsets hold {int(offsets[-1])} pairs, the "
                         f"stencil found {eng.nbr.shape[0]}")
    return eng


def _contract_plain(eng: CoefEngine, lanes: torch.Tensor) -> torch.Tensor:
    """(N, 4) sums over each row's pairs of w * lanes[nbr], the lanes
    rounded to the storage dtype first."""
    lanes = lanes.to(eng.w.dtype).float()
    rows = torch.repeat_interleave(
        torch.arange(eng.n, device=lanes.device), eng.offsets.diff())
    return lanes.new_zeros(eng.n, 4).index_add_(
        0, rows, eng.w.float()[:, None] * lanes[eng.nbr.long()])


def coef_matvec_plain(eng: CoefEngine, pos: torch.Tensor, k: torch.Tensor,
                      lane_sums: bool = False) -> torch.Tensor:
    KERNELS["coef_matvec"].plain_calls += 1
    s = _contract_plain(eng, torch.stack(
        [k, pos[:, 0] * k, pos[:, 1] * k, pos[:, 2] * k], dim=1))
    return s if lane_sums else pos * s[:, :1] - s[:, 1:]


def coef_matvec_dot_plain(eng: CoefEngine, pos: torch.Tensor,
                          v: torch.Tensor,
                          lane_sums: bool = False) -> torch.Tensor:
    KERNELS["coef_matvec_dot"].plain_calls += 1
    s = _contract_plain(eng, _record(pos, v))
    return s if lane_sums else _dot_finish(pos, s)


def _dot_finish(pos: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """coef_matvec_dot's final form of its lane sums s: x . s - s3."""
    return pos[:, 0] * s[:, 0] + pos[:, 1] * s[:, 1] + pos[:, 2] * s[:, 2] \
        - s[:, 3]


# ---------------------------------------------------------------------------
# From the JAX engine
# ---------------------------------------------------------------------------

def coef_from_blocks(blkq: np.ndarray, w: np.ndarray, n: int, B: int,
                     block: int) -> CoefEngine:
    """The CSR engine of a JAX `bandmat.CoefEngine`, from its numpy arrays:
    `blkq` (QB, nbcap) source-block ids and `w` (QB, B, nbcap * block), f32
    or bf16. Slot c of query q = g B + b reads source blkq[g, c // block] *
    block + c % block. Zero coefficients are dropped: masked and padding
    slots hold 0, and so do pairs at r = h, which add nothing."""
    blkq, w = np.asarray(blkq), np.asarray(w)
    qb, b, width = w.shape
    if b != B or blkq.shape[0] != qb or blkq.shape[1] * block != width:
        raise ValueError(f"blkq {blkq.shape} and w {w.shape} do not match "
                         f"B={B}, block={block}")
    src = (blkq[:, :, None].astype(np.int64) * block
           + np.arange(block)).reshape(qb, 1, width)
    src = np.broadcast_to(src, w.shape).reshape(qb * b, width)[:n]
    wf = w.astype(np.float32).reshape(qb * b, width)[:n]
    keep = wf != 0.0
    offsets = np.zeros(n + 1, np.int32)
    offsets[1:] = np.cumsum(keep.sum(axis=1))
    wt = torch.from_numpy(wf[keep])
    return CoefEngine(torch.from_numpy(offsets),
                      torch.from_numpy(src[keep].astype(np.int32)),
                      wt.to(torch.bfloat16) if w.dtype.name == "bfloat16"
                      else wt)
