"""Every hand-written kernel's call on a scene's seed lattice, beside its
plain version, its work and, for the coef contraction, the one PyTorch
call that computes its lane sums; and the one measurement of such a call
that chip_smoke.py and perf/kernel_table.py share: its time (CUDA events),
its bound and the share of it reached, and the library call's time."""

from __future__ import annotations

import functools
from typing import Callable, Iterator, NamedTuple

import torch

from cfd_taichi_tpu_torch.models import base, pbf
from cfd_taichi_tpu_torch.ops import coef
from cfd_taichi_tpu_torch.ops import stencil as S
from cfd_taichi_tpu_torch.perf import bounds, timing

VISC = dict(c_s=13.0, alpha=0.08)
WCSPH = dict(c_s=10.0, alpha=0.08, tension_k=0.2)
RHO0 = 1000.0
# (kernel, wrapper, plain version, key of its source in the inputs, dot)
CONTRACTIONS = (
    ("coef_matvec", coef.coef_matvec, coef.coef_matvec_plain, "k", False),
    ("coef_matvec_dot", coef.coef_matvec_dot, coef.coef_matvec_dot_plain,
     "v", True))


class Case(NamedTuple):
    name: str              # the kernel's name in stencil.KERNELS
    key: str               # name, with "_bf16" for bf16 coef storage
    kern: Callable         # the wrapper's call (a CUDA launch on the card)
    plain: Callable        # the plain version's call on the same inputs
    work: bounds.Work
    # {lanes layout: call} of the one-call library yardstick, or {}; the
    # contraction's kern and plain then also take `lane_sums=True`.
    library: dict = {}


def fluid_pairs(x: dict) -> int:
    """Fluid pairs within h of lattice inputs `x` (perf/inputs.py)."""
    sc = x["sc"]
    return int(S.fluid_terms(x["p"], x["st"], sc.grid, sc.h, sc.particle_m)
               .count.sum(dtype=torch.int64))


def coef_lanes(dot: bool, pos: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The (N, 4) f32 lanes that coef_matvec (x = k) or coef_matvec_dot
    (x = v) forms in registers: [k, x k, y k, z k] or [v, x . v]."""
    if dot:
        return torch.cat([x, (pos * x).sum(dim=1, keepdim=True)], dim=1)
    return torch.cat([x[:, None], pos * x[:, None]], dim=1)


def library_calls(eng: coef.CoefEngine, lanes: torch.Tensor) -> dict:
    """{layout: call}: `torch.sparse_csr_tensor(offsets, nbr, w) @ lanes`,
    a CSR sparse x dense product (cuSPARSE SpMM on the card) with the lanes
    rounded to the storage dtype, row-major and column-major. A yardstick
    for the kernels, which the port never calls; a call raises where
    PyTorch refuses the product for this dtype."""
    a = torch.sparse_csr_tensor(eng.offsets, eng.nbr, eng.w, (eng.n, eng.n),
                                check_invariants=False)
    rows = lanes.to(eng.w.dtype).contiguous()
    cols = rows.t().contiguous().t()
    return {"row-major": lambda: a @ rows, "column-major": lambda: a @ cols}


def scene_cases(x: dict, pairs: int) -> Iterator[Case]:
    """The cases of lattice inputs `x` with `pairs` fluid pairs: the
    stencil passes, then for f32 and bf16 storage coef_build and the
    contraction pair on the engine it builds."""
    sc, p, st, k, v, rho, pr = (x[key] for key in
                                ("sc", "p", "st", "k", "v", "rho", "pr"))
    g, h, m = sc.grid, sc.h, sc.particle_m
    work = bounds.scene_work(sc, p, st, pairs)
    bnd = (sc.boundary_pos, sc.boundary_volume, sc.boundary_starts, g, h,
           1000.0)
    for name, kern, plain in (
            ("fluid_terms", lambda: S.fluid_terms(p, st, g, h, m),
             lambda: S.fluid_terms_plain(p, st, g, h, m)),
            ("boundary_terms",
             lambda: S.boundary_terms(p, *bnd, sc.boundary_near),
             lambda: S.boundary_terms_plain(p, *bnd)),
            ("matvec", lambda: S.matvec(p, st, g, h, m, k),
             lambda: S.matvec_plain(p, st, g, h, m, k)),
            ("matvec_dot", lambda: S.matvec_dot(p, st, g, h, m, v),
             lambda: S.matvec_dot_plain(p, st, g, h, m, v)),
            ("viscosity",
             lambda: S.viscosity(p, st, g, h, m, v, rho, **VISC),
             lambda: S.viscosity_plain(p, st, g, h, m, v, rho, **VISC)),
            ("wcsph_forces",
             lambda: S.wcsph_forces(p, st, g, h, m, v, rho, pr, **WCSPH),
             lambda: S.wcsph_forces_plain(p, st, g, h, m, v, rho, pr,
                                          **WCSPH))):
        yield Case(name, name, kern, plain, work[name])
    yield from solver_cases(p, st, g, h, m, base.walls(sc), x, work)
    off = coef.csr_offsets(S.fluid_terms(p, st, g, h, m).count)
    for dtype, sfx in ((torch.float32, ""), (torch.bfloat16, "_bf16")):
        yield Case("coef_build", "coef_build" + sfx,
                   lambda d=dtype: coef.build_coef(p, st, g, h, m, off, d,
                                                   pairs),
                   lambda d=dtype: coef.build_coef_plain(p, st, g, h, m, off,
                                                         d),
                   work["coef_build" + sfx])
        eng = coef.build_coef(p, st, g, h, m, off, dtype, pairs)
        for name, fn, plain, src, dot in CONTRACTIONS:
            yield Case(name, name + sfx, functools.partial(fn, eng, p, x[src]),
                       functools.partial(plain, eng, p, x[src]),
                       work[name + sfx],
                       library_calls(eng, coef_lanes(dot, p, x[src])))
        del eng


def solver_cases(p, st, g, h: float, m: float, walls: S.Walls, x: dict,
                 work: dict) -> Iterator[Case]:
    """The PCISPH and PBF kernels on cell-sorted `p` with CSR `st` and the
    boundary set `walls`, as their steps call them on a scene with walls:
    the predicted density at x["shifted"], pbf_terms' fluid and boundary
    entries together, pbf_lambda of x["lam"], pbf_xsph at x["shifted"]
    with velocities x["v"]. `work` by kernel name, or {} (no bound)."""
    sp, lam, v = x["shifted"], x["lam"], x["v"]
    wr, kc = pbf.w_ref(h), pbf.TENSION_K

    def terms(fluid, boundary):
        return lambda: (*fluid(p, st, g, h, m, wr, kc),
                        *boundary(p, walls, g, h, RHO0, wr, kc))

    for name, kern, plain in (
            ("pcisph_predict_rho",
             lambda: S.pcisph_predict_rho(p, st, g, h, m, sp, walls, RHO0),
             lambda: S.pcisph_predict_rho_plain(p, st, g, h, m, sp, walls,
                                                RHO0)),
            ("pbf_terms", terms(S.pbf_terms, S.pbf_boundary_terms),
             terms(S.pbf_terms_plain, S.pbf_boundary_terms_plain)),
            ("pbf_lambda", lambda: S.pbf_lambda(p, st, g, h, lam),
             lambda: S.pbf_lambda_plain(p, st, g, h, lam)),
            ("pbf_xsph", lambda: S.pbf_xsph(p, st, g, h, sp, v),
             lambda: S.pbf_xsph_plain(p, st, g, h, sp, v))):
        yield Case(name, name, kern, plain, work.get(name))


def lane_error(got: torch.Tensor, want: torch.Tensor) -> float:
    """Largest |got - want| of the four lane sums over that lane's largest
    |want|."""
    return max(float((got[:, r] - want[:, r]).abs().max())
               / max(float(want[:, r].abs().max()), 1e-30) for r in range(4))


def scaled_error(got: torch.Tensor, want: torch.Tensor) -> float:
    """Largest |got - want| over the largest |want|."""
    return float((got - want).abs().max()) / max(float(want.abs().max()),
                                                  1e-30)


def terms_error(got: tuple, want: tuple) -> float:
    """fluid_terms' or boundary_terms' outputs against the plain
    version's: the largest `scaled_error` of the float outputs, or inf
    where an integer output (the pair count) differs anywhere."""
    worst = 0.0
    for a, b in zip(got, want):
        if not b.dtype.is_floating_point:
            if not torch.equal(a, b):
                return float("inf")
            continue
        worst = max(worst, scaled_error(a, b))
    return worst


def build_error(got: coef.CoefEngine, want: coef.CoefEngine) -> dict:
    """How coef_build's engine differs from the plain build's: `nbr_bad`
    slots that differ (the walk order is kept, so want 0), the largest
    |w - w_plain| (`w_abs_err`) and over the largest |w_plain| (`w_err`).
    f32 w holds to 1e-5 of scale. A bf16 w may round a value that sits on
    a rounding boundary the other way, so `w_off` slots may differ, each
    by at most one ulp (2^-7 relative), in at most 1e-4 of the slots.
    `ok` says whether all of it holds."""
    a, b = got.w.float(), want.w.float()
    err = float((a - b).abs().max()) if b.numel() else 0.0
    row = dict(nbr_bad=int((got.nbr != want.nbr).sum()), w_abs_err=err,
               w_err=err / max(float(b.abs().max()), 1e-30)
               if b.numel() else 0.0)
    if got.w.dtype == torch.float32:
        row["ok"] = row["nbr_bad"] == 0 and row["w_err"] <= 1e-5
        return row
    row["w_off"] = int((a != b).sum())
    row["ok"] = (row["nbr_bad"] == 0 and row["w_off"] <= 1e-4 * b.numel()
                 and bool(((a - b).abs() <= 2.0**-7 * b.abs()).all()))
    return row


def measure(case: Case) -> dict:
    """The case's kernel time (CUDA events, median of 10), its bound (and
    the walk's, `bounds.Work.walk_ops`) and the share of the bound reached.
    With a library yardstick also the kernel's lane-sum call and each
    layout of the library call, timed alike, and the library's error
    against the kernel's lane sums; `library_ms` is the faster layout's
    time, null where PyTorch refuses the product."""
    ms = timing.event_ms(case.kern)
    bound_s, by = case.work.bound()
    walk = bounds.Work(case.work.bytes, case.work.walk_ops).bound()[0]
    row = dict(ms=ms, bound_ms=bound_s * 1e3, bound_by=by,
               share=bound_s * 1e3 / ms, walk_bound_ms=walk * 1e3)
    if not case.library:
        return row
    want = case.kern(lane_sums=True)
    row["lane_sums_ms"] = timing.event_ms(
        lambda: case.kern(lane_sums=True))
    row["library_ms"] = row["library_layout"] = None
    for layout, call in case.library.items():
        try:
            err = lane_error(call().float(), want)
        except (RuntimeError, NotImplementedError) as e:
            row[f"library_note_{layout}"] = \
                f"not available: {str(e).splitlines()[0]}"
            continue
        lib_ms = timing.event_ms(call)
        row[f"library_ms_{layout}"] = lib_ms
        row[f"library_err_{layout}"] = err
        if row["library_ms"] is None or lib_ms < row["library_ms"]:
            row["library_ms"], row["library_layout"] = lib_ms, layout
    return row
