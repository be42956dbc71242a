"""Every hand-written kernel's call on a scene's seed lattice, beside its
plain version, its work and, for the coef contraction and the body's
reaction stream, the one PyTorch call that computes the same function;
and the one measurement of such a call that chip_smoke.py and perf/
kernel_table.py share: its time (CUDA events), its bound and the share of
it reached, and the library call's time."""

from __future__ import annotations

import functools
from typing import Callable, Iterator, NamedTuple

import numpy as np
import torch

from cfd_taichi_tpu_torch.models import base, dfsph, pbf
from cfd_taichi_tpu_torch.ops import coef
from cfd_taichi_tpu_torch.ops import rigid as R
from cfd_taichi_tpu_torch.ops import stencil as S
from cfd_taichi_tpu_torch.ops.neighbors import cell_id
from cfd_taichi_tpu_torch.ops.smoothing import f32
from cfd_taichi_tpu_torch.perf import bounds, timing

VISC = dict(c_s=13.0, alpha=0.08)
WCSPH = dict(c_s=10.0, alpha=0.08, tension_k=0.2)
RHO0 = 1000.0
# The device kernel of a case whose name is not its kernel's: the body's
# walk runs inside the launch of the predicted density's stream form (the
# coupled PCISPH step's on the stored-coefficient engine).
DEVICE_KERNEL = {"pcisph_predict_rho_rigid": "pcisph_predict_rho_list"}
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
    # {layout: call} of the one-call library yardstick, or {}: for the
    # coef contraction its lane sums (kern and plain then also take
    # `lane_sums=True`), else the kernel's output.
    library: dict = {}
    # maps kern's or plain's output to the tensors compared, or None (all
    # of them): pbf_terms' pair list is compared row by row (`compared`)
    view: Callable | None = None
    # DFSPH's loop kernels: the parent's composition on the same inputs
    # (the contraction's kernel and the torch ops around it), whose bits
    # the kernel must give, and the magnitudes of each output's terms
    # (`fused_scales`), to which `fused_error` holds it against the plain
    # version
    parent: Callable | None = None
    scales: Callable | None = None


def compared(case: Case) -> tuple[tuple, tuple]:
    """The kernel's and the plain version's outputs of `case`, as tensors
    that must agree (the pair list's rows without the slots past their
    counts, which nothing writes or reads)."""
    got, want = case.kern(), case.plain()
    if case.view is not None:
        return case.view(got), case.view(want)
    return ((got if isinstance(got, tuple) else (got,)),
            (want if isinstance(want, tuple) else (want,)))


def pbf_terms_view(out: tuple) -> tuple:
    """PBF's constraint pass (pbf_terms' one launch): the rows' constraint,
    lambda, gsum and ssum, and its pair list as each row's count and the
    sources of all rows in pair order (int32, compared exactly)."""
    rows, pairs = out
    return (*rows, pairs.cnt, S.stored_pairs(pairs)[1].to(torch.int32))


# A rest density below the lattices' (whose rows are all unconstrained at
# PBF's 1000), at which most lattice rows are constrained, so that their
# lambda takes its division.
LOW_RHO0 = 800.0


def pbf_constraint_args(p, st, g, h: float, m: float, rows, walls,
                        rho0: float = pbf.RHO_0) -> tuple:
    """The arguments of `stencil.pbf_constraint` (and its plain version) as
    the PBF step passes them, on cell-sorted `p` with CSR `st`, the list's
    `rows` and the boundary set `walls` (or None), at rest density `rho0`
    (the step's, or LOW_RHO0)."""
    return (p, st, g, h, m, pbf.w_ref(h), pbf.TENSION_K, rows, walls, rho0,
            *pbf.ROW_CONSTANTS[1:])


def side_list_view(side: R.SideList) -> tuple:
    """The reaction list as each row's count and, over all rows in pair
    order, the fluid indices (int32, compared exactly) and the pair
    vectors g."""
    _, i, g = R.side_pairs(side)
    return side.cnt, i.to(torch.int32), g


def side_list(x: dict) -> tuple[tuple, R.SideList]:
    """The arguments of `rigid_side_list` on coupled inputs `x`, its rows
    made as a step makes them (`rigid_side_rows`), and the list its
    wrapper builds from them: the list the stream reads."""
    offs = R.rigid_side_rows(x["rpos"], x["st"], x["grid"])
    args = (x["rpos"], x["rvol"], x["p"], x["st"], x["grid"], x["h"], RHO0,
            offs, R.list_slots(offs))
    return args, R.rigid_side_list(*args)


def side_library_calls(side: R.SideList, u: torch.Tensor,
                       force: torch.Tensor) -> dict:
    """{form: call}: the reaction stream's function as one sparse matrix-
    vector product, force + G u with G the (3 Nr, N) CSR matrix of the
    stored g (row 3 j + axis, column the fluid index i), made here outside
    the timing: `torch.addmv` and `@` (cuSPARSE SpMV on the card). A
    yardstick for the stream, which the port never calls."""
    rows, i, g = R.side_pairs(side)
    nr = side.cnt.shape[0]
    axis = torch.arange(3, device=i.device)
    a = torch.sparse_coo_tensor(
        torch.stack([(3 * rows[:, None] + axis).reshape(-1),
                     i[:, None].expand(-1, 3).reshape(-1)]),
        g.reshape(-1), (3 * nr, u.shape[0]),
        check_invariants=False).coalesce().to_sparse_csr()
    f = force.reshape(-1)
    return {"addmv": lambda: torch.addmv(f, a, u).view(nr, 3),
            "matmul": lambda: (f + a @ u).view(nr, 3)}


def fluid_pairs(x: dict) -> int:
    """Fluid pairs within h of lattice inputs `x` (perf/inputs.py)."""
    sc = x["sc"]
    return int(S.fluid_terms(x["p"], x["st"], sc.grid, sc.h, sc.particle_m)
               .count.sum(dtype=torch.int64))


def pair_store(p, st, g, h: float, m: float) -> coef.CoefEngine:
    """The f32 pair store of cell-sorted `p` with CSR `st`, as a step of the
    stored-coefficient engine builds it (fluid_terms' counts, coef_build):
    the rows that PCISPH's stream form sums over."""
    count = S.fluid_terms(p, st, g, h, m).count
    return coef.build_coef(p, st, g, h, m, coef.csr_offsets(count))


def ungated_box(device) -> torch.Tensor:
    """A body gate that holds every query: the body's walk of a gated pass
    (the predicted density, the contact dot, the solid viscosity) taken by
    every warp, as before the gate."""
    inf = float("inf")
    return torch.tensor([[-inf] * 3, [inf] * 3], dtype=torch.float32,
                        device=device)


def gate_box(x: dict) -> torch.Tensor:
    """The body's gate of coupled inputs `x`, made as a step makes it
    (`models/base.body_terms`)."""
    return S.make_body_box(x["table"].pos, x["h"])


def gated_calls(x: dict) -> dict:
    """{kernel: (call, plain)} of the three fluid-side passes that gate
    their walk of the body, on coupled inputs `x`: each call takes a gate,
    `gate_box(x)` or `ungated_box`, so that the two launches can be held
    to each other bit for bit (`same_bits`) and timed in turns."""
    g, h, m, p, t = (x[k] for k in ("grid", "h", "m", "p", "table"))
    terms = (p, t, g, h, RHO0)
    dot = (p, t, g, h, RHO0, x["v_r"])
    visc = (p, t, g, h, RHO0, m, x["v"], x["rho"], x["rho_quirk"],
            x["body_vel"], VISC["c_s"], VISC["alpha"])
    return {"rigid_terms": (
                lambda b: R.rigid_terms(*terms, body_box=b),
                lambda: R.rigid_terms_plain(*terms)),
            "rigid_contact_dot": (
                lambda b: R.rigid_contact_dot(*dot, body_box=b),
                lambda: R.rigid_contact_dot_plain(*dot)),
            "rigid_viscosity": (
                lambda b: R.rigid_viscosity(*visc, body_box=b),
                lambda: R.rigid_viscosity_plain(*visc))}


def tensors(out) -> tuple:
    """A call's output as a tuple of tensors: its own (rigid_terms' four
    sums), or the one it is."""
    return tuple(out) if isinstance(out, tuple) else (out,)


def same_bits(a, b) -> bool:
    """Whether two calls' outputs are equal bit for bit, tensor by
    tensor."""
    return all(torch.equal(u, v) for u, v in zip(tensors(a), tensors(b)))


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


# The forms of DFSPH's loop kernels that `scene_cases` yields, by storage
DFSPH_FORMS = {"": ("", "_div", "_mask", "_mask_den"), "_bf16": ("", "_div")}


def scene_cases(x: dict, pairs: int) -> Iterator[Case]:
    """The cases of lattice inputs `x` with `pairs` fluid pairs: the
    stencil passes, then for f32 and bf16 storage coef_build, the
    contraction pair and DFSPH's loop kernels (`dfsph_cases`, in the
    forms of DFSPH_FORMS) on the engine it builds, then dfsph_pack of
    v."""
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
    dfsph = dfsph_inputs(p, st, g, h, m, rho, seed=11)
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
        yield from dfsph_cases(eng, p, v, k, dfsph, sfx, DFSPH_FORMS[sfx])
        del eng
    yield Case("dfsph_pack", "dfsph_pack",
               functools.partial(coef.dfsph_pack, p, v),
               functools.partial(coef.dfsph_pack_plain, p, v),
               work["dfsph_pack"])


# The dt of DFSPH's loop kernels' inputs: TINY's delta_time, inside the
# adaptive dt's range [1e-5, 1e-3] (models/dfsph.py)
DFSPH_DT = 4e-4


def dfsph_inputs(p, st, g, h: float, m: float, rho: torch.Tensor,
                 seed: int) -> dict:
    """What DFSPH's loop kernels read besides the engine, v and k, on
    cell-sorted `p` with CSR `st`: S, the pair counts and alpha = rho /
    (|S|^2 + qsum) from fluid_terms (as `dfsph.dense_pre_terms` makes them
    without walls) at densities `rho`, dt = DFSPH_DT and dt^2 as 0-d
    tensors, then with numpy from `seed` a warm-start sum wk, a rate
    dr >= 0, a contact dot c_s of the scale of v . S for a unit v, and
    the masks owned (90 % of the rows) and upd (95 %)."""
    ft = S.fluid_terms(p, st, g, h, m)
    denom = (ft.s * ft.s).sum(dim=1) + ft.qsum
    alpha = torch.where(denom.abs() < 1e-6, torch.zeros_like(rho),
                        rho / denom)
    rng = np.random.default_rng(seed)
    n = p.shape[0]

    def dev(a):
        return torch.from_numpy(a).to(p.device)

    dt = torch.tensor(DFSPH_DT, dtype=torch.float32, device=p.device)
    scale = float(ft.s.norm(dim=1).mean())
    return dict(S=ft.s, counts=ft.count, alpha=alpha, rho=rho, dt=dt,
                dt2=dt * dt,
                wk=dev(rng.uniform(-1.0, 1.0, n).astype(np.float32)),
                dr=dev(rng.uniform(0.0, 1.0, n).astype(np.float32)),
                c_s=dev((rng.standard_normal(n) * scale).astype(np.float32)),
                owned=dev(rng.uniform(0.0, 1.0, n) < 0.9),
                upd=dev(rng.uniform(0.0, 1.0, n) < 0.95))


def dfsph_cases(eng: coef.CoefEngine, p: torch.Tensor, v: torch.Tensor,
                k: torch.Tensor, d: dict, sfx: str = "",
                forms: tuple = ("", "_div")) -> Iterator[Case]:
    """dfsph_kick and dfsph_rate on engine `eng` over `p`, with v, k and
    `d` (`dfsph_inputs`), in each of `forms`: "" as the density loop calls
    them (the kick without wk, the rate in Density mode), "_div" as the
    divergence loop does (the kick with wk, dr and alpha, the rate in
    Divergence mode), "_mask" as a rank of a sharded coupled step does
    (the divergence forms with upd, and c_s and owned), "_mask_den" (the
    density forms so). The rate reads the source record of v, packed once
    here by the plain version. `parent` is the composition the loops ran
    before the kernels (the contraction's kernel, then the torch ops, on
    v), the kick's with the record packed from its v_out. Keys are name +
    form + `sfx`."""
    n, pairs, wb = p.shape[0], eng.nbr.shape[0], eng.w.element_size()
    density = coef.Density(d["dt2"], RHO0)
    divergence = coef.Divergence(d["counts"], dfsph.MIN_NEIGHBORS)
    wk = (d["wk"], d["dr"], d["alpha"])
    rec = coef.dfsph_pack_plain(p, v)
    mv = functools.partial(coef.coef_matvec, eng, p)
    mvd = functools.partial(coef.coef_matvec_dot, eng, p)
    for form in forms:
        div, mask = form != "_mask_den" and form != "", "_mask" in form
        kick_args = (v, k, d["S"], d["dt"]) + (wk if div else ()) + (
            (None,) * 3 * (not div) + (d["upd"],) if mask else ())
        rate_args = (d["S"], d["alpha"], d["rho"], d["dt"],
                     divergence if div else density) + (
            (d["c_s"], d["owned"]) if mask else ())
        yield Case("dfsph_kick", "dfsph_kick" + form + sfx,
                   functools.partial(coef.dfsph_kick, eng, p, *kick_args),
                   functools.partial(coef.dfsph_kick_plain, eng, p,
                                     *kick_args),
                   bounds.dfsph_kick_work(n, pairs, wb, div, mask),
                   parent=functools.partial(parent_kick, mv, p, *kick_args),
                   scales=functools.partial(fused_scales, "dfsph_kick", eng,
                                            p, *kick_args))
        yield Case("dfsph_rate", "dfsph_rate" + form + sfx,
                   functools.partial(coef.dfsph_rate, eng, p, rec,
                                     *rate_args),
                   functools.partial(coef.dfsph_rate_plain, eng, p, rec,
                                     *rate_args),
                   bounds.dfsph_rate_work(n, pairs, wb, div, mask, mask),
                   parent=functools.partial(coef.rate_composition, mvd, v,
                                            *rate_args),
                   scales=functools.partial(fused_scales, "dfsph_rate", eng,
                                            p, v, *rate_args))


def parent_kick(mv: Callable, p: torch.Tensor, *args) -> tuple:
    """The kick's composition around `mv` with `args` (v, k, S, dt, ...),
    and the source record packed from its v_out by the plain version."""
    v_out, wk_out = coef.kick_composition(mv, *args)
    return v_out, wk_out, coef.dfsph_pack_plain(p, v_out)


def _cancel(pos: torch.Tensor, sums: torch.Tensor, lanes: int) -> float:
    """The largest |x_i| |s_i| over the first `lanes` lane sums plus the
    largest of the others: the magnitude of a contraction's final form
    before it cancels."""
    return float((pos.norm(dim=1) * sums[:, :lanes].norm(dim=1)).max()
                 + sums[:, lanes:].abs().max())


def fused_scales(name: str, eng: coef.CoefEngine, p: torch.Tensor, *args
                 ) -> dict:
    """The magnitude of the terms of each output of dfsph_kick or
    dfsph_rate called with `args`, by output: what a summation order
    other than the kernel's can move by 1e-5 of. The kick's v_out:
    |v| + dt (|S k| + the matvec's terms); wk_out: |wk| + |dr alpha|. The
    rate's d: |v . S| + the matvec_dot's terms + |c_s|, which bounds dr
    and the divergence's masked value; k: d's over dt, times alpha / rho;
    the density's rho_adv and masked value: |rho| + dt d's."""
    def top(t) -> float:
        return float(t.abs().max()) if t.numel() else 0.0

    if name == "dfsph_kick":
        v, k, S_, dt, wk, dr, alpha = (args + (None,) * 3)[:7]
        sums = coef.coef_matvec(eng, p, k, lane_sums=True)
        h = float(dt)
        out = {"v_out": top(v) + h * (top(S_ * k[:, None])
                                      + _cancel(p, sums, 1))}
        if wk is not None:
            out["wk_out"] = top(wk) + top(dr * alpha)
        return out
    v, S_, alpha, rho, dt, mode, c_s = (args + (None,))[:7]
    sums = coef.coef_matvec_dot(eng, p, v, lane_sums=True)
    h = float(dt)
    dd = (float((v.norm(dim=1) * S_.norm(dim=1)).max()) + _cancel(p, sums, 3)
          + (top(c_s) if c_s is not None else 0.0))
    k = dd * top(alpha / rho) / h
    if isinstance(mode, coef.Divergence):
        return {"dr": dd, "k": k, "masked": dd}
    val = top(rho) + h * dd
    return {"k": k, "masked": val, "threshold": mode.rho0}


def fused_outputs(name: str, out) -> dict:
    """dfsph_kick's or dfsph_rate's outputs by name, those it gave (not the
    kick's record, which is held bit for bit to the pack of its v_out)."""
    names = ("v_out", "wk_out") if name == "dfsph_kick" else \
        coef.Rate._fields
    return {key: t for key, t in zip(names, out) if t is not None}


def fused_error(name: str, got, want, scales: dict, tol: float) -> dict:
    """dfsph_kick's or dfsph_rate's outputs against the plain version's,
    which sums the contraction in another order: each float output to
    `tol` of its `scales` entry (`fused_scales`). The rate's selection
    may differ only on rows whose value sits within that of the average's
    threshold (0, or rho0 in the density mode), where the masked value
    is then compared with the threshold instead; `flips` counts them.
    Returns the largest error, the flips and `ok`."""
    a, b = fused_outputs(name, got), fused_outputs(name, want)
    row = dict(max_abs_err=0.0, flips=0, ok=a.keys() == b.keys())
    flip = None
    if "sel" in a:
        flip = a["sel"] != b["sel"]
        row["flips"] = int(flip.sum())
        edge = scales.get("threshold", 0.0)
        bar = tol * scales["masked"]
        near = ((a["masked"] - edge).abs() <= bar) | ~a["sel"]
        near &= ((b["masked"] - edge).abs() <= bar) | ~b["sel"]
        row["ok"] &= bool(near[flip].all())
    for key, t in a.items():
        if key == "sel":
            continue
        err = (t - b[key]).abs()
        if key == "masked" and flip is not None:
            err = torch.where(flip, torch.zeros_like(err), err)
        e = float(err.max()) if err.numel() else 0.0
        row[f"err_{key}"] = e
        row["max_abs_err"] = max(row["max_abs_err"], e)
        row["ok"] &= e <= tol * scales[key]
    return row


def bits(out) -> tuple:
    """A call's tensors as integers of their width (f32 as int32, bool as
    uint8), so that torch.equal holds them bit for bit: -0 against +0 and
    NaN payloads too."""
    def raw(t):
        if t.dtype == torch.float32:
            return t.view(torch.int32)
        return t.view(torch.uint8) if t.dtype == torch.bool else t
    return tuple(None if t is None else raw(t) for t in tensors(out))


def bit_equal(a, b) -> bool:
    """Whether two calls' outputs are the same bits, tensor by tensor, and
    None in the same places."""
    x, y = bits(a), bits(b)
    return len(x) == len(y) and all(
        (u is None and w is None) or (u is not None and w is not None
                                      and torch.equal(u, w))
        for u, w in zip(x, y))


def solver_cases(p, st, g, h: float, m: float, walls: S.Walls, x: dict,
                 work: dict) -> Iterator[Case]:
    """The PCISPH and PBF kernels on cell-sorted `p` with CSR `st` and the
    boundary set `walls`, as their steps call them on a scene with walls:
    the predicted density at x["shifted"] in its stencil form and in its
    stream form over the pair store of `p` (`pair_store`), PBF's constraint
    pass (pbf_terms' one launch: the fluid walk, which stores the pair list,
    the walls' walk and the rows' lambda), then pbf_lambda of x["lam"] and
    pbf_xsph at x["shifted"] with velocities x["v"], both over the list
    that the constraint pass' wrapper made here once. `work` by kernel
    name, or {} (no bound)."""
    sp, lam, v = x["shifted"], x["lam"], x["v"]
    eng = pair_store(p, st, g, h, m)
    # The list's rows, made once as a step makes them after its sort, and
    # the list itself, which both streams read.
    rows = S.pair_rows(st, g, cell_id(p, g))
    args = pbf_constraint_args(p, st, g, h, m, rows, walls)
    _, pl = S.pbf_constraint(*args)

    for name, kern, plain in (
            ("pcisph_predict_rho",
             lambda: S.pcisph_predict_rho(p, st, g, h, m, sp, walls, RHO0),
             lambda: S.pcisph_predict_rho_plain(p, st, g, h, m, sp, walls,
                                                RHO0)),
            ("pcisph_predict_rho_list",
             lambda: S.pcisph_predict_rho(p, st, g, h, m, sp, walls, RHO0,
                                          eng=eng),
             lambda: S.pcisph_predict_rho_list_plain(eng, p, g, h, m, sp,
                                                     walls, RHO0)),
            ("pbf_terms", lambda: S.pbf_constraint(*args),
             lambda: S.pbf_constraint_plain(*args)),
            ("pbf_lambda", lambda: S.pbf_lambda(p, pl, h, lam),
             lambda: S.pbf_lambda_list_plain(pl, p, h, lam)),
            ("pbf_xsph", lambda: S.pbf_xsph(pl, h, sp, v),
             lambda: S.pbf_xsph_list_plain(pl, h, sp, v))):
        yield Case(name, name, kern, plain, work.get(name),
                   view=pbf_terms_view if name == "pbf_terms" else None)


def rigid_cases(x: dict, work: dict | None = None) -> Iterator[Case]:
    """The fluid-rigid kernels on coupled inputs `x` (perf/inputs.
    coupled_inputs), as a coupled step calls them, the body's gate made
    once (`gate_box`): the solid sums, the contact dot of x["v_r"], the
    solid viscosity, the reaction of x["u"]
    on x["force"] by the walk, the reaction list's rows, the list, and its
    stream over the list that the wrappers made here once (`side_list`),
    as DFSPH's density loop calls it: of x["k"] and the scale m (its
    library yardstick `side_library_calls` of u = k m, formed outside the
    timing), the gate itself, and
    PCISPH's predicted density at x["shifted"] with its
    walk over the body (and the walls, where the scene has them): its
    stream form over the pair store of x["p"] as pcisph_predict_rho_rigid
    (the coupled PCISPH step's on the stored-coefficient engine), and its
    stencil form under its own name with the key
    "pcisph_predict_rho_body". `work` by kernel name (bounds.rigid_work),
    or None. No one PyTorch call computes any of the others."""
    g, h, m, p, t = (x[k] for k in ("grid", "h", "m", "p", "table"))
    work = work or {}
    box = gate_box(x)
    predict = (p, x["st"], g, h, m, x["shifted"], base.walls(x["sc"]), RHO0,
               t)
    eng = pair_store(p, x["st"], g, h, m)
    gated = {name: (functools.partial(call, box), plain)
             for name, (call, plain) in gated_calls(x).items()}
    side = (x["rpos"], x["rvol"], p, x["st"], g, h, RHO0, x["u"],
            x["force"])
    build, listed = side_list(x)
    stream = (listed, x["k"], x["force"], m)
    rows = (x["rpos"], x["st"], g)
    for name, kern, plain in (
            ("rigid_terms", *gated["rigid_terms"]),
            ("rigid_contact_dot", *gated["rigid_contact_dot"]),
            ("rigid_viscosity", *gated["rigid_viscosity"]),
            ("rigid_side_force", lambda: R.rigid_side_force(*side),
             lambda: R.rigid_side_force_plain(*side)),
            ("rigid_side_rows", lambda: R.rigid_side_rows(*rows),
             lambda: R.rigid_side_rows_plain(*rows)),
            ("rigid_side_list", lambda: R.rigid_side_list(*build),
             lambda: R.rigid_side_list_plain(*build)),
            ("rigid_side_force_list",
             lambda: R.rigid_side_force_list(*stream),
             lambda: R.rigid_side_force_list_plain(*stream)),
            ("body_box", lambda: S.make_body_box(t.pos, h),
             lambda: S.make_body_box_plain(t.pos, h)),
            ("pcisph_predict_rho_rigid",
             lambda: S.pcisph_predict_rho(*predict, eng=eng, body_box=box),
             lambda: S.pcisph_predict_rho_list_plain(eng, p, *predict[2:]))):
        yield Case(name, name, kern, plain, work.get(name),
                   side_library_calls(listed, x["k"] * f32(m), x["force"])
                   if name == "rigid_side_force_list" else {},
                   side_list_view if name == "rigid_side_list" else None)
    yield Case("pcisph_predict_rho", "pcisph_predict_rho_body",
               lambda: S.pcisph_predict_rho(*predict, body_box=box),
               lambda: S.pcisph_predict_rho_plain(*predict),
               work.get("pcisph_predict_rho"))


def lane_error(got: torch.Tensor, want: torch.Tensor) -> float:
    """Largest |got - want| of the four lane sums over that lane's largest
    |want|."""
    return max(float((got[:, r] - want[:, r]).abs().max())
               / max(float(want[:, r].abs().max()), 1e-30) for r in range(4))


def scaled_error(got: torch.Tensor, want: torch.Tensor) -> float:
    """Largest |got - want| over the largest |want|."""
    return float((got - want).abs().max()) / max(float(want.abs().max()),
                                                  1e-30)


def terms_error(got, want) -> float:
    """fluid_terms', boundary_terms' or rigid_terms' outputs (or one
    tensor) against the plain version's: the largest `scaled_error` of the
    float outputs, or inf where an integer output (the pair count) differs
    anywhere."""
    worst = 0.0
    for a, b in zip(tensors(got), tensors(want)):
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
    With a library yardstick also each layout of the library call, timed
    alike, and its error against the kernel's output (the contraction's:
    against the kernel's lane sums, whose call is timed too);
    `library_ms` is the faster layout's time, null where PyTorch refuses
    the product."""
    ms = timing.event_ms(case.kern)
    bound_s, by = case.work.bound()
    walk = bounds.Work(case.work.bytes, case.work.walk_ops).bound()[0]
    row = dict(ms=ms, bound_ms=bound_s * 1e3, bound_by=by,
               share=bound_s * 1e3 / ms, walk_bound_ms=walk * 1e3)
    if case.work.stream_bytes:
        row["stream_bound_ms"] = bounds.Work(
            case.work.stream_bytes, case.work.walk_ops).bound()[0] * 1e3
    if not case.library:
        return row
    lanes = case.name in {c[0] for c in CONTRACTIONS}
    if lanes:
        want = case.kern(lane_sums=True)
        row["lane_sums_ms"] = timing.event_ms(
            lambda: case.kern(lane_sums=True))
    else:
        want = case.kern()
    row["library_ms"] = row["library_layout"] = None
    for layout, call in case.library.items():
        try:
            err = (lane_error(call().float(), want) if lanes else
                   scaled_error(call(), want))
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
