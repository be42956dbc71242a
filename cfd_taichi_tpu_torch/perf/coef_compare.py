"""The coef contraction kernels of the tree (csrc/coef_matvec.cu) beside
other sources of the same two C entry points, on one card:

    python -m cfd_taichi_tpu_torch.perf.coef_compare \\
        --variant NAME=PATH [--variant NAME=PATH ...] [--out PATH]

For instance, the one-thread-per-row kernel of commit 334462f:

    mkdir -p build/baseline
    git show 334462f:cfd_taichi_tpu_torch/csrc/coef_matvec.cu \\
        > build/baseline/coef_matvec.cu
    python -m cfd_taichi_tpu_torch.perf.coef_compare \\
        --variant row_thread=build/baseline/coef_matvec.cu

Each source, the tree's ("tree") first, is built into its own library
(build/compare/; one that does not build is reported and left out) and
checked against the plain contraction (lane sums to 1e-5 of each lane's
largest value) on breaking_dam_1m's jittered lattice and on two ragged
engines (1000 and 1003 rows). Then it is timed at 1M in f32 and bf16
storage: CUDA events around 20 back-to-back launches of the final form,
over the count, in 4 rounds that visit the sources forward and backward
in turn (median of the rounds); and at 30k, torch.profiler's device time
per launch. Prints one line per measurement and writes the whole as JSON
(--out); exits 1 if a check failed.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

from cfd_taichi_tpu_torch.ops import _build, coef
from cfd_taichi_tpu_torch.ops import stencil as S
from cfd_taichi_tpu_torch.perf import cases, inputs, timing

COMPARE_DIR = _build.BUILD_DIR.parent / "compare"
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}
ROUNDS = 4


def build_variants(sources: dict[str, Path]) -> dict:
    """{name: KernelLibrary} of the sources that build, each on its own."""
    COMPARE_DIR.mkdir(parents=True, exist_ok=True)
    srcs = {}
    for name, path in sources.items():
        srcs[name] = COMPARE_DIR / f"coef_matvec_{name}.cu"
        srcs[name].write_text(Path(path).read_text())
    libs = {name: COMPARE_DIR / f"lib_{name}.so" for name in srcs}

    def build(name):
        try:
            _build.build_shared({libs[name]: [srcs[name]]})
        except RuntimeError as e:
            print(f"[compare] {name} does not build, left out:\n{e}")
            return None
        return _build.KernelLibrary(libs[name], 0.0,
                                    libs[name].with_suffix(".log").read_text())

    with ThreadPoolExecutor(len(srcs)) as pool:
        built = dict(zip(srcs, pool.map(build, srcs)))
    return {name: lib for name, lib in built.items() if lib is not None}


def launcher(lib, op: str, eng, pos, x, lane_sums: bool):
    """(launch, out): one launch of `op` from `lib` into `out`, with the
    pointers bound once."""
    n = pos.shape[0]
    out = pos.new_empty((n, 4) if lane_sums else
                        ((n, 3) if op == "coef_matvec" else (n,)))
    args = [ctypes.c_void_p(a.data_ptr()) if isinstance(a, torch.Tensor)
            else a for a in (pos, n, eng.offsets, eng.nbr, eng.w,
                             int(eng.w.dtype == torch.bfloat16), x, out,
                             int(lane_sums))]
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    return (lambda: lib.call(f"{op}_launch", *args, stream)), out


def lattice_engines(cfg_name: str) -> tuple[dict, dict]:
    """(lattice inputs, {dtype name: engine}) of the config."""
    x = inputs.lattice_inputs(cfg_name, seed=7)
    sc, p, st = x["sc"], x["p"], x["st"]
    g, h, m = sc.grid, sc.h, sc.particle_m
    off = coef.csr_offsets(S.fluid_terms(p, st, g, h, m).count)
    return x, {d: coef.build_coef(p, st, g, h, m, off, dt)
               for d, dt in DTYPES.items()}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variant", action="append", default=[],
                    metavar="NAME=PATH", help="another coef_matvec source")
    ap.add_argument("--out", default="build/perf/coef_compare.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA card")
    sources = {"tree": _build._CSRC / "coef_matvec.cu",
               **dict(v.split("=", 1) for v in args.variant)}
    print(f"[compare] card: {timing.card()}")
    libs = build_variants(sources)
    for name, lib in libs.items():
        regs = [ln.strip() for ln in lib.log.splitlines() if "registers" in ln]
        print(f"[compare] {name}: {regs}")
    names = list(libs)
    res: dict = {"card": timing.card(), "check": {}, "ms_1m": {},
                 "device_us_30k": {}}

    x, engs = lattice_engines("breaking_dam_1m.json")
    for d, dt in DTYPES.items():
        checks = [("1m", engs[d], x["p"], x["k"], x["v"])]
        for n in (1000, 1003):
            checks.append((f"ragged{n}", *inputs.ragged_engine(n, dt)))
        for case, eng, pos, k, v in checks:
            for op, _, plain, src, _ in cases.CONTRACTIONS:
                arg = k if src == "k" else v
                want = plain(eng, pos, arg, lane_sums=True)
                for name in names:
                    fn, got = launcher(libs[name], op, eng, pos, arg, True)
                    fn()
                    err = cases.lane_error(got, want)
                    key = f"{name}/{d}/{op}/{case}"
                    res["check"][key] = err
                    print(f"[check] {key}: lane err / scale {err:.3e} "
                          f"{'ok' if err <= 1e-5 else 'FAIL'}")
    for d in DTYPES:
        for op, _, _, src, _ in cases.CONTRACTIONS:
            fns = {name: launcher(libs[name], op, engs[d], x["p"], x[src],
                                  False)[0] for name in names}
            times: dict = {name: [] for name in names}
            for r in range(ROUNDS):
                for name in (names if r % 2 == 0 else names[::-1]):
                    times[name].append(timing.batch_ms(fns[name]))
            for name in names:
                ms = statistics.median(times[name])
                res["ms_1m"][f"{name}/{d}/{op}"] = dict(median=ms,
                                                        rounds=times[name])
                print(f"[1m] {name:10s} {d:4s} {op:16s} {ms * 1e3:9.2f} us "
                      f"(rounds {[round(t * 1e3, 2) for t in times[name]]})")
    del x, engs
    torch.cuda.empty_cache()

    x, engs = lattice_engines("breaking_dam_30k.json")
    for d in DTYPES:
        for op, _, _, src, _ in cases.CONTRACTIONS:
            for name in names:
                fn, _ = launcher(libs[name], op, engs[d], x["p"], x[src],
                                 False)
                us = timing.kernel_device_us(fn, op)
                res["device_us_30k"][f"{name}/{d}/{op}"] = us
                print(f"[30k] {name:10s} {d:4s} {op:16s} {us:8.2f} us")
    bad = [k for k, err in res["check"].items() if not err <= 1e-5]
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(res, indent=1))
    print(f"[compare] failed checks: {bad}")
    return 1 if bad else 0


if __name__ == "__main__":
    raise SystemExit(main())
