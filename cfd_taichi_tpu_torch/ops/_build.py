"""Build and bind the hand-written CUDA kernels of `csrc/`.

At first use, `nvcc` compiles every `csrc/*.cu` into one shared library
with a plain C interface, `build/kernels/libstencil-<hash>.so` at the root
of the checkout: one `nvcc -c` per source, all started together, then one
link. The hash covers the sources and the flags, so an edited kernel is
rebuilt and an unchanged one is loaded as it is. The library is
bound with ctypes: pointers come from `Tensor.data_ptr()`, the stream from
`torch.cuda.current_stream().cuda_stream`, and every entry returns
`cudaGetLastError()` so that a refused launch is reported right away.

Nothing here runs at import time: the CPU tests import every module of the
package on a machine without `nvcc`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"

# -fmad=false: see csrc/stencil.cuh (exact r2 rounding at r == h).
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-Xcompiler", "-fPIC", "-fmad=false",
              "-Xptxas=-v")


class StencilParams(ctypes.Structure):
    """ctypes mirror of `struct StencilParams` in csrc/stencil.cuh."""
    _fields_ = [("dims", ctypes.c_int * 3), ("strides", ctypes.c_int * 3),
                ("fast", ctypes.c_int), ("mid", ctypes.c_int),
                ("slow", ctypes.c_int), ("inv_cell", ctypes.c_float),
                ("h", ctypes.c_float), ("h2", ctypes.c_float),
                ("kw", ctypes.c_float), ("kw2", ctypes.c_float),
                ("kg6", ctypes.c_float), ("kgm6", ctypes.c_float),
                ("inv_h", ctypes.c_float)]


class SpikyPoly6(ctypes.Structure):
    """ctypes mirror of `struct SpikyPoly6` in csrc/stencil.cuh."""
    _fields_ = [("inv_h", ctypes.c_float), ("inv_pih4", ctypes.c_float),
                ("inv_pih3", ctypes.c_float), ("kp6", ctypes.c_float)]


_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_PP = ctypes.POINTER(StencilParams)
_SP = ctypes.POINTER(SpikyPoly6)

# C entry points and their argument types (the trailing _P is the stream).
_SIGNATURES = {
    "fluid_terms_launch": (_P, _P, _I, _PP, _F, _P, _P, _P, _P, _P, _P),
    "boundary_terms_launch": (_P, _I, _P, _P, _P, _P, _I, _PP, _F, _P, _P, _P,
                              _P, _P),
    "matvec_launch": (_P, _P, _I, _PP, _F, _P, _P, _P),
    "matvec_dot_launch": (_P, _P, _I, _PP, _F, _P, _P, _P),
    "viscosity_launch": (_P, _P, _I, _PP, _F, _F, _F, _P, _P, _P, _P),
    "wcsph_forces_launch": (_P, _P, _P, _I, _PP, _F, _F, _F, _F, _P, _P),
    "pcisph_predict_rho_launch": (_P, _P, _I, _PP, _F, _P, _P, _P, _P, _P,
                                  _I, _P, _P, _P, _P, _I, _F, _P, _P),
    "pcisph_predict_rho_list_launch": (_P, _I, _P, _P, _PP, _F, _P, _P, _P,
                                       _P, _P, _I, _P, _P, _P, _P, _I, _F,
                                       _P, _P),
    "pbf_constraint_launch": (_P, _P, _I, _PP, _SP, _F, _F, _F, _P, _P, _P,
                              _P, _P, _P, _P, _I, _F, _F, _F, _F, _F, _P, _P,
                              _P, _P, _P),
    "pbf_lambda_launch": (_P, _I, _P, _P, _P, _SP, _P, _P, _P),
    "pbf_xsph_launch": (_I, _P, _P, _P, _SP, _P, _P, _P, _P),
    "rigid_terms_launch": (_P, _I, _P, _P, _P, _I, _PP, _F, _P, _P, _P, _P,
                           _P, _P),
    "rigid_contact_dot_launch": (_P, _I, _P, _P, _P, _P, _I, _PP, _F, _P,
                                 _P, _P, _P),
    "rigid_viscosity_launch": (_P, _I, _P, _P, _P, _P, _I, _PP, _F, _F, _F,
                               _F, _P, _P, _P, _P, _P, _P, _P),
    "rigid_side_force_launch": (_P, _P, _I, _P, _P, _I, _PP, _F, _P, _P, _P,
                                _P),
    "rigid_side_rows_launch": (_P, _I, _P, _PP, _P, _P),
    "rigid_side_list_launch": (_P, _P, _I, _P, _P, _I, _PP, _F, _P, _P, _P,
                               _P, _P),
    "rigid_side_stream_launch": (_I, _P, _P, _P, _P, _F, _P, _P, _P, _P),
    "body_box_launch": (_P, _I, _F, _F, _P, _P),
    # queries of how two kernels were built and launched (no stream)
    "body_box_blocks": (_I,),
    "pcisph_predict_attributes": (_P,),
    "coef_build_launch": (_P, _P, _I, _PP, _F, _P, _P, _P, _I, _P),
    "coef_matvec_launch": (_P, _I, _P, _P, _P, _I, _P, _P, _I, _P),
    "coef_matvec_dot_launch": (_P, _I, _P, _P, _P, _I, _P, _P, _I, _P),
    "dfsph_kick_launch": (_P, _I, _P, _P, _P, _I, _P, _P, _P, _P, _P, _P, _P,
                          _P, _P, _P, _P, _P),
    "dfsph_rate_launch": (_P, _I, _P, _P, _P, _I, _P, _P, _P, _P, _I, _P, _P,
                          _P, _P, _F, _P, _P, _P, _P, _P, _P),
    "dfsph_pack_launch": (_P, _I, _P, _P, _P),
}


class KernelLibrary:
    """The loaded shared library plus how it was obtained."""

    def __init__(self, path: Path, build_seconds: float, log: str):
        self.path = path
        self.build_seconds = build_seconds  # 0.0 when loaded from disk
        self.log = log                      # nvcc output (-Xptxas -v)
        self.lib = ctypes.CDLL(str(path))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(self.lib, name, None)
            if fn is None:      # a library built from some sources only
                continue
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int

    def call(self, name: str, *args) -> None:
        rc = getattr(self.lib, name)(*args)
        if rc != 0:
            raise RuntimeError(f"{name} failed: cudaError_t {rc}")


_LIBRARY: KernelLibrary | None = None


def sources() -> list[Path]:
    return sorted(_CSRC.glob("*.cu")) + sorted(_CSRC.glob("*.cuh"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (PATH, CUDA_HOME or /usr/local/cuda)")


def _run_all(cmds: list[list[str]]) -> list[str]:
    """Run the commands side by side and wait for all of them; the output
    of each, or raise if one failed."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    for cmd, proc, out in zip(cmds, procs, outs):
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{out}")
    return outs


def library() -> KernelLibrary:
    """The kernel library, compiled on first use in this checkout."""
    global _LIBRARY
    if _LIBRARY is not None:
        return _LIBRARY
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    so = BUILD_DIR / f"libstencil-{digest.hexdigest()[:16]}.so"
    log_path = so.with_suffix(".log")
    seconds = 0.0
    if not so.exists():
        t0 = time.perf_counter()
        build_shared({so: [src for src in sources() if src.suffix == ".cu"]})
        seconds = time.perf_counter() - t0
    log = log_path.read_text() if log_path.exists() else ""
    _LIBRARY = KernelLibrary(so, seconds, log)
    return _LIBRARY


def build_shared(libraries: dict[Path, list[Path]]) -> None:
    """Build each shared library from its `.cu` sources (which may include
    the headers of csrc/): every `nvcc -c` of every library at once, then
    one link each. The nvcc output goes to `<library>.log`."""
    jobs = []
    for so, cus in libraries.items():
        so.parent.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        jobs.append((so, tmp, [(src, tmp.with_name(f"{tmp.name}.{src.stem}.o"))
                               for src in cus]))
    logs = iter(_run_all([[_nvcc(), *NVCC_FLAGS, "-I", str(_CSRC), "-c",
                           "-o", str(obj), str(src)]
                          for _, _, objs in jobs for src, obj in objs]))
    _run_all([[_nvcc(), "-shared", "-o", str(tmp),
               *(str(obj) for _, obj in objs)] for _, tmp, objs in jobs])
    for so, tmp, objs in jobs:
        so.with_suffix(".log").write_text("".join(next(logs) for _ in objs))
        for _, obj in objs:
            obj.unlink()
        os.replace(tmp, so)
