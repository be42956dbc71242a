"""SPH smoothing kernels on float32 tensors: the cubic spline W and its
gradient factor, and PBF's spiky gradient factor, spiky W and poly6 W.

Counterpart of `cfd_taichi_tpu/ops/smoothing.py:23-115` (reference
solver_base.py:74-129). The JAX functions mix Python-double constants into
f32 arrays as weak types: each constant such as 6 * 48/(pi h^3) is formed
in double and then rounded once to f32. `CubicConstants` and
`SpikyPoly6Constants` do the same rounding, so the plain versions here,
the CUDA kernels (which receive the same f32 values, csrc/stencil.cuh)
and the JAX package evaluate identical f32 expressions.

XLA computes JAX's jitted `r / h` for a constant h as r * (1 / h), the
reciprocal taken in f32, so every kernel here takes q = r * f32(1/h). (By
division q lies 1/8 ulp low on average at h = 0.1, and the cubic W then
equals JAX's on 83.5 % of radii instead of 93.2 %:
tests/test_torch_smoothing.py.) What is left between the two is XLA's FMA
contraction on the CPU, a few ulp.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

_PI = float(np.pi)


def f32(x: float) -> float:
    """Round a Python double to the nearest f32 value (kept as a Python
    float, so torch and numpy use it exactly)."""
    return float(np.float32(x))


class CubicConstants(NamedTuple):
    """f32-rounded constants of the cubic spline for support radius h."""
    h: float      # support radius
    h2: float     # f32(h) * f32(h), the pair cutoff r2 <= h2
    inv_h: float  # f32(1) / f32(h): q = r * inv_h (module note)
    kw: float     # 8 / (pi h^3)
    kw2: float    # 2 * 8 / (pi h^3)   (far branch of W)
    kg6: float    # 6 * 48 / (pi h^3)  (near branch of grad W)
    kgm6: float   # -6 * 48 / (pi h^3) (far branch of grad W)

    @staticmethod
    def of(h: float) -> "CubicConstants":
        kw = 8.0 / (_PI * h**3)
        kg = 48.0 / (_PI * h**3)
        hf = np.float32(h)
        return CubicConstants(h=f32(h), h2=float(hf * hf),
                              inv_h=float(np.float32(1.0) / hf), kw=f32(kw),
                              kw2=f32(2.0 * kw), kg6=f32(6.0 * kg),
                              kgm6=f32(-6.0 * kg))


_EPS_Q = f32(1e-5)     # grad W lower bound on q (solver_base.py:96)
_EPS_R = f32(1e-12)    # guarded direction denominator


def true_div(t: torch.Tensor, x: float) -> torch.Tensor:
    """t / x with IEEE division on every device (see the module note)."""
    return t / torch.full((), x, dtype=t.dtype, device=t.device)


def ieee_sqrt(t: torch.Tensor) -> torch.Tensor:
    """The square root of each element, rounded as IEEE 754 rounds it (as
    XLA's and the CUDA kernels' sqrt round it), on every device, the same
    in every process. On the CPU torch.sqrt runs MKL's vector math
    (vmsSqrt), which rounds up to an ulp off the exact root, and which, on
    its first call in a process, when the intra-op threads enter it
    together, has returned whole threads' chunks up to 3.2e-4 off in about
    one process in forty: the processor's sqrt instruction, through numpy,
    takes its place there."""
    if t.device.type == "cpu":
        return torch.from_numpy(np.asarray(np.sqrt(t.numpy())))
    return torch.sqrt(t)


def cubic_w(r: torch.Tensor, h: float) -> torch.Tensor:
    """W(q) = k(6(q^3-q^2)+1) for q <= 0.5, 2k(1-q)^3 for q <= 1, else 0,
    with q = r * f32(1/h)."""
    c = CubicConstants.of(h)
    q = r * c.inv_h
    q2 = q * q
    q3 = q2 * q
    near = c.kw * (6.0 * (q3 - q2) + 1.0)
    omq = 1.0 - q
    far = c.kw2 * omq * omq * omq
    w = torch.where(q <= 0.5, near, far)
    return torch.where(q <= 1.0, w, torch.zeros_like(w))


def cubic_grad_coeff(r: torch.Tensor, h: float) -> torch.Tensor:
    """Scalar factor c(r) with grad W = c(r) * x_ij, zero unless
    1e-5 < q <= 1 (the reference's lower bound on q), q = r * f32(1/h);
    the division by h max(r, 1e-12) stays a division, as in JAX."""
    c = CubicConstants.of(h)
    q = r * c.inv_h
    near = c.kg6 * (3.0 * q * q - 2.0 * q)
    omq = 1.0 - q
    far = c.kgm6 * omq * omq
    coeff = torch.where(q <= 0.5, near, far)
    coeff = torch.where((q > _EPS_Q) & (q <= 1.0), coeff,
                        torch.zeros_like(coeff))
    return coeff / (c.h * torch.clamp(r, min=_EPS_R))


class SpikyPoly6Constants(NamedTuple):
    """f32 constants of the spiky and poly6 kernels for support radius h
    (`cfd_taichi_tpu/ops/smoothing.py:79-115`). XLA computes JAX's jitted
    `x / c` for a constant c as x * (1 / c), the reciprocal taken in f32,
    so these kernels take q = r * inv_h and multiply by the reciprocal of
    pi h^4 (pi h^3): spiky's factor then equals JAX's bit for bit on the
    CPU."""
    inv_h: float     # f32(1) / f32(h)
    inv_pih4: float  # f32(1) / f32(pi h^4), the spiky gradient's divisor
    inv_pih3: float  # f32(1) / f32(pi h^3), spiky W's divisor
    kp6: float       # f32(315 / (64 pi h^3)), poly6's factor

    @staticmethod
    def of(h: float) -> "SpikyPoly6Constants":
        def inv(x: float) -> float:
            return float(np.float32(1.0) / np.float32(x))
        return SpikyPoly6Constants(inv_h=inv(h), inv_pih4=inv(_PI * h**4),
                                   inv_pih3=inv(_PI * h**3),
                                   kp6=f32(315.0 / (64.0 * _PI * h**3)))


def spiky_grad_coeff(r: torch.Tensor, h: float) -> torch.Tensor:
    """Scalar factor c(r) with spiky grad W = c(r) * x_ij: -45 (1-q)^2 /
    (pi h^4) / max(r, 1e-12), zero unless 0 < q <= 1."""
    c = SpikyPoly6Constants.of(h)
    q = r * c.inv_h
    omq = 1.0 - q
    coeff = -45.0 * omq * omq * c.inv_pih4
    coeff = torch.where((q > 0.0) & (q <= 1.0), coeff,
                        torch.zeros_like(coeff))
    return coeff / torch.clamp(r, min=_EPS_R)


def spiky_w(r: torch.Tensor, h: float) -> torch.Tensor:
    """Spiky W = 15 (1-q)^3 / (pi h^3) for q <= 1, else 0."""
    c = SpikyPoly6Constants.of(h)
    q = r * c.inv_h
    omq = 1.0 - q
    w = 15.0 * omq * omq * omq * c.inv_pih3
    return torch.where(q <= 1.0, w, torch.zeros_like(w))


def poly6_w(r: torch.Tensor, h: float) -> torch.Tensor:
    """Poly6 W, the reference's normalized-q form 315/(64 pi h^3)
    (1-q^2)^3 for q <= 1, else 0 (scaled by 1/h^3, not 1/h^9)."""
    c = SpikyPoly6Constants.of(h)
    q = r * c.inv_h
    t = 1.0 - q * q
    w = c.kp6 * t * t * t
    return torch.where(q <= 1.0, w, torch.zeros_like(w))
