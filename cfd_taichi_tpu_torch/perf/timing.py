"""Timing on the card: CUDA events around calls, and device time per
kernel from torch.profiler (CUPTI)."""

from __future__ import annotations

import re
import statistics
import subprocess
import time

import torch

_KERNEL = re.compile(r"\b(\w+)_kernel\b")
# The operation inside a PyTorch kernel's name (its functor or the
# function that launched it), e.g. MulFunctor, where_kernel_impl,
# sum_functor, direct_copy_kernel_cuda; the launchers' own wrappers skipped
_TORCH_OP = re.compile(r"[A-Za-z]\w*?(?:Functor|_functor|_impl|_cuda)\w*")
_WRAPPERS = {"BinaryFunctor", "gpu_kernel_impl", "gpu_kernel_impl_nocast",
             "func_wrapper_t", "AUnaryFunctor", "BUnaryFunctor"}


def kernel_name(key: str) -> str:
    """A device kernel's name in a profile: the `<name>_kernel` stem of a
    kernel of this package; for one of PyTorch's, that stem (the launcher,
    e.g. vectorized_elementwise) and the operation it ran, so that the
    loops' torch ops tell apart; else the first 60 characters."""
    m = _KERNEL.search(key)
    if not m:
        return key[:60]
    if "at::native" not in key:
        return m.group(1)
    ops = [op for op in _TORCH_OP.findall(key[m.end():])
           if op not in _WRAPPERS]
    return f"{m.group(1)}:{ops[0]}" if ops else m.group(1)


def card() -> str:
    """`nvidia-smi`'s name and power limit of the card."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()


def event_ms(fn, reps: int = 10, warm: int = 3) -> float:
    """Median over `reps` calls of the CUDA-event time of one call of `fn`
    (device time plus whatever host work the call waits for)."""
    for _ in range(warm):
        fn()
    times = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1))
    return statistics.median(times)


def batch_ms(fn, launches: int = 20, warm: int = 3) -> float:
    """CUDA-event time of `launches` back-to-back calls, over the count: the
    device time of one call where it is longer than its host work."""
    for _ in range(warm):
        fn()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(launches):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / launches


def _device_us(evt) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        val = getattr(evt, attr, None)
        if val:
            return float(val)
    return 0.0


def profile_kernels(fn, host: dict | None = None) -> tuple[dict, float]:
    """Run `fn` under torch.profiler. Returns ({kernel: (launches, device
    us)} for every device kernel, named by `kernel_name`, and the wall
    seconds of the window). Where `host` holds
    names of CUDA runtime calls, each gets its (calls, host us) in the
    window."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    out: dict = {}
    for evt in prof.key_averages():
        if host is not None and evt.key in host:
            host[evt.key] = (evt.count, float(evt.cpu_time_total))
        us = _device_us(evt)
        m = _KERNEL.search(evt.key)
        if us <= 0.0 or (evt.device_type != DeviceType.CUDA and not m):
            continue
        name = kernel_name(evt.key)
        count, total = out.get(name, (0, 0.0))
        out[name] = (count + evt.count, total + us)
    return out, wall


def device_us(fn, name: str, launches: int = 20) -> tuple[float, float]:
    """Mean device us of kernel `name` a launch, and of all the kernels a
    call of `fn` runs, over `launches` calls (after 3 calls outside the
    profile)."""
    for _ in range(3):
        fn()
    best: tuple = (0, {})
    for _ in range(3):      # a profile now and then comes back empty or short
        found, _ = profile_kernels(lambda: [fn() for _ in range(launches)])
        best = max(best, (found.get(name, (0, 0.0))[0], found),
                   key=lambda b: b[0])
        if best[0] == launches:
            break
    count, found = best
    if not count:
        raise RuntimeError(f"profiler saw no {name}_kernel: {sorted(found)}")
    # over the calls the profile saw, as many as it saw of `name`
    return found[name][1] / count, sum(t for _, t in found.values()) / count


def kernel_device_us(fn, name: str, launches: int = 20) -> float:
    """Mean device us of kernel `name` a launch (`device_us`)."""
    return device_us(fn, name, launches)[0]
