"""Timing on the card: CUDA events around calls, and device time per
kernel from torch.profiler (CUPTI)."""

from __future__ import annotations

import re
import statistics
import subprocess
import time

import torch

_KERNEL = re.compile(r"\b(\w+)_kernel\b")


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


def profile_kernels(fn) -> tuple[dict, float]:
    """Run `fn` under torch.profiler. Returns ({kernel: (launches, device
    us)} for every device kernel, named by its `<name>_kernel` stem where
    it has one, and the wall seconds of the window)."""
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
        us = _device_us(evt)
        m = _KERNEL.search(evt.key)
        if us <= 0.0 or (evt.device_type != DeviceType.CUDA and not m):
            continue
        name = m.group(1) if m else evt.key[:60]
        count, total = out.get(name, (0, 0.0))
        out[name] = (count + evt.count, total + us)
    return out, wall


def kernel_device_us(fn, name: str, launches: int = 20) -> float:
    """Mean device us of kernel `name` over `launches` calls of `fn` (after
    3 calls outside the profile)."""
    for _ in range(3):
        fn()
    found, _ = profile_kernels(lambda: [fn() for _ in range(launches)])
    if name not in found:
        raise RuntimeError(f"profiler saw no {name}_kernel: {sorted(found)}")
    count, total = found[name]
    return total / count
