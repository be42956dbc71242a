"""The solvers' pressure loops: U gated sub-iterations a trip, one host
read a trip, and on the card every trip after the first a replay of one
CUDA graph.

Counterpart of `cfd_taichi_tpu/ops/loops.py`, with its contract:
sub-iteration k applies `body` only where `cond` holds on the carry left by
sub-iteration k-1 (`torch.where` on every leaf), so counters, residuals
and stop flags advance only on real iterations and the realised sequence
equals the plain loop's bit for bit at every U. The price is up to U - 1
masked body evaluations after the last real one; whatever they compute,
non-finite values included, the gate discards.

How a loop runs:

* The first trip runs eagerly and reads `cond` once. The gate makes it
  exact even where `cond` does not hold on `init`, so the loop needs no
  read before it; it also launches every kernel of the body once before
  any capture, which takes PyTorch's and CUDA's lazy set-up out of it.
* On the CPU (`while_loop_unrolled_plain`, which the tests run) every
  later trip runs eagerly too.
* On the card the second trip is captured into a `torch.cuda.CUDAGraph`:
  the U sub-iterations, `cond` on their result, and the copy of the result
  into the carry's buffers (the first trip's outputs), which the graph
  reads and writes in place. Every later trip is a replay and one read of
  `cond`. A capture that fails raises: the loop never falls back to
  launching from Python.

A graph reads the addresses it was captured with, and a step's body reads
that step's tensors (positions, the coefficient store, dt), so a graph
serves one loop of one step: a step captures each loop that needs a second
trip once. The graphs of a scene's loops share one memory pool
(`GraphPool`), which holds about one trip's temporaries however many steps
run.

`stencil.KERNELS` counts launches in the wrappers, in Python: a capture
launches nothing and a replay runs no Python. So the loop takes back out
the counts that a capture adds, and adds them once a replay: the counts
are what an eager loop of as many trips gives, trips x U x the body's
launches a sub-iteration, where trips = ceil(iterations / U).
"""

from __future__ import annotations

import time
from typing import Callable, Sequence

import torch

from cfd_taichi_tpu_torch.ops.stencil import KERNELS

Carry = tuple[torch.Tensor, ...]


class GraphPool:
    """The memory pool of a scene's trip graphs, the stream they are
    captured on, and what its loops did.

    A pool lives while a graph captured into it does. Holding the last
    loop's graph keeps it alive, so that each capture reuses the memory
    that the captures before it freed; a pool left without a graph would
    be released with its last graph, and the next capture would make a new
    one (and could not share it). The old graph is never replayed once a
    newer one has taken its memory. Every capture runs on one side stream:
    the caching allocator reuses a freed block only for the stream it was
    allocated on."""

    def __init__(self):
        self.last: torch.cuda.CUDAGraph | None = None
        self.stream: torch.cuda.Stream | None = None
        self.reset()

    def reset(self) -> None:
        self.trips = 0          # trips run, each one host read of cond
        self.captures = 0       # graphs captured
        self.capture_s = 0.0    # host seconds in captures, all in
        self.instantiate_s = 0.0  # of which in capture_end (instantiation)


def _gated_trip(cond: Callable[[Carry], torch.Tensor],
                body: Callable[[Carry], Sequence[torch.Tensor]], unroll: int):
    """carry -> (carry after U gated sub-iterations, cond on it)."""
    def trip(carry: Carry):
        for _ in range(unroll):
            pred = cond(carry)
            new = tuple(body(carry))
            for i, (a, b) in enumerate(zip(new, carry, strict=True)):
                if a.dtype != b.dtype or a.shape != b.shape:
                    raise ValueError(
                        f"loop carry leaf {i}: the body returns {a.dtype} "
                        f"{tuple(a.shape)} for {b.dtype} {tuple(b.shape)}")
            carry = tuple(torch.where(pred, a, b) for a, b in zip(new, carry))
        return carry, cond(carry)

    if unroll < 1:
        raise ValueError(f"unroll {unroll}: want at least 1")
    return trip


def while_loop_unrolled_plain(cond: Callable[[Carry], torch.Tensor],
                              body: Callable[[Carry], Sequence[torch.Tensor]],
                              init: Sequence[torch.Tensor], unroll: int = 1,
                              pool: GraphPool | None = None) -> Carry:
    """The loop with every trip run eagerly, on any device: the plain
    version of `while_loop_unrolled`, which runs it on CPU tensors."""
    trip = _gated_trip(cond, body, unroll)
    carry, more = trip(tuple(init))
    trips = 1
    while bool(more):
        carry, more = trip(carry)
        trips += 1
    if pool is not None:
        pool.trips += trips
    return carry


def while_loop_unrolled(cond: Callable[[Carry], torch.Tensor],
                        body: Callable[[Carry], Sequence[torch.Tensor]],
                        init: Sequence[torch.Tensor], unroll: int = 1,
                        pool: GraphPool | None = None) -> Carry:
    """`while cond(carry): carry = body(carry)` over a tuple of tensors, U
    gated sub-iterations a trip (module note). `cond` returns a 0-d bool
    tensor; `body` the new carry, each leaf of its leaf's dtype and shape.
    On CUDA tensors the trips after the first replay a captured graph,
    into `pool`'s memory where one is given; on CPU tensors the loop is
    `while_loop_unrolled_plain`."""
    init = tuple(init)
    if not init[0].is_cuda:
        return while_loop_unrolled_plain(cond, body, init, unroll, pool)
    trip = _gated_trip(cond, body, unroll)
    carry, more = trip(init)
    trips = 1
    if bool(more):
        graph, more, per_trip = _capture(trip, carry, pool)
        while True:
            graph.replay()
            for name, n in per_trip.items():
                KERNELS[name].launches += n
            trips += 1
            if not bool(more):
                break
    if pool is not None:
        pool.trips += trips
    return carry


def _capture(trip, carry: Carry, pool: GraphPool | None):
    """Capture one trip that advances `carry` in place. Returns the graph,
    its 0-d `cond` output and the launches a trip counts, by kernel."""
    t0 = time.perf_counter()
    device = carry[0].device
    before = {name: k.launches for name, k in KERNELS.items()}
    graph = torch.cuda.CUDAGraph()
    if pool is None:
        side = torch.cuda.Stream(device=device)
    else:
        if pool.stream is None:
            pool.stream = torch.cuda.Stream(device=device)
        side = pool.stream
    side.wait_stream(torch.cuda.current_stream(device))
    try:
        with torch.cuda.stream(side):
            graph.capture_begin(
                pool=None if pool is None or pool.last is None
                else pool.last.pool())
            try:
                new, more = trip(carry)
                for buf, val in zip(carry, new):
                    buf.copy_(val)
            finally:
                t1 = time.perf_counter()
                graph.capture_end()
    finally:
        per_trip = {}
        for name, k in KERNELS.items():
            if k.launches != before[name]:
                per_trip[name] = k.launches - before[name]
                k.launches = before[name]
    torch.cuda.current_stream(device).wait_stream(side)
    if pool is not None:
        pool.last = graph
        pool.captures += 1
        t2 = time.perf_counter()
        pool.capture_s += t2 - t0
        pool.instantiate_s += t2 - t1
    return graph, more, per_trip
