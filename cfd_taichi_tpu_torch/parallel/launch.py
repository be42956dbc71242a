"""Start ranks on this host, as torchrun would: `spawn(fn, world, backend,
device)` runs `fn(ring, *args)` in `world` fresh processes joined in one
process group, and returns what each rank returned, by rank.

The processes start with the `spawn` method, so that a caller that holds
threads (JAX's, in the tests) forks none of them, and they rendezvous on a
free localhost port, so that several callers may run at once. A rank that
raises makes the call raise, with its traceback; the others are stopped.
`fn` and what it returns must pickle (a module-level function, numpy
arrays and numbers).

    from cfd_taichi_tpu_torch.parallel import launch
    out = launch.spawn(my_rank_fn, 4, backend="gloo", device="cpu")

With torchrun instead, each process calls `multihost.initialize()` and
`multihost.global_ring()` itself.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import queue
import socket
import time
import traceback


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(rank: int, world: int, backend: str, device: str, port: int,
               threads: int | None, fn, args, results) -> None:
    try:
        os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port),
                          RANK=str(rank), WORLD_SIZE=str(world),
                          LOCAL_RANK=str(rank))
        for var in ("GLOO_SOCKET_IFNAME", "NCCL_SOCKET_IFNAME"):
            os.environ.setdefault(var, "lo")    # the ranks share this host
        import torch
        import torch.distributed as dist

        from cfd_taichi_tpu_torch.parallel import multihost

        if threads is not None:
            torch.set_num_threads(threads)
        multihost.initialize(backend, f"tcp://localhost:{port}", world, rank)
        ring = multihost.global_ring(device)
        if ring.device.type == "cuda":
            torch.cuda.set_device(ring.device)
        out = fn(ring, *args)
        dist.barrier()
        dist.destroy_process_group()
        results.put((rank, True, out))
    except Exception:  # noqa: BLE001  (the rank's boundary: reported)
        results.put((rank, False, traceback.format_exc()))


def spawn(fn, world: int, backend: str = "nccl", device: str = "cuda",
          args: tuple = (), timeout: float = 1800.0,
          threads: int | None = None) -> list:
    """Run `fn(ring, *args)` on ranks 0 .. world - 1 of a new process group
    (`backend` "nccl" or "gloo") with their tensors on `device` ("cuda":
    rank r on card r modulo the cards there are; "cpu"), each process
    pinned to `threads` torch threads where given. Returns the ranks'
    results in rank order; raises RuntimeError if a rank fails or the
    call outlasts `timeout` seconds."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_rank_main,
                         args=(r, world, backend, device, port, threads, fn,
                               args, results), daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    out: dict = {}
    deadline = time.monotonic() + timeout
    try:
        while len(out) < world:
            try:
                rank, ok, val = results.get(timeout=1.0)
            except queue.Empty:
                if time.monotonic() > deadline:
                    raise RuntimeError(f"ranks timed out after {timeout} s")
                # a second empty get after a rank exited: it sent nothing
                dead = [r for r, p in enumerate(procs)
                        if p.exitcode is not None and r not in out]
                if dead:
                    raise RuntimeError(f"rank {dead[0]} exited with code "
                                       f"{procs[dead[0]].exitcode} and no "
                                       "result")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} failed:\n{val}")
            out[rank] = val
        for p in procs:
            p.join(timeout=max(deadline - time.monotonic(), 1.0))
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
        for p in procs:
            p.join(timeout=10.0)
            if p.is_alive():
                p.kill()
        results.close()
    return [out[r] for r in range(world)]
