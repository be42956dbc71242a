"""The process group of the slab decomposition.

Counterpart of `cfd_taichi_tpu/parallel/multihost.py:39-80`. JAX joins its
processes with `jax.distributed` and builds one mesh over every chip; here
each rank is one process with one device, joined by
`torch.distributed.init_process_group`, and the slab ring is the ranks in
order (parallel/domain.py).

Usage, one process per rank (torchrun sets RANK, WORLD_SIZE, LOCAL_RANK,
MASTER_ADDR and MASTER_PORT; parallel/launch.spawn does the same for a
local run):

    from cfd_taichi_tpu_torch.parallel import domain, multihost
    multihost.initialize()               # NCCL, rank r on cuda:LOCAL_RANK
    ring = multihost.global_ring()
    scene = build_scene(cfg, device=ring.device)
    spec = domain.make_spec(scene, ring.world)
    state = domain.init_sharded_solver(ring, spec, scene, "dfsph")
    step = domain.make_sharded_solver_step(scene, ring, spec, "dfsph")

NCCL is the default backend. gloo is asked for by name: on CPU tensors it
is how the tests run ranks, and on a card it lets several ranks share one
device (NCCL refuses two ranks on one device), its messages staged
through host memory (parallel/domain.Comm).
"""

from __future__ import annotations

import os
from typing import NamedTuple

import torch
import torch.distributed as dist

_initialized = False


class Ring(NamedTuple):
    """This process's place in the slab ring: its rank, the number of
    ranks, the device its tensors live on and the backend of the group
    (None when no process group was started: a world of one)."""
    rank: int
    world: int
    device: torch.device
    backend: str | None


def _env_int(name: str) -> int | None:
    val = os.environ.get(name)
    return int(val) if val else None


def initialize(backend: str | None = None, init_method: str | None = None,
               world_size: int | None = None, rank: int | None = None) -> int:
    """Join the process group (idempotent). Returns the number of ranks.

    The rank and world size come from the arguments, else from torchrun's
    environment (RANK, WORLD_SIZE; MASTER_ADDR and MASTER_PORT for the
    default `env://` rendezvous). With neither it is a no-op that returns
    1, as JAX's is: a single process needs no group. `backend` defaults to
    "nccl"; "gloo" is asked for by name."""
    global _initialized
    if dist.is_available() and dist.is_initialized():
        _initialized = True
        return dist.get_world_size()
    if _initialized:
        return 1
    world_size = world_size if world_size is not None else _env_int(
        "WORLD_SIZE")
    rank = rank if rank is not None else _env_int("RANK")
    if world_size is None and init_method is None:
        _initialized = True
        return 1
    if rank is None:
        raise ValueError("initialize: a world size without a rank")
    dist.init_process_group(backend or "nccl",
                             init_method=init_method or "env://",
                             world_size=world_size, rank=rank)
    _initialized = True
    return dist.get_world_size()


def local_rank() -> int:
    """LOCAL_RANK from the environment, else the global rank (one host)."""
    lr = _env_int("LOCAL_RANK")
    if lr is not None:
        return lr
    return dist.get_rank() if dist.is_initialized() else 0


def global_ring(device=None) -> Ring:
    """This rank's `Ring`. `device` defaults to the card of LOCAL_RANK
    (modulo the cards there are, so that gloo ranks may share one); pass
    "cpu" for CPU ranks."""
    if dist.is_available() and dist.is_initialized():
        rank, world = dist.get_rank(), dist.get_world_size()
        backend = str(dist.get_backend())
    else:
        rank, world, backend = 0, 1, None
    if device is None or str(device) == "cuda":
        count = torch.cuda.device_count()
        device = f"cuda:{local_rank() % max(count, 1)}"
    device = torch.device(device)
    if backend == "nccl" and device.type != "cuda":
        raise ValueError(f"the nccl backend needs a card, not {device}")
    return Ring(rank=rank, world=world, device=device, backend=backend)


def is_multihost() -> bool:
    """More than one process in the group (JAX's process_count() > 1)."""
    return (dist.is_available() and dist.is_initialized()
            and dist.get_world_size() > 1)
