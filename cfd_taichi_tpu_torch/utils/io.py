"""Checkpoints in the JAX package's leaf layout, and state carry-over.

A checkpoint is an `.npz` of `leaf_0 ... leaf_30`, the leaves of the JAX
package's `SimState` in `jax.tree_util.tree_flatten` order
(`cfd_taichi_tpu/utils/io.py:140-161`), plus a `.json` sidecar. Either
package can resume the other's checkpoint of a fluid-only scene, and
`state_from_numpy` carries a JAX state's leaves into the port.

Leaf layout: 0-2 pos x/y/z, 3-5 vel, 6-8 acc, 9 oid; 10-24 the rigid body
(pos x/y/z, vertices x/y/z, vel, omega, alpha, acc, force x/y/z, centroid,
inertia_inv); 25 dt, 26 t, 27 step_count, 28 warm_k (extra), 29 diag,
30 overflow.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from cfd_taichi_tpu_torch.models import base

NUM_LEAVES = 31
_RIGID_PARTICLE_LEAVES = (10, 11, 12, 13, 14, 15, 20, 21, 22)


def state_from_numpy(leaves, device="cuda") -> base.SimState:
    """Port state from the JAX `SimState` leaves (numpy arrays, flatten
    order). The scene must be fluid-only: the rigid leaves must be empty."""
    leaves = [np.asarray(a) for a in leaves]
    if len(leaves) != NUM_LEAVES:
        raise ValueError(f"expected {NUM_LEAVES} state leaves, got "
                         f"{len(leaves)}")
    for i in _RIGID_PARTICLE_LEAVES:
        if leaves[i].size:
            raise NotImplementedError(
                f"state leaf {i} holds rigid particles: rigid coupling is "
                f"not ported yet (ROADMAP.md, queue 1)")

    def t(a, dtype=torch.float32):
        return torch.tensor(a, dtype=dtype, device=device)

    def rows(i):
        return t(np.stack(leaves[i:i + 3], axis=-1))

    return base.SimState(
        fluid=base.FluidState(pos=rows(0), vel=rows(3), acc=rows(6),
                              oid=t(leaves[9], torch.int32)),
        rigid=None,
        dt=t(leaves[25]), t=t(leaves[26]),
        step_count=t(leaves[27], torch.int32),
        extra=(t(leaves[28]),),
        diag=t(leaves[29]),
        overflow=t(leaves[30], torch.int32))


def state_to_numpy(state: base.SimState) -> list[np.ndarray]:
    """The inverse of `state_from_numpy`: JAX leaf order, with an empty
    rigid body laid out as the JAX package's `empty_rigid()`."""
    def n(x):
        return x.detach().cpu().numpy()

    f = state.fluid
    z0 = np.zeros((0,), np.float32)
    z3 = np.zeros((3,), np.float32)
    rigid = ([z0] * 6 + [z3] * 4 + [z0] * 3
             + [z3, np.zeros((3, 3), np.float32)])
    return ([n(f.pos[:, c]) for c in range(3)]
            + [n(f.vel[:, c]) for c in range(3)]
            + [n(f.acc[:, c]) for c in range(3)]
            + [n(f.oid)] + rigid
            + [n(state.dt), n(state.t), n(state.step_count),
               n(state.extra[0]), n(state.diag), n(state.overflow)])


def save_checkpoint(path: str, state: base.SimState, meta: dict | None = None):
    """Dump the state to an .npz in the JAX leaf layout."""
    leaves = state_to_numpy(state)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez_compressed(path, **{f"leaf_{i}": a for i, a in enumerate(leaves)})
    with open(path + ".json", "w") as f:
        json.dump({"num_leaves": len(leaves), "meta": meta or {}}, f)


def load_checkpoint(path: str, device="cuda") -> base.SimState:
    """Restore a state saved by either package's `save_checkpoint`."""
    with np.load(path) as data:
        leaves = [data[f"leaf_{i}"] for i in range(NUM_LEAVES)]
    return state_from_numpy(leaves, device=device)
