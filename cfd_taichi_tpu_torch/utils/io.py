"""Checkpoints in the JAX package's leaf layout, and state carry-over.

A checkpoint is an `.npz` of `leaf_0 ... leaf_<L-1>`, the leaves of the
JAX package's `SimState` in `jax.tree_util.tree_flatten` order
(`cfd_taichi_tpu/utils/io.py:140-161`), plus a `.json` sidecar. Either
package can resume the other's checkpoint, with or without a rigid body,
and `state_from_numpy` carries a JAX state's leaves into the port.

Leaf layout: 0-2 pos x/y/z, 3-5 vel, 6-8 acc, 9 oid; 10-24 the rigid body
(pos x/y/z, vertices x/y/z, vel, omega, alpha, acc, force x/y/z, centroid,
inertia_inv); 25 dt, 26 t, 27 step_count; then the solver's E extra
leaves (DFSPH's warm_k, IISPH's p_past, none for WCSPH); then diag and
overflow. So L = 30 + E: 31 for DFSPH and IISPH, 30 for WCSPH. A scene
without a body holds the JAX package's `empty_rigid()` there: six and
three empty vectors, four zero 3-vectors, a zero centroid and a zero
3 x 3 matrix.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from cfd_taichi_tpu_torch.models import base

BASE_LEAVES = 30     # the leaves of every solver's state, extras aside
_RIGID = 10          # index of the first rigid leaf
_EXTRA = 28          # index of the first extra leaf


def state_from_numpy(leaves, device="cuda") -> base.SimState:
    """Port state from the JAX `SimState` leaves (numpy arrays, flatten
    order), a rigid body's included."""
    leaves = [np.asarray(a) for a in leaves]
    n_extra = len(leaves) - BASE_LEAVES
    if n_extra < 0:
        raise ValueError(f"expected at least {BASE_LEAVES} state leaves, "
                         f"got {len(leaves)}")

    def t(a, dtype=torch.float32):
        return torch.tensor(a, dtype=dtype, device=device)

    def rows(i):
        return t(np.stack(leaves[i:i + 3], axis=-1))

    r = _RIGID
    return base.SimState(
        fluid=base.FluidState(pos=rows(0), vel=rows(3), acc=rows(6),
                              oid=t(leaves[9], torch.int32)),
        rigid=base.RigidBodyState(
            pos=rows(r), vertices=rows(r + 3), vel=t(leaves[r + 6]),
            omega=t(leaves[r + 7]), alpha=t(leaves[r + 8]),
            acc=t(leaves[r + 9]), force=rows(r + 10),
            centroid=t(leaves[r + 13]), inertia_inv=t(leaves[r + 14])),
        dt=t(leaves[25]), t=t(leaves[26]),
        step_count=t(leaves[27], torch.int32),
        extra=tuple(t(a) for a in leaves[_EXTRA:_EXTRA + n_extra]),
        diag=t(leaves[_EXTRA + n_extra]),
        overflow=t(leaves[_EXTRA + n_extra + 1], torch.int32))


def state_to_numpy(state: base.SimState) -> list[np.ndarray]:
    """The inverse of `state_from_numpy`: JAX leaf order."""
    def n(x):
        return x.detach().cpu().numpy()

    def cols(x):
        return [n(x[:, c]) for c in range(3)]

    f, r = state.fluid, state.rigid
    rigid = (cols(r.pos) + cols(r.vertices)
             + [n(r.vel), n(r.omega), n(r.alpha), n(r.acc)]
             + cols(r.force) + [n(r.centroid), n(r.inertia_inv)])
    return (cols(f.pos) + cols(f.vel) + cols(f.acc)
            + [n(f.oid)] + rigid
            + [n(state.dt), n(state.t), n(state.step_count)]
            + [n(e) for e in state.extra]
            + [n(state.diag), n(state.overflow)])


def save_checkpoint(path: str, state: base.SimState, meta: dict | None = None):
    """Dump the state to an .npz in the JAX leaf layout."""
    leaves = state_to_numpy(state)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez_compressed(path, **{f"leaf_{i}": a for i, a in enumerate(leaves)})
    with open(path + ".json", "w") as f:
        json.dump({"num_leaves": len(leaves), "meta": meta or {}}, f)


def load_checkpoint(path: str, device="cuda") -> base.SimState:
    """Restore a state saved by either package's `save_checkpoint`: as many
    leaves as the file holds, which says how many extras the solver had."""
    with np.load(path) as data:
        count = sum(1 for k in data.files if k.startswith("leaf_"))
        leaves = [data[f"leaf_{i}"] for i in range(count)]
    return state_from_numpy(leaves, device=device)
