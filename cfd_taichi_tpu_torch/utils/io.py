"""Frame export (ascii PLY point clouds, OBJ and binary STL meshes),
checkpoints in the JAX package's leaf layout, and state carry-over.

The frame writers are the counterparts of `cfd_taichi_tpu/utils/io.py:
53-137` (reference main.py:184-201). Their text is byte for byte what the
JAX package's default writer, its native one (`csrc/fastio.cpp`), writes:
each coordinate printed `%.6g` from the f32 value, colours as uchar
0-255 of the clipped RGBA times 255.

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
import struct

import numpy as np
import torch

from cfd_taichi_tpu_torch.models import base

# Rows a frame writer formats at a time: one format string of ~2 MB.
_ROWS = 1 << 16


def _write_rows(f, fmt: str, values: np.ndarray) -> None:
    """Write each row of the (R, C) float64 `values` through `fmt`, one
    %-format a row (Python's %.6g is C's: both round the exact value)."""
    for lo in range(0, values.shape[0], _ROWS):
        chunk = values[lo:lo + _ROWS]
        f.write(fmt * chunk.shape[0] % tuple(chunk.ravel().tolist()))


def write_ply_ascii(path: str, pos: np.ndarray,
                    rgba: np.ndarray | None = None) -> None:
    """Ascii PLY of the (N, 3) positions with optional uchar RGBA, the
    layout the reference emits through ti.tools.PLYWriter (main.py:
    189-195)."""
    pos = np.ascontiguousarray(pos, np.float32)
    n = pos.shape[0]
    head = ["ply", "format ascii 1.0", f"element vertex {n}",
            "property float x", "property float y", "property float z"]
    values, fmt = pos.astype(np.float64), "%.6g %.6g %.6g\n"
    if rgba is not None:
        head += ["property uchar red", "property uchar green",
                 "property uchar blue", "property uchar alpha"]
        rgba_u8 = np.ascontiguousarray(
            np.clip(np.asarray(rgba), 0.0, 1.0) * 255, np.uint8)
        values = np.concatenate([values, rgba_u8.astype(np.float64)], axis=1)
        fmt = "%.6g %.6g %.6g %d %d %d %d\n"
    with open(path, "w") as f:
        f.write("\n".join(head) + "\nend_header\n")
        _write_rows(f, fmt, values)


def write_obj(path: str, vertices: np.ndarray, faces: np.ndarray) -> None:
    """OBJ of a triangle mesh, 1-based faces (reference main.py:196-200)."""
    vertices = np.ascontiguousarray(vertices, np.float32)
    faces = np.ascontiguousarray(faces, np.int32).astype(np.float64) + 1
    with open(path, "w") as f:
        _write_rows(f, "v %.6g %.6g %.6g\n", vertices.astype(np.float64))
        _write_rows(f, "f %d %d %d\n", faces)


def write_stl_binary(path: str, vertices: np.ndarray,
                     faces: np.ndarray) -> None:
    """Binary STL (80-byte header, u32 count, 50 bytes a triangle), each
    facet's normal recomputed: the inverse of geometry.load_mesh's STL
    reader."""
    verts = np.asarray(vertices, np.float32)
    tri = verts[np.asarray(faces, np.int64)]          # (F, 3, 3)
    n = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    norm = np.linalg.norm(n, axis=1, keepdims=True)
    n = (n / np.where(norm > 0, norm, 1.0)).astype(np.float32)
    rec = np.zeros((tri.shape[0], 50), np.uint8)
    rec[:, 0:12] = n.astype("<f4").view(np.uint8).reshape(-1, 12)
    rec[:, 12:48] = tri.astype("<f4").reshape(-1, 9).view(np.uint8)
    with open(path, "wb") as f:
        f.write(b"\0" * 80)
        f.write(struct.pack("<I", tri.shape[0]))
        f.write(rec.tobytes())


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
