"""Particle seeding (the fluid block lattice, the one-layer boundary shell)
and rigid meshes (loading, builtin meshes, voxelization).

Host-side numpy code that runs once at scene build, mirroring the
reference's init kernels (fluid block: ParticleSystem.py:139-152; boundary
box shell: ParticleSystem.py:129-137,154-195; mesh load and voxelization
of a rigid body: ParticleSystem.py:42-59, trimesh there). The arithmetic
is the JAX package's (`cfd_taichi_tpu/geometry.py`) line for line,
including the f32 float-modulo index math of the lattices, so both
packages seed identical lattices and voxelize a mesh into identical voxel
centres.
"""

from __future__ import annotations

import struct

import numpy as np


def fluid_particle_count(water_size, particle_radius: float) -> int:
    """N = prod(water_size / diameter), truncated (reference ParticleSystem.py:85-86)."""
    w = np.asarray(water_size, np.float32)
    d = np.float32(2.0 * particle_radius)
    return int(w[0] / d * w[1] / d * w[2] / d)


def seed_fluid_block(water_size, start_pos, particle_radius: float) -> np.ndarray:
    """Lattice-fill a water block at diameter spacing: x = i mod x_num,
    z = floor(i/x_num) mod z_num, y = floor(i / (x_num*z_num)) with
    x_num/z_num as f32 floats (ParticleSystem.py:142-150)."""
    n = fluid_particle_count(water_size, particle_radius)
    w = np.asarray(water_size, np.float32)
    d = np.float32(2.0 * particle_radius)
    x_num = w[0] / d
    z_num = w[2] / d
    xz_num = x_num * z_num
    i = np.arange(n, dtype=np.float32)
    x = np.fmod(i, x_num)
    z = np.fmod(np.floor(i / x_num), z_num)
    y = np.floor(i / xz_num)
    pos = np.stack([x, y, z], axis=-1) * np.float32(2.0 * particle_radius)
    return (pos + np.asarray(start_pos, np.float32)).astype(np.float32)


def boundary_particle_count(box_min, box_max, particle_radius: float) -> int:
    """Count formula, reference ParticleSystem.py:129-137."""
    box = np.asarray(box_max, np.float32) - np.asarray(box_min, np.float32)
    d = np.float32(2.0 * particle_radius)
    x_cnt = int(box[0] / d + 1)
    z_cnt = int(box[2] / d + 1)
    bottom = x_cnt * z_cnt
    ring = x_cnt * z_cnt - (x_cnt - 2) * (z_cnt - 2)
    layers = int(np.ceil((box[1] - d) / d))
    return layers * ring + bottom * 2


def seed_boundary_shell(box_min, box_max, particle_radius: float) -> np.ndarray:
    """Boundary particle lattice (reference ParticleSystem.py:154-195): a
    bottom plate (y=0) of x_cnt*z_cnt particles, `layers` perimeter rings
    at y = d*(layer+1), and a top plate at y = box_max.y. Coordinates are
    absolute from the origin, as in the reference."""
    box = np.asarray(box_max, np.float32) - np.asarray(box_min, np.float32)
    d = np.float32(2.0 * particle_radius)
    x_cnt = int(box[0] / d + 1)
    z_cnt = int(box[2] / d + 1)
    xr = x_cnt - 1
    zr = z_cnt - 1
    bottom = x_cnt * z_cnt
    ring = x_cnt * z_cnt - (x_cnt - 2) * (z_cnt - 2)
    n = boundary_particle_count(box_min, box_max, particle_radius)

    i = np.arange(n, dtype=np.int64)
    pos = np.zeros((n, 3), np.float32)

    mb = i < bottom
    pos[mb, 0] = (i[mb] % x_cnt) * d
    pos[mb, 2] = (i[mb] // x_cnt) * d

    mm = (i >= bottom) & (i < n - bottom)
    idx = i[mm] - bottom
    layer = idx // ring
    y = d * (layer + 1)
    idx = idx - layer * ring + 1  # 1-based ring index, range [1, ring]
    x = np.zeros(idx.shape, np.float32)
    z = np.zeros(idx.shape, np.float32)
    s1 = idx <= xr
    x[s1] = (idx[s1] % xr) * d
    s2 = (idx > xr) & (idx <= xr + zr)
    x[s2] = xr * d
    z[s2] = ((idx[s2] - x_cnt) % zr) * d
    s3 = (idx > xr + zr) & (idx <= 2 * xr + zr)
    x[s3] = ((2 * xr + zr - idx[s3]) % xr + 1) * d
    z[s3] = zr * d
    s4 = (idx > 2 * xr + zr) & (idx <= 2 * (xr + zr))
    z[s4] = ((2 * (xr + zr) - idx[s4]) % zr + 1) * d
    pos[mm, 0] = x
    pos[mm, 1] = y.astype(np.float32)
    pos[mm, 2] = z

    mt = i >= n - bottom
    idx = i[mt] - (n - bottom)
    pos[mt, 0] = (idx % x_cnt) * d
    pos[mt, 1] = np.float32(box_max[1])
    pos[mt, 2] = (idx // x_cnt) * d

    return pos


# ---------------------------------------------------------------------------
# Mesh loading (STL binary/ascii + OBJ) — replaces trimesh.load_mesh
# ---------------------------------------------------------------------------

def load_mesh(path: str, scale: float = 1.0):
    """Load a triangle mesh. Returns (vertices (V,3) f32, faces (F,3) i32).

    `builtin:<name>` paths resolve to procedural meshes (see builtin_mesh) so
    scenes need no mesh files on disk — the self-contained counterpart of the
    reference's obj/ assets (ParticleSystem.py:42-50)."""
    if path.startswith("builtin:"):
        verts, faces = builtin_mesh(path[len("builtin:"):])
        return (verts * np.float32(scale)).astype(np.float32), faces
    lower = path.lower()
    if lower.endswith(".stl"):
        verts, faces = _load_stl(path)
    elif lower.endswith(".obj"):
        verts, faces = _load_obj(path)
    else:
        raise ValueError(f"Unsupported mesh format: {path}")
    verts = verts * np.float32(scale)  # trimesh.apply_scale parity (ParticleSystem.py:43)
    return verts.astype(np.float32), faces.astype(np.int32)


def builtin_mesh(name: str):
    """Procedural meshes bundled with the framework.

    These replace the reference's shipped assets (obj/cube1.STL etc.) so
    every bundled config and test runs without external files:
      * ``cube``              — unit cube [0,1]^3 (like obj/cube2.STL)
      * ``cube1``             — 0.8 x 0.5 x 1.0 box (obj/cube1.STL extents)
      * ``box:<x>x<y>x<z>``   — axis-aligned box of the given extents
      * ``ball``              — sphere of diameter 0.5 in [0,0.5]^3
                                (obj/ball.STL extents)
      * ``torus``             — non-convex torus, major R=0.15 minor r=0.06,
                                hole along +y, shifted into the positive
                                octant (bbox [0,0.42]x[0,0.12]x[0,0.42]).
                                The non-convex analogue of the reference's
                                spot.obj / stanford-bunny.obj assets
                                (reference ParticleSystem.py:42-50) —
                                exercises the parity-fill voxelizer on a
                                body whose convex hull differs from it.
      * ``torus:<R>x<r>``     — torus with given major/minor radii
    """
    if name == "cube":
        return _box_mesh(1.0, 1.0, 1.0)
    if name == "cube1":
        return _box_mesh(0.8, 0.5, 1.0)
    if name.startswith("box:"):
        dims = [float(t) for t in name[4:].split("x")]
        if len(dims) != 3:
            raise ValueError(f"builtin box needs 3 extents: {name}")
        return _box_mesh(*dims)
    if name == "ball":
        verts, faces = _icosphere(subdiv=3)
        return (verts * 0.25 + 0.25).astype(np.float32), faces
    if name == "torus" or name.startswith("torus:"):
        if name == "torus":
            R, r = 0.15, 0.06
        else:
            parts = name[len("torus:"):].split("x")
            if len(parts) != 2:
                raise ValueError(f"builtin torus needs RxR: {name}")
            R, r = float(parts[0]), float(parts[1])
        verts, faces = _torus_mesh(R, r)
        # Shift into the positive octant like the other builtins.
        verts = verts - verts.min(axis=0, keepdims=True)
        return verts.astype(np.float32), faces
    raise ValueError(f"Unknown builtin mesh: {name!r}")


def _box_mesh(ex: float, ey: float, ez: float):
    """Axis-aligned box [0,ex]x[0,ey]x[0,ez] as 8 vertices / 12 triangles."""
    corners = np.array([[x, y, z] for x in (0, ex) for y in (0, ey)
                        for z in (0, ez)], np.float32)
    # Vertex index = 4*ix + 2*iy + iz. Two triangles per face, outward CCW.
    faces = np.array([
        [0, 1, 3], [0, 3, 2],   # x = 0
        [4, 7, 5], [4, 6, 7],   # x = ex
        [0, 4, 5], [0, 5, 1],   # y = 0
        [2, 3, 7], [2, 7, 6],   # y = ey
        [0, 2, 6], [0, 6, 4],   # z = 0
        [1, 5, 7], [1, 7, 3],   # z = ez
    ], np.int32)
    return corners, faces


def _torus_mesh(R: float, r: float, n_u: int = 48, n_v: int = 24):
    """Torus of major radius R (in the xz plane, hole along +y) and minor
    radius r, centered at the origin: n_u x n_v quad lattice split into
    triangles with outward orientation."""
    u = np.arange(n_u, dtype=np.float64) * (2.0 * np.pi / n_u)
    v = np.arange(n_v, dtype=np.float64) * (2.0 * np.pi / n_v)
    uu, vv = np.meshgrid(u, v, indexing="ij")         # (n_u, n_v)
    ring = R + r * np.cos(vv)
    verts = np.stack([ring * np.cos(uu),
                      r * np.sin(vv),
                      ring * np.sin(uu)], axis=-1).reshape(-1, 3)
    faces = []
    for i in range(n_u):
        for k in range(n_v):
            a = i * n_v + k
            b = ((i + 1) % n_u) * n_v + k
            c = ((i + 1) % n_u) * n_v + (k + 1) % n_v
            d = i * n_v + (k + 1) % n_v
            faces += [[a, b, c], [a, c, d]]
    return verts.astype(np.float32), np.asarray(faces, np.int32)


def _icosphere(subdiv: int = 3):
    """Unit icosphere (radius 1, centered at the origin)."""
    phi = (1.0 + np.sqrt(5.0)) / 2.0
    verts = np.array([
        [-1, phi, 0], [1, phi, 0], [-1, -phi, 0], [1, -phi, 0],
        [0, -1, phi], [0, 1, phi], [0, -1, -phi], [0, 1, -phi],
        [phi, 0, -1], [phi, 0, 1], [-phi, 0, -1], [-phi, 0, 1],
    ], np.float64)
    verts /= np.linalg.norm(verts, axis=1, keepdims=True)
    faces = np.array([
        [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
        [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
        [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
        [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1],
    ], np.int64)
    for _ in range(subdiv):
        edge_mid: dict = {}
        verts_l = list(verts)
        new_faces = []

        def midpoint(a: int, b: int) -> int:
            key = (min(a, b), max(a, b))
            if key not in edge_mid:
                m = verts_l[a] + verts_l[b]
                m /= np.linalg.norm(m)
                edge_mid[key] = len(verts_l)
                verts_l.append(m)
            return edge_mid[key]

        for a, b, c in faces:
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            new_faces += [[a, ab, ca], [b, bc, ab], [c, ca, bc], [ab, bc, ca]]
        verts = np.asarray(verts_l)
        faces = np.asarray(new_faces, np.int64)
    return verts.astype(np.float32), faces.astype(np.int32)


def _load_stl(path: str):
    with open(path, "rb") as f:
        data = f.read()
    # Binary STL: 80-byte header + uint32 count + count * 50 bytes.
    if len(data) >= 84:
        (n,) = struct.unpack_from("<I", data, 80)
        if 84 + n * 50 == len(data):
            tri = np.frombuffer(data, dtype=np.uint8, count=n * 50, offset=84)
            tri = tri.reshape(n, 50)
            xyz = tri[:, 12:48].copy().view("<f4").reshape(n, 3, 3)
            return _dedupe_vertices(xyz.astype(np.float32))
    # ASCII STL fallback.
    tokens = data.decode("ascii", errors="ignore").split()
    coords = []
    k = 0
    while k < len(tokens):
        if tokens[k] == "vertex":
            coords.append([float(tokens[k + 1]), float(tokens[k + 2]), float(tokens[k + 3])])
            k += 4
        else:
            k += 1
    xyz = np.asarray(coords, np.float32).reshape(-1, 3, 3)
    return _dedupe_vertices(xyz)


def _dedupe_vertices(tri_xyz: np.ndarray):
    """Merge identical corner vertices into a shared vertex/faces pair."""
    flat = tri_xyz.reshape(-1, 3)
    verts, inv = np.unique(flat, axis=0, return_inverse=True)
    faces = inv.reshape(-1, 3)
    return verts.astype(np.float32), faces.astype(np.int32)


def _load_obj(path: str):
    verts = []
    faces = []
    with open(path) as f:
        for line in f:
            if line.startswith("v "):
                p = line.split()
                verts.append([float(p[1]), float(p[2]), float(p[3])])
            elif line.startswith("f "):
                p = line.split()[1:]
                idx = [int(t.split("/")[0]) - 1 for t in p]
                for k in range(1, len(idx) - 1):  # fan-triangulate polygons
                    faces.append([idx[0], idx[k], idx[k + 1]])
    return np.asarray(verts, np.float32), np.asarray(faces, np.int32)


# ---------------------------------------------------------------------------
# Voxelization — replaces trimesh .voxelized(pitch).fill().points
# ---------------------------------------------------------------------------

def voxelize_mesh(verts: np.ndarray, faces: np.ndarray, pitch: float,
                  fill: bool = True) -> np.ndarray:
    """Voxelize a triangle mesh at the given pitch; returns voxel-center points.

    Equivalent capability to trimesh's `mesh.voxelized(pitch).fill().points`
    (reference ParticleSystem.py:47-50): surface voxels come from dense
    triangle-surface sampling; interior voxels (fill=True) from a per-column
    ray-parity test along +z. Voxel centers sit at bounds_min + (idx+0.5)*pitch.
    """
    tri = verts[faces]  # (F, 3, 3)
    bmin = verts.min(axis=0)
    dims = np.maximum(np.ceil((verts.max(axis=0) - bmin) / pitch).astype(np.int64), 1)

    occ = np.zeros(tuple(dims), dtype=bool)

    # --- Surface rasterization: barycentric supersampling at pitch/2 -------
    e1 = tri[:, 1] - tri[:, 0]
    e2 = tri[:, 2] - tri[:, 0]
    # samples per edge, proportional to triangle size
    n_samp = np.maximum(
        (np.maximum(np.linalg.norm(e1, axis=1), np.linalg.norm(e2, axis=1)) / (pitch * 0.5))
        .astype(np.int64) + 1, 1)
    max_s = int(n_samp.max())
    max_s = min(max_s, 512)  # cap supersampling for enormous triangles
    u = np.linspace(0.0, 1.0, max_s + 1, dtype=np.float32)
    uu, vv = np.meshgrid(u, u, indexing="ij")
    keep = (uu + vv) <= 1.0 + 1e-6
    uu, vv = uu[keep], vv[keep]  # (S,)
    pts = (tri[:, None, 0]
           + uu[None, :, None] * e1[:, None, :]
           + vv[None, :, None] * e2[:, None, :]).reshape(-1, 3)
    ijk = np.clip(((pts - bmin) / pitch).astype(np.int64), 0, dims - 1)
    occ[ijk[:, 0], ijk[:, 1], ijk[:, 2]] = True

    if fill:
        occ |= _parity_fill(tri, bmin, pitch, dims)

    idx = np.argwhere(occ)
    centers = bmin + (idx.astype(np.float32) + 0.5) * np.float32(pitch)
    return centers.astype(np.float32)


def _parity_fill(tri: np.ndarray, bmin: np.ndarray, pitch: float,
                 dims: np.ndarray) -> np.ndarray:
    """Interior voxels via +z ray-crossing parity per (x, y) column."""
    nx, ny, nz = int(dims[0]), int(dims[1]), int(dims[2])
    xs = bmin[0] + (np.arange(nx, dtype=np.float32) + 0.5) * pitch
    ys = bmin[1] + (np.arange(ny, dtype=np.float32) + 0.5) * pitch
    gx, gy = np.meshgrid(xs, ys, indexing="ij")
    origins = np.stack([gx.ravel(), gy.ravel()], axis=-1)  # (C, 2)

    # 2D point-in-triangle test in the xy plane + z of the intersection.
    a, b, c = tri[:, 0], tri[:, 1], tri[:, 2]
    # Edge functions for xy projection.
    d00 = (b[:, :2] - a[:, :2])
    d01 = (c[:, :2] - a[:, :2])
    denom = d00[:, 0] * d01[:, 1] - d00[:, 1] * d01[:, 0]  # (F,)
    ok = np.abs(denom) > 1e-12
    a_, b_, c_ = a[ok], b[ok], c[ok]
    d00, d01, denom = d00[ok], d01[ok], denom[ok]

    zs_grid = bmin[2] + (np.arange(nz, dtype=np.float32) + 0.5) * pitch
    crossings_count = np.zeros((origins.shape[0], nz), dtype=np.int64)
    # Process triangles in chunks so the (C, Fc, Z) broadcast stays bounded.
    chunk = max(1, int(2e7 // max(origins.shape[0] * nz, 1)))
    for f0 in range(0, a_.shape[0], chunk):
        f1 = min(f0 + chunk, a_.shape[0])
        A = a_[f0:f1]
        rel = origins[:, None, :] - A[None, :, :2]  # (C, Fc, 2)
        # Barycentric coordinates of the xy-projected ray origin.
        v = (rel[..., 0] * d01[None, f0:f1, 1] - rel[..., 1] * d01[None, f0:f1, 0]) / denom[None, f0:f1]
        w = (rel[..., 1] * d00[None, f0:f1, 0] - rel[..., 0] * d00[None, f0:f1, 1]) / denom[None, f0:f1]
        hit = (v >= 0) & (w >= 0) & (v + w <= 1)  # (C, Fc)
        z_hit = (A[None, :, 2]
                 + v * (b_[f0:f1, 2] - A[:, 2])[None, :]
                 + w * (c_[f0:f1, 2] - A[:, 2])[None, :])  # (C, Fc)
        z_hit = np.where(hit, z_hit, np.inf)
        # Count crossings strictly below each voxel-center z.
        crossings_count += (z_hit[:, :, None] < zs_grid[None, None, :]).sum(axis=1)
    interior = (crossings_count % 2) == 1  # odd crossings below => inside
    return interior.reshape(nx, ny, nz)
