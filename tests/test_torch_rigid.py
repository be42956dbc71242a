"""The port's rigid-body pieces held against the JAX package on the CPU:

* geometry: every builtin mesh voxelized at the configs' pitches, fill on
  and off, must give the JAX package's voxel centres exactly; the STL
  (binary and ASCII) and OBJ loaders on files written to tmp_path;
* scene: the body of tests/test_rigid.py:12-21 (RIGID_CFG) as DFSPH and
  of configs/torus_flush.json: voxel count and positions exactly, volumes
  and masses to rtol 1e-6, centroid, inertia and its inverse to rtol 1e-5
  (with an absolute floor of 1e-5 of the matrix's largest entry, for the
  entries that the body's symmetry makes zero);
* the rigid step: 20 steps under a numpy-seeded force field from a
  spinning, falling start that hits the floor, pos, centroid, vel and
  omega to atol 1e-5;
* the four fluid-rigid passes' plain versions (ops/rigid.py) against the
  JAX ops of cfd_taichi_tpu/ops/rigid_dense.py, jitted, on RIGID_CFG with
  the body at [0.4, 0.28, 0.4], the fluid jittered by 0.1 r and shifted by
  0.3 r so that pairs cross h both ways, with random v_r, velocities,
  densities and u: each output to 1e-5 of its largest magnitude; and the
  rho quirk's clip where the body has more particles than the fluid.
"""

import copy
import dataclasses
import struct
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfd_taichi_tpu import geometry as jgeo
from cfd_taichi_tpu import scene as jscene
from cfd_taichi_tpu.config import parse_config as jparse_config
from cfd_taichi_tpu.config import read_config as jread_config
from cfd_taichi_tpu.models import base as jbase
from cfd_taichi_tpu.models import rigid as jrigid
from cfd_taichi_tpu.ops import rigid_dense
from cfd_taichi_tpu.ops.vec import V3
from cfd_taichi_tpu_torch import build_scene, read_config
from cfd_taichi_tpu_torch import geometry as pgeo
from cfd_taichi_tpu_torch.config import parse_config
from cfd_taichi_tpu_torch.models import base, dfsph
from cfd_taichi_tpu_torch.models import rigid as prigid
from cfd_taichi_tpu_torch.ops import neighbors as nb
from cfd_taichi_tpu_torch.ops import rigid as R
from cfd_taichi_tpu_torch.ops import stencil

ROOT = Path(__file__).resolve().parents[1]
RIGID_CFG = {
    "scene": {"box_min": [0, 0, 0], "box_max": [0.8, 1.0, 0.8],
              "particle_radius": 0.025, "gravity": 9.8},
    "solver": {"name": "dfsph", "delta_time": 4e-4, "iter_cnt": 1,
               "boundary_handle": True, "fs_couple": True},
    "fluid": {"start_pos": [0.1, 0.05, 0.1], "water_size": [0.6, 0.25, 0.6]},
    "solid": {"mesh": "builtin:cube1", "voxel_radius": 0.025,
              "rho_0": 500, "scale": 0.18, "pos_offset": [0.4, 0.28, 0.4],
              "attitude_offset": [0.0, 0.0, 0.0], "fill": True,
              "active": True},
}
RHO0 = 1000.0
C_S, ALPHA = 13.0, 0.08     # DFSPH's viscosity constants


@pytest.fixture(autouse=True)
def one_thread():
    """The port's inputs here hold a few hundred particles, which torch's
    thread pool does not speed up; in a suite run in several processes
    its threads only contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def rigid_cfg(**overrides):
    raw = copy.deepcopy(RIGID_CFG)
    for path, value in overrides.items():
        section, key = path.split(".")
        raw[section][key] = value
    return raw


# ---------------------------------------------------------------------------
# Geometry
# ---------------------------------------------------------------------------

# (builtin mesh, scale, pitch): the configs' meshes at their pitches
# (2 voxel_radius), and the other builtins.
MESHES = [("cube1", 0.18, 0.05), ("cube1", 1.0, 0.05), ("cube1", 0.6, 0.05),
          ("torus", 1.6, 0.05), ("torus", 1.0, 0.03), ("cube", 0.5, 0.05),
          ("box:0.3x0.2x0.1", 1.0, 0.03), ("ball", 1.0, 0.05),
          ("torus:0.2x0.05", 1.0, 0.05)]


@pytest.mark.parametrize("fill", [True, False])
@pytest.mark.parametrize("name,scale,pitch", MESHES)
def test_builtin_voxels_match_jax(name, scale, pitch, fill):
    jv, jf = jgeo.load_mesh("builtin:" + name, scale=scale)
    pv, pf = pgeo.load_mesh("builtin:" + name, scale=scale)
    np.testing.assert_array_equal(pv, jv)
    np.testing.assert_array_equal(pf, jf)
    want = jgeo.voxelize_mesh(jv, jf, pitch=pitch, fill=fill)
    got = pgeo.voxelize_mesh(pv, pf, pitch=pitch, fill=fill)
    assert got.dtype == np.float32 and got.shape[0] > 0
    np.testing.assert_array_equal(got, want)


def _tetra_prism():
    """A closed triangular prism: 6 vertices, 2 triangles and 3 quads."""
    v = np.array([[0, 0, 0], [0.3, 0, 0], [0, 0.2, 0],
                  [0, 0, 0.25], [0.3, 0, 0.25], [0, 0.2, 0.25]], np.float32)
    tris = [[0, 2, 1], [3, 4, 5]]
    quads = [[0, 1, 4, 3], [1, 2, 5, 4], [2, 0, 3, 5]]
    return v, tris, quads


def test_mesh_loaders_match_jax(tmp_path):
    v, tris, quads = _tetra_prism()
    faces = tris + [[q[0], q[1], q[2]] for q in quads] \
        + [[q[0], q[2], q[3]] for q in quads]
    corners = v[np.asarray(faces)]                       # (F, 3, 3)
    binary = tmp_path / "prism.stl"
    with open(binary, "wb") as f:
        f.write(b"\0" * 80 + struct.pack("<I", len(faces)))
        for tri in corners:
            f.write(struct.pack("<3f", 0, 0, 0) + tri.astype("<f4").tobytes()
                    + b"\0\0")
    ascii_stl = tmp_path / "prism_ascii.STL"
    lines = ["solid prism"]
    for tri in corners:
        lines += ["facet normal 0 0 0", "outer loop"]
        lines += [f"vertex {x:.9g} {y:.9g} {z:.9g}" for x, y, z in tri]
        lines += ["endloop", "endfacet"]
    ascii_stl.write_text("\n".join(lines + ["endsolid prism"]) + "\n")
    obj = tmp_path / "prism.obj"
    obj.write_text("".join(f"v {x} {y} {z}\n" for x, y, z in v)
                   + "".join("f " + " ".join(f"{i + 1}/{i + 1}" for i in fc)
                             + "\n" for fc in tris + quads))
    for path in (binary, ascii_stl, obj):
        jv, jf = jgeo.load_mesh(str(path), scale=1.5)
        pv, pf = pgeo.load_mesh(str(path), scale=1.5)
        np.testing.assert_array_equal(pv, jv)
        np.testing.assert_array_equal(pf, jf)
        assert pf.shape == (8, 3)
        np.testing.assert_array_equal(
            pgeo.voxelize_mesh(pv, pf, pitch=0.05),
            jgeo.voxelize_mesh(jv, jf, pitch=0.05))
    with pytest.raises(ValueError, match="Unsupported"):
        pgeo.load_mesh(str(tmp_path / "prism.ply"))
    with pytest.raises(ValueError, match="Unknown builtin"):
        pgeo.load_mesh("builtin:teapot")


# ---------------------------------------------------------------------------
# Scene
# ---------------------------------------------------------------------------

def _close(got, want, rtol):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=rtol * np.abs(want).max())


@pytest.mark.parametrize("which", ["rigid_cfg", "torus_flush"])
def test_rigid_scene_matches_jax(which):
    if which == "torus_flush":
        path = str(ROOT / "configs" / "torus_flush.json")
        jcfg, cfg = jread_config(path), read_config(path)
    else:
        jcfg, cfg = jparse_config(rigid_cfg()), parse_config(rigid_cfg())
    js, sc = jscene.build_scene(jcfg), build_scene(cfg, device="cpu")
    st, ar, jr = js.static, js.arrays, js.rigid
    if which == "torus_flush":
        assert sc.n_rigid == 569
    assert (sc.n_rigid, sc.has_rigid, sc.rigid_active, sc.fs_couple,
            sc.rigid_rho) == (st.n_rigid, st.has_rigid, st.rigid_active,
                              st.fs_couple, st.rigid_rho)
    assert sc.coupled
    np.testing.assert_array_equal(sc.rigid0.pos.numpy(), jr.pos.to_numpy())
    np.testing.assert_array_equal(sc.rigid0.vertices.numpy(),
                                  jr.vertices.to_numpy())
    np.testing.assert_array_equal(sc.rigid0.faces, jr.faces)
    np.testing.assert_allclose(sc.rigid_volume.numpy(),
                               np.asarray(ar.rigid_volume), rtol=1e-6)
    np.testing.assert_allclose(sc.rigid_mass.numpy(),
                               np.asarray(ar.rigid_mass), rtol=1e-6)
    np.testing.assert_allclose(float(sc.rigid_mass_total),
                               float(ar.rigid_mass_total), rtol=1e-6)
    _close(sc.rigid0.centroid.numpy(), jr.centroid, 1e-5)
    _close(sc.rigid0.inertia.numpy(), jr.inertia, 1e-5)
    _close(sc.rigid0.inertia_inv.numpy(), jr.inertia_inv, 1e-5)
    # the initial state carries the body as JAX's does
    state = dfsph.init_state(sc)
    assert torch.equal(state.rigid.pos, sc.rigid0.pos)
    assert float(state.rigid.force.abs().max()) == 0.0


# ---------------------------------------------------------------------------
# The rigid step
# ---------------------------------------------------------------------------

def _f64(sc):
    """The scene's rigid fields in float64: the rigid step's exact value."""
    return dataclasses.replace(
        sc, rigid_mass_total=sc.rigid_mass_total.double(),
        gravity_acc=sc.gravity_acc.double(),
        rigid_box=tuple(b.double() for b in sc.rigid_box))


def test_rigid_steps_match_jax():
    """20 rigid steps from a spinning start falling at 4 m/s onto the floor
    (the body starts 0.095 above its floor margin and hits it at step 12),
    under the same numpy-seeded forces in both packages, beside the port's
    step in float64 from the same start.

    pos, centroid and vel hold to JAX at atol 1e-5 every step, omega up to
    the hit. The hit's impulse, j = K^-1 (v' - v), turned by I^-1 (~100 /
    kg m^2 here), amplifies f32 rounding: from the hit on, the port's omega
    lies ~3e-5 from the float64 run's and JAX's ~1.8e-4 (printed), so there
    omega is held to the float64 run, the port's at atol 1e-4 and JAX's at
    1e-3 (which shows that the float64 run computes JAX's function)."""
    raw = rigid_cfg(**{"solid.pos_offset": [0.4, 0.12, 0.4]})
    js = jscene.build_scene(jparse_config(raw))
    sc = build_scene(parse_config(raw), device="cpu")
    sc64 = _f64(sc)
    rng = np.random.default_rng(11)
    v0 = np.array([0.2, -4.0, -0.3], np.float32)
    w0 = np.array([0.8, -0.5, 1.2], np.float32)
    jr = jbase.init_rigid_state(js)._replace(vel=jnp.asarray(v0),
                                              omega=jnp.asarray(w0))
    pr = base.init_rigid_state(sc)._replace(vel=torch.from_numpy(v0),
                                            omega=torch.from_numpy(w0))
    r64 = base.RigidBodyState(*(t.double() for t in pr))
    jstep = jax.jit(jrigid.step, static_argnums=0)
    dt = np.float32(2e-3)
    hit = None
    for k in range(1, 21):
        f = rng.normal(0.0, 0.3, (sc.n_rigid, 3)).astype(np.float32)
        jr = jstep(js.static, js.arrays,
                   jr._replace(force=V3.from_rows(f)), jnp.asarray(dt))
        pr = prigid.step(sc, pr._replace(force=torch.from_numpy(f)),
                         torch.tensor(dt))
        r64 = prigid.step(sc64, r64._replace(
            force=torch.from_numpy(f).double()), torch.tensor(
                dt, dtype=torch.float64))
        for name, got, want in (
                ("pos", pr.pos.numpy(), jr.pos.to_numpy()),
                ("centroid", pr.centroid.numpy(), jr.centroid),
                ("vel", pr.vel.numpy(), jr.vel)):
            np.testing.assert_allclose(got, np.asarray(want), atol=1e-5,
                                       err_msg=f"step {k} {name}")
        assert float(pr.force.abs().max()) == 0.0
        if hit is None and float(jr.vel[1]) > -1.0:
            hit = k
        w, jw, w64 = pr.omega.numpy(), np.asarray(jr.omega), r64.omega.numpy()
        if hit is None:
            np.testing.assert_allclose(w, jw, atol=1e-5, err_msg=f"step {k}")
        else:
            print(f"step {k}: omega, port - f64 {np.abs(w - w64).max():.2e}, "
                  f"JAX - f64 {np.abs(jw - w64).max():.2e}")
            np.testing.assert_allclose(w, w64, atol=1e-4, err_msg=f"step {k}")
            np.testing.assert_allclose(jw, w64, atol=1e-3,
                                       err_msg=f"JAX step {k}")
    # the floor stopped the fall at step 12 and holds the body above it
    assert hit == 12
    assert float(pr.pos[:, 1].min()) >= 0.05 - 1e-6


def test_rigid_bbox_and_penetration_count():
    raw = rigid_cfg()
    js = jscene.build_scene(jparse_config(raw))
    sc = build_scene(parse_config(raw), device="cpu")
    jr, pr = jbase.init_rigid_state(js), base.init_rigid_state(sc)
    for a, b in zip(prigid.body_bbox(pr, sc.particle_radius),
                    jrigid.body_bbox(jr, js.static.particle_radius)):
        # the centroids differ in the last bits (f32 sums in another order)
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)
    fluid = np.random.default_rng(4).uniform(0.3, 0.6, (500, 3)).astype(
        np.float32)
    got = prigid.check_penetration(sc, pr, torch.from_numpy(fluid))
    want = jrigid.check_penetration(js.static, jr, V3.from_rows(fluid))
    assert int(got) == int(want) > 0


# ---------------------------------------------------------------------------
# The fluid-rigid passes
# ---------------------------------------------------------------------------

@jax.jit
def _jax_quirk(rho, oid, idx):
    return jnp.zeros_like(rho).at[oid].set(rho)[idx]


def _jax_ops(st, arrays, pos, rpos, v_r, vel, rho, rho_quirk, body_vel, u,
             force):
    """JAX's dense coupled passes on unsorted fluid `pos` (sorted inside,
    as its prepare does): the rigid sums, the contact dot, the solid
    viscosity (vel, rho in unsorted order) and the reaction force (u in
    unsorted order), in sorted order with the sort's perm."""
    n = st.n_fluid
    dp = jbase.build_dense_prep(st, arrays, pos, st.band_nb_wide, st.band_B)
    rw = rigid_dense.build_rigid_windows(st, dp.pos, dp.qcells, rpos,
                                         arrays.rigid_volume, cap=st.rq_cap)
    rt = rigid_dense.rigid_terms(st, rw, RHO0, n)
    dot = rigid_dense.contact_dot_op(st, rw, RHO0, n)(v_r)
    visc = rigid_dense.viscosity_op(st, rw, RHO0, n, C_S, ALPHA)(
        vel.take(dp.perm), rho[dp.perm], rho_quirk, body_vel)
    rs = rigid_dense.build_rigid_side(st, rpos, arrays.rigid_volume, dp.pos,
                                      dp.starts, RHO0, Kf=st.K)
    fr = rigid_dense.rigid_side_force(rs, u[dp.perm], rho, force)
    return dict(perm=dp.perm, rt=rt, dot=dot, visc=visc, force=fr,
                over=(rw.overflow, rs.overflow))


_jax_ops_jit = jax.jit(_jax_ops, static_argnums=0)


def _unsort(sorted_rows, perm):
    out = np.empty_like(sorted_rows)
    out[np.asarray(perm)] = sorted_rows
    return out


def _v3(v):
    return np.stack([np.asarray(c) for c in v.astuple()], axis=-1)


def _assert_scaled(got, want, tag):
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert scale > 0, tag
    assert err <= 1e-5 * scale, f"{tag}: error {err} over scale {scale}"


def _pass_inputs(raw, seed):
    """Both packages' scene of `raw`, the fluid seed lattice jittered by
    0.1 r and shifted by 0.3 r on every axis, and random per-particle
    inputs (numpy, unsorted / original order)."""
    js = jscene.build_scene(jparse_config(raw))
    sc = build_scene(parse_config(raw), device="cpu")
    r, n, nr = sc.particle_radius, sc.n_fluid, sc.n_rigid
    rng = np.random.default_rng(seed)
    pos = (sc.fluid_pos0.numpy() + 0.3 * r
           + rng.uniform(-0.1 * r, 0.1 * r, (n, 3))).astype(np.float32)
    x = dict(pos=pos, rpos=sc.rigid0.pos.numpy(),
             v_r=rng.normal(0.0, 1.0, (nr, 3)),
             vel=rng.normal(0.0, 1.0, (n, 3)),
             rho=rng.uniform(900.0, 1100.0, n),
             rho_quirk=rng.uniform(900.0, 1100.0, nr),
             body_vel=rng.normal(0.0, 1.0, 3),
             u=rng.normal(0.0, 1e-4, n),
             force=rng.normal(0.0, 1.0, (nr, 3)))
    x = {k: np.asarray(a, np.float32) for k, a in x.items()}
    return js, sc, x


def test_plain_passes_match_jax_ops():
    js, sc, x = _pass_inputs(rigid_cfg(), seed=2)
    g, h, m = sc.grid, sc.h, sc.particle_m
    want = _jax_ops_jit(
        js.static, js.arrays, V3.from_rows(x["pos"]),
        V3.from_rows(x["rpos"]), V3.from_rows(x["v_r"]),
        V3.from_rows(x["vel"]), jnp.asarray(x["rho"]),
        jnp.asarray(x["rho_quirk"]), jnp.asarray(x["body_vel"]),
        jnp.asarray(x["u"]), V3.from_rows(x["force"]))
    assert [int(o) for o in want["over"]] == [0, 0]
    jperm = want["perm"]

    t = {k: torch.from_numpy(a) for k, a in x.items()}
    scid, perm, pos, (vel, rho, u) = base.sort_by_cells(
        g, t["pos"], (t["vel"], t["rho"], t["u"]))
    starts = nb.csr_starts(scid, g.num_cells)
    table = R.rigid_table(g, t["rpos"], sc.rigid_volume)
    assert sorted(table.lid.tolist()) == list(range(sc.n_rigid))
    stencil.reset_counts()
    rt = R.rigid_terms_plain(pos, table, g, h, RHO0)
    n_pairs = int((rt.rho > 0).sum())
    assert 0 < n_pairs < sc.n_fluid      # some fluid near the body, not all
    got = dict(
        rho=rt.rho, s=rt.s, qsum=rt.qsum, g2=rt.g2,
        dot=R.rigid_contact_dot_plain(pos, table, g, h, RHO0, t["v_r"]),
        visc=R.rigid_viscosity_plain(pos, table, g, h, RHO0, m, vel, rho,
                                     t["rho_quirk"], t["body_vel"], C_S,
                                     ALPHA))
    jrt = want["rt"]
    ref = dict(rho=jrt.rho, s=_v3(jrt.s), qsum=jrt.qsum, g2=jrt.g2,
               dot=want["dot"], visc=_v3(want["visc"]))
    for key in ref:
        _assert_scaled(_unsort(got[key].numpy(), perm),
                       _unsort(np.asarray(ref[key]), jperm), key)
    force = R.rigid_side_force_plain(t["rpos"], sc.rigid_volume, pos, starts,
                                     g, h, RHO0, u, t["force"])
    _assert_scaled(force.numpy() - x["force"],
                   _v3(want["force"]) - x["force"], "reaction")
    for name in ("rigid_terms", "rigid_contact_dot", "rigid_viscosity",
                 "rigid_side_force"):
        assert stencil.KERNELS[name].plain_calls == 1
        assert stencil.KERNELS[name].launches == 0


def test_rho_quirk_clip_with_more_rigid_than_fluid_particles():
    """8 fluid particles beside the 24-voxel body: the quirk's index
    clips to the fluid's last, in both packages, and the solid viscosity
    that reads it agrees."""
    raw = rigid_cfg(**{"fluid.start_pos": [0.38, 0.22, 0.38],
                       "fluid.water_size": [0.1, 0.1, 0.1]})
    js, sc, x = _pass_inputs(raw, seed=5)
    n, nr = sc.n_fluid, sc.n_rigid
    assert n == 8 and nr == 24
    oid = np.random.default_rng(6).permutation(n).astype(np.int32)
    idx = np.clip(np.arange(nr), 0, n - 1)
    want_q = np.asarray(_jax_quirk(jnp.asarray(x["rho"]), jnp.asarray(oid),
                                   jnp.asarray(idx)))
    got_q = base.rho_quirk(torch.from_numpy(x["rho"]),
                            torch.from_numpy(oid), nr)
    np.testing.assert_array_equal(got_q.numpy(), want_q)
    assert (want_q[n - 1:] == want_q[n - 1]).all()

    want = _jax_ops_jit(
        js.static, js.arrays, V3.from_rows(x["pos"]),
        V3.from_rows(x["rpos"]), V3.from_rows(x["v_r"]),
        V3.from_rows(x["vel"]), jnp.asarray(x["rho"]), jnp.asarray(want_q),
        jnp.asarray(x["body_vel"]), jnp.asarray(x["u"]),
        V3.from_rows(x["force"]))
    g = sc.grid
    t = {k: torch.from_numpy(a) for k, a in x.items()}
    _, perm, pos, (vel, rho) = base.sort_by_cells(g, t["pos"],
                                                  (t["vel"], t["rho"]))
    table = R.rigid_table(g, t["rpos"], sc.rigid_volume)
    visc = R.rigid_viscosity_plain(pos, table, g, sc.h, RHO0,
                                   sc.particle_m, vel, rho, got_q,
                                   t["body_vel"], C_S, ALPHA)
    _assert_scaled(_unsort(visc.numpy(), perm),
                   _unsort(_v3(want["visc"]), want["perm"]), "viscosity")


def test_wrappers_take_the_plain_version_on_the_cpu_only():
    """A CPU tensor runs the plain version; a tensor on another device
    (the meta device here) raises rather than falling back."""
    sc = build_scene(parse_config(rigid_cfg()), device="cpu")
    g = sc.grid
    table = R.rigid_table(g, sc.rigid0.pos, sc.rigid_volume)
    pos = sc.fluid_pos0
    stencil.reset_counts()
    R.rigid_terms(pos, table, g, sc.h, RHO0)
    assert stencil.KERNELS["rigid_terms"].plain_calls == 1
    with pytest.raises(ValueError, match="no kernel"):
        R.rigid_terms(pos.to("meta"), table, g, sc.h, RHO0)
    with pytest.raises(ValueError, match="no kernel"):
        R.rigid_side_force(sc.rigid0.pos.to("meta"), sc.rigid_volume, pos,
                           torch.zeros(g.num_cells + 1, dtype=torch.int32),
                           g, sc.h, RHO0, pos[:, 0], sc.rigid0.pos)
