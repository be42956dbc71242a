"""The port's frame export held to the JAX package's on the CPU: the PLY,
OBJ and STL writers byte for byte against the JAX package's default
writers (its native `csrc/fastio.cpp` for PLY and OBJ) on a seeded cloud
and mesh; `run` with scene.is_output_ply on TINY and on RIGID_CFG writes
the files JAX's `run` writes over the same frames, each PLY row within
the last printed digit of JAX's; `run` with scene.is_output_gif writes a
PNG a frame, video.gif and video.mp4 (assembled as the JAX package
assembles the same frames, byte for byte), in each --color-by mode, and
fails before its first step without matplotlib; `render_frame` draws
JAX's PNG; `particle_colors` matches the JAX runner's through oid."""

import copy
import dataclasses
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cfd_taichi_tpu.models.dfsph as jdfsph
from cfd_taichi_tpu import runner as jrunner
from cfd_taichi_tpu.config import parse_config as jparse_config
from cfd_taichi_tpu.ops.vec import V3
from cfd_taichi_tpu.utils import io as jio
from cfd_taichi_tpu.utils import render as jrender
from cfd_taichi_tpu_torch import Simulation, runner
from cfd_taichi_tpu_torch.config import parse_config
from cfd_taichi_tpu_torch.utils import io, render

TINY = {
    "scene": {"box_min": [0.0, 0.0, 0.0], "box_max": [0.6, 0.8, 0.6],
              "particle_radius": 0.025, "gravity": 9.8},
    "solver": {"name": "dfsph", "delta_time": 4e-4, "iter_cnt": 1},
    "fluid": {"start_pos": [0.15, 0.1, 0.15], "water_size": [0.3, 0.3, 0.3]},
}
# tests/test_rigid.py:12-21: 720 fluid particles, a 24-voxel body in them
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
SCENES = {"tiny": TINY, "rigid": RIGID_CFG}
# A frame every 2.5 ms of simulated time: ~3 PLY frames in 6 frames
EXPORT = {"output_fps": 400}
FRAMES = 6


@pytest.fixture(autouse=True)
def one_thread():
    """One torch thread a test: the suite runs files side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _raw(name: str, **scene) -> dict:
    raw = copy.deepcopy(SCENES[name])
    raw["scene"].update(scene)
    return raw


def _cloud(n: int, seed: int = 3):
    """Seeded positions over many decades (signed zero, a subnormal) and
    RGBA outside [0, 1] as well as in it."""
    rng = np.random.default_rng(seed)
    pos = (rng.standard_normal((n, 3))
           * 10.0 ** rng.integers(-8, 6, (n, 3))).astype(np.float32)
    pos[0] = [0.0, -0.0, 1e-40]
    return pos, rng.uniform(-0.2, 1.2, (n, 4)).astype(np.float32)


def _mesh(seed: int = 4):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((300, 3)).astype(np.float32),
            rng.integers(0, 300, (500, 3)).astype(np.int32))


@pytest.mark.parametrize("what", ["ply", "ply_rgba", "obj", "stl"])
def test_writers_byte_equal_to_jax(what, tmp_path):
    assert jio._native_lib() is not None, "the JAX package's native writer"
    pos, rgba = _cloud(500)
    verts, faces = _mesh()
    calls = {"ply": lambda m, p: m.write_ply_ascii(p, pos),
             "ply_rgba": lambda m, p: m.write_ply_ascii(p, pos, rgba),
             "obj": lambda m, p: m.write_obj(p, verts, faces),
             "stl": lambda m, p: m.write_stl_binary(p, verts, faces)}
    a, b = tmp_path / "jax", tmp_path / "port"
    calls[what](jio, str(a))
    calls[what](io, str(b))
    assert a.read_bytes() == b.read_bytes()


def _read_ply(path):
    text = path.read_text().splitlines()
    body = text[text.index("end_header") + 1:]
    return text[:text.index("end_header") + 1], np.array(
        [[float(v) for v in ln.split()] for ln in body])


def _last_digit(x: np.ndarray) -> np.ndarray:
    """One unit in the last of the 6 significant digits %.6g prints."""
    mag = np.floor(np.log10(np.maximum(np.abs(x), 1e-30)))
    return 10.0 ** (mag - 5)


@pytest.fixture(scope="module")
def jax_ply_runs(tmp_path_factory):
    """JAX's `run` of each scene with PLY export, f32 loop coefficients
    (as tests/test_torch_dfsph.py pins them): its output directory."""
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jdfsph, "BAND_DTYPE", jnp.float32)
        jax.clear_caches()
        for name in SCENES:
            d = tmp_path_factory.mktemp(f"jax_{name}")
            jrunner.run(jparse_config(_raw(name, is_output_ply=True,
                                           **EXPORT)),
                        frames=FRAMES, output_dir=str(d), quiet=True)
            out[name] = d
    jax.clear_caches()
    return out


@pytest.mark.parametrize("name", list(SCENES))
def test_run_writes_the_jax_frames(name, jax_ply_runs, tmp_path):
    """The same files as JAX's run (PLY frames, and an OBJ beside each
    where there is a body); every PLY's header equal, and its rows, each
    matched to its nearest in JAX's one to one, within one unit of the
    last printed digit (plus the rounding of a value near a digit's
    boundary)."""
    sim = runner.run(parse_config(_raw(name, is_output_ply=True, **EXPORT)),
                     frames=FRAMES, output_dir=str(tmp_path), quiet=True,
                     device="cpu")
    ref = jax_ply_runs[name]
    names = sorted(p.name for p in tmp_path.iterdir())
    assert names == sorted(p.name for p in ref.iterdir())
    plys = [n for n in names if n.endswith(".ply")]
    assert len(plys) >= 3
    assert (name == "rigid") == any(n.endswith(".obj") for n in names)
    for n in plys:
        head, got = _read_ply(tmp_path / n)
        jhead, want = _read_ply(ref / n)
        assert head == jhead and got.shape == want.shape
        assert got.shape == (sim.scene.n_fluid, 7)
        d = np.abs(got[:, None, :3] - want[None, :, :3]).max(axis=2)
        match = d.argmin(axis=1)
        assert sorted(match) == list(range(len(match)))     # one to one
        err = np.abs(got[:, :3] - want[match, :3])
        assert (err <= 2 * _last_digit(want[match, :3])).all(), err.max()
        np.testing.assert_array_equal(got[:, 3:], want[match, 3:])
    for n in names:
        if n.endswith(".obj"):
            got, want = ((d / n).read_text().splitlines()
                         for d in (tmp_path, ref))
            assert len(got) == len(want)
            assert [ln for ln in got if ln[0] == "f"] == \
                [ln for ln in want if ln[0] == "f"]
            gv, wv = (np.array([[float(v) for v in ln.split()[1:]]
                                for ln in lines if ln[0] == "v"])
                      for lines in (got, want))
            assert gv.shape == wv.shape and len(gv) > 0
            assert (np.abs(gv - wv) <= 2 * _last_digit(wv)).all()


@pytest.mark.parametrize("color_by", ["none", "rho", "neighbors"])
def test_run_writes_png_frames_gif_and_mp4(color_by, tmp_path):
    from PIL import Image

    frames = 3
    sim = runner.run(parse_config(_raw("tiny", is_output_gif=True,
                                       output_fps=2000)),
                     frames=frames, output_dir=str(tmp_path), quiet=True,
                     color_by=color_by, device="cpu")
    pngs = sorted(p.name for p in tmp_path.glob("frame_*.png"))
    assert pngs == [f"frame_{k:06d}.png" for k in range(frames)]
    assert sim.timer.steps == frames
    with Image.open(tmp_path / pngs[0]) as im:
        assert im.size == (640, 640)
    # the JAX package's assembly of the same frames, byte for byte
    paths = [str(tmp_path / p) for p in pngs]
    jrender.assemble_gif(paths, str(tmp_path / "jax.gif"), fps=2000)
    jrender.assemble_mp4(paths, str(tmp_path / "jax.mp4"), fps=2000)
    for ext in ("gif", "mp4"):
        assert (tmp_path / f"video.{ext}").read_bytes() == \
            (tmp_path / f"jax.{ext}").read_bytes()
    with Image.open(tmp_path / "video.gif") as gif:
        assert gif.n_frames >= 1      # PIL merges frames that repeat
    mp4 = (tmp_path / "video.mp4").read_bytes()
    assert mp4[4:8] == b"ftyp" and b"moov" in mp4 and b"mdat" in mp4


def test_render_frame_equal_to_jax(tmp_path):
    """A seeded cloud with per-particle colours and a plain-coloured one,
    rendered by both packages: the same PNG bytes."""
    rng = np.random.default_rng(5)
    pos = rng.uniform(0.0, 0.6, (400, 3)).astype(np.float32)
    rgb = rng.uniform(0.0, 1.0, (400, 3)).astype(np.float32)
    clouds = [(pos, rgb, 0.025), (pos[:50] + 0.1, (1.0, 0.0, 0.0), 0.025)]
    sc = parse_config(_raw("tiny")).scene
    args = (clouds, (1.5, 1.2, 1.8), (0.3, 0.3, 0.3), (0.0, 1.0, 0.0),
            sc.box_min, sc.box_max)
    render.render_frame(str(tmp_path / "port.png"), *args)
    jrender.render_frame(str(tmp_path / "jax.png"), *args)
    assert (tmp_path / "port.png").read_bytes() == \
        (tmp_path / "jax.png").read_bytes()
    xy, depth = render.project_points(pos, *args[1:4])
    jxy, jdepth = jrender.project_points(pos, *args[1:4])
    np.testing.assert_array_equal(xy, jxy)
    np.testing.assert_array_equal(depth, jdepth)


def test_gif_run_without_matplotlib_fails_first(tmp_path, monkeypatch):
    def no_sim(*a, **k):
        raise AssertionError("a Simulation was built before the import")

    monkeypatch.setattr(runner, "Simulation", no_sim)
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(ImportError, match="matplotlib"):
        runner.run(parse_config(_raw("tiny", is_output_gif=True)), frames=1,
                   output_dir=str(tmp_path / "out"), quiet=True,
                   device="cpu")
    assert not (tmp_path / "out").exists()


def test_cli_color_by(tmp_path, capsys):
    cfg = tmp_path / "tiny.json"
    cfg.write_text(json.dumps(_raw("tiny", is_output_gif=True,
                                   output_fps=2000)))
    runner.main(["--config", str(cfg), "--frames", "2", "--device", "cpu",
                 "--output-dir", str(tmp_path / "out"), "--color-by", "rho"])
    assert len(list((tmp_path / "out").glob("frame_*.png"))) == 2
    assert "Final telemetry:" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        runner.main(["--config", str(cfg), "--color-by", "speed"])


def _jittered(name: str, seed: int = 9):
    """The port's and JAX's Simulation of the scene with the seed lattice
    jittered by 0.3 r (the same numbers in both)."""
    jsim = jrunner.Simulation(jparse_config(_raw(name)))
    sim = Simulation(parse_config(_raw(name)), device="cpu")
    pos = sim.state.fluid.pos.numpy()
    r = sim.scene.particle_radius
    pos = pos + np.random.default_rng(seed).uniform(
        -0.3 * r, 0.3 * r, pos.shape).astype(np.float32)
    sim.state = sim.state._replace(fluid=sim.state.fluid._replace(
        pos=torch.from_numpy(pos)))
    jsim.state = jsim.state._replace(fluid=jsim.state.fluid._replace(
        pos=V3.from_rows(jnp.asarray(pos))))
    return sim, jsim


@pytest.mark.parametrize("mode", ["rho", "neighbors", "none"])
@pytest.mark.parametrize("name", list(SCENES))
def test_particle_colors_match_jax(name, mode):
    sim, jsim = _jittered(name)
    got = sim.particle_colors(mode)
    want = np.asarray(jsim.particle_colors(mode))
    oid = sim.state.fluid.oid.numpy()
    joid = np.asarray(jsim.state.fluid.oid)
    got, want = got[np.argsort(oid)], want[np.argsort(joid)]
    assert got.dtype == np.float32 and got.shape == want.shape
    if mode == "rho":
        np.testing.assert_allclose(got, want, atol=1e-5)
    else:
        np.testing.assert_array_equal(got, want)
    if mode == "neighbors":
        counts = sim.neighbor_counts().numpy()
        assert counts.dtype == np.int32 and counts.min() < counts.max()
        if name == "rigid":        # the body's particles are counted too
            sc = dataclasses.replace(sim.scene, rigid_active=False)
            sim.scene = sc
            assert (sim.neighbor_counts().numpy() <= counts).all()
            assert (sim.neighbor_counts().numpy() < counts).any()
