"""Headless frame rendering, and GIF / MP4 assembly of the frames.

Counterpart of `cfd_taichi_tpu/utils/render.py` (reference main.py:51-62,
184-187, 208-209, which render through taichi's GGUI window): a
perspective point projection of the particle clouds from the scene camera
(cam_pos / cam_look_at / cam_up, default.json:11-13) drawn with
matplotlib, the GIF assembled with PIL and the MP4 written directly as an
ISO-BMFF file of JPEG frames. matplotlib and PIL are imported where they
are used, and `require` imports both up front, so that a run that asks
for frames where either is missing fails before its first step with an
ImportError that names it.
"""

from __future__ import annotations

import os

import numpy as np


def require() -> None:
    """Import matplotlib and PIL, raising an ImportError that names the
    package that is missing."""
    for name in ("matplotlib", "PIL"):
        try:
            __import__(name)
        except ImportError as e:
            raise ImportError(
                f"frame rendering needs the {name} package, which this "
                f"Python does not have: {e}") from e


def _camera_basis(cam_pos, look_at, up):
    fwd = np.asarray(look_at, np.float64) - np.asarray(cam_pos, np.float64)
    fwd = fwd / np.linalg.norm(fwd)
    right = np.cross(fwd, np.asarray(up, np.float64))
    right = right / np.linalg.norm(right)
    true_up = np.cross(right, fwd)
    return right, true_up, fwd


def project_points(pos, cam_pos, look_at, up, fov_deg=45.0):
    """Perspective-project world points to normalized image coords; returns
    (xy (N,2), depth (N,))."""
    right, true_up, fwd = _camera_basis(cam_pos, look_at, up)
    rel = np.asarray(pos, np.float64) - np.asarray(cam_pos, np.float64)
    x = rel @ right
    y = rel @ true_up
    z = rel @ fwd
    z = np.maximum(z, 1e-6)
    scale = 1.0 / np.tan(np.radians(fov_deg) / 2.0)
    return np.stack([x / z * scale, y / z * scale], axis=-1), z


def render_frame(path, clouds, cam_pos, look_at, up, box_min=None,
                 box_max=None, res=640):
    """Render point clouds [(pos, color, radius), ...] to a PNG."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig = plt.figure(figsize=(res / 100, res / 100), dpi=100)
    ax = fig.add_axes([0, 0, 1, 1])
    ax.set_facecolor("black")
    ax.set_xlim(-1, 1)
    ax.set_ylim(-1, 1)
    ax.axis("off")

    if box_min is not None and box_max is not None:
        corners = np.array([[x, y, z] for x in (box_min[0], box_max[0])
                            for y in (box_min[1], box_max[1])
                            for z in (box_min[2], box_max[2])])
        edges = [(0, 1), (0, 2), (0, 4), (1, 3), (1, 5), (2, 3), (2, 6),
                 (3, 7), (4, 5), (4, 6), (5, 7), (6, 7)]
        xy, _ = project_points(corners, cam_pos, look_at, up)
        for a, b in edges:
            ax.plot([xy[a, 0], xy[b, 0]], [xy[a, 1], xy[b, 1]],
                    color=(0.99, 0.68, 0.28), linewidth=0.8)

    for pos, color, radius in clouds:
        if len(pos) == 0:
            continue
        xy, depth = project_points(pos, cam_pos, look_at, up)
        order = np.argsort(-depth)  # painter's order, far first
        size = np.clip((radius / depth[order]) * 4e4, 0.2, 50.0)
        color = np.asarray(color, np.float32)
        c = color[order] if color.ndim == 2 else [color]
        ax.scatter(xy[order, 0], xy[order, 1], s=size, c=c,
                   linewidths=0, alpha=0.9)

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fig.savefig(path)
    plt.close(fig)


def assemble_gif(frame_paths, out_path, fps=60):
    """GIF assembly from rendered frames (VideoManager.make_video parity,
    main.py:208-209)."""
    from PIL import Image

    if not frame_paths:
        return
    frames = [Image.open(p) for p in frame_paths]
    frames[0].save(out_path, save_all=True, append_images=frames[1:],
                   duration=max(int(1000 / fps), 20), loop=0)


def assemble_mp4(frame_paths, out_path, fps=60):
    """MP4 assembly from rendered frames (the reference emits video.mp4 next
    to the GIF, main.py:208-209 via taichi's VideoManager/ffmpeg).

    The container is written directly, with no ffmpeg:
    an ISO-BMFF (MP4) file with a single Motion-JPEG video track — each frame
    JPEG-encoded by PIL, sample entry 'mp4v' with an MPEG-4 elementary-stream
    descriptor of objectTypeIndication 0x6C (JPEG), which players/demuxers
    (ffmpeg, VLC, QuickTime) decode as MJPEG.
    """
    import io as _io
    import struct

    from PIL import Image

    if not frame_paths:
        return

    samples = []
    w = h = 0
    for p in frame_paths:
        im = Image.open(p).convert("RGB")
        # JPEG needs even-ish dims for broad player compat; MP4 tkhd stores
        # the first frame's size.
        w, h = im.size
        buf = _io.BytesIO()
        im.save(buf, format="JPEG", quality=90)
        samples.append(buf.getvalue())

    timescale = int(fps)
    mdat_payload = b"".join(samples)

    def box(typ: bytes, payload: bytes) -> bytes:
        return struct.pack(">I", 8 + len(payload)) + typ + payload

    def full(typ: bytes, version: int, flags: int, payload: bytes) -> bytes:
        return box(typ, struct.pack(">B3s", version,
                                    flags.to_bytes(3, "big")) + payload)

    n = len(samples)
    dur = n  # one tick per frame at `timescale` ticks/s

    ftyp = box(b"ftyp", b"isom" + struct.pack(">I", 512) + b"isomiso2mp41")

    # --- sample tables ----------------------------------------------------
    stsd_esds = full(b"esds", 0, 0, bytes([
        0x03, 23, 0x00, 0x01, 0x00,            # ES_Descriptor
        0x04, 15, 0x6C, 0x11,                  # DecoderConfig: OTI 0x6C (JPEG)
        0x00, 0x00, 0x00,                      # buffer size db
        0x00, 0x00, 0x00, 0x00,                # max bitrate
        0x00, 0x00, 0x00, 0x00,                # avg bitrate
        0x05, 0,                               # DecoderSpecificInfo (empty)
        0x06, 1, 0x02,                         # SLConfig
    ]))
    mp4v = box(b"mp4v", struct.pack(
        ">6xH16xHHIIIH", 1, w, h, 0x480000, 0x480000, 0, 1)
        + b"\0" * 32 + struct.pack(">Hh", 0x18, -1) + stsd_esds)
    stsd = full(b"stsd", 0, 0, struct.pack(">I", 1) + mp4v)
    stts = full(b"stts", 0, 0, struct.pack(">III", 1, n, 1))
    stsc = full(b"stsc", 0, 0, struct.pack(">IIII", 1, 1, n, 1))
    stsz = full(b"stsz", 0, 0, struct.pack(">II", 0, n)
                + b"".join(struct.pack(">I", len(s)) for s in samples))
    # One chunk holding all samples; its file offset = after ftyp + mdat hdr.
    chunk_offset = len(ftyp) + 8
    stco = full(b"stco", 0, 0, struct.pack(">II", 1, chunk_offset))
    stbl = box(b"stbl", stsd + stts + stsc + stsz + stco)

    # --- media/track/movie headers -----------------------------------------
    url = full(b"url ", 0, 1, b"")
    dref = full(b"dref", 0, 0, struct.pack(">I", 1) + url)
    dinf = box(b"dinf", dref)
    vmhd = full(b"vmhd", 0, 1, struct.pack(">HHHH", 0, 0, 0, 0))
    minf = box(b"minf", vmhd + dinf + stbl)
    hdlr = full(b"hdlr", 0, 0, struct.pack(">I4s12x", 0, b"vide")
                + b"VideoHandler\0")
    mdhd = full(b"mdhd", 0, 0, struct.pack(">IIIIHH", 0, 0, timescale, dur,
                                           0x55C4, 0))
    mdia = box(b"mdia", mdhd + hdlr + minf)
    identity = struct.pack(">9i", 0x10000, 0, 0, 0, 0x10000, 0, 0, 0,
                           0x40000000)
    tkhd = full(b"tkhd", 0, 7, struct.pack(">IIIII8xHHHH", 0, 0, 1, 0, dur,
                                           0, 0, 0, 0)
                + identity + struct.pack(">II", w << 16, h << 16))
    trak = box(b"trak", tkhd + mdia)
    mvhd = full(b"mvhd", 0, 0, struct.pack(">IIII", 0, 0, timescale, dur)
                + struct.pack(">IH2x8x", 0x10000, 0x0100) + identity
                + b"\0" * 24 + struct.pack(">I", 2))
    moov = box(b"moov", mvhd + trak)
    mdat = box(b"mdat", mdat_payload)

    with open(out_path, "wb") as f:
        f.write(ftyp + mdat + moov)
