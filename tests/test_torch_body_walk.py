"""The predicted density's walk of the body (csrc/pcisph_predict.cu: the
queued walk, `queued_walk_of` in csrc/stencil.cuh, taken only by warps
with a row inside the body's gate) and the body gate's cluster fold
(csrc/body_box.cu), modelled on the CPU.

The walk: a warp takes the body only where one of its rows lies inside
the gate; lane t walks row t over the 9 runs of its stencil, C
candidates a chunk, the warp taking each run's most chunks of any lane;
hits queue in the lane's order and drain through the pair term whenever
a lane could not take another chunk's hits, and at the end. The plain
model here runs that schedule over TINY's block with a box body across
its water surface (perf/inputs.coupled_inputs, as
tests/test_torch_rigid_stream.py builds it), warp by warp, for the chunk
the kernel takes and those it was measured with, and holds:

* every candidate of the row's 9 runs tested exactly once, in walk order
  (dm outer, ds inner, ascending slot);
* the hits drained in the order of the plain version's walk
  (`_pair_chunks`, `walk_offsets`), whatever the drains' points, so that
  their terms, added one by one in f32, give one sum; and that sum
  within 1e-5 of the body's part of `pcisph_predict_rho_plain` (masked
  row sums);
* a row outside the gate with no hit, its body sum 0.f.

The fold: the cluster's blocks (`box_blocks`) and each block's slice
(`box_slice`) and its threads' strided loads, modelled at the edge sizes,
take every particle exactly once; the extremes of the slices folded in
any order give `make_body_box_plain`'s box bit for bit.

Torch on one thread; no JAX runs here (tests/test_torch_pcisph_predict.py
holds the plain versions to JAX's `predict_rho_op`).
"""

import copy
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from cfd_taichi_tpu_torch import build_scene
from cfd_taichi_tpu_torch.config import parse_config
from cfd_taichi_tpu_torch.ops import neighbors as nb
from cfd_taichi_tpu_torch.ops import stencil
from cfd_taichi_tpu_torch.ops.smoothing import CubicConstants, cubic_w, f32
from cfd_taichi_tpu_torch.perf import inputs
from test_torch_rigid_stream import TINY_BODY
from test_torch_rigid_walk import _runs

RHO0 = 1000.0
SEED = 11
WARP = 32
CSRC = Path(stencil.__file__).resolve().parents[1] / "csrc"


def _constant(source: str, name: str) -> int:
    """The integer constexpr `name` of csrc/`source`."""
    text = (CSRC / source).read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))


BODY_CHUNK = _constant("pcisph_predict.cu", "kPredictChunk")
BODY_QUEUE = _constant("pcisph_predict.cu", "kPredictQueue")
BOX_THREADS = _constant("body_box.cu", "kBoxThreads")
BOX_UNROLL = _constant("body_box.cu", "kBoxUnroll")
BOX_ONE_BLOCK = _constant("body_box.cu", "kBoxOneBlock")
BOX_CLUSTER = _constant("body_box.cu", "kBoxCluster")


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tiny():
    sc = build_scene(parse_config(copy.deepcopy(TINY_BODY)), device="cpu")
    x = inputs.coupled_inputs(sc, SEED, device="cpu")
    x["box"] = stencil.make_body_box_plain(x["table"].pos, sc.h)
    return x


def model_walk(x, chunk, queue=None):
    """The kernel's schedule, warp by warp: {row: [slot, ...]} of the hits
    each row inside the gate drains, in order, and the tested candidates
    {row: [slot, ...]}, with a queue of `queue` hits a lane (default the
    kernel's)."""
    queue = queue or BODY_QUEUE
    grid, h2 = x["grid"], np.float32(CubicConstants.of(x["h"]).h2)
    pos = x["p"].numpy()
    spos = x["table"].pos.numpy()
    starts = x["table"].starts.numpy()
    cells = nb.cell_coords(x["p"], grid).numpy()
    near = stencil.in_body_box(x["p"], x["box"]).numpy()
    n = pos.shape[0]
    drained, tested = {}, {}
    for w0 in range(0, n, WARP):
        rows = [i for i in range(w0, min(w0 + WARP, n))]
        if not near[w0:w0 + WARP].any():
            continue
        runs = {i: _runs(cells[i], grid, starts) if near[i] else [(0, 0)] * 9
                for i in rows}
        held = {i: [] for i in rows}
        for i in rows:
            drained[i], tested[i] = [], []

        def drain():
            for i in rows:
                drained[i] += held[i]
                held[i] = []

        for r in range(9):
            most = max(hi - lo for lo, hi in (runs[i][r] for i in rows))
            for t in range(0, most, chunk):
                for i in rows:
                    lo, hi = runs[i][r]
                    for j in range(lo + t, min(lo + t + chunk, hi)):
                        tested[i].append(j)
                        d = pos[i] - spos[j]
                        if d[0] * d[0] + d[1] * d[1] + d[2] * d[2] <= h2:
                            held[i].append(j)
                if any(len(q) > queue - chunk for q in held.values()):
                    drain()
        drain()
    return drained, tested, near


def _walk_order(x):
    """{row: [slot, ...]}: the body pairs of each row in the plain
    version's walk order (27 cells in `walk_offsets`, ascending slot)."""
    out = {}
    for rows, pr in stencil._pair_chunks(
            x["p"], x["table"].pos, x["table"].starts, x["grid"], x["h"],
            exclude_self=False, offsets=stencil.walk_offsets(x["grid"])):
        for k, i in enumerate(range(rows.start, rows.stop)):
            out[i] = pr.slot[k][pr.valid[k]].tolist()
    return out


def _terms(x, i, slots):
    """Row i's f32 terms (rho0 V_s) W(|x~_i - x_s|) of `slots`, in order."""
    s = torch.tensor(slots, dtype=torch.long)
    w = cubic_w(stencil._pair_r(x["shifted"][i:i + 1],
                                x["table"].pos[s][None]), x["h"])[0]
    return ((f32(RHO0) * x["table"].vol[s]) * w).numpy()


@pytest.mark.parametrize("chunk,queue", [(BODY_CHUNK, None), (6, None),
                                         (12, None), (BODY_CHUNK, 12)])
def test_walk_drains_each_pair_once_in_walk_order(tiny, chunk, queue):
    drained, tested, near = model_walk(tiny, chunk, queue)
    assert 0 < sum(near[i] for i in drained) < near.shape[0]
    order = _walk_order(tiny)
    assert sum(len(h) for h in drained.values()) > 50
    starts = tiny["table"].starts.numpy()
    cells = nb.cell_coords(tiny["p"], tiny["grid"]).numpy()
    for i, row in drained.items():
        assert row == order[i], i
        if near[i]:
            runs = _runs(cells[i], tiny["grid"], starts)
            assert tested[i] == [j for lo, hi in runs for j in range(lo, hi)]
    for i in np.flatnonzero(~near):
        assert order[int(i)] == [], i            # outside: no pair


def test_terms_in_walk_order_are_the_plain_sum(tiny):
    drained, _, near = model_walk(tiny, BODY_CHUNK)
    got = np.zeros(near.shape[0], np.float32)
    for i, row in drained.items():
        for t in _terms(tiny, i, row) if row else ():
            got[i] += t      # one f32 add a pair, in the walk's order
    body = stencil._predict_solid(
        tiny["p"], tiny["shifted"], tiny["table"].pos, tiny["table"].vol,
        tiny["table"].starts, tiny["grid"], tiny["h"], RHO0).numpy()
    scale = float(np.abs(body).max())
    assert scale > 0.0
    assert float(np.abs(got - body).max()) <= 1e-5 * scale
    assert not got[~near].any() and not body[~near].any()


def box_blocks(nr):
    """The blocks that fold a body of nr particles."""
    if nr <= BOX_ONE_BLOCK:
        return 1
    return min(BOX_CLUSTER, -(-nr // (BOX_THREADS * BOX_UNROLL)))


def box_slice(nr, c, b):
    per = -(-nr // c)
    lo = min(b * per, nr)
    return lo, min(lo + per, nr)


@pytest.mark.parametrize("nr", [1, 31, 1024, 8191, 8193, 16_384, 16_385,
                                20_481, 39_146, 70_001])
def test_cluster_slices_take_every_particle_once(nr):
    c = box_blocks(nr)
    assert 1 <= c <= BOX_CLUSTER and (c == 1) == (nr <= BOX_ONE_BLOCK)
    seen = np.zeros(nr, np.int64)
    for b in range(c):
        lo, hi = box_slice(nr, c, b)
        for t in range(BOX_THREADS):      # the block's strided loads
            for i0 in range(lo + t, hi, BOX_UNROLL * BOX_THREADS):
                for u in range(BOX_UNROLL):
                    i = i0 + u * BOX_THREADS
                    if i < hi:
                        seen[i] += 1
    assert (seen == 1).all()
    # the extremes of the slices, folded in any order, are the box's
    rng = np.random.default_rng(nr)
    bpos = rng.uniform(-3.0, 5.0, (nr, 3)).astype(np.float32)
    parts = [bpos[slice(*box_slice(nr, c, b))] for b in range(c)]
    parts = [p for p in parts if len(p)]
    lo = np.min([p.min(axis=0) for p in parts[::-1]], axis=0)
    hi = np.max([p.max(axis=0) for p in parts[::-1]], axis=0)
    want = stencil.make_body_box_plain(torch.from_numpy(bpos), 0.1)
    got = stencil.make_body_box_plain(torch.from_numpy(np.stack([lo, hi])),
                                      0.1)
    assert torch.equal(got, want)
