"""The reaction walk's lane group (csrc/rigid_side_force.cu,
`ordered_group_walk` in csrc/stencil.cuh), modelled on the CPU.

The kernel gives each body particle a group of G lanes: a round tests C
candidates a lane of one of the 9 stencil runs, a ballot ranks the hits
into the group's ring in walk order, and whenever a group of the warp
holds G hits every group hands its oldest to its lanes, lane l taking hit
done + l. The group then adds the batch's terms in lane order, so that
the sum rounds as the one-thread walk's did.

The plain model here runs that schedule over TINY's block with a box body
across its water surface (perf/inputs.coupled_inputs, as
tests/test_torch_rigid_stream.py builds it), warp by warp, for the
settings the kernel may take, and holds:

* the order in which the batches hand out the charged pairs to be the
  reaction list's (`rigid_side_list_plain`: `walk_offsets`, ascending
  slot), row by row;
* each hit on the lane the kernel gives it, no batch larger than G, the
  ring never fuller than its size;
* the terms added in that order, in f32, to equal bit for bit the list's
  stream (`rigid_side_force_list_plain`, index_add_ in pair order, which
  the card's stream and walk both equal), and `rigid_side_force_plain`
  (masked row sums) to 1e-5 of the reaction's scale.

Torch on one thread; no JAX runs here.
"""

import copy

import numpy as np
import pytest
import torch

from cfd_taichi_tpu_torch import build_scene
from cfd_taichi_tpu_torch.config import parse_config
from cfd_taichi_tpu_torch.ops import neighbors as nb
from cfd_taichi_tpu_torch.ops import rigid as R
from cfd_taichi_tpu_torch.ops.smoothing import (CubicConstants,
                                                cubic_grad_coeff, f32,
                                                ieee_sqrt)
from cfd_taichi_tpu_torch.perf import inputs
from test_torch_rigid_stream import TINY_BODY

RHO0 = 1000.0
SEED = 11
WARP = 32


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
    offs = R.rigid_side_rows(x["rpos"], x["st"], sc.grid)
    x["side"] = R.rigid_side_list(x["rpos"], x["rvol"], x["p"], x["st"],
                                  sc.grid, sc.h, RHO0, offs,
                                  R.list_slots(offs))
    return x


def _runs(c, grid, starts):
    """The 9 stencil runs [lo, hi) of the cell `c` in walk order (dm outer,
    ds inner; csrc/stencil.cuh, stencil_run)."""
    fast, mid, slow = grid.axes_by_stride
    out = []
    for dm in (-1, 0, 1):
        for ds in (-1, 0, 1):
            cm, cs = c[mid] + dm, c[slow] + ds
            if not (0 <= cm < grid.dims[mid] and 0 <= cs < grid.dims[slow]):
                out.append((0, 0))
                continue
            base = cm * grid.strides[mid] + cs * grid.strides[slow]
            f0 = max(c[fast] - 1, 0)
            f1 = min(c[fast] + 1, grid.dims[fast] - 1)
            out.append((int(starts[base + f0]), int(starts[base + f1 + 1])))
    return out


def ring_size(g, c):
    """The ring's slots a group: the least power of two that holds G hits
    less one and a round's C G."""
    need, size = g + c * g, 1
    while size < need:
        size *= 2
    return size


def model_batches(x, g, c):
    """The kernel's schedule, warp by warp: {row: [(fluid index, dx, dy,
    dz), ...]} in the order its group adds the terms (each batch's hits in
    lane order), and the (row, batch, lane) of every handed hit."""
    grid, h2 = x["grid"], np.float32(CubicConstants.of(x["h"]).h2)
    rpos = x["rpos"].numpy()
    pos = x["p"].numpy()
    starts = x["st"].numpy()
    cells = nb.cell_coords(x["rpos"], grid).numpy()
    nr, size = rpos.shape[0], ring_size(g, c)
    order = {j: [] for j in range(nr)}
    slots = []
    for w0 in range(0, nr, WARP // g):        # a warp's groups
        rows = list(range(w0, min(w0 + WARP // g, nr)))
        runs = {j: _runs(cells[j], grid, starts) for j in rows}
        queue = {j: [] for j in rows}
        batch = 0

        def hand():
            nonlocal batch
            for j in rows:
                handed, queue[j] = queue[j][:g], queue[j][g:]
                for lane, hit in enumerate(handed):
                    slots.append((j, batch, lane))
                    order[j].append(hit)
            batch += 1

        for r in range(9):
            rounds = max(-(-(hi - lo) // (c * g)) for lo, hi in
                         (runs[j][r] for j in rows))
            for t in range(rounds):
                for cc in range(c):
                    for j in rows:
                        lo, hi = runs[j][r]
                        for lane in range(g):   # ascending lanes: ranks
                            i = lo + (t * c + cc) * g + lane
                            if i >= hi:
                                continue
                            d = rpos[j] - pos[i]
                            r2 = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
                            if r2 <= h2:
                                queue[j].append((i, *d))
                assert all(len(q) < size for q in queue.values())
                while any(len(q) >= g for q in queue.values()):
                    hand()
        while any(queue.values()):
            hand()
    return order, slots


def _terms(x, order):
    """(rows, fluid indices, charged f32 terms ((-d) coeff) u_i (P, 3)) of
    the model's hits, in its add order, the pair term as the kernel and
    the plain versions form it."""
    hits = [(j, *hit) for j, row in order.items() for hit in row]
    rows = torch.tensor([hit[0] for hit in hits], dtype=torch.long)
    fluid = torch.tensor([hit[1] for hit in hits], dtype=torch.long)
    d = torch.tensor(np.array([hit[2:] for hit in hits], np.float32))
    r2 = d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1] + d[:, 2] * d[:, 2]
    r = ieee_sqrt(torch.clamp(r2, min=f32(1e-24)))
    coeff = (f32(RHO0) * x["rvol"][rows]) * cubic_grad_coeff(r, x["h"])
    charged = r <= CubicConstants.of(x["h"]).h
    terms = ((-d) * coeff[:, None]) * x["u"][fluid][:, None]
    return rows[charged], fluid[charged], terms[charged]


# (G, C): the kernel's (16, 2) and the others it was measured with
SETTINGS = [(16, 2), (4, 1), (8, 1), (16, 1), (8, 2), (8, 4), (4, 4),
            (32, 1)]


@pytest.mark.parametrize("g,c", SETTINGS)
def test_batches_hand_out_the_pairs_in_walk_order(tiny, g, c):
    order, slots = model_batches(tiny, g, c)
    rows, fluid, _ = _terms(tiny, order)
    want_rows, want_fluid, _ = R.side_pairs(tiny["side"])
    assert rows.numel() > 50
    assert torch.equal(rows, want_rows) and torch.equal(fluid, want_fluid)
    # hit k of a batch on lane k, and no batch past G
    per_batch = {}
    for j, batch, lane in slots:
        k = per_batch.setdefault((j, batch), 0)
        assert lane == k
        per_batch[(j, batch)] = k + 1
    assert max(per_batch.values()) <= g


@pytest.mark.parametrize("g,c", SETTINGS[:3])
def test_terms_added_in_batch_order_are_the_streams_bits(tiny, g, c):
    order, _ = model_batches(tiny, g, c)
    rows, _, terms = _terms(tiny, order)
    force = tiny["force"]
    acc = np.zeros((force.shape[0], 3), np.float32)
    for j, t in zip(rows.tolist(), terms.numpy()):
        acc[j] += t     # one f32 add a pair, in the group's order
    got = force + torch.from_numpy(acc)
    want = R.rigid_side_force_list_plain(tiny["side"], tiny["u"], force)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    walk = R.rigid_side_force_plain(tiny["rpos"], tiny["rvol"], tiny["p"],
                                    tiny["st"], tiny["grid"], tiny["h"],
                                    RHO0, tiny["u"], force)
    react = (walk - force).abs().max()
    assert float((got - walk).abs().max()) <= 1e-5 * float(react)
    assert float(react) > 0.0
