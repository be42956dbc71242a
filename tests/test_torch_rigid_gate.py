"""The body gate of the solid sums, the contact dot and the solid
viscosity, held on the CPU:

* on perf/inputs.coupled_inputs of TINY's block with a box body across
  its water surface, RIGID_CFG (tests/test_rigid.py:12-21), the
  half-immersed torus (perf/inputs.torus_immersed) and RIGID_CFG's cube
  at two corners of the domain (over the fluid block's corner against the
  walls, and across the domain's far corner, its cells clamped): every
  query with a pair in the pair sets of `rigid_terms_plain`,
  `rigid_contact_dot_plain` and `rigid_viscosity_plain`
  (`ops/rigid._solid_pairs`, the f32 test r2 <= h2 at the start-of-step
  positions) lies inside the step's `stencil.make_body_box`, and the
  plain outputs (all four of the solid sums) with the queries outside it
  set to 0 are the outputs, bit for bit: what the kernels, which walk only
  from the box, write;
* the wrappers take `body_box` and check it (shape, dtype, device), and
  the plain versions they run here ignore it;
* a coupled step of each solver with a body (DFSPH, PCISPH, IISPH,
  WCSPH) makes one box (`base.body_terms`), before the solid sums, and
  hands that box to every gated pass: the solid sums, the contact dot,
  the solid viscosity and PCISPH's predicted density.

Torch on one thread; no JAX runs here.
"""

import copy
import inspect

import pytest
import torch

from cfd_taichi_tpu_torch import Simulation, build_scene
from cfd_taichi_tpu_torch.config import parse_config
from cfd_taichi_tpu_torch.ops import rigid as R
from cfd_taichi_tpu_torch.ops import stencil
from cfd_taichi_tpu_torch.perf import cases, inputs
from test_torch_dfsph_rigid import rigid_cfg
from test_torch_rigid_stream import TINY_BODY

SEED = 5
SCENES = {
    "tiny": lambda: build_scene(parse_config(copy.deepcopy(TINY_BODY)),
                                device="cpu"),
    "rigid_cfg": lambda: build_scene(parse_config(rigid_cfg()),
                                     device="cpu"),
    "torus": lambda: build_scene(inputs.torus_immersed(), device="cpu"),
    # the cube over the fluid block's low corner, against the walls
    "corner_low": lambda: build_scene(parse_config(rigid_cfg(
        **{"solid.pos_offset": [0.0, 0.0, 0.0]})), device="cpu"),
    # a larger cube beside the fluid block's far corner, across the
    # domain's (x, z past box_max)
    "corner_out": lambda: build_scene(parse_config(rigid_cfg(
        **{"solid.pos_offset": [0.62, 0.0, 0.62], "solid.scale": 0.3})),
        device="cpu"),
}


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def coupled():
    return {tag: inputs.coupled_inputs(make(), SEED, device="cpu")
            for tag, make in SCENES.items()}


def _paired(x) -> torch.Tensor:
    """(N,) bool: the queries with a pair in the plain versions' pair
    sets."""
    out = torch.zeros(x["p"].shape[0], dtype=torch.bool)
    for rows, pr, _, _ in R._solid_pairs(x["p"], x["table"], x["grid"],
                                         x["h"], cases.RHO0):
        out[rows] = pr.valid.any(dim=1)
    return out


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().view(torch.int32)


@pytest.mark.parametrize("tag", SCENES)
def test_every_query_with_a_body_pair_lies_inside_the_gate(coupled, tag):
    x = coupled[tag]
    paired = _paired(x)
    inside = stencil.in_body_box(x["p"], cases.gate_box(x))
    assert int(paired.sum()) > 10
    assert bool(inside[paired].all()), int((paired & ~inside).sum())
    assert int(inside.sum()) < x["p"].shape[0]


@pytest.mark.parametrize("tag", SCENES)
def test_plain_outputs_outside_the_gate_are_zero_bit_for_bit(coupled, tag):
    x = coupled[tag]
    inside = stencil.in_body_box(x["p"], cases.gate_box(x))
    for name, (_, plain) in cases.gated_calls(x).items():
        for out in cases.tensors(plain()):
            keep = inside if out.dim() == 1 else inside[:, None]
            masked = torch.where(keep, out, torch.zeros_like(out))
            assert bool((out[~inside] == 0).all()), name
            assert torch.equal(_bits(masked), _bits(out)), name
            assert bool((out != 0).any()), name


def test_wrappers_take_and_check_the_gate(coupled):
    x = coupled["tiny"]
    box = cases.gate_box(x)
    for name, (call, plain) in cases.gated_calls(x).items():
        want = plain()
        for gate in (None, box, cases.ungated_box("cpu")):
            assert cases.same_bits(call(gate), want), name
        for bad in (box.T.contiguous(), box.double(), box.reshape(6),
                    box[:, :2].contiguous()):
            with pytest.raises(ValueError, match="body_box"):
                call(bad)


@pytest.mark.parametrize("solver", ["dfsph", "pcisph", "iisph", "wcsph"])
def test_a_coupled_step_makes_one_gate_for_every_gated_pass(solver,
                                                            monkeypatch):
    """RIGID_CFG squeezed by 0.85 about its mean (pressure acts), one step:
    `stencil.make_body_box` runs once, in `base.body_terms`, before the
    solid sums, and the solid sums, the contact dot, the solid viscosity
    and the predicted density each get that box."""
    sim = Simulation(parse_config(rigid_cfg(**{"solver.name": solver})),
                     device="cpu")
    sim.state = inputs.squeezed(sim.state)
    made, got = [], []
    make = stencil.make_body_box

    def making(*args, **kw):
        made.append(make(*args, **kw))
        got.append(("make_body_box", made[-1]))
        return made[-1]

    def spy(module, name):
        fn = getattr(module, name)
        sig = inspect.signature(fn)

        def call(*args, **kw):
            got.append((name, sig.bind(*args, **kw).arguments.get(
                "body_box")))
            return fn(*args, **kw)
        monkeypatch.setattr(module, name, call)

    monkeypatch.setattr(stencil, "make_body_box", making)
    for module, name in ((R, "rigid_terms"), (R, "rigid_contact_dot"),
                         (R, "rigid_viscosity"),
                         (stencil, "pcisph_predict_rho")):
        spy(module, name)
    sim.step()
    want = {"rigid_terms", "rigid_viscosity"} | {
        "dfsph": {"rigid_contact_dot"}, "iisph": {"rigid_contact_dot"},
        "pcisph": {"pcisph_predict_rho"}, "wcsph": set()}[solver]
    assert len(made) == 1
    assert [name for name, _ in got[:2]] == ["make_body_box", "rigid_terms"]
    assert {name for name, _ in got[1:]} == want
    assert all(box is made[0] for _, box in got), got
