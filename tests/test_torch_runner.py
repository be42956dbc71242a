"""The port's `run` and `Simulation` parameters held against the JAX
runner's (cfd_taichi_tpu/runner.py:36, 149-153, 180, 237) on the TINY
scene, on the CPU: `max_sim_time` ends a run at the JAX run's frame,
`profile_dir` leaves a Chrome trace, `check_nan` raises after a frame that
holds a NaN. Frame export: tests/test_torch_export.py.
"""

import copy
import inspect
import json

import pytest
import torch

from cfd_taichi_tpu import runner as jrunner
from cfd_taichi_tpu.config import parse_config as jparse_config
from cfd_taichi_tpu_torch import Simulation, runner
from cfd_taichi_tpu_torch.config import parse_config

TINY = {
    "scene": {"box_min": [0.0, 0.0, 0.0], "box_max": [0.6, 0.8, 0.6],
              "particle_radius": 0.025, "gravity": 9.8},
    "solver": {"name": "dfsph", "delta_time": 4e-4, "iter_cnt": 1},
    "fluid": {"start_pos": [0.15, 0.1, 0.15], "water_size": [0.3, 0.3, 0.3]},
}


def _cfg(**scene):
    raw = copy.deepcopy(TINY)
    raw["scene"].update(scene)
    return parse_config(raw)


def test_run_without_export_flags_runs(tmp_path, capsys):
    sim = runner.run(_cfg(), frames=2, device="cpu",
                     output_dir=str(tmp_path))
    assert sim.timer.steps == 2 and not sim.check_nan
    tele = json.loads(
        capsys.readouterr().out.split("Final telemetry:")[1].splitlines()[0])
    assert tele["nan_particles"] == 0 and tele["steps"] == 2


def test_parameters_carry_the_jax_names_and_defaults():
    for fn, jfn, names in (
            (runner.run, jrunner.run, ("max_sim_time", "profile_dir",
                                       "color_by")),
            (Simulation.__init__, jrunner.Simulation.__init__,
             ("check_nan",))):
        got, want = (inspect.signature(f).parameters for f in (fn, jfn))
        for name in names:
            assert got[name].default == want[name].default
    assert runner.MAX_SIM_TIME == jrunner.MAX_SIM_TIME == 4.0


def test_max_sim_time_stops_at_the_jax_frame(tmp_path):
    """dt is 1e-3 on TINY's first steps: t passes 2.5e-3 in frame 3."""
    limit = 2.5e-3
    jsim = jrunner.run(jparse_config(copy.deepcopy(TINY)), frames=8,
                       output_dir=str(tmp_path / "jax"), quiet=True,
                       max_sim_time=limit)
    sim = runner.run(_cfg(), frames=8, output_dir=str(tmp_path / "port"),
                     quiet=True, max_sim_time=limit, device="cpu")
    assert sim.timer.steps == jsim.timer.steps == 3
    assert sim.t > limit
    assert sim.t == pytest.approx(jsim.t, rel=1e-5)


def test_profile_dir_leaves_a_trace(tmp_path):
    prof = tmp_path / "prof"
    runner.run(_cfg(), frames=1, output_dir=str(tmp_path), quiet=True,
               profile_dir=str(prof), device="cpu")
    trace = prof / "trace.json"
    assert trace.stat().st_size > 0
    assert json.loads(trace.read_text())["traceEvents"]


def test_profile_dir_reaches_the_cli(tmp_path):
    cfg = tmp_path / "tiny.json"
    cfg.write_text(json.dumps(TINY))
    runner.main(["--config", str(cfg), "--frames", "1", "--device", "cpu",
                 "--quiet", "--output-dir", str(tmp_path),
                 "--profile-dir", str(tmp_path / "prof")])
    assert (tmp_path / "prof" / "trace.json").stat().st_size > 0


def test_check_nan_raises_after_a_frame():
    sim = Simulation(_cfg(), check_nan=True, device="cpu")
    sim.frame()
    pos = sim.state.fluid.pos.clone()
    pos[5, 1] = float("nan")
    sim.state = sim.state._replace(
        fluid=sim.state.fluid._replace(pos=pos))
    with pytest.raises(FloatingPointError, match="NaN/Inf"):
        sim.frame()

    quiet = Simulation(_cfg(), device="cpu")
    quiet.state = sim.state
    quiet.frame()       # check_nan=False: no check, as in the JAX runner
    assert not torch.isfinite(quiet.state.fluid.pos).all()
