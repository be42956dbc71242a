"""Solver registry (`cfd_taichi_tpu/models/__init__.py`): config
`solver.name` -> solver module with `init_state(scene)` and
`step(scene, state)`."""

import importlib

_PORTED = {name: f"cfd_taichi_tpu_torch.models.{name}"
           for name in ("dfsph", "wcsph", "iisph", "pcisph", "pbf")}


def get_solver(name: str):
    if name in _PORTED:
        return importlib.import_module(_PORTED[name])
    raise ValueError(f"Unknown solver '{name}'; available: "
                     f"{sorted(_PORTED)}")
