"""cfd_taichi_tpu_torch: the PyTorch + CUDA port of cfd_taichi_tpu.

SPH fluid simulation for NVIDIA Hopper GPUs. The JAX package
`cfd_taichi_tpu` beside it is the reference the port is tested against;
this package imports neither it nor JAX.

Ported so far: the single-device steps of the five pressure solvers
(DFSPH, WCSPH, IISPH, PCISPH, PBF) on scenes with Akinci boundary
particles or the clamp boundary, a rigid body coupled both ways to
DFSPH, PCISPH, IISPH and WCSPH, and the runner with its frame export.
Their pair passes are hand-written CUDA kernels (csrc/, bound in
ops/stencil.py and ops/rigid.py) over cell-sorted CSR tables, with plain
PyTorch versions for CPU tensors; their pressure loops run on the device
as replayed CUDA graph trips (ops/loops.py). Fluid-only scenes also step
sharded over torch.distributed, one process a slab (parallel/).
"""

__version__ = "0.1.0"

from cfd_taichi_tpu_torch.config import SimConfig, read_config  # noqa: F401
from cfd_taichi_tpu_torch.runner import Simulation  # noqa: F401
from cfd_taichi_tpu_torch.scene import Scene, build_scene  # noqa: F401
