"""Measurement scripts of the port, run on a machine with an NVIDIA card
from the root of a checkout:

    python -m cfd_taichi_tpu_torch.perf.kernel_table   # kernel table, rates
    python -m cfd_taichi_tpu_torch.perf.coef_compare   # a kernel's sources
    python -m cfd_taichi_tpu_torch.perf.loop_rates     # loop modes
    python -m cfd_taichi_tpu_torch.perf.shard_rates    # the sharded step

`inputs` makes the seeded inputs they share with chip_smoke.py and the
tests, `cases` the kernel calls and their measurement (time, `bounds`,
library yardstick) that they share with chip_smoke.py. Nothing here runs
at import time.
"""
