"""torch.sqrt's first call in fresh CPU processes, against the IEEE root
(numpy's): how often, and by how much, it parts from the exact root.

    python -m cfd_taichi_tpu_torch.perf.sqrt_first_call [--processes N]
        [--parallel P] [--out PATH]

Each process imports torch and takes, as its first square root, that of
a (216, 324) f32 tensor of squared distances in [1e-4, 1e-2) (the shape
of the plain pair passes' one chunk on TINY's block) on its default
intra-op threads; it reports the largest relative difference from
numpy's root and how many elements differ. On the CPU torch.sqrt runs
MKL's vector math: an ulp off on under 1 % of elements, and in some
processes whole threads' chunks far off. The port takes its roots through
`ops/smoothing.ieee_sqrt` instead. Prints one line per kind of outcome and
writes them as JSON (--out).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from collections import Counter
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

FIRST_CALL = """
import numpy as np, torch
x = torch.from_numpy(np.random.default_rng(1).uniform(
    1e-4, 1e-2, (216, 324)).astype(np.float32))
got = torch.sqrt(x)
ref = torch.from_numpy(np.sqrt(x.numpy()))
print(float(((got - ref).abs() / ref).max()), int((got != ref).sum()))
"""


def first_call() -> tuple[str, int]:
    """(largest relative difference rounded to 2 digits, elements off) of
    one fresh process."""
    out = subprocess.run([sys.executable, "-c", FIRST_CALL], check=True,
                         capture_output=True, text=True).stdout.split()
    return f"{float(out[0]):.1e}", int(out[1])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--processes", type=int, default=200)
    ap.add_argument("--parallel", type=int, default=6)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    with ThreadPoolExecutor(args.parallel) as pool:
        runs = list(pool.map(lambda _: first_call(), range(args.processes)))
    worst = Counter(rel for rel, _ in runs)
    for rel, count in sorted(worst.items()):
        off = sorted({n for r, n in runs if r == rel})
        print(f"[sqrt] {count} of {args.processes} processes: largest "
              f"relative difference {rel}, elements off {off}")
    if args.out:
        Path(args.out).write_text(json.dumps(
            {"processes": args.processes, "runs": runs}, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
