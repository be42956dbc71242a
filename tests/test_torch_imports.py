"""The port stands alone: cfd_taichi_tpu_torch and chip_smoke.py import
neither JAX nor the JAX package, and chip_smoke.py refuses to report a
result without a CUDA card or without the rest of the repo."""

import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "cfd_taichi_tpu_torch"

_IMPORT_ALL = """
import pkgutil, sys
sys.modules["jax"] = None        # any `import jax` now raises ImportError
import cfd_taichi_tpu_torch
for mod in pkgutil.walk_packages(cfd_taichi_tpu_torch.__path__,
                                 "cfd_taichi_tpu_torch."):
    __import__(mod.name)
leaked = sorted(m for m in sys.modules
                if m == "cfd_taichi_tpu" or m.startswith("cfd_taichi_tpu."))
assert not leaked, leaked
for name in ("domain", "multihost", "launch"):
    assert f"cfd_taichi_tpu_torch.parallel.{name}" in sys.modules, name
print("imported", len([m for m in sys.modules
                       if m.startswith("cfd_taichi_tpu_torch")]))
"""


def test_port_imports_without_jax():
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("imported ")


def test_no_jax_import_statements():
    pattern = re.compile(r"^\s*(import|from) (jax|cfd_taichi_tpu)\b")
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    hits = [f"{f.relative_to(ROOT)}:{i}"
            for f in files
            for i, line in enumerate(f.read_text().splitlines(), 1)
            if pattern.match(line)]
    assert not hits


def _run_smoke(cwd):
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          capture_output=True, text=True, timeout=120,
                          env={"PATH": "/usr/bin:/bin",
                               "CUDA_VISIBLE_DEVICES": ""})


def test_chip_smoke_fails_without_a_card():
    out = _run_smoke(ROOT)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    out = _run_smoke(tmp_path)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
