"""The port stands alone: importing every module of pyrecover_tpu_torch, and
chip_smoke.py, loads neither JAX nor the JAX package."""

import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent

PROBE = """
import importlib, pkgutil, sys
import pyrecover_tpu_torch
names = [m.name for m in pkgutil.walk_packages(pyrecover_tpu_torch.__path__, "pyrecover_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
loaded = sorted(k for k in sys.modules if k.split(".")[0] in ("jax", "jaxlib", "pyrecover_tpu"))
print(len(names))
print(",".join(loaded))
"""


def test_port_and_chip_smoke_import_no_jax():
    proc = subprocess.run(
        [sys.executable, "-c", PROBE], cwd=REPO, capture_output=True, text=True,
        timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    n_modules, loaded = proc.stdout.splitlines()[-2:]
    assert int(n_modules) >= 40  # every module of the package, serving included, was imported
    assert loaded == "", f"imported: {loaded}"
