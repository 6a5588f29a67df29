"""The port stands alone: importing it, every module under it, or
``chip_smoke.py`` leaves JAX and the JAX package out of ``sys.modules``,
and ``chip_smoke.py`` refuses to run without a CUDA device."""

import os
import subprocess
import sys

import pytest
import torch

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_IMPORT_ALL = """
import importlib, pkgutil, sys
import robir_tpu_torch
names = [m.name for m in pkgutil.walk_packages(robir_tpu_torch.__path__, "robir_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = sorted(k for k in sys.modules if k.split(".")[0] in ("jax", "jaxlib", "robir_tpu"))
assert not bad, bad
print(len(names))
"""


def _run(args, **kw):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, *args], cwd=REPO_ROOT, env=env,
                          capture_output=True, text=True, timeout=120, **kw)


def test_port_imports_neither_jax_nor_the_jax_package():
    proc = _run(["-c", _IMPORT_ALL])
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split()[-1]) >= 20  # every module was imported


def test_chip_smoke_fails_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: chip_smoke.py would run in full")
    proc = _run(["chip_smoke.py"])
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
