"""The port stands alone: importing it, every module under it, or
``chip_smoke.py`` leaves JAX and the JAX package out of ``sys.modules``; no
module of it imports cv2; and ``chip_smoke.py`` refuses to run without a
CUDA device."""

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
print(" ".join(names))
"""


def _run(args, **kw):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, *args], cwd=REPO_ROOT, env=env,
                          capture_output=True, text=True, timeout=120, **kw)


def test_port_imports_neither_jax_nor_the_jax_package():
    proc = _run(["-c", _IMPORT_ALL])
    assert proc.returncode == 0, proc.stderr
    names = set(proc.stdout.split())
    assert len(names) >= 20  # every module was imported
    assert {"robir_tpu_torch.core.checkpoint", "robir_tpu_torch.stages.vis",
            "robir_tpu_torch.stages.pbr", "robir_tpu_torch.texture.mesh",
            "robir_tpu_torch.texture.focus_sampler", "robir_tpu_torch.stages.norm",
            "robir_tpu_torch.cli", "robir_tpu_torch.tools.logger",
            "robir_tpu_torch.tools.relight", "robir_tpu_torch.tools.tex_extract",
            "robir_tpu_torch.tools.shadow_pipeline", "robir_tpu_torch.stages.sg_fit",
            "robir_tpu_torch.core.import_ref", "robir_tpu_torch.utils.resize",
            "robir_tpu_torch.data.llff", "robir_tpu_torch.data.multicam",
            "robir_tpu_torch.fields.vnerf", "robir_tpu_torch.fields.hashgrid",
            "robir_tpu_torch.render.mip", "robir_tpu_torch.tools.profiler",
            "robir_tpu_torch.tools.vis_workload"} <= names


def test_port_imports_no_cv2():
    """The card's machine has no cv2: no module of the port imports it, where
    it is imported at all (at the top or inside a function)."""
    import re
    found = []
    for dirpath, _, files in os.walk(os.path.join(REPO_ROOT, "robir_tpu_torch")):
        for f in files:
            if f.endswith(".py"):
                with open(os.path.join(dirpath, f)) as fp:
                    if re.search(r"^\s*(import|from)\s+cv2\b", fp.read(), re.M):
                        found.append(f)
    assert not found, found


def _imported_modules(path: str, package: str) -> list[str]:
    """Absolute names of the modules a file imports, at the top or inside
    a function, relative imports resolved against its ``package``."""
    import ast
    with open(path) as fp:
        tree = ast.parse(fp.read(), path)
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            base = package.split(".")
            base = base[:len(base) - node.level + 1] if node.level else []
            mod = ".".join(base + ([node.module] if node.module else []))
            names += [mod] if node.module else [f"{mod}.{a.name}" for a in node.names]
    return names


def test_kernel_layer_imports_nothing_above_it():
    """No module under ``render/cuda`` imports the fields, the stages or the
    rest of ``render``: the layers above call the kernel layer, never the
    other way round."""
    cuda_dir = os.path.join(REPO_ROOT, "robir_tpu_torch", "render", "cuda")
    above = ("robir_tpu_torch.fields", "robir_tpu_torch.stages", "robir_tpu_torch.render")
    found = []
    for f in sorted(os.listdir(cuda_dir)):
        if f.endswith(".py"):
            for name in _imported_modules(os.path.join(cuda_dir, f),
                                          "robir_tpu_torch.render.cuda"):
                if (name.startswith(above) and name != "robir_tpu_torch.render.cuda"
                        and not name.startswith("robir_tpu_torch.render.cuda.")):
                    found.append(f"{f}: {name}")
    assert found == []


def test_chip_smoke_fails_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: chip_smoke.py would run in full")
    proc = _run(["chip_smoke.py"])
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
