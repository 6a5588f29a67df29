"""Finding a cell's parts by name.

A cell ``<config>.<mix>`` is ``configs/<config>.json``, ``traffic/<mix>.json``
and ``limits/<config>.<mix>.json`` (a limit for each number that decides
``correct``; a number without one is read and not compared); its stage
driver is
``stages/<traffic["stage"]>.py``. A per-layer metric ``<name>`` is
``metrics/<name>.py``, which sets ``UNIT``, ``LAYER``, ``SOURCE``,
``MOVES`` and ``read(ctx)`` (a number, or None where it finds nothing to
read). A layer's kernels are the non-empty lines, less ``#`` comments, of
every file under ``layers/<layer>/``. Adding any of these is adding a
file.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
from types import ModuleType

ROOT = os.path.dirname(os.path.abspath(__file__))


def load_cell(name: str, root: str = ROOT) -> dict:
    """``{"name", "config", "traffic", "limits", "stage"}`` of cell ``name``."""
    config, _, mix = name.partition(".")
    if not config or not mix:
        raise KeyError(f"a cell is <config>.<mix>, not {name!r}")
    paths = {"config": ("configs", f"{config}.json"), "traffic": ("traffic", f"{mix}.json"),
             "limits": ("limits", f"{name}.json")}
    out = {"name": name}
    for key, parts in paths.items():
        path = os.path.join(root, *parts)
        if not os.path.isfile(path):
            raise KeyError(f"cell {name!r}: no {os.path.join(*parts)}")
        with open(path) as fp:
            out[key] = json.load(fp)
    out["stage"] = out["traffic"]["stage"]
    return out


def stage_module(stage: str) -> ModuleType:
    if not os.path.isfile(os.path.join(ROOT, "stages", f"{stage}.py")):
        raise KeyError(f"no stage driver stages/{stage}.py")
    return importlib.import_module(f"{__package__}.stages.{stage}")


def metric_names(root: str = ROOT) -> list[str]:
    return sorted(f[:-3] for f in os.listdir(os.path.join(root, "metrics"))
                  if f.endswith(".py") and not f.startswith("_"))


def metric_module(name: str, root: str = ROOT) -> ModuleType:
    path = os.path.join(root, "metrics", f"{name}.py")
    if not os.path.isfile(path):
        raise KeyError(f"no metric metrics/{name}.py")
    spec = importlib.util.spec_from_file_location(f"port_bench_metric_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    for key in ("UNIT", "LAYER", "SOURCE", "MOVES", "read"):
        if not hasattr(module, key):
            raise AttributeError(f"metrics/{name}.py has no {key}")
    return module


def layer_kernels(layer: str, root: str = ROOT) -> list[str]:
    """The kernel-name patterns of ``layers/<layer>/*``."""
    folder = os.path.join(root, "layers", layer)
    if not os.path.isdir(folder):
        raise KeyError(f"no layer folder layers/{layer}")
    out = []
    for f in sorted(os.listdir(folder)):
        with open(os.path.join(folder, f)) as fp:
            out += [ln.split("#")[0].strip() for ln in fp]
    return [p for p in out if p]
