"""JSON config loading for the port's stage-1 sections (counterpart of
``robir_tpu/core/config.py``, which imports the JAX modules).

Reads the same ``configs/*.json`` files: JSON with ``//`` line comments.
``_build`` fills a frozen dataclass from a dict, keeping defaults for
missing keys and rejecting unknown ones. Covered sections: ``model``,
``render``, ``train`` and ``dataset``; other sections (``mesh``, stage 2)
are not read.
"""

from __future__ import annotations

import dataclasses
import json
import re

from ..data.blender import BlenderConfig
from ..fields.neus_model import NeuSConfig, VarianceConfig
from ..fields.radiance import RenderingConfig
from ..fields.sdf import SDFConfig
from ..render.neus import NeusRenderConfig
from ..stages.neus_stage import NeusTrainConfig


def load_config(path: str) -> dict:
    """JSON with // line comments."""
    with open(path) as f:
        text = f.read()
    text = re.sub(r"^\s*//.*$", "", text, flags=re.M)
    return json.loads(text)


def _build(dc_type, d: dict | None, **extra):
    """Construct a dataclass from a dict, tolerating missing keys (defaults
    apply) and rejecting unknown ones."""
    d = dict(d or {})
    d.update(extra)
    names = {f.name for f in dataclasses.fields(dc_type)}
    unknown = set(d) - names
    if unknown:
        raise KeyError(f"unknown {dc_type.__name__} keys: {sorted(unknown)}")
    kwargs = {k: tuple(v) if isinstance(v, list) else v for k, v in d.items()}
    return dc_type(**kwargs)


def build_neus_config(d: dict) -> NeuSConfig:
    d = dict(d)
    if d.pop("type", "neus") != "neus":
        raise KeyError("the port's stage 1 supports model.type 'neus' only")
    unknown = set(d) - {"sdf", "color", "variance", "background", "radius"}
    if unknown:
        raise KeyError(f"unknown model keys: {sorted(unknown)}")
    return NeuSConfig(sdf=_build(SDFConfig, d.get("sdf")),
                      color=_build(RenderingConfig, d.get("color")),
                      variance=_build(VarianceConfig, d.get("variance")),
                      background=d.get("background"),
                      radius=d.get("radius", 2.0))


def build_neus_render_config(d: dict) -> NeusRenderConfig:
    d = dict(d)
    if d.pop("type", "neus") != "neus":
        raise KeyError("the port's stage 1 supports render.type 'neus' only")
    return _build(NeusRenderConfig, d)


def build_stage1_configs(cfg: dict):
    """(model, render, train, dataset) configs of a stage-1 config dict."""
    return (build_neus_config(cfg.get("model", {})),
            build_neus_render_config(cfg.get("render", {})),
            _build(NeusTrainConfig, cfg.get("train")),
            _build(BlenderConfig, cfg.get("dataset")))
