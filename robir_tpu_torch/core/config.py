"""JSON config loading (counterpart of ``robir_tpu/core/config.py``, which
imports the JAX modules).

Reads the same ``configs/*.json`` files: JSON with ``//`` line comments.
``_build`` fills a frozen dataclass from a dict, keeping defaults for
missing keys and rejecting unknown ones. Covered sections: stage 1's
``model``, ``render``, ``train`` and ``dataset``; stage 2's ``model``
(``neus``, ``envmap_material_network``, ``indirect_illum_network``,
``visibility_network``, ``tonemap``, ``grid``, ``coord_scale`` and the
tracer keys) and the ``cesr`` stage section. Other sections (``mesh``,
``norm``, ``vis``, ``pbr``) are not read.
"""

from __future__ import annotations

import dataclasses
import json
import re

from ..data.blender import BlenderConfig
from ..fields.envmap_material import EnvmapMaterialConfig
from ..fields.neus_model import NeuSConfig, VarianceConfig
from ..fields.radiance import RenderingConfig
from ..fields.sdf import SDFConfig
from ..fields.visibility import IndirIllumConfig, VisNetConfig
from ..render.color import ToneMapConfig
from ..render.neus import NeusRenderConfig
from ..render.stage2 import GridConfig, Stage2Config
from ..stages.losses import InvLossConfig
from ..stages.neus_stage import NeusTrainConfig
from ..stages.stage2_runner import StageOptConfig
from ..tracing.sphere import SphereTracerConfig


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


_STAGE2_KEYS = {"neus", "envmap_material_network", "indirect_illum_network",
                "visibility_network", "tonemap", "grid", "coord_scale", "bgr",
                "vis_compute_dtype", "use_neus", "tracer",
                "sphere_tracer"}


def build_stage2_config(d: dict, **overrides) -> Stage2Config:
    """Stage2Config of a stage-2 ``model`` section; ``overrides`` (e.g.
    ``tracer="sphere"``) replace top-level keys."""
    d = {**d, **overrides}
    unknown = set(d) - _STAGE2_KEYS
    if unknown:
        raise KeyError(f"unknown stage-2 model keys: {sorted(unknown)}")
    return Stage2Config(
        neus=build_neus_config(d.get("neus", {})),
        envmap=_build(EnvmapMaterialConfig, d.get("envmap_material_network")),
        indirect=_build(IndirIllumConfig, d.get("indirect_illum_network")),
        visnet=_build(VisNetConfig, d.get("visibility_network")),
        tonemap=_build(ToneMapConfig, d.get("tonemap")),
        grid=_build(GridConfig, d.get("grid")),
        coord_scale=d.get("coord_scale", 2.0),
        bgr=d.get("bgr", False),
        vis_compute_dtype=d.get("vis_compute_dtype"),
        use_neus=d.get("use_neus", True),
        tracer=d.get("tracer", "grid"),
        sphere_tracer=_build(SphereTracerConfig, d.get("sphere_tracer")))


def build_stage_config(dc_type, d: dict | None, **overrides):
    """A stage config (e.g. ``CESRStageConfig``) from its section, with the
    nested ``opt`` and ``loss`` sections built from plain dicts."""
    d = {**(d or {}), **overrides}
    if isinstance(d.get("opt"), dict):
        d["opt"] = _build(StageOptConfig, d["opt"])
    if isinstance(d.get("loss"), dict):
        d["loss"] = _build(InvLossConfig, d["loss"])
    return _build(dc_type, d)
