"""JSON config loading (counterpart of ``robir_tpu/core/config.py``, which
imports the JAX modules).

Reads the same ``configs/*.json`` files: JSON with ``//`` line comments.
``_build`` fills a frozen dataclass from a dict, keeping defaults for
missing keys and rejecting unknown ones. Covered sections: stage 1's
``model`` (``type`` "neus", "hash" or "vnerf", dispatched by
``stage1_dispatch`` as the JAX ``build_stage1_configs``), ``render``
(``type`` "neus" or "mip"), ``train`` and ``dataset``; stage 2's ``model``
(``neus``, ``envmap_material_network``, ``indirect_illum_network``,
``visibility_network``, ``tonemap``, ``grid``, ``coord_scale``,
``sweep_light_chunk`` and the tracer keys), ``texture_resolution``, and
the ``norm``, ``vis``, ``pbr`` and ``cesr`` stage sections; stage 1's
``mesh`` section (``build_mesh_config``). ``apply_overrides`` applies the
command line's dotted ``--set`` overrides; ``config_to_dict`` turns a
dataclass tree back into plain dicts.
"""

from __future__ import annotations

import dataclasses
import json
import re
from typing import Any

from ..data.blender import BlenderConfig
from ..fields.envmap_material import EnvmapMaterialConfig
from ..fields.hashgrid import HashGridConfig, HashSDFConfig
from ..fields.neus_model import HashNeuSConfig, NeuSConfig, VarianceConfig
from ..fields.radiance import NeRFBgConfig, RenderingConfig
from ..fields.vnerf import VNeRFConfig
from ..fields.sdf import SDFConfig
from ..fields.visibility import IndirIllumConfig, VisNetConfig
from ..render.color import ToneMapConfig
from ..render.mip import MipRenderConfig
from ..render.neus import NeusRenderConfig
from ..render.stage2 import Stage2Config
from ..stages.losses import IllumLossConfig, InvLossConfig
from ..stages.neus_stage import NeusTrainConfig
from ..stages.stage2_runner import StageOptConfig
from ..stages.vis import VisStageConfig
from ..texture.mesh import MeshConfig
from ..tracing.grid import GridConfig
from ..tracing.sphere import SphereTracerConfig


def load_config(path: str) -> dict:
    """JSON with // line comments."""
    with open(path) as f:
        text = f.read()
    text = re.sub(r"^\s*//.*$", "", text, flags=re.M)
    return json.loads(text)


def apply_overrides(cfg: dict, overrides: list[str]) -> dict:
    """Apply 'a.b.c=value' overrides in place (each value parsed as JSON,
    else kept as the string); returns ``cfg``."""
    for ov in overrides:
        path, _, raw = ov.partition("=")
        try:
            value = json.loads(raw)
        except json.JSONDecodeError:
            value = raw
        node = cfg
        keys = path.strip().split(".")
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = value
    return cfg


def config_to_dict(obj: Any) -> Any:
    """Dataclass tree -> plain dicts and lists (a run directory's snapshot
    of its configs)."""
    if dataclasses.is_dataclass(obj):
        return {f.name: config_to_dict(getattr(obj, f.name)) for f in dataclasses.fields(obj)}
    if isinstance(obj, (list, tuple)):
        return [config_to_dict(x) for x in obj]
    return obj


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
        raise KeyError("build_neus_config builds model.type 'neus' only")
    unknown = set(d) - {"sdf", "color", "variance", "background", "radius"}
    if unknown:
        raise KeyError(f"unknown model keys: {sorted(unknown)}")
    bg = d.get("background")
    return NeuSConfig(sdf=_build(SDFConfig, d.get("sdf")),
                      color=_build(RenderingConfig, d.get("color")),
                      variance=_build(VarianceConfig, d.get("variance")),
                      background=_build(NeRFBgConfig, bg) if bg is not None else None,
                      radius=d.get("radius", 2.0))


def build_neus_render_config(d: dict | None) -> NeusRenderConfig:
    """The NeuS renderer's section (``render``) as a ``NeusRenderConfig``."""
    return _build(NeusRenderConfig, d)


def stage1_dispatch(cfg: dict):
    """(model_type, render_type, model_cfg, render_cfg) of a stage-1 config
    dict, as the JAX ``build_stage1_configs``: ``model.type`` "neus" (its
    fields at ``model`` or, in a stage-2 config, at ``model.neus``),
    "hash" (``hash_sdf`` with its nested ``grid``) or "vnerf";
    ``render.type`` "neus", or "mip" (the default for "vnerf")."""
    model_d = dict(cfg.get("model", {}))
    render_d = dict(cfg.get("render", {}))
    model_type = model_d.pop("type", "neus")
    render_type = render_d.pop("type", "mip" if model_type == "vnerf" else "neus")
    if model_type == "neus":
        model_cfg = build_neus_config(model_d["neus"] if "neus" in model_d
                                      and "sdf" not in model_d else model_d)
    elif model_type == "hash":
        hs = dict(model_d.get("hash_sdf", {}))
        grid = hs.pop("grid", None)
        model_cfg = HashNeuSConfig(
            hash_sdf=_build(HashSDFConfig, hs, **({"grid": _build(HashGridConfig, grid)}
                                                  if grid is not None else {})),
            color=_build(RenderingConfig, model_d.get("color")),
            variance=_build(VarianceConfig, model_d.get("variance")),
            radius=model_d.get("radius", 2.0))
    elif model_type == "vnerf":
        model_cfg = _build(VNeRFConfig, model_d)
    else:
        raise KeyError(f"unknown stage-1 model.type {model_type!r}")
    if render_type == "neus":
        render_cfg = build_neus_render_config(render_d)
    elif render_type == "mip":
        render_cfg = _build(MipRenderConfig, render_d)
    else:
        raise KeyError(f"unknown stage-1 render.type {render_type!r}")
    return model_type, render_type, model_cfg, render_cfg


def build_mesh_config(cfg: dict) -> MeshConfig:
    """The mesh export's grid of a stage-1 config dict (its ``mesh``
    section; ``robir_tpu/cli.py:cmd_mesh``'s defaults where it is absent)."""
    return _build(MeshConfig, cfg.get("mesh"))


def texture_resolution(cfg: dict) -> int:
    """The texture maps' side of a stage-2 config dict (default 2048, as
    ``robir_tpu/cli.py:cmd_norm``)."""
    return int(cfg.get("texture_resolution", 2048))


def build_stage1_configs(cfg: dict):
    """(model, render, train, dataset) configs of a stage-1 config dict; the
    model and render configs of ``stage1_dispatch``."""
    _, _, model_cfg, render_cfg = stage1_dispatch(cfg)
    return (model_cfg, render_cfg, _build(NeusTrainConfig, cfg.get("train")),
            _build(BlenderConfig, cfg.get("dataset")))


_STAGE2_KEYS = {"neus", "envmap_material_network", "indirect_illum_network",
                "visibility_network", "tonemap", "grid", "coord_scale", "bgr",
                "vis_compute_dtype", "sweep_light_chunk", "use_neus", "tracer",
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
        sweep_light_chunk=d.get("sweep_light_chunk", 0),
        use_neus=d.get("use_neus", True),
        tracer=d.get("tracer", "grid"),
        sphere_tracer=_build(SphereTracerConfig, d.get("sphere_tracer")))


def build_stage_config(dc_type, d: dict | None, **overrides):
    """A stage config (``NormStageConfig``, ``VisStageConfig``,
    ``PBRStageConfig``, ``CESRStageConfig``) from its section, with the
    nested ``opt`` and ``loss`` sections built from plain dicts (the Vis stage's loss is an
    ``IllumLossConfig``). Unknown keys raise KeyError."""
    d = {**(d or {}), **overrides}
    if isinstance(d.get("opt"), dict):
        d["opt"] = _build(StageOptConfig, d["opt"])
    if isinstance(d.get("loss"), dict):
        loss_type = IllumLossConfig if dc_type is VisStageConfig else InvLossConfig
        d["loss"] = _build(loss_type, d["loss"])
    return _build(dc_type, d)
