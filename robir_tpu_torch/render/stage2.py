"""Stage-2 composite model (counterpart of ``robir_tpu/render/stage2.py``,
the reference's IDRNetwork): the frozen stage-1 NeuS bridge, the SG
envmap/material heads, the indirect-illumination and visibility nets, the
tone-mapping learnables and the primary-ray tracer, with the dense
``stage2_forward``.

The bridge queries the NeuS SDF at coordinate scale 2 and halves its
output (``neus_model.py:785-791``): ``sdf`` and ``sdf_full`` through K1,
``sdf_gradient`` through K3 with no graph (the 2 in and the / 2 out cancel
in the gradient).

Ported for ``tracer="sphere"`` (live sphere tracing of the frozen NeuS,
each query a K1 launch). Not ported yet: the cached-SDF grid tracer (the
JAX default, ``tracer="grid"``), surface-pixel compaction
(``compact_chunk``), the Illum stage's forward, ``trace_radiance``,
``borrow_color``, ``neus_bridge_render`` and the plain-IDR mode
(``use_neus=False``).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from .. import resolve_device
from ..core.draws import Draws
from ..core.params import ParamTree, from_jax
from ..fields.envmap_material import (EnvmapMaterialConfig, MaterialOutput,
                                      envmap_material_apply)
from ..fields.mlp import Params
from ..fields.neus_model import NeuSConfig
from ..fields.sdf import frozen_sdf, sdf_apply, sdf_full_and_gradient
from ..fields.visibility import (IndirIllumConfig, VisNetConfig, indirect_apply,
                                 visnet_apply, visnet_outer_apply)
from ..tracing.sphere import SphereTracerConfig, sphere_trace
from . import sg as sg_lib
from .color import ToneMapConfig

TINY = 1e-6


@dataclasses.dataclass(frozen=True)
class GridConfig:
    """The cached-SDF grid tracer's settings (``robir_tpu/tracing/grid.py``):
    parsed so that configs load, used by nothing yet."""
    resolution: int = 256
    bbox_min: tuple[float, float, float] = (-1.0, -1.0, -1.0)
    bbox_max: tuple[float, float, float] = (1.0, 1.0, 1.0)
    max_steps: int = 128
    relax: float = 0.9
    hit_eps_cells: float = 0.25
    start_offset: float = 5e-3
    compact_after: int = 2
    compact_chunk: int = 4096
    blocked_gather: bool = False
    over_relax: float = 0.0
    storage_dtype: str | None = None
    quad_rows: bool = False


@dataclasses.dataclass(frozen=True)
class Stage2Config:
    neus: NeuSConfig = NeuSConfig()
    envmap: EnvmapMaterialConfig = EnvmapMaterialConfig()
    indirect: IndirIllumConfig = IndirIllumConfig()
    visnet: VisNetConfig = VisNetConfig(points_multires=10, dirs_multires=10,
                                        dims=(256, 256, 256, 256))
    tonemap: ToneMapConfig = ToneMapConfig()
    grid: GridConfig = GridConfig()
    coord_scale: float = 2.0
    bgr: bool = False
    vis_compute_dtype: str | None = None
    use_neus: bool = True
    tracer: str = "grid"
    sphere_tracer: SphereTracerConfig = SphereTracerConfig()

    def __post_init__(self):
        if not self.use_neus:
            raise NotImplementedError("use_neus=False (the plain IDR pair) is not ported yet")
        if self.bgr:
            raise NotImplementedError("bgr=True (BGR-ordered images) is not ported yet")
        if self.vis_compute_dtype is not None:
            raise NotImplementedError("vis_compute_dtype is not ported "
                                      "(visibility_network.storage_dtype is)")
        if self.tracer not in ("grid", "sphere"):
            raise KeyError(f"unknown tracer {self.tracer!r} (expected 'grid' or 'sphere')")


class Stage2Model:
    """Binder of (params, cfg) on a device: ``params`` is the stage-2 tree
    with the reference's module names: implicit_network (the frozen NeuS),
    envmap_material_network, indirect_illum_network, visibility_network,
    gamma. A ``ParamTree`` already on ``device`` is used as it is (so
    gradients reach it); anything else is copied there by ``from_jax``.
    Runs on ``cuda`` unless ``device="cpu"`` is passed."""

    def __init__(self, params: Params, cfg: Stage2Config, device="cuda"):
        device = resolve_device(device)
        if not (isinstance(params, ParamTree) and all(
                p.device.type == device.type for p in params.parameters())):
            params = from_jax(params, device)
        self.params = params
        self.cfg = cfg

    def _sdf_params(self):
        return self.params["implicit_network"]["sdf_network"]

    def sdf_full(self, x: torch.Tensor) -> torch.Tensor:
        """[N, 3] stage-2 points -> [N, 1 + feat]."""
        return sdf_apply(self._sdf_params(), self.cfg.neus.sdf,
                         x * self.cfg.coord_scale) / 2.0

    def sdf(self, x: torch.Tensor) -> torch.Tensor:
        return sdf_apply(self._sdf_params(), self.cfg.neus.sdf,
                         x * self.cfg.coord_scale, out_cols=1) / 2.0

    def sdf_gradient(self, x: torch.Tensor) -> torch.Tensor:
        """d sdf / dx in stage-2 coordinates, by K3, without a graph."""
        with torch.no_grad():
            _, g = sdf_full_and_gradient(self._sdf_params(), self.cfg.neus.sdf,
                                         x * self.cfg.coord_scale)
        return g * (self.cfg.coord_scale / 2.0)

    def material(self, points, draws: Optional[Draws] = None, train_spec=False,
                 spec_var=None) -> MaterialOutput:
        """The material heads; ``draws`` gives their smoothness-pair noise
        (``spec_ae`` and ``normal_ae``), None turns it off."""
        env = self.cfg.envmap
        n = points.shape[0]
        return envmap_material_apply(
            self.params["envmap_material_network"], env, points,
            spec_noise=(draws.normal("spec_ae", env.spec_brdf_ae.noise_shape(n))
                        if draws else None),
            normal_noise=(draws.normal("normal_ae", env.normal_ae.noise_shape(n))
                          if draws else None),
            train_spec=train_spec, spec_var=spec_var)

    def indirect(self, points, hdr_shift, draws: Optional[Draws] = None):
        ind = self.cfg.indirect
        noise = (draws.normal("indirect_ae", ind.integral_ae.noise_shape(points.shape[0]))
                 if draws else None)
        return indirect_apply(self.params["indirect_illum_network"], ind, points,
                              hdr_shift, noise)

    def vis_logits(self, points, dirs):
        return visnet_apply(self.params["visibility_network"], self.cfg.visnet,
                            points, dirs)

    def vis_logits_outer(self, points, dirs):
        """[N, 3] x [K, 3] -> [N, K, 2], the diffuse sweep's shape."""
        return visnet_outer_apply(self.params["visibility_network"], self.cfg.visnet,
                                  points, dirs)

    def trace(self, origins, dirs):
        """Primary-ray cast -> (t [N], hit [N], x [N, 3]): ``sdf`` without a
        graph, its weights folded and packed once for all the queries."""
        if self.cfg.tracer != "sphere":
            raise NotImplementedError("the cached-SDF grid tracer is not ported yet: "
                                      "use Stage2Config(tracer='sphere')")
        query = frozen_sdf(self._sdf_params(), self.cfg.neus.sdf, out_cols=1)
        scale = self.cfg.coord_scale
        res = sphere_trace(lambda x: query(x * scale) / 2.0, origins, dirs,
                           self.cfg.sphere_tracer)
        return res.dists, res.mask, res.points


SGRenderFn = Callable[..., dict]


def default_sg_render(model: Stage2Model, draws: Draws, points, view_dirs,
                      indir_lgt_sgs, indir_integral=None, train_spec=False,
                      lin_diff=False, argmax_vis=False, **_) -> dict:
    """The PBR-style SG render (IDRNetwork.get_sg_render, :499-529):
    geometry normals of the frozen SDF, the material heads and full SG
    shading with MLP visibility."""
    view_dirs = view_dirs / (torch.linalg.norm(view_dirs, dim=-1, keepdim=True) + TINY)
    normals = model.sdf_gradient(points)  # unnormalised, as the reference
    mat = model.material(points, draws, train_spec=train_spec)
    sg_ret = sg_lib.render_with_all_sg(
        draws, points.detach(), normals, view_dirs, mat.lgt_sgs,
        mat.specular_reflectance, mat.roughness, mat.diffuse_albedo,
        indir_lgt_sgs=indir_lgt_sgs, indir_integral=indir_integral,
        vis_fn=model.vis_logits, vis_outer_fn=model.vis_logits_outer,
        lin_diff=lin_diff, argmax_vis=argmax_vis)
    return {
        "normals": normals, "sg_rgb": sg_ret.sg_rgb,
        "sg_specular_rgb": sg_ret.sg_specular_rgb,
        "sg_diffuse_rgb": sg_ret.sg_diffuse_rgb, "indir_rgb": sg_ret.indir_rgb,
        "indir_diffuse_rgb": sg_ret.indir_diffuse_rgb,
        "indir_specular_rgb": sg_ret.indir_specular_rgb,
        "vis_shadow": sg_ret.vis_shadow, "diffuse_albedo": mat.diffuse_albedo,
        "roughness": mat.roughness, "metallic": mat.metallic,
        "normal_map": mat.normal_map,
        "random_xi_roughness": mat.random_xi_roughness,
        "random_xi_metallic": mat.random_xi_metallic,
        "random_xi_diffuse_albedo": mat.random_xi_diffuse_albedo,
        "random_xi_normal": mat.random_xi_normal,
    }


_MASKED = ("sg_rgb", "indir_rgb", "sg_diffuse_rgb", "sg_specular_rgb",
           "indir_diffuse_rgb", "indir_specular_rgb", "normals", "diffuse_albedo",
           "roughness", "metallic", "normal_map", "vis_shadow", "random_xi_roughness",
           "random_xi_metallic", "random_xi_diffuse_albedo", "random_xi_normal")


def stage2_forward(model: Stage2Model, draws: Draws, inp: dict,
                   sg_render_fn: Optional[SGRenderFn] = None,
                   train_spec: bool = False, lin_diff: bool = False,
                   traced=None, **sg_kwargs) -> dict:
    """IDRNetwork.forward (:290-479), dense and masked, for the Material
    stages: trace (no grad), the indirect SGs at the hit points, then the
    SG render of every lane, with misses' per-row outputs set to 1.

    ``inp`` (all [N, ...]): 'points' (ray origins), 'dirs'; optional
    'object_mask' [N] bool and 'hdr_shift' [N, 1]. ``traced`` is the
    (t, hit) of ``model.trace`` on these rays made beforehand (so that two
    devices can shade one trace); None traces here. The surface sdf
    (``sdf_output`` in the JAX package) is not computed: nothing here
    reads it."""
    cam_loc = inp["points"].reshape(-1, 3)
    ray_dirs = inp["dirs"].reshape(-1, 3)
    n = cam_loc.shape[0]
    object_mask = inp.get("object_mask")
    if object_mask is None:
        object_mask = torch.ones((n,), dtype=torch.bool, device=cam_loc.device)

    dists, hit = model.trace(cam_loc, ray_dirs)[:2] if traced is None else traced
    network_object_mask = hit & object_mask
    dists = torch.where(network_object_mask, dists, 0.0)
    points = cam_loc + dists[:, None] * ray_dirs
    out = {"points": points,
           "network_object_mask": network_object_mask,
           "object_mask": object_mask, "ray_dirs": ray_dirs}

    surface_mask = network_object_mask
    indirect_sgs = torch.ones((n, model.cfg.indirect.num_lgt_sgs, 7),
                              device=points.device)
    indirect_sgs[:, :, -3:] = 0.0
    indirect_integral = torch.ones((n, 3), device=points.device)
    hdr_shift = inp.get("hdr_shift")
    if hdr_shift is not None:
        sgs, integral = model.indirect(points, hdr_shift, draws)
        indirect_sgs = torch.where(surface_mask[:, None, None], sgs, indirect_sgs)
        indirect_integral = torch.where(surface_mask[:, None], integral, indirect_integral)
        out["hdr_shift"] = hdr_shift

    render = sg_render_fn or default_sg_render
    ret = render(model, draws, points, -ray_dirs, indirect_sgs,
                 indir_integral=indirect_integral, train_spec=train_spec,
                 lin_diff=lin_diff, hdr_shift=hdr_shift, surface_mask=surface_mask,
                 **sg_kwargs)

    def masked(x):
        if x.dim() == 1:
            x = x[:, None]
        if x.shape[0] != n:
            x = x.expand(n, x.shape[-1])
        return torch.where(surface_mask[:, None], x, 1.0)

    zero = points.new_zeros(())
    out.update({k: masked(ret[k]) for k in _MASKED if k in ret})
    out.update({"gradient_error": ret.get("gradient_error", zero),
                "supervise": ret.get("supervise", zero),
                "surface_mask": surface_mask})
    for name in ret:  # any extra per-row outputs, unmasked
        out.setdefault(name, ret[name])
    return out
