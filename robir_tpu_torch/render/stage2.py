"""Stage-2 composite model (counterpart of ``robir_tpu/render/stage2.py``,
the reference's IDRNetwork): the frozen stage-1 NeuS bridge, the SG
envmap/material heads, the indirect-illumination and visibility nets, the
tone-mapping learnables and the primary-ray tracer, with
``stage2_forward``.

The bridge queries the NeuS SDF at coordinate scale 2 and halves its
output (``neus_model.py:785-791``): ``sdf`` and ``sdf_full`` through K1,
``sdf_gradient`` through K3 with no graph (the 2 in and the / 2 out cancel
in the gradient).

Two tracers, as in the JAX package: ``tracer="grid"`` (the default)
marches the cached-SDF grid that the runner bakes from the frozen NeuS
(``tracing/grid.py``, the grid-march kernel on the card), and
``tracer="sphere"`` sphere-traces the live NeuS (each query a K1 launch).
``stage2_forward(compact_chunk=...)`` shades only the surface pixels
(``core/compact.py``). ``stage2_forward(trainstage="Illum")`` and
``trace_radiance`` are the Vis stage's forward: the indirect SGs and AE
normals at the primary hits, then a fan of secondary rays, traced (the
grid march on the card), whose hits borrow their colour from the frozen
NeuS (``borrow_color``: a 16-sample mini render through K3 and the colour
net, run only on the rays whose colour a loss reads).

IDR mode (``use_neus=False``, implicit_differentiable_renderer.py:268-282)
runs the plain IDR pair instead of the bridge: ``implicit_network`` is the
SDF tree itself and ``rendering_network`` a top-level colour net, queried
in stage-2 coordinates with no scale (``sdf`` K1, ``sdf_gradient`` K3);
``borrow_color`` evaluates the rendering network at the surface point
(one K3 call for the full output and the gradient). With ``bgr`` the
colour net's channels are reversed (``color``), as JAX's ``Stage2Model``
does: IDR mode's ``borrow_color`` goes through ``color`` and flips, the
NeuS bridge's mini render calls the stage-1 colour net directly and does
not (the reference's ``borrow_color``, neus_model.py:856-868).
``neus_bridge_render`` renders the frozen NeuS in stage-2 coordinates
through the stage-1 renderer (K1 in its sampling, K3 in ``render_core``).

Under data parallelism (``Stage2Model(mesh=)``, ``core/mesh.py``) each rank
holds its own pixels: the compaction gate is the rank's
(``effective_chunk`` of its rows), and a compacted render's per-row draws
are this rank's rows of the draw for every rank's surface rows in rank
order (one all-reduce of the counts), so that a row gets the draw it gets
in one process. Each rank traces the secondary fan of its own pixels: the
JAX package's ``shard_fan`` (the fan's own axis spread over the chips) is
what one process per rank does already.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import torch

from .. import resolve_device
from ..core.compact import compact_apply, compact_apply_padded, effective_chunk
from ..core.draws import Draws
from ..core.mesh import DataMesh, mesh_shards, row_split
from ..core.params import ParamTree, from_jax
from ..fields.envmap_material import (EnvmapMaterialConfig, MaterialOutput,
                                      envmap_material_apply)
from ..fields.mlp import Params
from ..fields.neus_model import NeuS, NeuSConfig, variance_apply
from ..fields.radiance import rendering_apply
from ..fields.sdf import frozen_sdf, sdf_apply, sdf_full_and_gradient
from ..fields.visibility import (IndirIllumConfig, VisNetConfig, indirect_apply,
                                 visnet_apply, visnet_outer_apply)
from ..tools.profiler import span
from ..tracing.grid import GridConfig, f32, grid_cast
from ..tracing.sphere import SphereTracerConfig, sphere_trace
from . import sg as sg_lib
from .color import ToneMapConfig, ldr2hdr
from .neus import NeusRenderConfig, Rays, render_neus

TINY = 1e-6


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
    # the diffuse visibility sweep in groups of this many lights (0: one
    # pass); the same values, a smaller peak of activations
    sweep_light_chunk: int = 0
    use_neus: bool = True
    tracer: str = "grid"
    sphere_tracer: SphereTracerConfig = SphereTracerConfig()

    def __post_init__(self):
        if self.vis_compute_dtype not in (None, "bfloat16"):
            raise ValueError(f"vis_compute_dtype {self.vis_compute_dtype!r} not in "
                             "(None, 'bfloat16')")
        if self.tracer not in ("grid", "sphere"):
            raise KeyError(f"unknown tracer {self.tracer!r} (expected 'grid' or 'sphere')")


class Stage2Model:
    """Binder of (params, cfg, grid) on a device: ``params`` is the stage-2
    tree with the reference's module names: implicit_network (the frozen
    NeuS; in IDR mode the SDF tree, beside a top-level rendering_network),
    envmap_material_network, indirect_illum_network, visibility_network,
    gamma. A ``ParamTree`` already on ``device`` is
    used as it is (so gradients reach it); anything else is copied there by
    ``from_jax``. ``grid_values`` is the baked [R, R, R] grid that
    ``tracer="grid"`` marches. Runs on ``cuda`` unless ``device="cpu"`` is
    passed. ``mesh``: the data-parallel ranks the batch is spread over
    (None: one process)."""

    def __init__(self, params: Params, cfg: Stage2Config, device="cuda",
                 grid_values: Optional[torch.Tensor] = None,
                 mesh: Optional[DataMesh] = None):
        device = resolve_device(device)
        if not (isinstance(params, ParamTree) and all(
                p.device.type == device.type for p in params.parameters())):
            params = from_jax(params, device)
        self.params = params
        self.cfg = cfg
        self.grid_values = grid_values
        self.mesh = mesh

    def _sdf_params(self):
        if not self.cfg.use_neus:
            return self.params["implicit_network"]
        return self.params["implicit_network"]["sdf_network"]

    def _query_scale(self) -> tuple[float, float]:
        """(coordinate scale into the SDF, divisor of its output): the NeuS
        bridge queries at ``coord_scale`` and halves (neus_model.py:785-791);
        the IDR pair queries stage-2 coordinates as they are."""
        return (self.cfg.coord_scale, 2.0) if self.cfg.use_neus else (1.0, 1.0)

    def sdf_full(self, x: torch.Tensor) -> torch.Tensor:
        """[N, 3] stage-2 points -> [N, 1 + feat]."""
        scale, div = self._query_scale()
        return sdf_apply(self._sdf_params(), self.cfg.neus.sdf, x * scale) / div

    def sdf(self, x: torch.Tensor) -> torch.Tensor:
        scale, div = self._query_scale()
        return sdf_apply(self._sdf_params(), self.cfg.neus.sdf, x * scale, out_cols=1) / div

    def sdf_gradient(self, x: torch.Tensor) -> torch.Tensor:
        """d sdf / dx in stage-2 coordinates, by K3, without a graph."""
        scale, div = self._query_scale()
        with torch.no_grad():
            _, g = sdf_full_and_gradient(self._sdf_params(), self.cfg.neus.sdf, x * scale)
        return g * (scale / div)

    def _color_params(self):
        if not self.cfg.use_neus:
            return self.params["rendering_network"]
        return self.params["implicit_network"]["color_network"]

    def color(self, points, normals, view_dirs, feature_vectors) -> torch.Tensor:
        """The colour net at stage-2 ``points``: the frozen NeuS's, or in IDR
        mode the rendering network; its channels reversed with ``bgr``."""
        c = rendering_apply(self._color_params(), self.cfg.neus.color,
                            points * self._query_scale()[0], normals, view_dirs,
                            feature_vectors)
        return torch.flip(c, (-1,)) if self.cfg.bgr else c

    def neus(self) -> NeuS:
        """The frozen stage-1 NeuS over this model's ``implicit_network``
        (its parameters, not a copy: a caller's graph reaches them)."""
        if not self.cfg.use_neus:
            raise ValueError("IDR mode (use_neus=false) has no stage-1 NeuS")
        return NeuS.over(self.params["implicit_network"], self.cfg.neus)

    def inv_s(self) -> torch.Tensor:
        """The frozen NeuS's inverse deviation, exp(10 v) clipped to
        [1e-6, 1e6]; IDR mode has no deviation network (ValueError)."""
        if not self.cfg.use_neus:
            raise ValueError("IDR mode (use_neus=false) has no deviation network")
        return torch.clamp(variance_apply(self.params["implicit_network"]["deviation_network"]),
                           1e-6, 1e6)

    def volume_render_color(self, sdf: torch.Tensor, color: torch.Tensor) -> torch.Tensor:
        """NeuS alpha compositing of precomputed samples (neus_model.py:828-854):
        sdf [B, S, 1], color [B, S, 3] -> [B, 3]."""
        inv_s = self.inv_s()
        next_sdf = torch.cat([sdf[:, 1:], sdf[:, -1:]], 1)
        prev_sdf = torch.cat([sdf[:, :-1], sdf[:, -1:]], 1)
        prev_cdf = torch.sigmoid(prev_sdf * inv_s)
        next_cdf = torch.sigmoid(next_sdf * inv_s)
        alpha = torch.clamp(((prev_cdf - next_cdf + 1e-5) / (prev_cdf + 1e-5))[..., 0], 0.0, 1.0)
        ones = torch.ones_like(alpha[:, :1])
        trans = torch.cumprod(torch.cat([ones, 1.0 - alpha + 1e-7], -1), -1)[:, :-1]
        return torch.sum(color * (alpha * trans)[:, :, None], dim=1)

    def borrow_color(self, points: torch.Tensor, view_dirs: torch.Tensor,
                     chunk: int = 0) -> torch.Tensor:
        """The frozen geometry's colour at stage-2 ``points`` [B, 3] seen
        along ``-view_dirs``. NeuS: a 16-sample mini render
        (neus_model.py:856-871) at t in linspace(-0.01, 0.05) along the
        negated view direction, in stage-1 coordinates, one K3 call for
        (sdf, feature, gradient) at the B x 16 samples and one colour-net
        call. IDR mode: the rendering network at the point itself, its
        normal and feature from one K3 call. With ``chunk`` > 0, one of
        each per slice of ``chunk`` points (the same result: nothing here
        couples two points). No bgr flip: the reference calls the stage-1
        model directly here. Differentiable through K4 if a caller asks;
        ``trace_radiance`` runs it without a graph."""
        if 0 < chunk < points.shape[0]:
            return torch.cat([self.borrow_color(points[i:i + chunk], view_dirs[i:i + chunk])
                              for i in range(0, points.shape[0], chunk)])
        vd = -view_dirs / torch.linalg.norm(view_dirs, dim=-1, keepdim=True)
        if not self.cfg.use_neus:
            full, grads = sdf_full_and_gradient(self._sdf_params(), self.cfg.neus.sdf, points)
            return self.color(points, grads, vd, full[..., 1:])
        n_samp = 16
        t = torch.linspace(-0.01, 0.05, n_samp, dtype=points.dtype,
                           device=points.device)[:, None]
        pts = points[:, None, :] * self.cfg.coord_scale + vd[:, None, :] * t
        flat = pts.reshape(-1, 3)
        full, grads = sdf_full_and_gradient(self._sdf_params(), self.cfg.neus.sdf, flat)
        color = rendering_apply(self._color_params(), self.cfg.neus.color, flat, grads,
                                vd[:, None, :].expand(pts.shape).reshape(-1, 3), full[..., 1:])
        b = points.shape[0]
        return self.volume_render_color(full[..., :1].reshape(b, n_samp, 1),
                                        color.reshape(b, n_samp, 3))

    def material(self, points, draws: Optional[Draws] = None, train_spec=False,
                 spec_var=None) -> MaterialOutput:
        """The material heads; ``draws`` gives their smoothness-pair noise
        (``spec_ae`` and ``normal_ae``), None turns it off."""
        env = self.cfg.envmap
        n = points.shape[0]
        return envmap_material_apply(
            self.params["envmap_material_network"], env, points,
            spec_noise=(draws.normal("spec_ae", env.spec_brdf_ae.noise_shape(n), rows=True)
                        if draws else None),
            normal_noise=(draws.normal("normal_ae", env.normal_ae.noise_shape(n), rows=True)
                          if draws else None),
            train_spec=train_spec, spec_var=spec_var)

    def indirect(self, points, hdr_shift, draws: Optional[Draws] = None):
        ind = self.cfg.indirect
        noise = (draws.normal("indirect_ae", ind.integral_ae.noise_shape(points.shape[0]),
                              rows=True)
                 if draws else None)
        return indirect_apply(self.params["indirect_illum_network"], ind, points,
                              hdr_shift, noise)

    def vis_logits(self, points, dirs):
        """The visibility net's fp32 logits, at ``vis_compute_dtype``."""
        return visnet_apply(self.params["visibility_network"], self.cfg.visnet,
                            points, dirs, compute_dtype=self.cfg.vis_compute_dtype)

    def vis_logits_outer(self, points, dirs):
        """[N, 3] x [K, 3] -> [N, K, 2], the diffuse sweep's shape."""
        return visnet_outer_apply(self.params["visibility_network"], self.cfg.visnet,
                                  points, dirs, compute_dtype=self.cfg.vis_compute_dtype)

    def frozen_sdf(self):
        """``sdf`` without a graph, the weights folded and packed once for
        all the queries (the sphere tracer's, the grid bake's)."""
        query = frozen_sdf(self._sdf_params(), self.cfg.neus.sdf, out_cols=1)
        scale, div = self._query_scale()
        return lambda x: query(x * scale) / div

    def trace(self, origins, dirs):
        """Primary-ray cast -> (t [N], hit [N], x [N, 3]), without a graph:
        the grid march of ``grid_values`` (``tracer="grid"``) or sphere
        tracing of ``sdf`` (``"sphere"``)."""
        if self.cfg.tracer == "sphere":
            res = sphere_trace(self.frozen_sdf(), origins, dirs, self.cfg.sphere_tracer)
            return res.dists, res.mask, res.points
        if self.grid_values is None:
            raise ValueError("tracer='grid' needs baked grid_values: call the runner's "
                             "bake_grid() or pass grid_values to Stage2Model")
        return grid_cast(self.grid_values, self.cfg.grid, origins, dirs)


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
        lin_diff=lin_diff, argmax_vis=argmax_vis,
        diffuse_sweep_chunk=model.cfg.sweep_light_chunk)
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
                   trainstage: str = "Material",
                   sg_render_fn: Optional[SGRenderFn] = None,
                   train_spec: bool = False, lin_diff: bool = False,
                   compact_chunk: int = 0, traced=None, padded=None, **sg_kwargs) -> dict:
    """IDRNetwork.forward (:290-479), masked: trace (no grad), the indirect
    SGs at the hit points, then for the Material stages the SG render, with
    misses' per-row outputs set to 1. With ``trainstage="Illum"`` (the Vis
    stage) it returns before any render, with ``indirect_sgs``,
    ``indir_integral`` and ``normals``: the material heads' AE normal map
    at the surface rows (no smoothness draws of the spec head,
    ``train_spec=False``) and ones elsewhere.

    ``inp`` (all [N, ...]): 'points' (ray origins), 'dirs'; optional
    'object_mask' [N] bool and 'hdr_shift' [N, 1]. ``traced`` is the
    (t, hit) of ``model.trace`` on these rays made beforehand (so that two
    devices can shade one trace); None traces here. The surface sdf
    (``sdf_output`` in the JAX package) is not computed: nothing here
    reads it.

    With ``compact_chunk`` below N the render runs on the surface rows only
    (``core/compact.py``; the reference shades ``points[surface_mask]``,
    implicit_differentiable_renderer.py:396-400): the render's outputs
    must all be per-row. Its per-row
    draws then have one row per surface pixel; per-light draws are the
    dense render's. Otherwise every lane is shaded.

    ``padded`` = (index [B], valid [B]) of ``core/compact.py:pad_rows``
    runs that render on the B padded rows instead, without waiting for the
    device (``compact_apply_padded``), its per-row draws from
    ``draws.rows()`` (``draws`` a ``core/draws.py:PaddedDraws``): the step a
    CUDA graph holds (``stages/material_graph.py``)."""
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

    if trainstage == "Illum":
        mat = model.material(points, draws, train_spec=False)
        out.update({"indirect_sgs": indirect_sgs, "indir_integral": indirect_integral,
                    "normals": torch.where(surface_mask[:, None], mat.normal_map,
                                           torch.ones_like(points))})
        return out

    render = sg_render_fn or default_sg_render
    compacted = effective_chunk(n, compact_chunk, mesh_shards(model.mesh))
    if padded is not None and not compacted:
        raise ValueError("stage2_forward(padded=...) needs a compacted render")
    if compacted:
        # per-row draws of this rank's surface rows: its part of every
        # rank's, when the draws are split over the ranks
        if padded is not None:
            row_draws = draws.rows()
        elif draws.split is None:
            row_draws = draws
        else:
            row_draws = draws.with_split(row_split(model.mesh, int(surface_mask.sum())))

        def row_render(pts, vdirs, isgs, iint, h):
            with span("stage2.shade"):
                r = render(model, row_draws, pts, vdirs, isgs, indir_integral=iint,
                           train_spec=train_spec, lin_diff=lin_diff, hdr_shift=h,
                           surface_mask=torch.ones_like(pts[:, 0], dtype=torch.bool),
                           **sg_kwargs)
            bad = [k for k, v in r.items() if v.dim() == 0 or v.shape[0] != pts.shape[0]]
            if bad:
                raise ValueError(f"stage2_forward(compact_chunk=...) needs per-row render "
                                 f"outputs; {bad} are batch statistics: run this render "
                                 f"fn dense (compact_chunk=0)")
            return r

        hs = hdr_shift if hdr_shift is not None else points.new_zeros((n, 1))
        inputs = [points, -ray_dirs, indirect_sgs, indirect_integral, hs]
        ret = (compact_apply(row_render, surface_mask, inputs) if padded is None
               else compact_apply_padded(row_render, *padded, inputs))
    else:
        with span("stage2.shade"):
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


def spherical_uniform(draws: Draws, shape) -> torch.Tensor:
    """Directions uniform on the sphere, ``shape + (3,)``
    (IDRNetwork.trace_radiance:583-590), from the draws ``sphere_u`` (the
    z coordinate) and ``sphere_t`` (the azimuth), each U[0, 1) of
    ``shape``."""
    u = draws.uniform("sphere_u", shape, rows=True) * 2 - 1
    t = draws.uniform("sphere_t", shape, rows=True) * 2 * math.pi
    r = torch.sqrt(torch.clamp(1 - u ** 2, min=0.0))
    return torch.stack([r * torch.cos(t), r * torch.sin(t), u], -1)


def secondary_fan(model: Stage2Model, draws: Draws, forward_out: dict, nsamp: int) -> dict:
    """The Vis stage's secondary rays from the primary points
    (trace_radiance:583-612): ``nsamp`` uniform directions a pixel, culled
    where ``n . d < 0`` against the unit (detached, clipped) normals, the
    origins pushed off the surface along them by max(0.005,
    2 hit_eps_cells cell) on the grid tracer (0.005 on the sphere tracer),
    rounded to fp32 as the JAX package rounds it: a grazing ray re-hits its
    own surface below that. Returns normals [N, 3], sample_dirs [N, S, 3],
    back_cull [N, S], and the fan's origins and directions, [N * S, 3]."""
    points = forward_out["points"]
    normals = forward_out["normals"].detach()
    normals = normals / torch.clamp(torch.linalg.norm(normals, dim=-1, keepdim=True), min=1e-4)
    n = points.shape[0]
    sample_dirs = spherical_uniform(draws, (n, nsamp))
    back_cull = torch.sum(normals[:, None, :] * sample_dirs, -1) < 0
    offset = 0.005
    if model.cfg.tracer == "grid":
        offset = max(offset, 2.0 * model.cfg.grid.hit_eps_cells * model.cfg.grid.cell)
    origins = points + normals * f32(offset)
    return {"normals": normals, "sample_dirs": sample_dirs, "back_cull": back_cull,
            "origins": origins[:, None, :].expand(n, nsamp, 3).reshape(-1, 3),
            "dirs": sample_dirs.reshape(-1, 3)}


def trace_radiance(model: Stage2Model, draws: Draws, forward_out: dict, nsamp: int = 16,
                   compact_chunk: int = 4096, traced=None) -> dict:
    """Secondary-ray supervision of the Vis stage (IDRNetwork.trace_radiance,
    :566-650), from ``stage2_forward(trainstage="Illum")``'s output.

    One trace of the fan (``secondary_fan``) without a graph, or ``traced``
    = its (t, hit, x) made beforehand (so that two devices can share one
    trace). The borrowed colour runs without a graph on the rays that need
    it (hit, front facing, from a surface pixel), in slices of
    ``compact_chunk`` rays (0: dense, on every ray of the fan at once): K3's
    scratch, about 8 KB a sample row, stays bounded at any hit rate, and the
    result equals one call (the colour has no draws). Then the radiance
    ``ldr2hdr(clip(colour)^2.2)`` under each pixel's shift, culled and
    masked; the trainable visibility net's logits over the whole fan; the
    labels and the hemisphere integral of the traced radiance.

    Returns trace_radiance [N, S, 3], sample_dirs [N, S, 3], gt_vis [N, S]
    bool, pred_vis [N, S, 2], indir_mask [N, S], gt_integral [N, 3], and
    the fan's ``hit`` and ``need`` [N * S] bool: its rays that hit, and
    those whose colour was borrowed."""
    points = forward_out["points"]
    points_mask = forward_out["network_object_mask"]
    n = points.shape[0]
    fan = secondary_fan(model, draws, forward_out, nsamp)
    normals, sample_dirs, back_cull = fan["normals"], fan["sample_dirs"], fan["back_cull"]
    d_flat = fan["dirs"]
    sec_t, sec_hit, sec_x = model.trace(fan["origins"], d_flat) if traced is None else traced
    need = sec_hit & ~back_cull.reshape(-1) & points_mask[:, None].expand(n, nsamp).reshape(-1)
    chunk = effective_chunk(n * nsamp, compact_chunk, mesh_shards(model.mesh))
    with torch.no_grad():
        if chunk:
            color = compact_apply(lambda x, d: {"color": model.borrow_color(x, d, chunk)},
                                  need, [sec_x, -d_flat])["color"]
        else:
            color = model.borrow_color(sec_x, -d_flat)
        color = torch.where(sec_hit[:, None], color, 0.0)
        shift = forward_out["hdr_shift"][:, None, :].expand(n, nsamp, 1).reshape(-1, 1)
        hdr = ldr2hdr(model.params["gamma"], model.cfg.tonemap,
                      torch.clamp(color, min=0.0) ** 2.2, shift)
        hdr = torch.where(sec_hit[:, None], hdr, 0.0)
        radiance = torch.where(back_cull[..., None], 0.0, hdr.reshape(n, nsamp, 3))
        radiance = torch.where(points_mask[:, None, None], radiance, 0.0)

    p_in = points[:, None, :].expand(n, nsamp, 3).reshape(-1, 3)
    pred_vis = model.vis_logits(p_in, d_flat).reshape(n, nsamp, 2)
    pred_vis = torch.where(points_mask[:, None, None], pred_vis, 0.0)
    gt_vis = sec_hit.reshape(n, nsamp) & points_mask[:, None]
    indir_mask = ~back_cull & gt_vis
    cos_dot = radiance * torch.relu(torch.sum(normals[:, None, :] * sample_dirs, -1,
                                              keepdim=True))
    hemi = torch.sum(~back_cull, -1, keepdim=True).to(radiance.dtype)
    gt_integral = torch.sum(cos_dot, dim=-2) / torch.clamp(hemi, min=1e-4)
    gt_integral = torch.where(points_mask[:, None], gt_integral, 0.0)
    return {"trace_radiance": radiance, "sample_dirs": sample_dirs, "gt_vis": gt_vis,
            "pred_vis": pred_vis, "indir_mask": indir_mask, "gt_integral": gt_integral,
            "hit": sec_hit, "need": need}


def neus_bridge_render(model: Stage2Model, rays, render_cfg=None,
                       t_rand: Optional[torch.Tensor] = None,
                       generator: Optional[torch.Generator] = None) -> dict:
    """The frozen stage-1 NeuS rendered through the stage-2 model in
    stage-2 coordinates (JAX ``render/stage2.py:neus_bridge_render``, the
    reference's ``wrap_renderer``, sdf_render.py:377-426). ``rays`` (a
    ``render/neus.py:Rays``) are in stage-2 coordinates: their origins and
    near/far bounds are scaled by ``coord_scale`` into stage-1 space, and
    ``dist`` comes back divided by it. ``render_cfg`` defaults to 64 + 64
    samples without a shell. The JAX function's ``key`` is the jitter here:
    ``t_rand`` ([B, 1] in [-0.5, 0.5)) or ``generator``; with neither the
    render is an eval render, as with ``key=None`` there. Returns idr_rgb
    and sg_rgb (the rendered colour, channels reversed with ``bgr``),
    indir_rgb (zeros), acc, dist and network_object_mask (acc > 0.5)."""
    render_cfg = render_cfg or NeusRenderConfig(n_samples=64, n_importance=64, n_outside=0)
    s = model.cfg.coord_scale
    scaled = Rays(rays.origins * s, rays.directions, rays.viewdirs, rays.radii,
                  rays.lossmult, rays.near * s, rays.far * s)
    out = render_neus(scaled, model.neus(), 1.0, render_cfg,
                      is_eval=t_rand is None and generator is None, t_rand=t_rand,
                      generator=generator)
    rgb = torch.flip(out["rgb"], (-1,)) if model.cfg.bgr else out["rgb"]
    return {"idr_rgb": rgb, "sg_rgb": rgb, "indir_rgb": torch.zeros_like(rgb),
            "acc": out["acc"], "dist": out["dist"] / s,
            "network_object_mask": out["acc"] > 0.5}
