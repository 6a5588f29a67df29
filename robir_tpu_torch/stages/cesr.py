"""Stage CESR (RVE): shadow and illumination removal (counterpart of
``robir_tpu/stages/cesr.py``, the reference's ``training/train_cesr.py``).

Adds a fresh per-light diffuse-visibility ``shadow_net`` (an 8x512 SDF-style
MLP on PE10(x) (+) the one-hot light label -> 2 logits) and a refined
``normal_net`` (PE10(x) -> 3, 8x512 with the skip at layer 4). The SG render
runs with lin_diff=True and the per-SG visibility softmax[..., 1] in place
of the sampled one; rgb = diffuse light * albedo / pi + specular. The
explore / project / warmup schedule sets the KL weights, and latent dropout
resamples the spec-AE ``var`` mask every ``dropout_iter`` steps.

``normal_net`` runs through ``sdf_apply``: K1 forward and K2 backward on the
card. ``shadow_net_vis`` is the hand-factorised [N, L, 512] trunk in plain
PyTorch, as in the JAX package (no Pallas kernel there). The frozen
subtrees (implicit, indirect, visibility) have ``requires_grad=False``.

With ``compact_chunk`` below the batch (the default: 128 of 1,024 pixels)
the step runs in row mode: the render shades the surface pixels only and
returns the supervision's per-row ingredients, which the step reduces
(the weighted means equal the dense ones). The runner switches to the
dense step while the measured surface fraction is above
``compact_max_surface_frac``, as the JAX runner does. The dense step, too,
takes the supervision's per-row ingredients from the render and reduces
them in the step (without the row mode's lobe weights, as JAX's dense
render): under data parallelism (``mesh=``) its KL is of the global mean
rate, which no rank's render can take alone.

Under a profiler the spans ``cesr.shadow_net`` and ``cesr.normal_net``
name the two nets' forwards in the render, and the counter
``cesr.light_rows`` logs the (row, light) pairs the shadow net evaluates
(``tools/profiler.py``; their readers: ``PERF.md`` section 3).

``cesr_plot_to_disk`` writes the stage's diagnostic grid of one view.
"""

from __future__ import annotations

import dataclasses
import functools
import os

import numpy as np
import torch

from ..core.compact import effective_chunk
from ..core.draws import Draws
from ..core.mesh import DataMesh, global_sum, mesh_shards
from ..core.params import ParamTree
from ..data.syn_dataset import SynDataset
from ..fields.encoding import PEConfig, positional_encoding
from ..fields.mlp import effective_weight
from ..fields.sdf import SDFConfig, init_sdf, sdf_apply
from ..render import sg as sg_lib
from ..render.color import as_input, hdr2ldr
from ..render.stage2 import Stage2Config, Stage2Model, stage2_forward
from ..tools import plots
from ..tools.profiler import count, span
from .losses import (InvLossConfig, latent_smooth_loss, masked_spec_kl, rgb_loss,
                     white_loss)
from .stage2_runner import MaterialRunner, StageOptConfig, render_view

SHADOW_PE = PEConfig(num_freqs=10, input_dims=3)


@dataclasses.dataclass(frozen=True)
class CESRStageConfig:
    num_pixels: int = 1024
    max_iters: int = 200_001
    opt: StageOptConfig = StageOptConfig(lr=5e-4)
    loss: InvLossConfig = InvLossConfig()
    explore_smooth: float = 0.1
    explore_kl: float = 1.0
    proj_smooth: float = 0.01
    proj_kl: float = 0.01
    explore_iter: int = 1000
    proj_iter: int = 0
    dropout_iter: int = 0
    warmup_iters: int = 500
    normal_switch_iter: int = 1000
    white_light: bool = False
    argmax_vis: bool = False
    num_lights: int = 128
    # row mode when 0 < compact_chunk < num_pixels (0: the dense step); the
    # runner steps dense while the surface fraction it reads every
    # guard_every steps is above compact_max_surface_frac
    compact_chunk: int = 128
    compact_max_surface_frac: float = 0.6
    guard_every: int = 8
    # > 0 weights the diffuse-vis KL per light lobe by 1 + ambient_anchor /
    # (1 + lambda); applied in row mode only, as in the JAX package
    ambient_anchor: float = 0.0
    sv_weight: float = 1.0

    @property
    def shadow_cfg(self) -> SDFConfig:
        return SDFConfig(d_in=SHADOW_PE.out_dim + self.num_lights, d_out=2,
                         d_hidden=512, n_layers=8, skip_in=(4,), multires=0)

    @property
    def normal_cfg(self) -> SDFConfig:
        return SDFConfig(d_in=SHADOW_PE.out_dim, d_out=3, d_hidden=512,
                         n_layers=8, skip_in=(4,), multires=0)

    def prefit_option(self, cur_iter: int) -> str:
        """train_cesr.py:546-559."""
        if cur_iter <= self.warmup_iters:
            return "warmup"
        cycle = self.explore_iter + self.proj_iter
        if cycle > 0 and (cur_iter % cycle) >= self.proj_iter:
            return "explore"
        return "project"


def shadow_net_vis(shadow_params, cfg: CESRStageConfig, points: torch.Tensor,
                   num_lights: int) -> torch.Tensor:
    """Per-light diffuse visibility [N, 3] -> [N, L], softmax[..., 1]
    (train_cesr.py:492-504), factorised over points x labels: the trunk's
    input is PE(x) (+) one-hot(l), so the first layer's (and the skip
    layer's) PE projection is computed once per point and the one-hot
    projection is a row of the weight."""
    L = num_lights
    scfg = cfg.shadow_cfg
    pe = positional_encoding(points.detach(), SHADOW_PE)
    d_pe = pe.shape[-1]
    num_layers = len(scfg.dims)
    h = None
    for layer in range(num_layers - 1):
        p = shadow_params[f"lin{layer}"]
        w, b = effective_weight(p), p["b"]
        if layer == 0:
            h = (pe @ w[:d_pe])[:, None, :] + w[d_pe:d_pe + L][None] + b
        elif layer in scfg.skip_in:
            d_h = h.shape[-1]
            h = (h @ w[:d_h] + (pe @ w[d_h:d_h + d_pe])[:, None, :]
                 + w[d_h + d_pe:d_h + d_pe + L][None]) * float(1.0 / np.sqrt(2)) + b
        else:
            h = h @ w + b
        if layer < num_layers - 2:
            h = torch.nn.functional.softplus(h, beta=100.0)
    return torch.softmax(h, -1)[..., 1]


def normal_net_apply(normal_params, cfg: CESRStageConfig,
                     points: torch.Tensor) -> torch.Tensor:
    """Unit normals from the refined normal net (K1 forward, K2 backward)."""
    pe = positional_encoding(points.detach(), SHADOW_PE)
    n = sdf_apply(normal_params, cfg.normal_cfg, pe)
    return n / torch.clamp(torch.linalg.norm(n, dim=-1, keepdim=True), min=1e-4)


def cesr_sg_render(model: Stage2Model, draws: Draws, points, view_dirs,
                   indir_lgt_sgs, indir_integral=None, *, shadow_params,
                   normal_params, stage_cfg: CESRStageConfig, prefit: str,
                   use_new_normal: bool, spec_var=None, train_spec=True,
                   diffuse_vis_grad: bool = True, **_) -> dict:
    """CESR get_sg_render (train_cesr.py:465-544), with per-row outputs
    only: the supervision (shadow-net KL, normal consistency, white light)
    comes out as its per-row ingredients ``supervise_x`` [N, M] (|gt -
    vis|) and ``normal_sq`` [N, 3], which ``cesr_loss`` reduces over the
    surface rows, outside a surface-pixel compaction and over the ranks."""
    view_dirs = view_dirs / (torch.linalg.norm(view_dirs, dim=-1, keepdim=True) + 1e-6)
    normals = model.sdf_gradient(points)
    normals = normals / torch.clamp(torch.linalg.norm(normals, dim=-1, keepdim=True),
                                    min=1e-4)
    mat = model.material(points, draws, train_spec=train_spec, spec_var=spec_var)
    indir_integral = indir_integral * 2 * np.pi
    normal_map = mat.normal_map.detach()

    num_lights = mat.lgt_sgs.shape[0]
    with span("cesr.shadow_net"):
        diffuse_vis = shadow_net_vis(shadow_params, stage_cfg, points, num_lights)
    # the (row, light) pairs the shadow net evaluates: a host int, no wait
    count("cesr.light_rows", points.shape[0] * num_lights)
    with span("cesr.normal_net"):
        normal_new = normal_net_apply(normal_params, stage_cfg, points)
    sg_ret = sg_lib.render_with_all_sg(
        draws, points.detach(), normal_new if use_new_normal else normal_map,
        view_dirs, mat.lgt_sgs, torch.abs(mat.specular_reflectance), mat.roughness,
        mat.diffuse_albedo, indir_lgt_sgs=indir_lgt_sgs,
        indir_integral=indir_integral, vis_fn=model.vis_logits,
        vis_outer_fn=model.vis_logits_outer, lin_diff=True,
        diffuse_vis=diffuse_vis, prefit=prefit, argmax_vis=stage_cfg.argmax_vis,
        diffuse_sweep_chunk=model.cfg.sweep_light_chunk, supervise_rows=True,
        diffuse_vis_grad=diffuse_vis_grad)

    albedo = mat.diffuse_albedo / np.pi
    return {
        "normals": normals,
        "sg_rgb": sg_ret.sg_diffuse_rgb * albedo + sg_ret.sg_specular_rgb,
        "indir_rgb": sg_ret.indir_diffuse_rgb * albedo + sg_ret.indir_specular_rgb,
        "sg_diffuse_rgb": sg_ret.sg_diffuse_rgb,
        "sg_specular_rgb": sg_ret.sg_specular_rgb,
        "indir_diffuse_rgb": sg_ret.indir_diffuse_rgb,
        "indir_specular_rgb": sg_ret.indir_specular_rgb,
        "vis_shadow": sg_ret.vis_shadow,
        "diffuse_albedo": mat.diffuse_albedo, "roughness": mat.roughness,
        "metallic": mat.metallic, "normal_map": normal_new,
        "random_xi_roughness": mat.random_xi_roughness,
        "random_xi_metallic": mat.random_xi_metallic,
        "random_xi_diffuse_albedo": mat.random_xi_diffuse_albedo,
        "supervise_x": sg_ret.supervise,
        "normal_sq": (normal_map - normal_new) ** 2,
    }


def cesr_loss(params: ParamTree, cfg: Stage2Config, stage_cfg: CESRStageConfig,
              spec_var: torch.Tensor, batch: dict, draws: Draws, prefit: str,
              use_new_normal: bool, use_rgb_loss: bool, traced=None,
              grid_values=None, mesh: DataMesh | None = None, padded=None):
    """The CESR step's loss (make_cesr_step's ``loss_fn``) -> (total,
    metrics): in row mode where ``stage2_forward`` compacts at
    ``stage_cfg.compact_chunk``, else dense; either way the supervision is
    reduced here from its per-row ingredients. ``traced`` and ``padded``
    as in ``stage2_forward``; ``grid_values`` is the grid tracer's baked grid.
    Under a ``mesh``, ``batch`` is this rank's rows, the loss and every
    metric but ``psnr`` (global) this rank's share."""
    model = Stage2Model(params, cfg, batch["dirs"].device, grid_values, mesh)
    n = batch["dirs"].shape[0]
    world = 1 if mesh is None else mesh.world
    compacted = bool(effective_chunk(n, stage_cfg.compact_chunk, mesh_shards(mesh)))
    inp = {"points": batch["points"], "dirs": batch["dirs"],
           "object_mask": batch["object_mask"],
           "hdr_shift": as_input(params["gamma"]).expand(n, 1)}
    out = stage2_forward(
        model, draws, inp, sg_render_fn=cesr_sg_render, train_spec=True,
        compact_chunk=stage_cfg.compact_chunk,
        stage_cfg=stage_cfg, prefit=prefit, use_new_normal=use_new_normal,
        shadow_params=params["shadow_net"], normal_params=params["normal_net"],
        spec_var=spec_var, traced=traced, padded=padded,
        # the warmup step without the rgb term never reads the sampled
        # visibility's gradient: sweep it without a graph there
        diffuse_vis_grad=use_rgb_loss or prefit != "warmup")
    # the supervision from its per-row ingredients: weighted means over the
    # surface rows (miss rows weigh 0), the lobe weights in row mode only
    w = out["surface_mask"].to(torch.float32)
    lgt = params["envmap_material_network"]["lgtSGs"]
    lobe_w = None
    if stage_cfg.ambient_anchor > 0 and compacted:
        lobe_w = 1.0 + stage_cfg.ambient_anchor / (1.0 + torch.abs(lgt[:, 3].detach()))
    sv = sg_lib.kl_divergence(out["supervise_x"], 0.01, weight=w, lobe_weight=lobe_w,
                              mesh=mesh)
    sv = sv * {"warmup": 0.1, "project": 0.2}.get(prefit, 1.0)
    if stage_cfg.white_light and prefit != "warmup":
        # a term of the parameters alone: every rank's share of it
        sv = sv + white_loss(lgt) / world
    w1 = w[:, None]
    sv = sv + torch.sum(w1 * out["normal_sq"]) / torch.clamp(
        global_sum(mesh, torch.sum(w1)) * 3, min=1.0)
    total = sv * stage_cfg.sv_weight
    metrics = {"sv_loss": total}
    mask = out["network_object_mask"] & out["object_mask"]
    if use_rgb_loss:
        pred = hdr2ldr(params["gamma"], cfg.tonemap, out["sg_rgb"] + out["indir_rgb"])
        sg_rgb_loss = rgb_loss(stage_cfg.loss, pred, batch["rgb"], mask, mesh)
        if prefit == "project":
            smooth_w, kl_w = stage_cfg.proj_smooth, stage_cfg.proj_kl
        else:
            smooth_w, kl_w = stage_cfg.explore_smooth, stage_cfg.explore_kl
        kl = masked_spec_kl(params["envmap_material_network"], cfg.envmap, out["points"],
                            mask, var=spec_var, mesh=mesh) * stage_cfg.loss.kl_weight * kl_w
        smooth = latent_smooth_loss(
            out["diffuse_albedo"], out["roughness"], out["random_xi_diffuse_albedo"],
            out["random_xi_roughness"], mesh) * stage_cfg.loss.latent_smooth_weight * smooth_w
        total = total + stage_cfg.loss.sg_rgb_weight * sg_rgb_loss + kl + smooth
        with torch.no_grad():
            w = mask.to(torch.float32)[:, None]
            sq, n_w = global_sum(mesh, torch.sum(w * (pred - batch["rgb"]) ** 2), torch.sum(w))
            mse = sq / torch.clamp(n_w * 3, min=1.0)
        metrics.update({"rgb_loss": sg_rgb_loss, "kl": kl, "smooth": smooth,
                        "psnr": -10 / np.log(10) * torch.log(mse + 1e-12)})
    metrics["loss"] = total
    metrics["surface_frac"] = torch.sum(mask.to(torch.float32)) / (n * world)
    return total, metrics


class CESRRunner(MaterialRunner):
    """The CESR loop on a dataset: ``run(n)`` takes n steps, each in row
    mode or dense as ``step_config`` picks. It starts from the PBR stage's
    checkpoint (``load_pbr_checkpoint``). With ``tracer="grid"`` call
    ``bake_grid()`` first.

    Runs on ``cuda`` unless ``device="cpu"`` is passed; with a ``mesh``,
    one rank of a data-parallel run (``MaterialRunner``)."""

    stage_name = "CESR"
    TRAINABLE = ("gamma", "envmap_material_network", "shadow_net", "normal_net")

    def __init__(self, cfg: Stage2Config, params: dict, dataset: SynDataset,
                 stage_cfg: CESRStageConfig = CESRStageConfig(), seed: int = 0,
                 device="cuda", log_dir: str | None = None, mesh: DataMesh | None = None):
        if stage_cfg.num_lights != cfg.envmap.num_lgt_sgs:
            # the one-hot label width is the envmap's number of SG lights
            stage_cfg = dataclasses.replace(stage_cfg, num_lights=cfg.envmap.num_lgt_sgs)
        if stage_cfg.dropout_iter == -2:
            # truck-config variant: softplus latent of the specular encoder
            cfg = dataclasses.replace(cfg, envmap=dataclasses.replace(
                cfg.envmap, spec_lc_act="softplus"))
        params = dict(params)
        gen = torch.Generator().manual_seed(seed + 77)
        params["shadow_net"] = init_sdf(gen, stage_cfg.shadow_cfg)
        params["normal_net"] = init_sdf(gen, stage_cfg.normal_cfg)
        super().__init__(cfg, params, dataset, stage_cfg, seed, device, log_dir, mesh)
        self.spec_var = torch.zeros((cfg.envmap.latent_dim,), device=self.device)

    def load_pbr_checkpoint(self, path: str) -> None:
        """Every leaf of the PBR stage's checkpoint but the runner's own
        ``shadow_net`` and ``normal_net``, and without the spec-BRDF
        autoencoder unless latent dropout is off (``dropout_iter`` -1;
        train_cesr.py:136-139); then a fresh Adam."""
        no_discard = self.stage_cfg.dropout_iter == -1
        self.restore_surgical(
            path, keep=lambda p: (not p.startswith(("shadow_net", "normal_net")))
            and ("spec_brdf" not in p or no_discard))

    def step(self, batch: dict, draws: Draws) -> dict:
        """One update at ``cur_iter``; returns the metrics (detached). A
        compacted step on the card replays the graph of its row bucket and
        its phase's flags (``MaterialRunner._graph_step``), its draws from
        the runner's generator; every other step runs eagerly on
        ``draws``."""
        sc, step_cfg = self.stage_cfg, self.step_config()
        flags = (sc.prefit_option(self.cur_iter), self.cur_iter > sc.normal_switch_iter,
                 self.cur_iter > sc.warmup_iters)
        metrics = None
        if self._graphed(step_cfg):
            def loss_fn(batch, draws, traced, padded):
                return cesr_loss(self.params, self.cfg, step_cfg, self.spec_var, batch, draws,
                                 *flags, traced=traced, padded=padded)

            batch = self._graph_set().put(batch)
            metrics = self._graph_step(batch, flags, loss_fn)
        if metrics is None:
            with span("forward"):
                loss, metrics = cesr_loss(
                    self.params, self.cfg, step_cfg, self.spec_var, batch, draws, *flags,
                    grid_values=self.grid_values, mesh=self.mesh)
            metrics = self._update(loss, metrics)
        if sc.dropout_iter > 0 and self.cur_iter % sc.dropout_iter == 0:
            # latent dropout resample (train_cesr.py:639-641), in place: the
            # graphs read the mask from its buffer
            self.spec_var.copy_((torch.rand(self.spec_var.shape, generator=self.generator,
                                            device=self.device) > 0.8).to(torch.float32))
        return metrics


def cesr_plot_to_disk(runner: CESRRunner, dataset, idx: int = 0, plots_dir: str | None = None,
                      chunk: int = 8000) -> str:
    """The CESR grid of view ``idx`` (train_cesr.py plot_to_disk ->
    utils/plots.py plot_cesr: prediction, image, albedo, shadow, refined
    normals, specular), into ``plots_dir`` (default ``<log_dir>/CESR/plots``)
    as ``cesr_<cur_iter>_<idx>.png``; returns its path. ``render_view``
    with ``cesr_sg_render`` at the runner's step (its prefit phase and
    normal switch; per-row outputs, so that it compacts), one set of draws
    a chunk from the runner's generator: on the card per chunk one grid
    march, and K3 (geometry normals) and K1 (the normal net) at the
    surface rows."""
    sc = runner.stage_cfg
    render = functools.partial(cesr_sg_render, stage_cfg=sc,
                               prefit=sc.prefit_option(runner.cur_iter),
                               use_new_normal=runner.cur_iter > sc.normal_switch_iter)
    out = render_view(runner.model(), dataset, idx, sg_render_fn=render,
                      draws=lambda _: Draws(runner.generator, device=runner.device),
                      chunk=chunk, shadow_params=runner.params["shadow_net"],
                      normal_params=runner.params["normal_net"], spec_var=runner.spec_var)
    plots_dir = plots_dir or os.path.join(runner.log_dir or ".", runner.stage_name, "plots")
    return plots.plot_cesr(out, dataset.rgb_images[idx], plots_dir, runner.cur_iter,
                           dataset.img_res, idx)
