"""Stage PBR: the SG envmap and the BRDF under an HDR calibration
(counterpart of ``robir_tpu/stages/pbr.py``, the reference's
``training/train_pbr.py``).

The runner starts from the Vis stage's checkpoint (the indirect and
visibility nets, ``load_vis_checkpoint``) and, where there is one, the Norm
stage's (the normal decoder, ``load_norm_checkpoint``); both are frozen
here with the NeuS. It trains ``gamma`` and ``envmap_material_network``
with one Adam. The render (``pbr_sg_render``) shades with the AE normal
map (the geometry normals with ``use_normal_map=False``), the indirect
integral times 2 pi and |specular_reflectance|; the loss
(``pbr_loss``, JAX's ``make_pbr_step`` loss) is the tone-mapped
reconstruction, the KL sparsity of the spec-BRDF latents, 0.1 x the latent
smoothness and the white-light term.

The diffuse sweep keeps its graph: its sample directions come from the
trainable ``lgtSGs``, so the loss differentiates the frozen visibility
net's input with respect to the lights; ``gamma`` reaches the frozen
indirect net through ``hdr_shift``. On the card a step runs the grid march
once (the batch's rays) and K3 once (the geometry normals at the shaded
rows); K1, K2 and K4 not at all.

``PBRRunner.render_view`` renders a view, ``pbr_plot_to_disk`` writes the
stage's diagnostic grid of it.
"""

from __future__ import annotations

import dataclasses
import functools
import os

import numpy as np
import torch

from ..core.draws import Draws
from ..core.mesh import DataMesh, global_sum
from ..core.params import ParamTree
from ..data.syn_dataset import SynDataset
from ..render import sg as sg_lib
from ..render.color import as_input, hdr2ldr
from ..render.stage2 import Stage2Config, Stage2Model, stage2_forward
from ..tools import plots
from ..tools.profiler import span
from .losses import InvLossConfig, latent_smooth_loss, masked_spec_kl, rgb_loss, white_loss
from .stage2_runner import MaterialRunner, StageOptConfig, render_view


@dataclasses.dataclass(frozen=True)
class PBRStageConfig:
    num_pixels: int = 1024
    max_iters: int = 200_001
    opt: StageOptConfig = StageOptConfig(lr=5e-4)
    loss: InvLossConfig = InvLossConfig()
    # shade with the AE normal map (False: the geometry normals)
    use_normal_map: bool = True
    # row mode when 0 < compact_chunk < num_pixels (0: the dense step); the
    # runner steps dense while the surface fraction it reads every
    # guard_every steps is above compact_max_surface_frac
    compact_chunk: int = 128
    compact_max_surface_frac: float = 0.6
    guard_every: int = 8


def pbr_sg_render(model: Stage2Model, draws: Draws, points, view_dirs, indir_lgt_sgs,
                  indir_integral=None, train_spec=True, lin_diff=False,
                  use_normal_map: bool = True, argmax_vis=False, **_) -> dict:
    """The PBR ``get_sg_render`` (train_pbr.py:348-396). Unlike
    ``default_sg_render``: the geometry normals (K3, no graph) are
    normalised with their norm clipped at 1e-4; the indirect integral is
    times 2 pi; |specular_reflectance|; the shading normal is the AE normal
    map, without its graph, unless ``use_normal_map`` is False. Every
    output is per row (no batch statistic), so ``stage2_forward`` can
    compact it."""
    view_dirs = view_dirs / (torch.linalg.norm(view_dirs, dim=-1, keepdim=True) + 1e-6)
    normals = model.sdf_gradient(points)
    normals = normals / torch.clamp(torch.linalg.norm(normals, dim=-1, keepdim=True), min=1e-4)
    mat = model.material(points, draws, train_spec=train_spec)
    shade_normal = mat.normal_map if use_normal_map else normals
    sg_ret = sg_lib.render_with_all_sg(
        draws, points.detach(), shade_normal.detach(), view_dirs, mat.lgt_sgs,
        torch.abs(mat.specular_reflectance), mat.roughness, mat.diffuse_albedo,
        indir_lgt_sgs=indir_lgt_sgs, indir_integral=indir_integral * 2 * np.pi,
        vis_fn=model.vis_logits, vis_outer_fn=model.vis_logits_outer, lin_diff=lin_diff,
        argmax_vis=argmax_vis, diffuse_sweep_chunk=model.cfg.sweep_light_chunk)
    return {
        "normals": normals, "sg_rgb": sg_ret.sg_rgb,
        "sg_specular_rgb": sg_ret.sg_specular_rgb,
        "sg_diffuse_rgb": sg_ret.sg_diffuse_rgb, "indir_rgb": sg_ret.indir_rgb,
        "indir_diffuse_rgb": sg_ret.indir_diffuse_rgb,
        "indir_specular_rgb": sg_ret.indir_specular_rgb,
        "vis_shadow": sg_ret.vis_shadow, "diffuse_albedo": mat.diffuse_albedo,
        "roughness": mat.roughness, "metallic": mat.metallic, "normal_map": mat.normal_map,
        "random_xi_roughness": mat.random_xi_roughness,
        "random_xi_metallic": mat.random_xi_metallic,
        "random_xi_diffuse_albedo": mat.random_xi_diffuse_albedo,
        "random_xi_normal": mat.random_xi_normal,
    }


def pbr_loss(params: ParamTree, cfg: Stage2Config, stage_cfg: PBRStageConfig, batch: dict,
             draws: Draws, traced=None, grid_values=None, mesh: DataMesh | None = None,
             padded=None):
    """The PBR step's loss (``make_pbr_step``'s ``loss_fn``) on ``batch``
    (``BATCH_KEYS``) -> (total, metrics): ``loss``, ``rgb_loss``, ``kl``,
    ``smooth``, ``white``, ``psnr`` and ``surface_frac``. In row mode where
    ``stage2_forward`` compacts at ``stage_cfg.compact_chunk``, else dense.
    ``traced`` and ``padded`` as in ``stage2_forward``; ``grid_values`` is the grid
    tracer's baked grid. Under a ``mesh``, ``batch`` is this rank's rows,
    the loss and every metric but ``psnr`` (global) this rank's share."""
    model = Stage2Model(params, cfg, batch["dirs"].device, grid_values, mesh)
    world = 1 if mesh is None else mesh.world
    n = batch["dirs"].shape[0]
    inp = {"points": batch["points"], "dirs": batch["dirs"],
           "object_mask": batch["object_mask"],
           "hdr_shift": as_input(params["gamma"]).expand(n, 1)}
    out = stage2_forward(model, draws, inp, sg_render_fn=pbr_sg_render, train_spec=True,
                         compact_chunk=stage_cfg.compact_chunk, traced=traced,
                         padded=padded, use_normal_map=stage_cfg.use_normal_map)
    loss_cfg = stage_cfg.loss
    pred = hdr2ldr(params["gamma"], cfg.tonemap, out["sg_rgb"] + out["indir_rgb"])
    mask = out["network_object_mask"] & out["object_mask"]
    sg_rgb_loss = rgb_loss(loss_cfg, pred, batch["rgb"], mask, mesh)
    env = params["envmap_material_network"]
    kl = masked_spec_kl(env, cfg.envmap, out["points"], mask, mesh=mesh) * loss_cfg.kl_weight
    # the reference's (latent_smooth_weight * smooth) * 0.1 (loss.py:122,
    # train_pbr.py:333)
    smooth = latent_smooth_loss(out["diffuse_albedo"], out["roughness"],
                                out["random_xi_diffuse_albedo"], out["random_xi_roughness"],
                                mesh) * loss_cfg.latent_smooth_weight * 0.1
    # a term of the parameters alone: every rank's share of it
    wl = white_loss(env["lgtSGs"]) / world
    total = loss_cfg.sg_rgb_weight * sg_rgb_loss + kl + smooth + wl
    with torch.no_grad():
        w = mask.to(pred.dtype)[:, None]
        sq, n_w = global_sum(mesh, torch.sum(w * (pred - batch["rgb"]) ** 2), torch.sum(w))
        mse = sq / torch.clamp(n_w * 3, min=1.0)
        metrics = {"loss": total.detach(), "rgb_loss": sg_rgb_loss.detach(), "kl": kl.detach(),
                   "smooth": smooth.detach(), "white": wl.detach(),
                   "psnr": -10 / np.log(10) * torch.log(mse + 1e-12),
                   "surface_frac": torch.sum(mask.to(torch.float32)) / (mask.shape[0] * world)}
    return total, metrics


class PBRRunner(MaterialRunner):
    """The PBR loop on a dataset: ``load_vis_checkpoint`` (and
    ``load_norm_checkpoint`` where the Norm stage ran), ``bake_grid()``
    with ``tracer="grid"``, then ``run(n)``: n steps, each in row mode or
    dense as ``step_config`` picks.

    Runs on ``cuda`` unless ``device="cpu"`` is passed; with a ``mesh``,
    one rank of a data-parallel run (``MaterialRunner``)."""

    stage_name = "PBR"
    TRAINABLE = ("gamma", "envmap_material_network")

    def __init__(self, cfg: Stage2Config, params: dict, dataset: SynDataset,
                 stage_cfg: PBRStageConfig = PBRStageConfig(), seed: int = 0, device="cuda",
                 log_dir: str | None = None, mesh: DataMesh | None = None):
        super().__init__(cfg, params, dataset, stage_cfg, seed, device, log_dir, mesh)

    def load_norm_checkpoint(self, path: str) -> None:
        """The normal decoder of the Norm stage's checkpoint
        (train_pbr.py:157-159); then a fresh Adam."""
        self.restore_surgical(path, keep=lambda p: "normal_decoder_layer" in p)

    def load_vis_checkpoint(self, path: str) -> None:
        """The indirect and visibility nets of the Vis stage's checkpoint
        (train_pbr.py:195-203); then a fresh Adam."""
        self.restore_surgical(path, keep=lambda p: p.startswith(
            ("indirect_illum_network", "visibility_network")))

    def step(self, batch: dict, draws: Draws) -> dict:
        """One update at ``cur_iter``; returns the metrics (detached). A
        compacted step on the card replays its row bucket's graph
        (``MaterialRunner._graph_step``), its draws from the runner's
        generator; every other step runs eagerly on ``draws``."""
        sc = self.step_config()
        if self._graphed(sc):
            def loss_fn(batch, draws, traced, padded):
                return pbr_loss(self.params, self.cfg, sc, batch, draws, traced=traced,
                                padded=padded)

            batch = self._graph_set().put(batch)
            metrics = self._graph_step(batch, (), loss_fn)
            if metrics is not None:
                return metrics
        with span("forward"):
            loss, metrics = pbr_loss(self.params, self.cfg, sc, batch, draws,
                                     grid_values=self.grid_values, mesh=self.mesh)
        return self._update(loss, metrics)

    def render_view(self, idx: int, dataset=None, chunk: int = 8000) -> dict:
        """The PBR decomposition of view ``idx`` of ``dataset`` (default: the
        runner's), ``render_view`` with this stage's render and one set of
        draws a chunk from the runner's generator (the render of
        ``pbr_plot_to_disk``, without the plots)."""
        return render_view(
            self.model(), self.dataset if dataset is None else dataset, idx,
            sg_render_fn=functools.partial(pbr_sg_render,
                                           use_normal_map=self.stage_cfg.use_normal_map),
            draws=lambda _: Draws(self.generator, device=self.device), chunk=chunk)


def pbr_plot_to_disk(runner: PBRRunner, dataset, idx: int = 0, plots_dir: str | None = None,
                     chunk: int = 8000) -> str:
    """The PBR decomposition grid of view ``idx`` (train_pbr.py
    plot_to_disk -> utils/plots.py plot_mat: prediction, image, albedo,
    roughness, indirect light, shadow), rendered by
    ``runner.render_view``, into ``plots_dir`` (default
    ``<log_dir>/PBR/plots``) as ``mat_<cur_iter>_<idx>.png``; returns its
    path."""
    out = runner.render_view(idx, dataset, chunk=chunk)
    plots_dir = plots_dir or os.path.join(runner.log_dir or ".", runner.stage_name, "plots")
    return plots.plot_mat(out, dataset.rgb_images[idx], plots_dir, runner.cur_iter,
                          dataset.img_res, idx)
