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

Dense step only (``compact_chunk=0``): surface-pixel compaction is not
ported yet, and its result is the dense one.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.draws import Draws
from ..core.params import ParamTree
from ..data.syn_dataset import SynDataset
from ..fields.encoding import PEConfig, positional_encoding
from ..fields.mlp import effective_weight
from ..fields.sdf import SDFConfig, init_sdf, sdf_apply
from ..render import sg as sg_lib
from ..render.color import as_input, hdr2ldr
from ..render.stage2 import Stage2Config, Stage2Model, stage2_forward
from .losses import (InvLossConfig, latent_smooth_loss, masked_spec_kl, rgb_loss,
                     white_loss)
from .stage2_runner import Stage2RunnerBase, StageOptConfig, make_adam

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
    compact_chunk: int = 0          # only the dense step (0) is ported
    ambient_anchor: float = 0.0
    sv_weight: float = 1.0

    def __post_init__(self):
        if self.compact_chunk:
            raise NotImplementedError("surface-pixel compaction is not ported yet: "
                                      "compact_chunk must be 0 (the dense step)")

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
                   surface_mask=None, diffuse_vis_grad: bool = True, **_) -> dict:
    """CESR get_sg_render (train_cesr.py:465-544), dense: the supervision
    terms (shadow-net KL, normal consistency) are weighted by
    ``surface_mask``, as the reference shades surface points only."""
    view_dirs = view_dirs / (torch.linalg.norm(view_dirs, dim=-1, keepdim=True) + 1e-6)
    normals = model.sdf_gradient(points)
    normals = normals / torch.clamp(torch.linalg.norm(normals, dim=-1, keepdim=True),
                                    min=1e-4)
    mat = model.material(points, draws, train_spec=train_spec, spec_var=spec_var)
    indir_integral = indir_integral * 2 * np.pi
    normal_map = mat.normal_map.detach()

    diffuse_vis = shadow_net_vis(shadow_params, stage_cfg, points, mat.lgt_sgs.shape[0])
    normal_new = normal_net_apply(normal_params, stage_cfg, points)
    sv_weight = None if surface_mask is None else surface_mask.to(torch.float32)
    sg_ret = sg_lib.render_with_all_sg(
        draws, points.detach(), normal_new if use_new_normal else normal_map,
        view_dirs, mat.lgt_sgs, torch.abs(mat.specular_reflectance), mat.roughness,
        mat.diffuse_albedo, indir_lgt_sgs=indir_lgt_sgs,
        indir_integral=indir_integral, vis_fn=model.vis_logits,
        vis_outer_fn=model.vis_logits_outer, lin_diff=True,
        diffuse_vis=diffuse_vis, prefit=prefit, argmax_vis=stage_cfg.argmax_vis,
        supervise_weight=sv_weight, diffuse_vis_grad=diffuse_vis_grad)

    albedo = mat.diffuse_albedo / np.pi
    out = {
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
    }
    supervise = sg_ret.supervise
    if stage_cfg.white_light and prefit != "warmup":
        supervise = supervise + white_loss(mat.lgt_sgs)
    sq = (normal_map - normal_new) ** 2
    if sv_weight is None:
        supervise = supervise + torch.mean(sq)
    else:
        w = sv_weight[:, None]
        supervise = supervise + torch.sum(w * sq) / torch.clamp(torch.sum(w) * 3, min=1.0)
    out["gradient_error"] = supervise
    out["supervise"] = supervise
    return out


def cesr_loss(params: ParamTree, cfg: Stage2Config, stage_cfg: CESRStageConfig,
              spec_var: torch.Tensor, batch: dict, draws: Draws, prefit: str,
              use_new_normal: bool, use_rgb_loss: bool, traced=None):
    """The dense CESR step's loss (make_cesr_step's ``loss_fn``) ->
    (total, metrics); ``traced`` as in ``stage2_forward``."""
    model = Stage2Model(params, cfg, batch["dirs"].device)
    n = batch["dirs"].shape[0]
    inp = {"points": batch["points"], "dirs": batch["dirs"],
           "object_mask": batch["object_mask"],
           "hdr_shift": as_input(params["gamma"]).expand(n, 1)}
    out = stage2_forward(
        model, draws, inp, sg_render_fn=cesr_sg_render, train_spec=True,
        stage_cfg=stage_cfg, prefit=prefit, use_new_normal=use_new_normal,
        shadow_params=params["shadow_net"], normal_params=params["normal_net"],
        spec_var=spec_var, traced=traced,
        # the warmup step without the rgb term never reads the sampled
        # visibility's gradient: sweep it without a graph there
        diffuse_vis_grad=use_rgb_loss or prefit != "warmup")
    total = out["supervise"] * stage_cfg.sv_weight
    metrics = {"sv_loss": total}
    mask = out["network_object_mask"] & out["object_mask"]
    if use_rgb_loss:
        pred = hdr2ldr(params["gamma"], cfg.tonemap, out["sg_rgb"] + out["indir_rgb"])
        sg_rgb_loss = rgb_loss(stage_cfg.loss, pred, batch["rgb"], mask)
        if prefit == "project":
            smooth_w, kl_w = stage_cfg.proj_smooth, stage_cfg.proj_kl
        else:
            smooth_w, kl_w = stage_cfg.explore_smooth, stage_cfg.explore_kl
        kl = masked_spec_kl(params["envmap_material_network"], cfg.envmap, out["points"],
                            mask, var=spec_var) * stage_cfg.loss.kl_weight * kl_w
        smooth = latent_smooth_loss(
            out["diffuse_albedo"], out["roughness"], out["random_xi_diffuse_albedo"],
            out["random_xi_roughness"]) * stage_cfg.loss.latent_smooth_weight * smooth_w
        total = total + stage_cfg.loss.sg_rgb_weight * sg_rgb_loss + kl + smooth
        w = mask.to(torch.float32)[:, None]
        mse = torch.sum(w * (pred - batch["rgb"]) ** 2) / torch.clamp(torch.sum(w) * 3,
                                                                     min=1.0)
        metrics.update({"rgb_loss": sg_rgb_loss, "kl": kl, "smooth": smooth,
                        "psnr": -10 / np.log(10) * torch.log(mse + 1e-12)})
    metrics["loss"] = total
    metrics["surface_frac"] = torch.mean(mask.to(torch.float32))
    return total, metrics


class CESRRunner(Stage2RunnerBase):
    """The CESR loop on a dataset: ``run(n)`` takes n dense steps.

    Runs on ``cuda`` unless ``device="cpu"`` is passed."""

    TRAINABLE = ("gamma", "envmap_material_network", "shadow_net", "normal_net")

    def __init__(self, cfg: Stage2Config, params: dict, dataset: SynDataset,
                 stage_cfg: CESRStageConfig = CESRStageConfig(), seed: int = 0,
                 device="cuda"):
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
        super().__init__(cfg, params, seed, device)
        self.stage_cfg = stage_cfg
        self.dataset = dataset
        self.optimizer, self.lr_fn = make_adam(self.trainable, stage_cfg.opt)
        self.spec_var = torch.zeros((cfg.envmap.latent_dim,), device=self.device)

    def _batch(self) -> dict:
        idx = int(self.rng.integers(self.dataset.n_cameras))
        b = self.dataset.sample_pixels(self.rng, idx, self.stage_cfg.num_pixels)
        return {k: torch.as_tensor(b[k], device=self.device)
                for k in ("points", "dirs", "object_mask", "rgb")}

    def step(self, batch: dict, draws: Draws) -> dict:
        """One update at ``cur_iter``; returns the metrics (detached)."""
        sc = self.stage_cfg
        loss, metrics = cesr_loss(
            self.params, self.cfg, sc, self.spec_var, batch, draws,
            prefit=sc.prefit_option(self.cur_iter),
            use_new_normal=self.cur_iter > sc.normal_switch_iter,
            use_rgb_loss=self.cur_iter > sc.warmup_iters)
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        for group in self.optimizer.param_groups:
            group["lr"] = self.lr_fn(self.cur_iter)
        self.optimizer.step()
        self.cur_iter += 1
        if sc.dropout_iter > 0 and self.cur_iter % sc.dropout_iter == 0:
            # latent dropout resample (train_cesr.py:639-641)
            self.spec_var = (torch.rand(self.spec_var.shape, generator=self.generator,
                                        device=self.device) > 0.8).to(torch.float32)
        return {k: v.detach() for k, v in metrics.items()}

    def run(self, n_iters: int) -> dict:
        """Take ``n_iters`` steps; returns the last step's metrics as floats."""
        metrics = {}
        for _ in range(n_iters):
            metrics = self.step(self._batch(), Draws(self.generator, device=self.device))
        return {k: float(v) for k, v in metrics.items()}
