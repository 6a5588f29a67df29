"""Stage Norm: distil the mesh's geometry normals into the AE normal map
(counterpart of ``robir_tpu/stages/norm.py``, the reference's
``training/train_normal.py``, NormalTrainRunner on its minimum_mem path).

Each step samples texture-space surface points with their mesh normals
(``TexSpaceSampler.simple_data_batch``) and trains the
``normal_decoder_layer`` sparse autoencoder alone: the MSE of its
normalised output against the mesh normals, plus, after ``smooth_after``
steps, the L1 distance to its smoothness twin (the output from a perturbed
input, pbr_step:302-345). Every other subtree is frozen. The step is a
small MLP in plain PyTorch: no kernel of the port runs in it (the JAX
package's step reaches no Pallas kernel either).

``get_neus_surface`` is the short-segment NeuS integration of a surface
point and its normal, through the frozen NeuS's sdf and its K3 gradient.
``norm_plot_to_disk`` writes the stage's diagnostic grid of one view.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from ..core.draws import Draws
from ..core.mesh import DataMesh, global_sum
from ..core.params import ParamTree
from ..fields.encoding import integrated_pos_enc
from ..fields.sparse_ae import sparse_ae_apply
from ..render.stage2 import Stage2Config, Stage2Model
from ..texture.focus_sampler import TexSpaceSampler
from ..tools import plots
from ..tools.profiler import span
from .stage2_runner import Stage2RunnerBase, StageOptConfig, make_adam, map_view


@dataclasses.dataclass(frozen=True)
class NormStageConfig:
    num_pixels: int = 1024
    max_iters: int = 200_001
    smooth_after: int = 500
    opt: StageOptConfig = StageOptConfig(lr=5e-4)


BATCH_KEYS = ("points", "normals", "object_mask")
# the JAX package's error for IDR mode (robir_tpu/stages/norm.py:132-136)
IDR_REFUSAL = ("get_neus_surface needs the frozen NeuS bridge (its alpha uses "
               "the deviation network's inv_s); the Norm stage's short-segment "
               "integration is undefined with model.use_neus=false")


def _unit(v: torch.Tensor) -> torch.Tensor:
    return v / torch.clamp(torch.linalg.norm(v, dim=-1, keepdim=True), min=1e-4)


def norm_loss(params: ParamTree, cfg: Stage2Config, stage_cfg: NormStageConfig, batch: dict,
              cur_iter: int, draws: Draws, mesh: DataMesh | None = None):
    """The Norm step's loss (``make_norm_step``'s ``loss_fn``) on ``batch``
    (``BATCH_KEYS``) at step ``cur_iter`` -> (total, metrics): ``loss``,
    ``normal_loss`` and ``smooth_loss``. The smoothness term counts from
    ``cur_iter > smooth_after``; its noise is the draw ``normal_ae``. Under
    a ``mesh``, ``batch`` is this rank's rows and both means are over the
    global count of masked points (each rank's share)."""
    env = cfg.envmap
    points = batch["points"]
    mask = batch["object_mask"].to(points.dtype)[:, None]
    pts_ipe = integrated_pos_enc(points, torch.full_like(points, 1e-5), env.ipe)
    noise = draws.normal("normal_ae", env.normal_ae.noise_shape(points.shape[0]), rows=True)
    normal, xi_normal = sparse_ae_apply(
        params["envmap_material_network"]["normal_decoder_layer"], env.normal_ae, pts_ipe, noise)
    normal, xi_normal = _unit(normal), _unit(xi_normal)
    denom = torch.clamp(global_sum(mesh, torch.sum(mask)) * 3, min=1.0)
    normal_loss = torch.sum(mask * (normal - batch["normals"]) ** 2) / denom
    smooth_loss = torch.sum(mask * torch.abs(normal - xi_normal)) / denom
    use_smooth = float(cur_iter > stage_cfg.smooth_after)
    loss = normal_loss + use_smooth * smooth_loss
    return loss, {"loss": loss.detach(), "normal_loss": normal_loss.detach(),
                  "smooth_loss": smooth_loss.detach()}


class NormRunner(Stage2RunnerBase):
    """The Norm loop: ``run(n)`` over batches of ``tex_space_sampler``
    (which may be set later, as ``sampler``, once the grid it traces is
    baked). ``save`` writes ``log_dir/Norm/checkpoints``, which the Vis
    stage's parameters (as ``robir_tpu/cli.py:cmd_vis`` restores them) and
    ``PBRRunner.load_norm_checkpoint`` read.

    Runs on ``cuda`` unless ``device="cpu"`` is passed; with a ``mesh``,
    one rank of a data-parallel run (``Stage2RunnerBase``)."""

    stage_name = "Norm"
    TRAINABLE = ("envmap_material_network/normal_decoder_layer",)

    def __init__(self, cfg: Stage2Config, params: dict,
                 tex_space_sampler: TexSpaceSampler | None,
                 stage_cfg: NormStageConfig = NormStageConfig(), seed: int = 0, device="cuda",
                 log_dir: str | None = None, mesh: DataMesh | None = None):
        super().__init__(cfg, params, seed, device, log_dir, mesh)
        self.stage_cfg = stage_cfg
        self.sampler = tex_space_sampler
        self.optimizer, self.lr_fn = make_adam(self.trainable, stage_cfg.opt)

    def _refresh_after_restore(self) -> None:
        super()._refresh_after_restore()
        self.optimizer, self.lr_fn = make_adam(self.trainable, self.stage_cfg.opt)

    def _batch(self) -> dict:
        """``num_pixels`` texture-space samples from the numpy RNG, on the
        runner's device; the points and normals in float32, as the JAX
        runner puts them on its device (the samples are float64 numpy);
        this rank's rows of them under a mesh."""
        b = self.sampler.simple_data_batch(self.rng, self.stage_cfg.num_pixels)
        return self._local({k: np.asarray(b[k], dtype=bool if k == "object_mask"
                                          else np.float32) for k in BATCH_KEYS})

    def step(self, batch: dict, draws: Draws) -> dict:
        """One Adam update at ``cur_iter``'s learning rate (the gradients and
        metrics summed over a mesh's ranks first); then ``cur_iter`` + 1.
        Returns the metrics (detached)."""
        with span("forward"):
            loss, metrics = norm_loss(self.params, self.cfg, self.stage_cfg, batch,
                                      self.cur_iter, draws, self.mesh)
        self.optimizer.zero_grad(set_to_none=True)
        with span("backward"):
            loss.backward()
        with span("update"):
            metrics = self._reduce(metrics)
            for group in self.optimizer.param_groups:
                group["lr"] = self.lr_fn(self.cur_iter)
            self.optimizer.step()
        self.cur_iter += 1
        return metrics


def get_neus_surface(model: Stage2Model, points: torch.Tensor, view_dirs: torch.Tensor,
                     pred_normals: torch.Tensor, n_samp: int = 32, dist: float = 0.05,
                     mesh: DataMesh | None = None):
    """Short-segment NeuS integration of the surface position and normal
    (NormalTrainRunner.get_neus_surface, train_normal.py:239-286): march
    ``dist`` back along each view ray from its surface point in ``n_samp``
    samples, composite the positions and the sdf gradients (K3 on the card)
    with the NeuS alpha weights (alpha clipped to [0.01, 0.99]), and give
    the residual weight to (points, pred_normals). ``model`` is the
    stage-2 model of the frozen NeuS. Returns (final_x [N, 3],
    final_normal [N, 3], gradient_error scalar); under a ``mesh`` the
    gradient error's count of samples inside the relaxed sphere is every
    rank's (this rank's share of the global mean)."""
    if not model.cfg.use_neus:
        raise ValueError(IDR_REFUSAL)
    t = torch.linspace(0.0, dist, n_samp, dtype=points.dtype, device=points.device)[:, None]
    xs = points[:, None, :] - t[None, :, :] * view_dirs[:, None, :]
    flat = xs.reshape(-1, 3)
    sdfs = model.sdf(flat).reshape(-1, n_samp, 1)
    normals = model.sdf_gradient(flat).reshape(-1, n_samp, 3)

    next_sdf = torch.cat([sdfs[:, 1:], sdfs[:, -1:]], 1).reshape(-1, 1)
    prev_sdf = torch.cat([sdfs[:, :-1], sdfs[:, -1:]], 1).reshape(-1, 1)
    inv_s = model.inv_s()
    prev_cdf = torch.sigmoid(prev_sdf * inv_s)
    next_cdf = torch.sigmoid(next_sdf * inv_s)
    alpha = torch.clamp(((prev_cdf - next_cdf + 1e-5) / (prev_cdf + 1e-5)).reshape(-1, n_samp),
                        0.01, 0.99)
    ones = torch.ones_like(alpha[:, :1])
    trans = torch.cumprod(torch.cat([ones, 1.0 - alpha + 1e-10], -1), -1)
    weight = (alpha * trans[:, :-1])[..., None]
    res = 1 - torch.sum(weight, dim=-2)

    final_x = torch.sum(xs * weight, dim=-2) + res * points
    final_normal = torch.sum(normals * weight, dim=-2) + res * pred_normals

    pts_norm = torch.linalg.norm(flat, dim=-1).reshape(-1, n_samp)
    relax = (pts_norm < 1.2).to(points.dtype)
    grad_err = torch.sum(relax * (torch.linalg.norm(normals, dim=-1) - 1.0) ** 2) / (
        global_sum(mesh, torch.sum(relax)) + 1e-5)
    return final_x, final_normal, grad_err


def norm_plot_to_disk(runner: NormRunner, dataset, idx: int = 0, plots_dir: str | None = None,
                      chunk: int = 8000) -> str:
    """The AE normals against the NeuS short-segment normals and the image
    of view ``idx`` (train_normal.py plot_to_disk -> utils/plots.py
    plot_norm), into ``plots_dir`` (default ``<log_dir>/Norm/plots``) as
    ``norm_<cur_iter>.png``; returns its path. Per chunk of ``chunk`` rays
    without a graph: the primary trace (on the card one grid march), the
    decoder's normals at the hits, and ``get_neus_surface`` (K1 and K3 at
    32 samples a ray); ones off the surface."""
    model = runner.model()
    env = runner.cfg.envmap
    ae = runner.params["envmap_material_network"]["normal_decoder_layer"]

    def chunk_fn(_, o, d):
        _, hit, x = model.trace(o, d)
        pts_ipe = integrated_pos_enc(x, torch.full_like(x, 1e-5), env.ipe)
        normal = _unit(sparse_ae_apply(ae, env.normal_ae, pts_ipe)[0])
        _, neus_n, _ = get_neus_surface(model, x, d, normal)
        m = hit[:, None]
        return {"normals": torch.where(m, normal, 1.0),
                "normal_neus": torch.where(m, neus_n, 1.0)}

    out = map_view(dataset, idx, chunk, runner.device, chunk_fn)
    plots_dir = plots_dir or os.path.join(runner.log_dir or ".", runner.stage_name, "plots")
    return plots.plot_norm(out, dataset.rgb_images[idx], plots_dir, runner.cur_iter,
                           dataset.img_res)
