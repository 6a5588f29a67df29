"""Stage 1: NeuS SDF + radiance training (counterpart of
``robir_tpu/stages/neus_stage.py``).

One train step: render a ray batch (sampling through K1, the shaded pass
through K3), the masked MSE + eikonal + silhouette loss, backward (K4 for
the SDF trunk), optional global-norm clipping, then ``torch.optim.Adam``
with ``lr = log_lerp_lr(step)`` set before the update. The step counter
starts at 0, as optax counts the first update. ``NeusTrainer`` runs the
loop on a scene and renders test views in chunks.

Not ported yet: checkpoints, in-train eval and mesh export, ``throughput``
and the CLI (``ckpt_every``, ``eval_every``, ``mesh_resolution`` and
``mesh_bbox`` stay accepted config keys).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Iterable, Optional

import numpy as np
import torch

from .. import resolve_device
from ..core.schedule import log_lerp_lr
from ..data.blender import BlenderScene, Prefetcher, RayBatch
from ..fields.neus_model import NeuS, NeuSConfig, init_neus
from ..render.neus import NeusRenderConfig, Rays, render_neus


@dataclasses.dataclass(frozen=True)
class NeusTrainConfig:
    lr_init: float = 5e-4
    lr_final: float = 5e-6
    lr_delay_steps: int = 2500
    lr_delay_mult: float = 0.01
    max_steps: int = 200_000
    anneal_end: int = 50_000
    batch_size: int = 512
    eikonal_weight: float = 0.1
    silhouette_weight: float = 1.0
    sparsity_weight: float = 0.0
    similarity_weight: float = 0.0
    eval_chunk: int = 1024
    ckpt_every: int = 50_000
    grad_max_norm: float = 0.0
    eval_every: int = 50_000
    mesh_resolution: int = 128
    mesh_bbox: float = 1.2


def mse_to_psnr(mse):
    return -10.0 / np.log(10.0) * torch.log(mse)


def make_optimizer(params: Iterable[torch.nn.Parameter], cfg: NeusTrainConfig):
    """(Adam, lr schedule). The schedule is applied by the train step, which
    sets the group's lr to ``schedule(step)`` before each update."""
    lr = log_lerp_lr(cfg.lr_init, cfg.lr_final, cfg.max_steps,
                     cfg.lr_delay_steps, cfg.lr_delay_mult)
    opt = torch.optim.Adam(list(params), lr=lr(0), betas=(0.9, 0.999), eps=1e-8)
    return opt, lr


def clip_by_global_norm_(params: list[torch.nn.Parameter], max_norm: float) -> None:
    """optax.clip_by_global_norm: scale all grads by max_norm / norm when
    the global norm reaches max_norm."""
    grads = [p.grad for p in params if p.grad is not None]
    norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
    scale = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    for g in grads:
        g.mul_(scale)


def batch_to_rays(batch: RayBatch) -> tuple[Rays, torch.Tensor]:
    """RayBatch of tensors -> (Rays, pixels)."""
    return Rays(batch.origins, batch.directions, batch.viewdirs, batch.radii,
                batch.lossmult, batch.near, batch.far), batch.pixels


def neus_loss(out: dict, mask: torch.Tensor, pixels: torch.Tensor,
              cfg: NeusTrainConfig) -> tuple[torch.Tensor, dict]:
    """Masked MSE + eikonal + silhouette (+ optional sparsity)."""
    mask_sum = torch.sum(mask) + 1e-5
    mse = torch.sum(mask * (out["rgb"] - pixels) ** 2) / mask_sum
    eikonal = out["gradient_error"] * cfg.eikonal_weight
    silhouette = torch.mean((out["acc"] - mask[..., 0]) ** 2) * cfg.silhouette_weight
    loss = mse + eikonal + silhouette
    metrics = {"mse": mse, "psnr": mse_to_psnr(mse),
               "eikonal": eikonal, "silhouette": silhouette}
    if cfg.sparsity_weight > 0:
        sparsity = torch.mean(torch.sum(torch.log(1 + 2 * out["weights"] ** 2), -1))
        loss = loss + sparsity * cfg.sparsity_weight
        metrics["sparsity"] = sparsity
    metrics["loss"] = loss
    return loss, metrics


def cos_anneal_ratio(step: int, anneal_end: int) -> float:
    return float(min(np.float32(1.0), np.float32(step) / np.float32(anneal_end)))


def train_step(model: NeuS, optimizer: torch.optim.Optimizer,
               lr_fn: Callable[[int], float], batch: RayBatch, step: int,
               train_cfg: NeusTrainConfig, render_cfg: NeusRenderConfig,
               t_rand: Optional[torch.Tensor] = None,
               generator: Optional[torch.Generator] = None) -> dict:
    """One update of ``model``'s parameters in place; returns the metrics
    (detached tensors)."""
    rays, pixels = batch_to_rays(batch)
    out = render_neus(rays, model, cos_anneal_ratio(step, train_cfg.anneal_end),
                      render_cfg, t_rand=t_rand, generator=generator)
    loss, metrics = neus_loss(out, rays.lossmult, pixels, train_cfg)
    optimizer.zero_grad(set_to_none=True)
    loss.backward()
    if train_cfg.grad_max_norm > 1e-10:
        clip_by_global_norm_([p for g in optimizer.param_groups
                              for p in g["params"]], train_cfg.grad_max_norm)
    for group in optimizer.param_groups:
        group["lr"] = lr_fn(step)
    optimizer.step()
    return {k: v.detach() for k, v in metrics.items()}


def eval_render(model: NeuS, render_cfg: NeusRenderConfig, batch: RayBatch) -> dict:
    """Forward-only render of a ray batch (K1 and K3, no gradients)."""
    rays, _ = batch_to_rays(batch)
    with torch.no_grad():
        out = render_neus(rays, model, 1.0, render_cfg, is_eval=True)
    return {"rgb": out["rgb"], "acc": out["acc"], "dist": out["dist"]}


class NeusTrainer:
    """Host-side loop over a scene: sampling, train steps, test renders.

    Runs on ``cuda`` unless ``device="cpu"`` is passed; raises if CUDA is
    asked for and absent.
    """

    def __init__(self, scene: BlenderScene, model_cfg: NeuSConfig,
                 render_cfg: NeusRenderConfig, train_cfg: NeusTrainConfig,
                 seed: int = 0, device="cuda"):
        self.scene = scene
        self.model_cfg = model_cfg
        self.render_cfg = render_cfg
        self.train_cfg = train_cfg
        self.device = resolve_device(device)
        self.model = NeuS(init_neus(torch.Generator().manual_seed(seed), model_cfg),
                          model_cfg, self.device)
        self.optimizer, self.lr_fn = make_optimizer(self.model.parameters(),
                                                    train_cfg)
        self.step = 0
        self._rng = np.random.default_rng(seed)
        self._noise = torch.Generator(device=self.device).manual_seed(seed)
        self._prefetch: Prefetcher | None = None

    def _sample(self) -> RayBatch:
        return self.scene.sample(self._rng, self.train_cfg.batch_size)

    def _put(self, batch: RayBatch) -> RayBatch:
        return RayBatch(*[torch.as_tensor(np.asarray(x), device=self.device)
                          for x in batch])

    def run(self, n_steps: int) -> dict:
        """Train ``n_steps``; returns the last step's metrics as floats."""
        if self._prefetch is None:
            self._prefetch = Prefetcher(self._sample)
        metrics = {}
        for _ in range(n_steps):
            batch = self._put(next(self._prefetch))
            metrics = train_step(self.model, self.optimizer, self.lr_fn, batch,
                                 self.step, self.train_cfg, self.render_cfg,
                                 generator=self._noise)
            self.step += 1
        return {k: float(v) for k, v in metrics.items()}

    def close(self) -> None:
        """Stop the prefetch thread."""
        if self._prefetch is not None:
            self._prefetch.close()
            self._prefetch = None

    def render_image(self, idx: int = 0, scene: BlenderScene | None = None) -> dict:
        """Chunked whole-image render of one view, with its MSE and PSNR
        against the view's image."""
        scene = scene or self.scene
        full = scene.image_rays(idx)
        n = full.origins.shape[0]
        chunk = self.train_cfg.eval_chunk
        outs = []
        for i in range(0, n, chunk):
            sl = RayBatch(*[np.asarray(x[i:i + chunk]) for x in full])
            valid = sl.origins.shape[0]
            pad = chunk - valid
            if pad:
                sl = RayBatch(*[np.concatenate([x, np.repeat(x[-1:], pad, 0)])
                                for x in sl])
            out = eval_render(self.model, self.render_cfg, self._put(sl))
            outs.append({k: v[:valid].cpu().numpy() for k, v in out.items()})
        img = {k: np.concatenate([o[k] for o in outs], 0) for k in outs[0]}
        rgb = img["rgb"].reshape(scene.h, scene.w, 3)
        mse = float(np.mean((rgb - scene.images[idx]) ** 2))
        return {"rgb": rgb, "acc": img["acc"].reshape(scene.h, scene.w),
                "dist": img["dist"].reshape(scene.h, scene.w),
                "mse": mse, "psnr": -10.0 / np.log(10.0) * np.log(mse)}
