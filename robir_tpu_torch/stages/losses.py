"""Stage-2 losses (counterpart of ``robir_tpu/stages/losses.py``, the
reference's ``model/loss.py``): InvLoss's terms of the Material stages,
``robir_tpu/stages/pbr.py:white_loss``, and the Vis stage's IllumLoss
(the indirect SGs against the traced radiance, the indirect integral, and
the visibility cross-entropy). The AE latent KL is
``fields/sparse_ae.py:ae_kl_divergence``.
Boolean-indexed reductions are mask-weighted dense sums with the
reference's normalisers.

Under data parallelism (a ``mesh``, ``core/mesh.py``) each normaliser is
the global count (``global_sum``) and each sum this rank's, and each
batch statistic that a loss takes non-linearly (the KL terms' mean rates)
is the global one, the term divided by the world size; so the ranks'
losses add up to the global batch's loss. A term of the parameters alone
(``white_loss``) is divided by the world size by its caller.

``eikonal_loss``, ``mask_loss`` and ``normal_consistency_loss`` are InvLoss's
remaining terms (loss.py:44-59, 69-73); no stage of either package calls
them.
"""

from __future__ import annotations

import dataclasses

import torch

from ..core.mesh import DataMesh, batch_mean, global_sum
from ..fields.encoding import positional_encoding
from ..fields.sparse_ae import encode as ae_encode


@dataclasses.dataclass(frozen=True)
class InvLossConfig:
    idr_rgb_weight: float = 1.0
    eikonal_weight: float = 0.1
    mask_weight: float = 100.0
    alpha: float = 50.0
    sg_rgb_weight: float = 1.0
    kl_weight: float = 1.0
    latent_smooth_weight: float = 1.0
    loss_type: str = "L1"


def _world(mesh: DataMesh | None) -> int:
    return 1 if mesh is None else mesh.world


def rgb_loss(cfg: InvLossConfig, rgb_pred, rgb_gt, mask,
             mesh: DataMesh | None = None) -> torch.Tensor:
    """Masked image loss / n_rays (loss.py:31-42); mask [N] bool; n_rays
    of every rank under a ``mesh``."""
    diff = rgb_pred - rgb_gt.reshape(-1, 3)
    if cfg.loss_type == "L1":
        err = torch.abs(diff)
    elif cfg.loss_type == "L2":
        err = diff ** 2
    else:
        raise ValueError(cfg.loss_type)
    return torch.sum(err * mask[:, None]) / (rgb_pred.shape[0] * _world(mesh))


def _mean(x: torch.Tensor, mesh: DataMesh | None) -> torch.Tensor:
    """The mean of every rank's ``x`` (of one shape on each), as this
    rank's share: its sum over the global count."""
    return torch.sum(x) / (x.numel() * _world(mesh))


def eikonal_loss(grad_theta: torch.Tensor, mesh: DataMesh | None = None) -> torch.Tensor:
    """Mean of (|grad| - 1)^2 over the rows (loss.py:44-49); under a
    ``mesh`` this rank's share of every rank's mean."""
    return _mean((torch.linalg.norm(grad_theta, dim=-1) - 1.0) ** 2, mesh)


def mask_loss(cfg: InvLossConfig, sdf_output, network_object_mask, object_mask,
              mesh: DataMesh | None = None) -> torch.Tensor:
    """BCE on -alpha * sdf over the rays not both hit and in the object,
    / alpha / n_rays (loss.py:51-59); n_rays of every rank under a
    ``mesh``."""
    sel = ~(network_object_mask & object_mask)
    logits = -cfg.alpha * sdf_output.reshape(-1)
    gt = object_mask.to(logits.dtype)
    bce = torch.clamp(logits, min=0) - logits * gt + torch.log1p(torch.exp(-logits.abs()))
    return (1.0 / cfg.alpha) * torch.sum(bce * sel) / (object_mask.shape[0] * _world(mesh))


def normal_consistency_loss(normal_map, normals, surface_mask,
                            mesh: DataMesh | None = None) -> torch.Tensor:
    """Masked MSE of the AE normal map against the geometry normals
    (loss.py:69-73): over the surface rows' entries, their count (of every
    rank under a ``mesh``) clamped at 1."""
    w = surface_mask[:, None].to(normal_map.dtype)
    count = global_sum(mesh, torch.sum(w)) * normal_map.shape[-1]
    return torch.sum(w * (normal_map - normals) ** 2) / torch.clamp(count, min=1.0)


def latent_smooth_loss(diffuse_albedo, roughness, xi_diffuse, xi_roughness,
                       mesh: DataMesh | None = None):
    """L1(albedo pair) + 0.2 * L1(roughness pair) (loss.py:61-67); under a
    ``mesh`` this rank's share."""
    return (_mean(torch.abs(diffuse_albedo - xi_diffuse), mesh)
            + _mean(torch.abs(roughness[..., 0] - xi_roughness[..., 0]), mesh) * 0.2)


def masked_spec_kl(envmap_params, envmap_cfg, points, mask, var=None,
                   rho: float = 0.05, mesh: DataMesh | None = None) -> torch.Tensor:
    """Bernoulli KL sparsity of the spec-BRDF encoder's latents at surface
    points (loss.py:85-95 on points[network_object_mask]), as a
    mask-weighted batch mean (under a ``mesh`` over every rank's rows, the
    KL divided by the world size)."""
    latent = ae_encode(envmap_params["spec_brdf_encoder_layer"],
                       envmap_cfg.spec_brdf_ae,
                       positional_encoding(points, envmap_cfg.pe), var=var)
    rho_hat = batch_mean(mesh, torch.sigmoid(latent), mask)
    return torch.mean(rho * torch.log(rho / (rho_hat + 1e-4)) + (1 - rho)
                      * torch.log((1 - rho) / (1 - rho_hat + 1e-4))) / _world(mesh)


def white_loss(lgt_sgs: torch.Tensor) -> torch.Tensor:
    """Chromaticity variance of the SG amplitudes (train_pbr.py:313-316),
    unbiased over the 3 channels as torch ``.var(-1)``."""
    lgt = torch.abs(lgt_sgs[..., -3:])
    mu = torch.linalg.norm(lgt, dim=-1, keepdim=True) + 1e-4
    return torch.var(lgt / mu, dim=-1, correction=1).mean() * 0.01


def query_indir_illum(lgt_sgs: torch.Tensor, sample_dirs: torch.Tensor) -> torch.Tensor:
    """Per-point SG sets along sample directions (loss.py:128-141):
    lgt_sgs [N, L, 7], sample_dirs [N, S, 3] -> [N, S, 3]."""
    lobes = lgt_sgs[..., :3] / torch.linalg.norm(lgt_sgs[..., :3], dim=-1, keepdim=True)
    lam = lgt_sgs[..., 3:4]
    mu = lgt_sgs[..., -3:]
    d = sample_dirs[:, :, None, :]
    rad = mu[:, None] * torch.exp(lam[:, None] * (
        torch.sum(d * lobes[:, None], -1, keepdim=True) - 1.0))
    return torch.sum(rad, dim=2)


@dataclasses.dataclass(frozen=True)
class IllumLossConfig:
    loss_type: str = "L1"


def illum_loss(cfg: IllumLossConfig, *, indirect_sgs, indir_integral, network_object_mask,
               trace_radiance, sample_dirs, gt_vis, pred_vis, indir_mask, gt_integral,
               anneal_t: float = 0.0, mesh: DataMesh | None = None):
    """(radiance_loss, visibility_loss) of IllumLoss.forward (loss.py:156-179).

    N rays, S secondary directions: indirect_sgs [N, L, 7], indir_integral
    [N, 3], network_object_mask [N] bool, trace_radiance [N, S, 3],
    sample_dirs [N, S, 3], gt_vis [N, S] bool (True: occluded, the ray
    hit), pred_vis [N, S, 2] logits, indir_mask [N, S] bool, gt_integral
    [N, 3]. The radiance loss sums the SG radiance term over the needed
    rays and the integral term over the surface pixels; the visibility
    loss is the cross-entropy over every direction of the surface pixels,
    label 1 (visible) where the ray did not hit. Under a ``mesh`` the three
    counts are every rank's (one all-reduce)."""
    if cfg.loss_type == "L1":
        err = lambda a, b: torch.abs(a - b)  # noqa: E731
    elif cfg.loss_type == "L2":
        err = lambda a, b: (a - b) ** 2  # noqa: E731
    else:
        raise ValueError(cfg.loss_type)
    pred_rad = query_indir_illum(indirect_sgs, sample_dirs)
    w = (indir_mask & network_object_mask[:, None]).to(pred_rad.dtype)[..., None]
    wi = network_object_mask.to(pred_rad.dtype)[:, None]
    labels = (~gt_vis).to(torch.int64)
    logp = torch.log_softmax(pred_vis, dim=-1)
    ce = -torch.gather(logp, -1, labels[..., None])[..., 0]
    wv = network_object_mask.to(ce.dtype)[:, None]
    n_w, n_wi, n_wv = global_sum(mesh, torch.sum(w), torch.sum(wi),
                                 torch.sum(wv * torch.ones_like(ce)))
    radiance = torch.sum(err(trace_radiance + anneal_t, pred_rad) * w) / torch.clamp(
        n_w * 3, min=1.0)
    integral = torch.sum(err(gt_integral, indir_integral) * wi) / torch.clamp(
        n_wi * 3, min=1.0)
    visibility = torch.sum(ce * wv) / torch.clamp(n_wv, min=1.0)
    return radiance + integral, visibility
