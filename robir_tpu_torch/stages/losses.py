"""Stage-2 losses of the Material stages (counterpart of
``robir_tpu/stages/losses.py``, the reference's ``model/loss.py``
InvLoss, and of ``robir_tpu/stages/pbr.py:white_loss``). Boolean-indexed
reductions are mask-weighted dense sums with the reference's normalisers.

Not ported yet: eikonal, mask, normal-consistency and the Vis stage's
IllumLoss.
"""

from __future__ import annotations

import dataclasses

import torch

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


def rgb_loss(cfg: InvLossConfig, rgb_pred, rgb_gt, mask) -> torch.Tensor:
    """Masked image loss / n_rays (loss.py:31-42); mask [N] bool."""
    diff = rgb_pred - rgb_gt.reshape(-1, 3)
    if cfg.loss_type == "L1":
        err = torch.abs(diff)
    elif cfg.loss_type == "L2":
        err = diff ** 2
    else:
        raise ValueError(cfg.loss_type)
    return torch.sum(err * mask[:, None]) / rgb_pred.shape[0]


def latent_smooth_loss(diffuse_albedo, roughness, xi_diffuse, xi_roughness):
    """L1(albedo pair) + 0.2 * L1(roughness pair) (loss.py:61-67)."""
    return (torch.mean(torch.abs(diffuse_albedo - xi_diffuse))
            + torch.mean(torch.abs(roughness[..., 0] - xi_roughness[..., 0])) * 0.2)


def masked_spec_kl(envmap_params, envmap_cfg, points, mask, var=None,
                   rho: float = 0.05) -> torch.Tensor:
    """Bernoulli KL sparsity of the spec-BRDF encoder's latents at surface
    points (loss.py:85-95 on points[network_object_mask]), as a
    mask-weighted batch mean."""
    latent = ae_encode(envmap_params["spec_brdf_encoder_layer"],
                       envmap_cfg.spec_brdf_ae,
                       positional_encoding(points, envmap_cfg.pe), var=var)
    w = mask.to(torch.float32)[:, None]
    rho_hat = torch.sum(torch.sigmoid(latent) * w, 0) / torch.clamp(torch.sum(w), min=1.0)
    return torch.mean(rho * torch.log(rho / (rho_hat + 1e-4)) + (1 - rho)
                      * torch.log((1 - rho) / (1 - rho_hat + 1e-4)))


def white_loss(lgt_sgs: torch.Tensor) -> torch.Tensor:
    """Chromaticity variance of the SG amplitudes (train_pbr.py:313-316),
    unbiased over the 3 channels as torch ``.var(-1)``."""
    lgt = torch.abs(lgt_sgs[..., -3:])
    mu = torch.linalg.norm(lgt, dim=-1, keepdim=True) + 1e-4
    return torch.var(lgt / mu, dim=-1, correction=1).mean() * 0.01
