"""NeuS SDF volume renderer: hierarchical importance sampling + sigmoid-CDF
alpha compositing (counterpart of ``robir_tpu/render/neus.py``).

The sampling phase (``sample_z_vals``) runs under ``torch.no_grad`` (the
JAX package wraps it in ``stop_gradient``) and queries the SDF through K1;
``render_samples`` shades those samples, and its ``render_core`` queries
value + spatial gradient through K3, whose backward is K4. Noise
(``t_rand`` for the stratified jitter, ``u`` for stochastic inverse-CDF
draws) can be handed in as tensors, so a test can feed both packages the
same numbers; when absent it is drawn from a ``torch.Generator``.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from ..fields.neus_model import NeuS


class Rays(NamedTuple):
    origins: torch.Tensor      # [N, 3]
    directions: torch.Tensor   # [N, 3]
    viewdirs: torch.Tensor     # [N, 3]
    radii: torch.Tensor        # [N, 1]
    lossmult: torch.Tensor     # [N, 1]
    near: torch.Tensor         # [N, 1]
    far: torch.Tensor          # [N, 1]


@dataclasses.dataclass(frozen=True)
class NeusRenderConfig:
    n_samples: int = 64
    n_importance: int = 64
    n_outside: int = 0
    up_sample_steps: int = 4
    white_bkgd: bool = True
    perturb: float = 1.0
    # the JAX package's low-precision sampling-phase option; the port's
    # sampling phase always runs the fp32 kernel
    sampling_dtype: str | None = None

    def __post_init__(self):
        if self.n_outside > 0:
            raise NotImplementedError("n_outside > 0 needs the NeRF background "
                                      "shell, which is not ported yet")
        if self.sampling_dtype is not None:
            raise NotImplementedError("sampling_dtype is not supported by the "
                                      "port's fp32 sampling kernel")


def sample_pdf(bins: torch.Tensor, weights: torch.Tensor, n_samples: int,
               det: bool = False, u: Optional[torch.Tensor] = None,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Inverse-CDF sampling. bins [B, T], weights [B, T-1] -> [B, n_samples].
    Stochastic draws use ``u`` [B, n_samples] if given, else ``generator``."""
    weights = weights + 1e-5
    pdf = weights / torch.sum(weights, -1, keepdim=True)
    cdf = torch.cumsum(pdf, -1)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], -1)  # [B, T]
    B, _ = cdf.shape

    if det:
        u = torch.linspace(0.5 / n_samples, 1.0 - 0.5 / n_samples, n_samples,
                           device=cdf.device, dtype=cdf.dtype)
        u = u.expand(B, n_samples)
    elif u is None:
        u = torch.rand((B, n_samples), generator=generator,
                       device=cdf.device, dtype=cdf.dtype)

    # searchsorted(side="right") bracket lookups as masked max/min over the
    # ascending cdf and bins rows, as the JAX package computes them
    mask_le = cdf[:, None, :] <= u[:, :, None]                    # [B, n, T]
    cdf_b = cdf[:, None, :].expand(mask_le.shape)
    bins_b = bins[:, None, :].expand(mask_le.shape)
    ninf = torch.tensor(-torch.inf, device=cdf.device, dtype=cdf.dtype)
    pinf = torch.tensor(torch.inf, device=cdf.device, dtype=cdf.dtype)
    cdf_below = torch.where(mask_le, cdf_b, ninf).amax(-1)
    bins_below = torch.where(mask_le, bins_b, ninf).amax(-1)
    cdf_above = torch.where(mask_le, pinf, cdf_b).amin(-1)
    bins_above = torch.where(mask_le, pinf, bins_b).amin(-1)
    cdf_below = torch.where(torch.isfinite(cdf_below), cdf_below, cdf[:, :1])
    bins_below = torch.where(torch.isfinite(bins_below), bins_below, bins[:, :1])
    cdf_above = torch.where(torch.isfinite(cdf_above), cdf_above, cdf[:, -1:])
    bins_above = torch.where(torch.isfinite(bins_above), bins_above, bins[:, -1:])
    denom = cdf_above - cdf_below
    denom = torch.where(denom < 1e-5, torch.ones_like(denom), denom)
    t = (u - cdf_below) / denom
    return bins_below + t * (bins_above - bins_below)


def _cumprod_trans(alpha: torch.Tensor) -> torch.Tensor:
    ones = torch.ones_like(alpha[:, :1])
    return torch.cumprod(torch.cat([ones, 1.0 - alpha + 1e-7], -1), -1)[:, :-1]


def up_sample(rays_o, rays_d, z_vals, sdf, n_importance, inv_s,
              sphere_radius=1.0):
    """One round of NeuS importance sampling at fixed inv_s."""
    batch_size, n_samples = z_vals.shape
    pts = rays_o[:, None, :] + rays_d[:, None, :] * z_vals[..., :, None]
    radius = torch.linalg.norm(pts, dim=-1)
    inside_sphere = (radius[:, :-1] < sphere_radius) | (radius[:, 1:] < sphere_radius)
    sdf = sdf.reshape(batch_size, n_samples)
    prev_sdf, next_sdf = sdf[:, :-1], sdf[:, 1:]
    prev_z, next_z = z_vals[:, :-1], z_vals[:, 1:]
    mid_sdf = (prev_sdf + next_sdf) * 0.5
    cos_val = (next_sdf - prev_sdf) / (next_z - prev_z + 1e-5)

    prev_cos = torch.cat([torch.zeros_like(cos_val[:, :1]), cos_val[:, :-1]], -1)
    cos_val = torch.minimum(prev_cos, cos_val)
    cos_val = torch.clamp(cos_val, -1e3, 0.0) * inside_sphere

    dist = next_z - prev_z
    prev_esti = mid_sdf - cos_val * dist * 0.5
    next_esti = mid_sdf + cos_val * dist * 0.5
    prev_cdf = torch.sigmoid(prev_esti * inv_s)
    next_cdf = torch.sigmoid(next_esti * inv_s)
    alpha = (prev_cdf - next_cdf + 1e-5) / (prev_cdf + 1e-5)
    weights = alpha * _cumprod_trans(alpha)
    return sample_pdf(z_vals, weights, n_importance, det=True)


def merge_sorted(a, b, vals_a=None, vals_b=None):
    """Merge row-wise sorted [B, n1] and [B, n2] into sorted [B, n1+n2],
    carrying optional per-element values along. Ties keep ``a`` first
    (argsort-stable order): each element's merged position is its own index
    plus a comparison count against the other row, and a scatter places it."""
    B, n1 = a.shape
    n2 = b.shape[1]
    rank_a = (torch.arange(n1, device=a.device)[None, :]
              + (b[:, None, :] < a[:, :, None]).sum(-1))
    rank_b = (torch.arange(n2, device=a.device)[None, :]
              + (a[:, None, :] <= b[:, :, None]).sum(-1))

    def scatter(xa, xb):
        out = xa.new_empty((B, n1 + n2))
        out.scatter_(1, rank_a, xa)
        out.scatter_(1, rank_b, xb)
        return out

    merged = scatter(a, b)
    if vals_a is None:
        return merged
    return merged, scatter(vals_a, vals_b)


def cat_z_vals(model: NeuS, rays_o, rays_d, z_vals, new_z_vals, sdf,
               last: bool):
    """Merge sample positions, querying the SDF at the new ones (K1)."""
    batch_size, _ = z_vals.shape
    _, n_importance = new_z_vals.shape
    if last:
        return merge_sorted(z_vals, new_z_vals), sdf
    pts = rays_o[:, None, :] + rays_d[:, None, :] * new_z_vals[..., :, None]
    new_sdf = model.sdf(pts.reshape(-1, 3)).reshape(batch_size, n_importance)
    return merge_sorted(z_vals, new_z_vals, sdf, new_sdf)


def render_core(rays_o, rays_d, z_vals, sample_dist, model: NeuS,
                background_rgb=None, cos_anneal_ratio=0.0):
    """Core NeuS compositing; the SDF value + gradient go through K3/K4."""
    batch_size, n_samples = z_vals.shape
    dists = torch.cat([z_vals[..., 1:] - z_vals[..., :-1],
                       torch.full_like(z_vals[:, :1], sample_dist)], -1)
    mid_z = z_vals + dists * 0.5
    pts = (rays_o[:, None, :] + rays_d[:, None, :] * mid_z[..., :, None]).reshape(-1, 3)
    dirs = rays_d[:, None, :].expand(batch_size, n_samples, 3).reshape(-1, 3)

    sdf_full, gradients = model.full_with_grad(pts)
    sdf, feature = sdf_full[..., :1], sdf_full[..., 1:]
    sampled_color = model.color(pts, gradients, dirs, feature).reshape(
        batch_size, n_samples, 3)

    inv_s = model.inv_s()

    true_cos = torch.sum(dirs * gradients, -1, keepdim=True)
    # anneal keeps cos "not dead" early in training
    iter_cos = -(torch.relu(-true_cos * 0.5 + 0.5) * (1.0 - cos_anneal_ratio)
                 + torch.relu(-true_cos) * cos_anneal_ratio)

    est_next = sdf + iter_cos * dists.reshape(-1, 1) * 0.5
    est_prev = sdf - iter_cos * dists.reshape(-1, 1) * 0.5
    prev_cdf = torch.sigmoid(est_prev * inv_s)
    next_cdf = torch.sigmoid(est_next * inv_s)
    alpha = torch.clamp(((prev_cdf - next_cdf + 1e-5) / (prev_cdf + 1e-5)
                         ).reshape(batch_size, n_samples), 0.0, 1.0)

    pts_norm = torch.linalg.norm(pts, dim=-1).reshape(batch_size, n_samples)
    radius = model.radius()
    inside_sphere = (pts_norm < radius).to(alpha.dtype).detach()
    relax_inside = (pts_norm < radius * 1.2).to(alpha.dtype).detach()

    alpha = alpha * inside_sphere
    weights = alpha * _cumprod_trans(alpha)
    weights_sum = torch.sum(weights, -1, keepdim=True)
    color = torch.sum(sampled_color * weights[:, :, None], dim=1)
    if background_rgb is not None:
        color = color + background_rgb * (1.0 - weights_sum)

    grad_norm = torch.sqrt(torch.sum(
        gradients.reshape(batch_size, n_samples, 3) ** 2, dim=-1) + 1e-12)
    gradient_error = torch.sum(relax_inside * (grad_norm - 1.0) ** 2) / (
        torch.sum(relax_inside) + 1e-5)

    return {
        "color": color,
        "sdf": sdf,
        "dists": dists,
        "gradients": gradients.reshape(batch_size, n_samples, 3),
        "s_val": 1.0 / inv_s,
        "mid_z_vals": mid_z,
        "weights": weights,
        "cdf": prev_cdf.reshape(batch_size, n_samples),
        "gradient_error": gradient_error,
        "inside_sphere": inside_sphere,
    }


def sample_z_vals(rays: Rays, model: NeuS, cfg: NeusRenderConfig,
                  is_eval: bool = False, t_rand: Optional[torch.Tensor] = None,
                  generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """The sample positions along each ray, [B, n_samples + n_importance],
    without gradients: stratified (with perturbation, jittered by ``t_rand``
    [B, 1] in [-0.5, 0.5) if given, else drawn from ``generator``), then the
    importance rounds, which query the SDF through K1."""
    perturb = 0.0 if is_eval else cfg.perturb
    rays_o, rays_d = rays.origins, rays.directions
    near, far = rays.near, rays.far
    batch_size = rays_o.shape[0]
    z_vals = torch.linspace(0.0, 1.0, cfg.n_samples, device=rays_o.device,
                            dtype=rays_o.dtype)[None, :]
    z_vals = near + (far - near) * z_vals

    if perturb > 0:
        if t_rand is None:
            t_rand = torch.rand((batch_size, 1), generator=generator,
                                device=rays_o.device) - 0.5
        z_vals = z_vals + t_rand * 2.0 / cfg.n_samples

    # importance sampling (no grad, like the reference's torch.no_grad block)
    if cfg.n_importance > 0:
        with torch.no_grad():
            z_vals = z_vals.detach()
            pts = rays_o[:, None, :] + rays_d[:, None, :] * z_vals[..., :, None]
            sdf = model.sdf(pts.reshape(-1, 3)).reshape(batch_size, cfg.n_samples)
            for i in range(cfg.up_sample_steps):
                new_z = up_sample(rays_o, rays_d, z_vals, sdf,
                                  cfg.n_importance // cfg.up_sample_steps,
                                  64 * 2 ** i, model.radius())
                z_vals, sdf = cat_z_vals(model, rays_o, rays_d, z_vals, new_z,
                                         sdf, last=(i + 1 == cfg.up_sample_steps))
    return z_vals


def render_samples(rays: Rays, z_vals: torch.Tensor, model: NeuS,
                   cos_anneal_ratio, cfg: NeusRenderConfig) -> dict:
    """Shade and composite the given sample positions (``render_core``):
    the part of ``render_neus`` that gradients flow through."""
    rays_o, rays_d = rays.origins, rays.directions
    near, far = rays.near, rays.far
    background_rgb = (torch.ones((1, 3), device=rays_o.device)
                      if cfg.white_bkgd else None)
    ret_fine = render_core(rays_o, rays_d, z_vals, 2.0 / cfg.n_samples, model,
                           background_rgb=background_rgb,
                           cos_anneal_ratio=cos_anneal_ratio)

    weights = ret_fine["weights"]
    acc = torch.sum(weights, dim=-1)
    z_mids = ret_fine["mid_z_vals"]
    distance = torch.sum(weights[..., :128] * z_mids, dim=-1) / acc
    distance = torch.nan_to_num(distance, nan=torch.inf)
    distance = torch.minimum(torch.maximum(distance, near.squeeze(-1)),
                             far.squeeze(-1))
    return {
        "rgb": ret_fine["color"],
        "dist": distance,
        "acc": acc,
        "gradient_error": ret_fine["gradient_error"],
        "weights": weights,
        "means": z_mids,
        "s_val": ret_fine["s_val"],
    }


def render_neus(rays: Rays, model: NeuS, cos_anneal_ratio,
                cfg: NeusRenderConfig = NeusRenderConfig(),
                is_eval: bool = False, t_rand: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> dict:
    """Top-level NeuS render: ``sample_z_vals`` (which takes the noise),
    then ``render_samples``."""
    z_vals = sample_z_vals(rays, model, cfg, is_eval, t_rand, generator)
    return render_samples(rays, z_vals, model, cos_anneal_ratio, cfg)
