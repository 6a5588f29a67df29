"""Mip-NeRF cone-cast renderer, the stage-1 alternate render mode
(counterpart of ``robir_tpu/render/mip.py``).

Conical-frustum Gaussians (``conical_frustum_to_gaussian``,
``lift_gaussian``), stratified sampling (``sample_along_rays``), blurpool
resampling over a sorted piecewise-constant PDF (``resample_along_rays``,
``sorted_piecewise_constant_pdf``: the intervals found by a masked max/min
over the cdf, as the JAX package finds them, not by ``searchsorted``),
density compositing (``density_process``), the ``sim``/``sdf``/``raw``
compositor family (``similarity_process``) and the n-level loop
(``render_mip``). Each level's stratified or inverse-CDF draw is a tensor
the caller hands in (``render_mip`` asks a ``Draws`` for ``mip_u<level>``,
[B, S + 1] each), so a test can give both packages the same numbers.

The ``sdf`` sub-mode takes an SDF model with ``grad``/``dev``/``radius``;
``NeuSSDF`` adapts a NeuS, whose ``grad`` is K3 (and K4 in the backward).
Plain PyTorch otherwise: the JAX package has no kernel here.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from ..core.draws import Draws
from .neus import Rays


def lift_gaussian(d, t_mean, t_var, r_var):
    """Lift a 1-D ray Gaussian to 3-D (diagonal covariance)."""
    mean = d[..., None, :] * t_mean[..., None]
    mag = torch.sum(d ** 2, dim=-1, keepdim=True)
    d_mag_sq = torch.clamp_min(mag, 1e-10)
    d_outer_diag = d ** 2
    null_outer_diag = 1 - d_outer_diag / d_mag_sq
    t_cov_diag = t_var[..., None] * d_outer_diag[..., None, :]
    xy_cov_diag = r_var[..., None] * null_outer_diag[..., None, :]
    return mean, t_cov_diag + xy_cov_diag


def conical_frustum_to_gaussian(d, t0, t1, base_radius):
    """Stable conical-frustum moments (mip_render.py:256-287)."""
    mu = (t0 + t1) / 2
    hw = (t1 - t0) / 2
    t_mean = mu + (2 * mu * hw ** 2) / (3 * mu ** 2 + hw ** 2)
    t_var = (hw ** 2) / 3 - (4 / 15) * ((hw ** 4 * (12 * mu ** 2 - hw ** 2))
                                        / (3 * mu ** 2 + hw ** 2) ** 2)
    r_var = base_radius ** 2 * ((mu ** 2) / 4 + (5 / 12) * hw ** 2
                                - 4 / 15 * (hw ** 4) / (3 * mu ** 2 + hw ** 2))
    return lift_gaussian(d, t_mean, t_var, r_var)


def cast_rays(t_vals, origins, directions, radii):
    t0, t1 = t_vals[..., :-1], t_vals[..., 1:]
    means, covs = conical_frustum_to_gaussian(directions, t0, t1, radii)
    return means + origins[..., None, :], covs


def sample_along_rays(t_rand: Optional[torch.Tensor], origins, directions, radii,
                      num_samples: int, near, far, lindisp: bool = False):
    """Stratified fencepost sampling (mip_render.py:311-350), jittered by
    ``t_rand`` [B, num_samples + 1] in [0, 1) where given (training)."""
    t_vals = torch.linspace(0.0, 1.0, num_samples + 1, device=origins.device,
                            dtype=origins.dtype)
    if lindisp:
        t_vals = 1.0 / (1.0 / near * (1.0 - t_vals) + 1.0 / far * t_vals)
    else:
        t_vals = near * (1.0 - t_vals) + far * t_vals
    if t_rand is not None:
        mids = 0.5 * (t_vals[..., 1:] + t_vals[..., :-1])
        upper = torch.cat([mids, t_vals[..., -1:]], -1)
        lower = torch.cat([t_vals[..., :1], mids], -1)
        t_vals = lower + (upper - lower) * t_rand
    else:
        t_vals = t_vals.expand(origins.shape[0], num_samples + 1)
    return t_vals, cast_rays(t_vals, origins, directions, radii)


def sorted_piecewise_constant_pdf(u_rand: Optional[torch.Tensor], bins, weights,
                                  num_samples: int):
    """Invert a piecewise-constant CDF over sorted bins
    (mip_render.py:353-416): stratified by ``u_rand`` [..., num_samples] in
    [0, 1) where given, else evenly spaced."""
    eps = 1e-5
    weight_sum = torch.sum(weights, dim=-1, keepdim=True)
    padding = torch.clamp_min(eps - weight_sum, 0.0)
    weights = weights + padding / weights.shape[-1]
    weight_sum = weight_sum + padding

    pdf = weights / weight_sum
    cdf = torch.clamp_max(torch.cumsum(pdf[..., :-1], dim=-1), 1.0)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf, torch.ones_like(cdf[..., :1])], -1)

    full_shape = cdf.shape[:-1] + (num_samples,)
    if u_rand is not None:
        s = 1 / num_samples
        u = torch.arange(num_samples, device=cdf.device, dtype=cdf.dtype) * s
        u = u + u_rand * (s - 1e-8)
        u = torch.clamp_max(u, 1.0 - 1e-8)
    else:
        u = torch.linspace(0.0, 1.0 - 1e-5, num_samples, device=cdf.device, dtype=cdf.dtype)
        u = u.expand(full_shape)

    mask = cdf[..., :, None] <= u[..., None, :]

    def find_interval(x):
        x0 = torch.where(mask, x[..., None], x[..., :1, None]).amax(-2)
        x1 = torch.where(~mask, x[..., None], x[..., -1:, None]).amin(-2)
        return x0, x1

    bins_g0, bins_g1 = find_interval(bins)
    cdf_g0, cdf_g1 = find_interval(cdf)
    t = torch.clamp(torch.nan_to_num((u - cdf_g0) / (cdf_g1 - cdf_g0), nan=0.0), 0, 1)
    return bins_g0 + t * (bins_g1 - bins_g0)


def resample_along_rays(u_rand: Optional[torch.Tensor], origins, directions, radii,
                        t_vals, weights, stop_grad: bool = True,
                        resample_padding: float = 0.01):
    """Blurpool + CDF resampling (mip_render.py:419-461)."""
    weights_pad = torch.cat([weights[..., :1], weights, weights[..., -1:]], -1)
    weights_max = torch.maximum(weights_pad[..., :-1], weights_pad[..., 1:])
    weights_blur = 0.5 * (weights_max[..., :-1] + weights_max[..., 1:])
    weights = weights_blur + resample_padding

    new_t_vals = sorted_piecewise_constant_pdf(u_rand, t_vals, weights, t_vals.shape[-1])
    if stop_grad:
        new_t_vals = new_t_vals.detach()
    return new_t_vals, cast_rays(new_t_vals, origins, directions, radii)


@dataclasses.dataclass(frozen=True)
class MipRenderConfig:
    n_levels: int = 2
    num_samples: int = 64
    resample_padding: float = 0.01
    rgb_padding: float = 0.001
    density_bias: float = -1.0
    density_activation: str = "softplus"  # softplus | relu
    white_bkgd: bool = True
    stop_level_grad: bool = True
    # 'mip' = density compositing; 'sim'/'sdf'/'raw' = similarity_process
    # sub-modes (mip_render.py:203)
    mode: str = "mip"


def _softplus(x):
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-x.abs()))


def density_process(raw_rgb, raw_density, t_vals, rays_d, cfg: MipRenderConfig):
    """Density compositing (mip_render.py:42-84)."""
    rgb = torch.sigmoid(raw_rgb)
    rgb = rgb * (1 + 2 * cfg.rgb_padding) - cfg.rgb_padding
    act = _softplus if cfg.density_activation == "softplus" else torch.relu
    density = act(raw_density + cfg.density_bias)

    t_mids = 0.5 * (t_vals[..., :-1] + t_vals[..., 1:])
    t_dists = t_vals[..., 1:] - t_vals[..., :-1]
    delta = t_dists * torch.linalg.norm(rays_d[..., None, :], dim=-1)
    density_delta = density[..., 0] * delta

    alpha = 1 - torch.exp(-density_delta)
    trans = torch.exp(-torch.cat([torch.zeros_like(density_delta[..., :1]),
                                  torch.cumsum(density_delta[..., :-1], dim=-1)], -1))
    weights = alpha * trans

    comp_rgb = torch.sum(weights[..., None] * rgb, dim=-2)
    acc = torch.sum(weights, dim=-1)
    distance = torch.sum(weights * t_mids, dim=-1) / acc
    distance = torch.nan_to_num(distance, nan=torch.inf)
    distance = torch.minimum(torch.maximum(distance, t_vals[:, 0]), t_vals[:, -1])
    if cfg.white_bkgd:
        comp_rgb = comp_rgb + (1.0 - acc[..., None])
    return {"rgb": comp_rgb, "dist": distance, "acc": acc,
            "weights": weights, "sim_or_grad": torch.ones_like(alpha)}


class NeuSSDF:
    """The ``sdf`` sub-mode's model over a NeuS: ``grad`` its sdf's spatial
    gradient (K3, K4 in the backward), ``dev`` its inverse deviation per
    point, ``radius`` its sphere."""

    def __init__(self, neus):
        self.neus = neus

    def grad(self, x: torch.Tensor) -> torch.Tensor:
        return self.neus.full_with_grad(x)[1]

    def dev(self, x: torch.Tensor) -> torch.Tensor:
        return self.neus.inv_s().expand(x.shape[0], 1)

    def radius(self) -> float:
        return self.neus.radius()


def similarity_process(raw_rgb, raw_density, means, t_vals, rays_d,
                       cfg: MipRenderConfig, mode: str = "sim", model=None,
                       cos_anneal_ratio: float = 1.0):
    """The reference's 'sim' compositor family (mip_render.py:87-198), on
    the raw density channel(s): 'sim' takes alpha from the cosine
    similarity of adjacent samples' features and colour from segment
    midpoints; 'sdf' composites NeuS-style section CDFs over an SDF channel
    with an eikonal term (``model``: grad/dev/radius; the anneal is the
    explicit ``cos_anneal_ratio``); any other mode the relu raw2alpha.
    Returns :func:`density_process`'s keys, the similarity (or the eikonal
    error) in ``sim_or_grad``."""
    rgb = torch.sigmoid(raw_rgb)
    dists = t_vals[..., 1:] - t_vals[..., :-1]
    dists = dists * torch.linalg.norm(rays_d[..., None, :], dim=-1)
    if raw_density.dim() == 3 and raw_density.shape[-1] == 1:
        raw_density = raw_density[..., 0]

    if "sim" in mode:
        sig = raw_density if raw_density.dim() == 3 else raw_density[..., None]
        a_sig, b_sig = sig[:, :-1], sig[:, 1:]
        sim = torch.sum(a_sig * b_sig, -1) / (
            torch.linalg.norm(a_sig, dim=-1) + 1e-3) / (
            torch.linalg.norm(b_sig, dim=-1) + 1e-3)
        sim = torch.cat([sim, sim[:, -1:]], 1)
        alpha = torch.relu(1.0 - torch.relu(sim + 0.5))
        rgb = (rgb[:, 1:] + rgb[:, :-1]) / 2.0
        rgb = torch.cat([rgb, rgb[:, -1:]], 1)
        sim_or_grad = sim
    elif "sdf" in mode:
        batch_size, n_samples = means.shape[0], means.shape[1]
        sdf = raw_density
        flat = means.reshape(-1, 3)
        gradients = model.grad(flat).reshape(batch_size, n_samples, 3)
        inv_s = model.dev(flat).reshape(batch_size, n_samples)
        dirs = rays_d[:, None, :].expand(means.shape)
        true_cos = torch.sum(dirs * gradients, -1)
        iter_cos = -(torch.relu(-true_cos * 0.5 + 0.5) * (1.0 - cos_anneal_ratio)
                     + torch.relu(-true_cos) * cos_anneal_ratio)
        est_next = sdf + iter_cos * dists * 0.5
        est_prev = sdf - iter_cos * dists * 0.5
        prev_cdf = torch.sigmoid(est_prev * inv_s)
        next_cdf = torch.sigmoid(est_next * inv_s)
        alpha = torch.clamp((prev_cdf - next_cdf + 1e-5) / (prev_cdf + 1e-5), 0.0, 1.0)
        pts_norm = torch.linalg.norm(means, dim=-1)
        radius = model.radius()
        inside = (pts_norm < radius).to(alpha.dtype).detach()
        relax_inside = (pts_norm < radius * 1.2).to(alpha.dtype).detach()
        alpha = alpha * inside
        grad_norm = torch.sqrt(torch.sum(gradients ** 2, dim=-1) + 1e-12)
        sim_or_grad = torch.sum(relax_inside * (grad_norm - 1.0) ** 2) / (
            torch.sum(relax_inside) + 1e-5)
    else:
        alpha = 1.0 - torch.exp(-torch.relu(raw_density) * dists)
        sim_or_grad = torch.ones_like(alpha)

    ones = torch.ones_like(alpha[:, :1])
    trans = torch.cumprod(torch.cat([ones, 1.0 - alpha + 1e-10], -1), -1)
    weights = alpha * trans[:, :-1]
    rgb_map = torch.sum(weights[..., None] * rgb, -2)
    mid_z = (t_vals[:, 1:] + t_vals[:, :-1]) / 2.0
    depth_map = torch.sum(weights * mid_z, -1)
    acc_map = torch.sum(weights, -1)
    if cfg.white_bkgd:
        rgb_map = rgb_map + (1.0 - acc_map[..., None])
    return {"rgb": rgb_map, "dist": depth_map, "acc": acc_map,
            "weights": weights, "sim_or_grad": sim_or_grad}


# model_fn(means [B,S,3], covs_diag [B,S,3], viewdirs [B,3]) -> (raw_rgb, raw_density)
MipModelFn = Callable[[torch.Tensor, torch.Tensor, torch.Tensor],
                      tuple[torch.Tensor, torch.Tensor]]


def render_mip(draws: Optional[Draws], rays: Rays, model_fn: MipModelFn,
               cfg: MipRenderConfig = MipRenderConfig(), is_eval: bool = False,
               model=None, cos_anneal_ratio: float = 1.0) -> list[dict]:
    """The n-level coarse-to-fine loop (mip_render.py:201-226); returns the
    per-level outputs, the fine render last. In training each level asks
    ``draws`` for ``mip_u<level>`` [B, num_samples + 1]; ``is_eval`` takes
    none. ``cfg.mode`` 'mip' composites densities, any other value runs
    :func:`similarity_process` in that sub-mode ('sdf' needs ``model``)."""
    batch = rays.origins.shape[0]
    ret = []
    t_vals = weights = None
    for level in range(cfg.n_levels):
        u = (None if is_eval
             else draws.uniform(f"mip_u{level}", (batch, cfg.num_samples + 1), rows=True))
        if level == 0:
            t_vals, (means, covs) = sample_along_rays(
                u, rays.origins, rays.directions, rays.radii, cfg.num_samples,
                rays.near, rays.far)
        else:
            t_vals, (means, covs) = resample_along_rays(
                u, rays.origins, rays.directions, rays.radii, t_vals, weights,
                cfg.stop_level_grad, cfg.resample_padding)
        raw_rgb, raw_density = model_fn(means, covs, rays.viewdirs)
        if cfg.mode == "mip":
            out = density_process(raw_rgb, raw_density, t_vals, rays.directions, cfg)
        else:
            out = similarity_process(raw_rgb, raw_density, means, t_vals, rays.directions,
                                     cfg, mode=cfg.mode, model=model,
                                     cos_anneal_ratio=cos_anneal_ratio)
        out["means"] = means
        weights = out["weights"]
        ret.append(out)
    return ret
