"""Stage-1 NeRF model family: VNeRF, MipNeRF, spherical harmonics
(counterpart of ``robir_tpu/fields/vnerf.py``).

The trunk is the NeRF architecture of ``fields/radiance.py:nerf_trunk``
(8 x 256 ReLU linears, the skip input concatenated after the activation at
``skips``, a density head and a view-dependent colour head); MipNeRF swaps
the positional encoding for the integrated encoding of the cone Gaussians.
Plain PyTorch: the JAX package leaves these nets to XLA, so they have no
kernel of their own. ``VNeRF`` is the ``nn.Module`` a trainer holds.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from .. import resolve_device
from ..core.params import from_jax
from .encoding import IPEConfig, PEConfig, integrated_pos_enc, positional_encoding
from .mlp import Params
from .radiance import init_nerf_mlp, nerf_trunk


@dataclasses.dataclass(frozen=True)
class VNeRFConfig:
    depth: int = 8
    width: int = 256
    multires: int = 10
    multires_view: int = 4
    skips: tuple[int, ...] = (4,)
    use_ipe: bool = False      # MipNeRF mode: encode (mean, cov) Gaussians
    ipe_max_deg: int = 16

    @property
    def pts_pe(self) -> PEConfig:
        return PEConfig(num_freqs=self.multires, input_dims=3)

    @property
    def ipe(self) -> IPEConfig:
        return IPEConfig(min_deg=0, max_deg=self.ipe_max_deg, input_dims=3)

    @property
    def view_pe(self) -> PEConfig:
        return PEConfig(num_freqs=self.multires_view, input_dims=3)

    @property
    def in_ch(self) -> int:
        return self.ipe.out_dim if self.use_ipe else self.pts_pe.out_dim


def init_vnerf(gen: torch.Generator, cfg: VNeRFConfig) -> Params:
    return init_nerf_mlp(gen, cfg.in_ch, cfg.view_pe.out_dim, cfg.width, cfg.depth,
                         cfg.skips, "density")


def _apply(params: Params, cfg: VNeRFConfig, enc: torch.Tensor, dirs: torch.Tensor,
           B: int, S: int):
    views_e = positional_encoding(dirs, cfg.view_pe)
    views_e = views_e[:, None, :].expand(B, S, views_e.shape[-1]).reshape(B * S, -1)
    density, rgb = nerf_trunk(params, cfg.depth, cfg.skips, enc, views_e, "density")
    return rgb.reshape(B, S, 3), density.reshape(B, S, 1)


def vnerf_apply(params: Params, cfg: VNeRFConfig, points: torch.Tensor,
                dirs: torch.Tensor):
    """points [B, S, 3], dirs [B, 3] -> (raw_rgb [B, S, 3], raw_density
    [B, S, 1]); the renderer applies the activations."""
    B, S, _ = points.shape
    return _apply(params, cfg, positional_encoding(points.reshape(-1, 3), cfg.pts_pe),
                  dirs, B, S)


def mipnerf_apply(params: Params, cfg: VNeRFConfig, means: torch.Tensor,
                  covs_diag: torch.Tensor, dirs: torch.Tensor):
    """The Gaussian-input variant (IMip.color_and_density_of_gaussian)."""
    B, S, _ = means.shape
    enc = integrated_pos_enc(means.reshape(-1, 3), covs_diag.reshape(-1, 3), cfg.ipe)
    return _apply(params, cfg, enc, dirs, B, S)


class VNeRF(nn.Module):
    """The parameter tree on a device (``cuda`` unless ``device="cpu"``)
    and ``__call__(means, covs, viewdirs)``, the model function of
    ``render/mip.py:render_mip``: MipNeRF on the Gaussians with
    ``use_ipe``, else VNeRF on their means."""

    def __init__(self, params: Params, cfg: VNeRFConfig, device="cuda"):
        super().__init__()
        self.cfg = cfg
        self.params = from_jax(params, resolve_device(device))

    def forward(self, means, covs, viewdirs):
        if self.cfg.use_ipe:
            return mipnerf_apply(self.params, self.cfg, means, covs, viewdirs)
        return vnerf_apply(self.params, self.cfg, means, viewdirs)


# ---------------------------------------------------------------------------
# Spherical harmonics (neus/misc/math.py:35-88)
# ---------------------------------------------------------------------------

_C0 = 0.28209479177387814
_C1 = 0.4886025119029199
_C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
       -1.0925484305920792, 0.5462742152960396)
_C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
       0.3731763325901154, -0.4570457994644658, 1.445305721320277,
       -0.5900435899266435)
_C4 = (2.5033429417967046, -1.7701307697799304, 0.9461746957575601,
       -0.6690465435572892, 0.10578554691520431, -0.6690465435572892,
       0.47308734787878004, -1.7701307697799304, 0.6258357354491761)


def eval_sh(deg: int, sh: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
    """SH basis colours: sh [..., C, (deg+1)^2], dirs [..., 3]."""
    assert 0 <= deg <= 4
    result = _C0 * sh[..., 0]
    if deg > 0:
        x, y, z = dirs[..., 0:1], dirs[..., 1:2], dirs[..., 2:3]
        result = (result - _C1 * y * sh[..., 1] + _C1 * z * sh[..., 2]
                  - _C1 * x * sh[..., 3])
        if deg > 1:
            xx, yy, zz = x * x, y * y, z * z
            xy, yz, xz = x * y, y * z, x * z
            result = (result + _C2[0] * xy * sh[..., 4]
                      + _C2[1] * yz * sh[..., 5]
                      + _C2[2] * (2.0 * zz - xx - yy) * sh[..., 6]
                      + _C2[3] * xz * sh[..., 7]
                      + _C2[4] * (xx - yy) * sh[..., 8])
            if deg > 2:
                result = (result + _C3[0] * y * (3 * xx - yy) * sh[..., 9]
                          + _C3[1] * xy * z * sh[..., 10]
                          + _C3[2] * y * (4 * zz - xx - yy) * sh[..., 11]
                          + _C3[3] * z * (2 * zz - 3 * xx - 3 * yy) * sh[..., 12]
                          + _C3[4] * x * (4 * zz - xx - yy) * sh[..., 13]
                          + _C3[5] * z * (xx - yy) * sh[..., 14]
                          + _C3[6] * x * (xx - 3 * yy) * sh[..., 15])
                if deg > 3:
                    result = (result
                              + _C4[0] * xy * (xx - yy) * sh[..., 16]
                              + _C4[1] * yz * (3 * xx - yy) * sh[..., 17]
                              + _C4[2] * xy * (7 * zz - 1) * sh[..., 18]
                              + _C4[3] * yz * (7 * zz - 3) * sh[..., 19]
                              + _C4[4] * (zz * (35 * zz - 30) + 3) * sh[..., 20]
                              + _C4[5] * xz * (7 * zz - 3) * sh[..., 21]
                              + _C4[6] * (xx - yy) * (7 * zz - 1) * sh[..., 22]
                              + _C4[7] * xz * (xx - 3 * yy) * sh[..., 23]
                              + _C4[8] * (xx * (xx - 3 * yy)
                                          - yy * (3 * xx - yy)) * sh[..., 24])
    return result
