"""NeRF positional encoding (counterpart of ``robir_tpu/fields/encoding.py``).

Feature layout is [x, sin(f0 x), cos(f0 x), sin(f1 x), ...] with
per-frequency 3-vectors interleaved sin-then-cos and log-spaced frequencies
2^0..2^(L-1), the JAX package's order; ``alpha`` eases the bands in one
at a time under ``cosine_easing_window`` (the nerfies schedule).
``integrated_pos_enc`` is the mip-NeRF encoding of a diagonal Gaussian (the
stage-2 normal head's input; ``ipe_isotropic`` at one variance).
``grid_embed`` is the learnable trilinear feature grid of
``neus/model/embedders.py`` (Grid, :107-124).
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class PEConfig:
    num_freqs: int = 10
    input_dims: int = 3
    include_input: bool = True
    log_sampling: bool = True

    @property
    def out_dim(self) -> int:
        d = self.input_dims if self.include_input else 0
        return d + 2 * self.num_freqs * self.input_dims


def pe_freq_bands(cfg: PEConfig) -> np.ndarray:
    max_freq = cfg.num_freqs - 1
    if cfg.log_sampling:
        return 2.0 ** np.linspace(0.0, max_freq, cfg.num_freqs)
    return np.linspace(2.0 ** 0.0, 2.0 ** max_freq, cfg.num_freqs)


def cosine_easing_window(num_bands: int, alpha) -> torch.Tensor:
    """The weight of each of ``num_bands`` frequency bands at window
    position ``alpha`` (0 .. num_bands): 0.5 (1 + cos(pi clip(alpha - i, 0,
    1) + pi)) for band i, so the bands ease in one at a time
    (``PE.cosine_easing_window``; ``robir_tpu/fields/encoding.py:69-74``)."""
    alpha = torch.as_tensor(alpha, dtype=torch.float32)
    bands = torch.linspace(0.0, num_bands - 1.0, num_bands, device=alpha.device)
    x = torch.clamp(alpha - bands, 0.0, 1.0)
    return 0.5 * (1 + torch.cos(np.pi * x + np.pi))


def positional_encoding(x: torch.Tensor, cfg: PEConfig, alpha=None) -> torch.Tensor:
    """NeRF positional encoding over the last axis, shape-polymorphic over
    the leading ones. ``alpha`` (a window position, 0 .. num_freqs) scales
    each band's (sin, cos) pair by ``cosine_easing_window``."""
    feats = [x] if cfg.include_input else []
    window = None if alpha is None else cosine_easing_window(cfg.num_freqs, alpha).to(x.device)
    for i, f in enumerate(pe_freq_bands(cfg)):
        xf = x * float(np.float32(f))
        s, c = torch.sin(xf), torch.cos(xf)
        if window is not None:
            s, c = s * window[i], c * window[i]
        feats.append(s)
        feats.append(c)
    return torch.cat(feats, dim=-1)


def positional_encoding_vjp(x: torch.Tensor, g: torch.Tensor,
                            cfg: PEConfig) -> torch.Tensor:
    """(d positional_encoding / d x)^T g: the cotangent of the encoded
    features ``g`` pulled back to the input ``x``. Written out (not taken
    from autograd) so that it stays an ordinary differentiable function of
    both ``x`` and ``g`` for the train step's second-order terms."""
    d = cfg.input_dims
    out = g[..., :d] if cfg.include_input else torch.zeros_like(x)
    off = d if cfg.include_input else 0
    for f in pe_freq_bands(cfg):
        ff = float(np.float32(f))
        xf = x * ff
        gs, gc = g[..., off:off + d], g[..., off + d:off + 2 * d]
        off += 2 * d
        out = out + (gs * torch.cos(xf) - gc * torch.sin(xf)) * ff
    return out


@dataclasses.dataclass(frozen=True)
class IPEConfig:
    min_deg: int = 0
    max_deg: int = 6
    input_dims: int = 3

    @property
    def out_dim(self) -> int:
        return 2 * (self.max_deg - self.min_deg) * self.input_dims


@functools.lru_cache(maxsize=None)
def _ipe_scales(min_deg: int, max_deg: int, dtype, device) -> torch.Tensor:
    """2^min_deg ... 2^(max_deg - 1), made once a device and dtype: a copy
    from the host cannot be captured in a CUDA graph."""
    return torch.tensor(2.0 ** np.arange(min_deg, max_deg), dtype=dtype, device=device)


def integrated_pos_enc(mean: torch.Tensor, var_diag: torch.Tensor,
                       cfg: IPEConfig) -> torch.Tensor:
    """IPE of a Gaussian with diagonal covariance: E[sin(f x)] under
    x ~ N(mu, sigma^2) = sin(f mu) exp(-f^2 sigma^2 / 2), the same
    attenuation for cos. Layout [sin(all scales), cos(all scales)], scales
    outer and coordinates inner."""
    scales = _ipe_scales(cfg.min_deg, cfg.max_deg, mean.dtype, mean.device)
    shape = mean.shape[:-1] + (len(scales) * cfg.input_dims,)
    y = (mean[..., None, :] * scales[:, None]).reshape(shape)
    y_var = (var_diag[..., None, :] * scales[:, None] ** 2).reshape(shape)
    atten = torch.exp(-0.5 * y_var)
    return torch.cat([atten * torch.sin(y), atten * torch.cos(y)], dim=-1)


def ipe_isotropic(x: torch.Tensor, cfg: IPEConfig, var: float = 0.005) -> torch.Tensor:
    """IPE at an isotropic covariance ``var`` (``neus/model/neus_fields.py``
    ``ipe_embedder``)."""
    return integrated_pos_enc(x, torch.full_like(x, var), cfg)


@dataclasses.dataclass(frozen=True)
class GridEmbedConfig:
    """A learnable [C, N, N, N] feature grid sampled trilinearly at coords
    in [-1, 1]."""
    n_cells: int = 128
    out_dim: int = 3

    @property
    def feature_dim(self) -> int:
        return self.out_dim


def init_grid_embed(gen: torch.Generator, cfg: GridEmbedConfig) -> dict:
    """``{"grid": N(0, 1) [C, N, N, N]}`` from a CPU generator."""
    return {"grid": torch.randn((cfg.out_dim,) + (cfg.n_cells,) * 3, generator=gen)}


def grid_embed(params: dict, cfg: GridEmbedConfig, x: torch.Tensor) -> torch.Tensor:
    """[..., 3] coords in [-1, 1] -> [..., out_dim] trilinear features:
    ``grid_sample`` with align_corners=False and zero padding outside, x
    walking the grid's last axis, as the reference samples it."""
    g = params["grid"]
    pts = x.reshape(1, -1, 1, 1, 3).to(g.dtype)
    out = torch.nn.functional.grid_sample(g[None], pts, mode="bilinear",
                                          padding_mode="zeros", align_corners=False)
    return out.reshape(cfg.out_dim, -1).t().reshape(x.shape[:-1] + (cfg.out_dim,))
