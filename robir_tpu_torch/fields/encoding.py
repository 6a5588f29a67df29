"""NeRF positional encoding (counterpart of ``robir_tpu/fields/encoding.py``).

Feature layout is [x, sin(f0 x), cos(f0 x), sin(f1 x), ...] with
per-frequency 3-vectors interleaved sin-then-cos and log-spaced frequencies
2^0..2^(L-1), the JAX package's order. ``integrated_pos_enc`` is the
mip-NeRF encoding of a diagonal Gaussian (the stage-2 normal head's input).
"""

from __future__ import annotations

import dataclasses

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


def positional_encoding(x: torch.Tensor, cfg: PEConfig) -> torch.Tensor:
    """NeRF positional encoding over the last axis, shape-polymorphic over
    the leading ones."""
    feats = [x] if cfg.include_input else []
    for f in pe_freq_bands(cfg):
        xf = x * float(np.float32(f))
        feats.append(torch.sin(xf))
        feats.append(torch.cos(xf))
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


def integrated_pos_enc(mean: torch.Tensor, var_diag: torch.Tensor,
                       cfg: IPEConfig) -> torch.Tensor:
    """IPE of a Gaussian with diagonal covariance: E[sin(f x)] under
    x ~ N(mu, sigma^2) = sin(f mu) exp(-f^2 sigma^2 / 2), the same
    attenuation for cos. Layout [sin(all scales), cos(all scales)], scales
    outer and coordinates inner."""
    scales = torch.tensor(2.0 ** np.arange(cfg.min_deg, cfg.max_deg),
                          dtype=mean.dtype, device=mean.device)
    shape = mean.shape[:-1] + (len(scales) * cfg.input_dims,)
    y = (mean[..., None, :] * scales[:, None]).reshape(shape)
    y_var = (var_diag[..., None, :] * scales[:, None] ** 2).reshape(shape)
    atten = torch.exp(-0.5 * y_var)
    return torch.cat([atten * torch.sin(y), atten * torch.cos(y)], dim=-1)
