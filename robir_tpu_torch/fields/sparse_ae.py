"""Sparse autoencoder: the latent-bottleneck material and normal heads
(counterpart of ``robir_tpu/fields/sparse_ae.py``).

512x4 LeakyReLU(0.2) encoder -> latent(32), 128x2 decoder; latent
activation sigmoid (or softplus for the indirect-integral head); the
smoothness pair comes from a perturbed latent (+0.01 N(0,1)) or a perturbed
input (+0.02 N(0,1)); the latent dropout mask ``var`` (CESR) multiplies
the raw latent by (1 - var). The perturbation's N(0,1) draw is an argument
(``noise``), shaped like the latent or the input.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from .mlp import Params, apply_linear, init_linear


@dataclasses.dataclass(frozen=True)
class SparseAEConfig:
    in_dim: int = 63
    out_dim: int = 5
    latent_dim: int = 32
    encoder_dims: tuple[int, ...] = (512, 512, 512, 512)
    decoder_dims: tuple[int, ...] = (128, 128)
    smooth_on_latent: bool = True
    out_act: Optional[str] = "sigmoid"   # None | 'sigmoid'
    lc_act: str = "sigmoid"              # 'sigmoid' | 'softplus'

    def noise_shape(self, n: int) -> tuple[int, int]:
        """Shape of the perturbation draw for ``n`` rows."""
        return (n, self.latent_dim if self.smooth_on_latent else self.in_dim)


def _leaky(x):
    return torch.nn.functional.leaky_relu(x, 0.2)


def init_sparse_ae(gen: torch.Generator, cfg: SparseAEConfig) -> Params:
    enc_dims = (cfg.in_dim,) + cfg.encoder_dims + (cfg.latent_dim,)
    dec_dims = (cfg.latent_dim,) + cfg.decoder_dims + (cfg.out_dim,)
    return {
        "encoder": {f"lin{i}": init_linear(gen, enc_dims[i], enc_dims[i + 1])
                    for i in range(len(enc_dims) - 1)},
        "decoder": {f"lin{i}": init_linear(gen, dec_dims[i], dec_dims[i + 1])
                    for i in range(len(dec_dims) - 1)},
    }


def _lc_act(cfg: SparseAEConfig, x):
    if cfg.lc_act == "sigmoid":
        return torch.sigmoid(x)
    if cfg.lc_act == "softplus":
        return torch.nn.functional.softplus(x)
    raise ValueError(cfg.lc_act)


def encode(params: Params, cfg: SparseAEConfig, x: torch.Tensor,
           var: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Raw (pre-activation) latent, with the dropout mask applied."""
    h = x
    n = len(cfg.encoder_dims) + 1
    for i in range(n):
        h = apply_linear(params["encoder"][f"lin{i}"], h)
        if i < n - 1:
            h = _leaky(h)
    if var is not None:
        h = h * (1.0 - var)
    return h


def decode(params: Params, cfg: SparseAEConfig, latent: torch.Tensor) -> torch.Tensor:
    h = latent
    n = len(cfg.decoder_dims) + 1
    for i in range(n):
        h = apply_linear(params["decoder"][f"lin{i}"], h)
        if i < n - 1:
            h = _leaky(h)
    return h


def sparse_ae_apply(params: Params, cfg: SparseAEConfig, x: torch.Tensor,
                    noise: Optional[torch.Tensor] = None,
                    var: Optional[torch.Tensor] = None
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """(out, out_xi): the decoded output and the smoothness-pair output from
    a perturbed latent or input. ``noise=None`` disables the perturbation
    (the pair equals the output)."""
    latent = _lc_act(cfg, encode(params, cfg, x, var))
    out = decode(params, cfg, latent)

    if noise is None:
        out_xi = out
    elif cfg.smooth_on_latent:
        out_xi = decode(params, cfg, latent + 0.01 * noise)
    else:
        rand_lc = _lc_act(cfg, encode(params, cfg, x + 0.02 * noise, var))
        out_xi = decode(params, cfg, rand_lc)

    if cfg.out_act == "sigmoid":
        out = torch.sigmoid(out)
        out_xi = torch.sigmoid(out_xi)
    return out, out_xi
