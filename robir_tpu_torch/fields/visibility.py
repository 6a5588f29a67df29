"""Visibility classifier and the indirect-illumination SG field
(counterpart of ``robir_tpu/fields/visibility.py``).

- ``visnet_apply``: (PE(x), PE(w)) -> 2 logits (occluded, visible), a ReLU
  MLP; ``visnet_outer_apply`` is the same net on the outer product of N
  points and K directions without forming the [N, K, .] input: the first
  layer splits into point rows and direction rows. With
  ``storage_dtype="bfloat16"`` (``configs/hotdog.json``) every layer's
  operands and output are bf16, as in the JAX package; logits return fp32.
  ``compute_dtype`` (bf16) rounds the operands only and sums in fp32
  (``apply_linear``); storage wins where both are set, as in the JAX
  package, so at ``hotdog.json`` it changes nothing.
- ``indirect_apply``: PE(x) (+ hdr shift) -> 24 SG lobes (theta/phi by
  sigmoid, lambda = sigmoid * 30 + 0.1, mu = relu) and the indirect
  integral from a softplus-latent SparseAE; the reference uses that AE's
  perturbed-input output, so its N(0,1) draw ``noise`` ([N, in_dim]) is
  part of the forward.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .encoding import PEConfig, positional_encoding
from .mlp import (Params, _store, apply_linear, effective_weight, init_linear,
                  low_precision_mm)
from .sparse_ae import SparseAEConfig, init_sparse_ae, sparse_ae_apply


@dataclasses.dataclass(frozen=True)
class VisNetConfig:
    points_multires: int = 10
    dirs_multires: int = 4
    dims: tuple[int, ...] = (128, 128, 128, 128)
    storage_dtype: str | None = None

    @property
    def p_pe(self) -> PEConfig:
        return PEConfig(num_freqs=self.points_multires, input_dims=3)

    @property
    def d_pe(self) -> PEConfig:
        return PEConfig(num_freqs=self.dirs_multires, input_dims=3)


def init_visnet(gen: torch.Generator, cfg: VisNetConfig) -> Params:
    dims = (cfg.p_pe.out_dim + cfg.d_pe.out_dim,) + cfg.dims + (2,)
    return {f"lin{i}": init_linear(gen, dims[i], dims[i + 1])
            for i in range(len(dims) - 1)}


def _relu_trunk(params: Params, cfg: VisNetConfig, h: torch.Tensor, first: int,
                compute_dtype=None):
    n = len(cfg.dims) + 1
    for i in range(first, n):
        h = apply_linear(params[f"lin{i}"], h, cfg.storage_dtype, compute_dtype)
        if i < n - 1:
            h = torch.relu(h)
    return h.to(torch.float32)


def visnet_apply(params: Params, cfg: VisNetConfig, points: torch.Tensor,
                 view_dirs: torch.Tensor, compute_dtype=None) -> torch.Tensor:
    """[..., 3], [..., 3] -> [..., 2] fp32 logits; ``compute_dtype`` as in
    the module's docstring."""
    h = torch.cat([positional_encoding(points, cfg.p_pe),
                   positional_encoding(view_dirs, cfg.d_pe)], dim=-1)
    return _relu_trunk(params, cfg, h, 0, compute_dtype)


def visnet_outer_apply(params: Params, cfg: VisNetConfig, points: torch.Tensor,
                       dirs: torch.Tensor, compute_dtype=None) -> torch.Tensor:
    """Points [N, 3] x dirs [K, 3] -> logits [N, K, 2]: the first layer on
    N + K rows, nothing of size [N, K] until its output. Its operands are
    in the storage dtype, else ``compute_dtype``, and it sums in that dtype
    only under storage (fp32 otherwise), as the JAX package does."""
    p = positional_encoding(points, cfg.p_pe)
    d = positional_encoding(dirs, cfg.d_pe)
    w0 = effective_weight(params["lin0"])
    b0 = params["lin0"]["b"]
    wp, wd = w0[:p.shape[-1]], w0[p.shape[-1]:]
    store = _store(cfg.storage_dtype)
    compute = _store(compute_dtype)
    if store is not None:
        p, wp, d, wd, b0 = (t.to(store) for t in (p, wp, d, wd, b0))
        hp, hd = p @ wp, d @ wd
    elif compute is not None:
        hp, hd = low_precision_mm(p, wp, compute), low_precision_mm(d, wd, compute)
    else:
        hp, hd = p @ wp, d @ wd
    h = torch.relu(hp[:, None, :] + (hd + b0)[None, :, :])
    return _relu_trunk(params, cfg, h, 1, compute_dtype)


@dataclasses.dataclass(frozen=True)
class IndirIllumConfig:
    multires: int = 10
    dims: tuple[int, ...] = (128, 128, 128, 128)
    num_lgt_sgs: int = 24
    use_hdr: bool = True

    @property
    def pe(self) -> PEConfig:
        return PEConfig(num_freqs=self.multires, input_dims=3)

    @property
    def in_dim(self) -> int:
        return self.pe.out_dim + (1 if self.use_hdr else 0)

    @property
    def integral_ae(self) -> SparseAEConfig:
        return SparseAEConfig(in_dim=self.in_dim, out_dim=3, out_act=None,
                              smooth_on_latent=False, lc_act="softplus")


def init_indirect(gen: torch.Generator, cfg: IndirIllumConfig) -> Params:
    dims = (cfg.in_dim,) + cfg.dims + (cfg.num_lgt_sgs * 6,)
    return {
        "lobe_layer": {f"lin{i}": init_linear(gen, dims[i], dims[i + 1])
                       for i in range(len(dims) - 1)},
        "integral_layer": init_sparse_ae(gen, cfg.integral_ae),
    }


def indirect_apply(params: Params, cfg: IndirIllumConfig, points: torch.Tensor,
                   hdr_shift: Optional[torch.Tensor] = None,
                   noise: Optional[torch.Tensor] = None
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """[N, 3] (, [N, 1]) -> (lgt_sgs [N, M, 7], env_int [N, 3])."""
    x = positional_encoding(points, cfg.pe)
    if cfg.use_hdr:
        x = torch.cat([x, hdr_shift], dim=-1)
    h = x
    n = len(cfg.dims) + 1
    for i in range(n):
        h = apply_linear(params["lobe_layer"][f"lin{i}"], h)
        if i < n - 1:
            h = torch.relu(h)
    out = h.reshape(points.shape[0], cfg.num_lgt_sgs, 6)

    tp = torch.sigmoid(out[..., :2])
    theta = tp[..., :1] * 2 * np.pi
    phi = tp[..., 1:2] * np.pi
    lobes = torch.cat([torch.cos(theta) * torch.sin(phi),
                       torch.sin(theta) * torch.sin(phi),
                       torch.cos(phi)], dim=-1)
    lam = torch.sigmoid(out[..., 2:3]) * 30 + 0.1
    mu = torch.relu(out[..., 3:])
    _, env_int = sparse_ae_apply(params["integral_layer"], cfg.integral_ae, x, noise)
    return torch.cat([lobes, lam, mu], dim=-1), torch.abs(env_int)
