"""Radiance (rendering) MLP (counterpart of ``robir_tpu/fields/radiance.py``).

``idr`` mode: [points, PE(view dirs), normals, feature] -> ReLU trunk ->
sigmoid colour. A plain ``torch.matmul`` chain: the JAX package leaves this
net to XLA, so it has no kernel of its own. The NeRF background shell
(``nerf_bg_apply``) is not ported yet; ``configs/neus_blender.json`` runs
without it (``n_outside`` 0).
"""

from __future__ import annotations

import dataclasses

import torch

from .encoding import PEConfig, positional_encoding
from .mlp import Params, apply_linear, apply_linear_parts, init_linear


@dataclasses.dataclass(frozen=True)
class RenderingConfig:
    d_feature: int = 256
    mode: str = "idr"  # {no_view_dir, no_normal, idr} (+ 'raw' disables sigmoid)
    d_in: int = 9      # points(3) + viewdirs(3) + normals(3)
    d_out: int = 3
    d_hidden: int = 256
    n_layers: int = 4
    weight_norm: bool = True
    multires_view: int = 4
    squeeze_out: bool = True
    # bf16 inter-layer activation storage; outputs return fp32
    storage_dtype: str | None = None

    @property
    def effective_d_in(self) -> int:
        d = self.d_in
        if "no" in self.mode:
            d -= 3
        return d

    @property
    def view_pe(self) -> PEConfig:
        return PEConfig(num_freqs=self.multires_view, input_dims=3)

    @property
    def dims(self) -> tuple[int, ...]:
        d0 = self.effective_d_in + self.d_feature
        if self.multires_view > 0:
            d0 += self.view_pe.out_dim - 3
        return (d0,) + (self.d_hidden,) * self.n_layers + (self.d_out,)

    @property
    def use_sigmoid(self) -> bool:
        return self.squeeze_out and "raw" not in self.mode


def init_rendering(gen: torch.Generator, cfg: RenderingConfig) -> Params:
    dims = cfg.dims
    return {
        f"lin{i}": init_linear(gen, dims[i], dims[i + 1],
                               weight_norm=cfg.weight_norm)
        for i in range(len(dims) - 1)
    }


def rendering_apply(params: Params, cfg: RenderingConfig, points: torch.Tensor,
                    normals: torch.Tensor, view_dirs: torch.Tensor,
                    feature_vectors: torch.Tensor) -> torch.Tensor:
    if cfg.multires_view > 0:
        view_dirs = positional_encoding(view_dirs, cfg.view_pe)
    if "no_view_dir" in cfg.mode:
        small = torch.cat([points, normals], dim=-1)
    elif "no_normal" in cfg.mode:
        small = torch.cat([points, view_dirs], dim=-1)
    else:  # idr
        small = torch.cat([points, view_dirs, normals], dim=-1)
    # first layer as split matmuls over [small | feature], as the JAX package
    h = apply_linear_parts(params["lin0"], [small, feature_vectors],
                           storage_dtype=cfg.storage_dtype)
    n = len(cfg.dims)
    for i in range(1, n - 1):
        h = torch.relu(h)
        h = apply_linear(params[f"lin{i}"], h, storage_dtype=cfg.storage_dtype)
    h = h.float()
    if cfg.use_sigmoid:
        h = torch.sigmoid(h)
    return h
