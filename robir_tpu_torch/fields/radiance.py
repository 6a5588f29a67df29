"""Radiance (rendering) MLP and the NeRF background shell (counterpart of
``robir_tpu/fields/radiance.py``).

``idr`` mode: [points, PE(view dirs), normals, feature] -> ReLU trunk ->
sigmoid colour. ``nerf_bg_apply`` is the NeRF++ outer shell on the 4-D
inverted-sphere points [x/r, 1/r]: a ReLU trunk with the skip input
appended *after* the activation at ``skips``, then density and a
view-dependent colour head (``nerf_trunk``, shared with the stage-1 VNeRF,
``fields/vnerf.py``). Plain ``torch.matmul`` chains: the JAX package
leaves these nets to XLA, so they have no kernel of their own.
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
    if cfg.storage_dtype is not None:
        h = h.float()
    if cfg.use_sigmoid:
        h = torch.sigmoid(h)
    return h


# ---------------------------------------------------------------------------
# NeRF background (NeRF++ outer shell)
# ---------------------------------------------------------------------------


def init_nerf_mlp(gen: torch.Generator, in_ch: int, in_ch_view: int, width: int,
                  depth: int, skips: tuple[int, ...], density_key: str) -> Params:
    """The NeRF trunk's tree in the JAX package's order: ``pts_lin*``,
    ``views_lin0``, ``feature``, the density head (``density_key``), ``rgb``."""
    params: Params = {"pts_lin0": init_linear(gen, in_ch, width)}
    for i in range(depth - 1):
        d_in = width + in_ch if i in skips else width
        params[f"pts_lin{i + 1}"] = init_linear(gen, d_in, width)
    params["views_lin0"] = init_linear(gen, in_ch_view + width, width // 2)
    params["feature"] = init_linear(gen, width, width)
    params[density_key] = init_linear(gen, width, 1)
    params["rgb"] = init_linear(gen, width // 2, 3)
    return params


def nerf_trunk(params: Params, depth: int, skips: tuple[int, ...], enc: torch.Tensor,
               views_e: torch.Tensor, density_key: str):
    """(density [N, 1], rgb [N, 3]) of the NeRF trunk on encoded points and
    view directions; the skip input is concatenated after the activation."""
    h = enc
    for i in range(depth):
        h = torch.relu(apply_linear(params[f"pts_lin{i}"], h))
        if i in skips:
            h = torch.cat([enc, h], dim=-1)
    density = apply_linear(params[density_key], h)
    feature = apply_linear(params["feature"], h)
    h = torch.relu(apply_linear(params["views_lin0"], torch.cat([feature, views_e], dim=-1)))
    return density, apply_linear(params["rgb"], h)


@dataclasses.dataclass(frozen=True)
class NeRFBgConfig:
    depth: int = 8
    width: int = 256
    d_in: int = 4       # [x/r, 1/r] inverted-sphere coords
    d_in_view: int = 3
    multires: int = 10
    multires_view: int = 4
    skips: tuple[int, ...] = (4,)

    @property
    def pts_pe(self) -> PEConfig:
        return PEConfig(num_freqs=self.multires, input_dims=self.d_in)

    @property
    def view_pe(self) -> PEConfig:
        return PEConfig(num_freqs=self.multires_view, input_dims=self.d_in_view)


def init_nerf_bg(gen: torch.Generator, cfg: NeRFBgConfig) -> Params:
    return init_nerf_mlp(gen, cfg.pts_pe.out_dim, cfg.view_pe.out_dim, cfg.width,
                         cfg.depth, cfg.skips, "alpha")


def nerf_bg_apply(params: Params, cfg: NeRFBgConfig, pts: torch.Tensor,
                  views: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(alpha/density [N, 1], rgb [N, 3]) of points [N, 4] seen along
    ``views`` [N, 3] (NeRF.forward, neus_fields.py:313-337)."""
    return nerf_trunk(params, cfg.depth, cfg.skips, positional_encoding(pts, cfg.pts_pe),
                      positional_encoding(views, cfg.view_pe), "alpha")
