"""NeuS model: SDF net + radiance net + variance (counterpart of
``robir_tpu/fields/neus_model.py``).

``NeuS`` is an ``nn.Module`` holding the parameter tree under the JAX
package's names (``sdf_network``, ``color_network``,
``deviation_network`` and, with ``background``, the NeRF shell
``nerf_outside``), so the weights bridge (``core/params.py``) maps it 1:1.
``HashNeuS`` is the same interface over the hash-encoded SDF
(``fields/hashgrid.py``): plain PyTorch, its spatial gradient one
``torch.autograd.grad`` with ``create_graph`` (the JAX package's per-point
``vmap(grad)``), so the eikonal term reaches the hash tables.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from .. import resolve_device
from ..core.params import ParamTree, from_jax
from .mlp import Params
from .hashgrid import HashSDFConfig, hash_sdf_apply, init_hash_sdf
from .radiance import (NeRFBgConfig, RenderingConfig, init_nerf_bg, init_rendering,
                       nerf_bg_apply, rendering_apply)
from .sdf import SDFConfig, init_sdf, sdf_apply, sdf_full_and_gradient


@dataclasses.dataclass(frozen=True)
class VarianceConfig:
    init_val: float = 0.3


def init_variance(cfg: VarianceConfig) -> Params:
    return {"variance": torch.tensor(cfg.init_val, dtype=torch.float32)}


def variance_apply(params: Params) -> torch.Tensor:
    """inv_s = exp(10 * v)."""
    return torch.exp(params["variance"] * 10.0)


@dataclasses.dataclass(frozen=True)
class NeuSConfig:
    sdf: SDFConfig = SDFConfig(d_in=3, d_out=257, d_hidden=256, n_layers=8)
    color: RenderingConfig = RenderingConfig(
        d_feature=256, mode="idr", d_in=9, d_out=3, d_hidden=256, n_layers=4)
    variance: VarianceConfig = VarianceConfig(0.3)
    background: NeRFBgConfig | None = None  # None: no outer NeRF shell
    radius: float = 2.0


def init_neus(gen: torch.Generator, cfg: NeuSConfig) -> Params:
    """A fresh parameter tree (CPU tensors) from a CPU generator."""
    params = {
        "sdf_network": init_sdf(gen, cfg.sdf),
        "color_network": init_rendering(gen, cfg.color),
        "deviation_network": init_variance(cfg.variance),
    }
    if cfg.background is not None:
        params["nerf_outside"] = init_nerf_bg(gen, cfg.background)
    return params


class NeuS(nn.Module):
    """The renderer's view of the model: ``sdf``, ``full_with_grad``,
    ``color``, ``inv_s`` and ``radius`` over one parameter tree.

    The parameters live on ``cuda`` unless ``device="cpu"`` is passed;
    raises if CUDA is asked for and absent. ``over`` wraps a ``ParamTree``
    without copying it."""

    def __init__(self, params: Params, cfg: NeuSConfig, device="cuda"):
        super().__init__()
        self.cfg = cfg
        self.params = from_jax(params, resolve_device(device))

    @classmethod
    def over(cls, params: ParamTree, cfg: NeuSConfig) -> "NeuS":
        """The model over ``params`` as they are, on their own device: not a
        copy, so a caller's graph reaches them."""
        model = cls.__new__(cls)
        nn.Module.__init__(model)
        model.cfg, model.params = cfg, params
        return model

    def sdf(self, x: torch.Tensor, compute_dtype=None) -> torch.Tensor:
        """[N, 3] -> [N, 1]: the sdf column of the full trunk output (K1),
        or with ``compute_dtype`` of the trunk layer by layer on operands
        of that type with fp32 sums (``sdf_apply``)."""
        return sdf_apply(self.params["sdf_network"], self.cfg.sdf, x,
                         out_cols=1, compute_dtype=compute_dtype)

    def full_with_grad(self, x: torch.Tensor):
        """(sdf+features, sdf spatial gradient) sharing one forward."""
        return sdf_full_and_gradient(self.params["sdf_network"], self.cfg.sdf, x)

    def color(self, x, gradients, dirs, feature) -> torch.Tensor:
        return rendering_apply(self.params["color_network"], self.cfg.color,
                               x, gradients, dirs, feature)

    def inv_s(self) -> torch.Tensor:
        return torch.clamp(variance_apply(self.params["deviation_network"]),
                           1e-6, 1e6)

    def radius(self) -> float:
        return self.cfg.radius

    def background(self, pts4: torch.Tensor, dirs: torch.Tensor):
        """(density [N, 1], rgb [N, 3]) of the NeRF shell at the 4-D
        inverted-sphere points."""
        return nerf_bg_apply(self.params["nerf_outside"], self.cfg.background, pts4, dirs)


@dataclasses.dataclass(frozen=True)
class HashNeuSConfig:
    hash_sdf: HashSDFConfig = HashSDFConfig()
    color: RenderingConfig = RenderingConfig(
        d_feature=256, mode="idr", d_in=9, d_out=3, d_hidden=256, n_layers=4)
    variance: VarianceConfig = VarianceConfig(0.3)
    radius: float = 2.0


def init_hash_neus(gen: torch.Generator, cfg: HashNeuSConfig) -> Params:
    return {
        "sdf_network": init_hash_sdf(gen, cfg.hash_sdf),
        "color_network": init_rendering(gen, cfg.color),
        "deviation_network": init_variance(cfg.variance),
    }


class HashNeuS(NeuS):
    """``NeuS``'s interface over the hash-SDF field (no background shell);
    ``cfg`` is a ``HashNeuSConfig``."""

    def _full(self, x: torch.Tensor) -> torch.Tensor:
        return hash_sdf_apply(self.params["sdf_network"], self.cfg.hash_sdf, x)

    def sdf(self, x: torch.Tensor, compute_dtype=None) -> torch.Tensor:
        """The sdf column; ``compute_dtype`` changes nothing here (the hash
        encoding is gathers, as in the JAX package)."""
        return self._full(x)[..., :1]

    def full_with_grad(self, x: torch.Tensor):
        """(sdf+features, d sdf/dx): one forward and one backward to the
        points; under grad mode the gradient keeps its graph, so a loss on
        it reaches the parameters."""
        keep = torch.is_grad_enabled()
        with torch.enable_grad():
            xg = x.detach().requires_grad_(True)
            full = self._full(xg)
            g, = torch.autograd.grad(full[..., 0].sum(), xg, create_graph=keep)
        return (full, g) if keep else (full.detach(), g)
