"""NeuS model: SDF net + radiance net + variance (counterpart of
``robir_tpu/fields/neus_model.py``).

``NeuS`` is an ``nn.Module`` holding the parameter tree under the JAX
package's names (``sdf_network``, ``color_network``,
``deviation_network``), so the weights bridge (``core/params.py``) maps it
1:1. The hash-grid variant and the background shell are not ported yet.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from .. import resolve_device
from ..core.params import from_jax
from .mlp import Params
from .radiance import RenderingConfig, init_rendering, rendering_apply
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
    background: None = None  # the outer NeRF shell is not ported yet
    radius: float = 2.0

    def __post_init__(self):
        if self.background is not None:
            raise NotImplementedError("the NeRF background shell is not "
                                      "ported yet (set model.background null)")


def init_neus(gen: torch.Generator, cfg: NeuSConfig) -> Params:
    """A fresh parameter tree (CPU tensors) from a CPU generator."""
    return {
        "sdf_network": init_sdf(gen, cfg.sdf),
        "color_network": init_rendering(gen, cfg.color),
        "deviation_network": init_variance(cfg.variance),
    }


class NeuS(nn.Module):
    """The renderer's view of the model: ``sdf``, ``full_with_grad``,
    ``color``, ``inv_s`` and ``radius`` over one parameter tree.

    The parameters live on ``cuda`` unless ``device="cpu"`` is passed;
    raises if CUDA is asked for and absent."""

    def __init__(self, params: Params, cfg: NeuSConfig, device="cuda"):
        super().__init__()
        self.cfg = cfg
        self.params = from_jax(params, resolve_device(device))

    def sdf(self, x: torch.Tensor) -> torch.Tensor:
        """[N, 3] -> [N, 1]: the sdf column of the full trunk output."""
        return sdf_apply(self.params["sdf_network"], self.cfg.sdf, x,
                         out_cols=1)

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
