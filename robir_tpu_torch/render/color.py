"""HDR tone mapping and gamma correction (counterpart of
``robir_tpu/render/color.py``).

The four hdr modes of the reference (``model/color_correction.py``): 0
scale-ACES (what the shipped configs select), 1 warp-ACES, 2 ln-space, 3
identity; the learnable shift ``adapt_illum`` enters as ``as_input``.
Parameters ride in the ``gamma`` subtree, the mode in a frozen config.

Not ported yet: the energy-integral prefit (``fit_energy``,
``energy_apply``, ``energy_scalar``), which only the Vis stage runs; the
``energy`` subtree is created by ``init_tonemap`` so the tree matches the
JAX package's.
"""

from __future__ import annotations

import dataclasses

import torch

from ..fields.encoding import PEConfig
from ..fields.mlp import Params, init_linear


def aces_fn(x):
    return x * (2.51 * x + 0.03) / (x * (2.43 * x + 0.59) + 0.14)


def aces_inv(x):
    return ((0.59 * x - 0.03) + torch.sqrt((0.59 * x - 0.03) ** 2
            + 4 * (2.51 - 2.43 * x) * 0.14 * x)) / (2 * (2.51 - 2.43 * x))


def warp_aces_inv(x, t):
    return 0.73 * aces_inv(x * t) / aces_inv(0.73 * t)


def warp_aces_fn(x, t):
    return aces_fn(aces_inv(0.73 * t) / 0.73 * x) / t


def scale_aces_inv(x, t):
    return aces_inv(x * t ** 0.2)


def scale_aces_fn(x, t):
    return aces_fn(x) / t ** 0.2


def ln_space_fn(x, shift):
    x = x * (0.5 + shift) / 0.5
    return x / (1 + shift * x)


def ln_space_inv(x, shift):
    y = x / (1 - shift * x)
    return y * 0.5 / (0.5 + shift)


def identity_fn(x, t):
    return x


_HDR_MODES = {
    0: (scale_aces_fn, scale_aces_inv),
    1: (warp_aces_fn, warp_aces_inv),
    2: (ln_space_fn, ln_space_inv),
    3: (identity_fn, identity_fn),
}


@dataclasses.dataclass(frozen=True)
class ToneMapConfig:
    hdr_mode: int = 0
    gamma: float = 1.0


_ENERGY_PE = PEConfig(num_freqs=4, input_dims=1)
_ENERGY_DIMS = (128, 128, 64)


def init_energy(gen: torch.Generator) -> Params:
    dims = (_ENERGY_PE.out_dim,) + _ENERGY_DIMS + (3,)
    return {f"lin{i}": init_linear(gen, dims[i], dims[i + 1])
            for i in range(len(dims) - 1)}


def init_tonemap(cfg: ToneMapConfig, gen: torch.Generator) -> Params:
    """GammaCorrect + ACESToneMapping learnables
    (color_correction.py:7-28,76-83)."""
    return {
        "gamma": torch.tensor(cfg.gamma, dtype=torch.float32),
        "indir_coef": torch.tensor(1.0),
        "dir_coef": torch.tensor(2.0),
        "coef": torch.tensor(1.0),
        "adapt_illum": torch.tensor(0.0),
        "energy": init_energy(gen),
    }


def gamma_forward(params: Params, x):
    return torch.pow(x, 1.0 / params["gamma"])


def gamma_inv(params: Params, x):
    return torch.pow(x, params["gamma"])


def as_input(params: Params) -> torch.Tensor:
    """The learnable shift as a [1, 1] input (color_correction.py:116-119)."""
    return torch.clamp(params["adapt_illum"] * 10 + 0.5, 0, 1).reshape(1, 1)


def make_shift(params: Params, shift=None) -> torch.Tensor:
    if shift is None:
        shift = as_input(params)
    shift = torch.as_tensor(shift, dtype=torch.float32)
    if shift.dim() == 0:
        shift = shift[None]
    return torch.clamp(shift, 1e-4, 1.0)


def hdr2ldr(params: Params, cfg: ToneMapConfig, x, raw_shift=None):
    fn, _ = _HDR_MODES[cfg.hdr_mode]
    return fn(x, make_shift(params, raw_shift))


def ldr2hdr(params: Params, cfg: ToneMapConfig, x, raw_shift=None):
    _, inv = _HDR_MODES[cfg.hdr_mode]
    return inv(x, make_shift(params, raw_shift))
