"""HDR tone mapping and gamma correction (counterpart of
``robir_tpu/render/color.py``).

The four hdr modes of the reference (``model/color_correction.py``): 0
scale-ACES (what the shipped configs select), 1 warp-ACES, 2 ln-space, 3
identity; the learnable shift ``adapt_illum`` enters as ``as_input``.
Parameters ride in the ``gamma`` subtree, the mode in a frozen config.

The energy-integral net (``energy_apply``, ``energy_scalar``) maps a shift
to the mean HDR energy of the dataset's pixels under that shift;
``fit_energy`` fits it once, in the Vis stage's prologue
(``model/energy_integral.py:51-77``).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from ..core.draws import Draws
from ..core.params import ParamTree, from_jax
from ..fields.encoding import PEConfig, positional_encoding
from ..fields.mlp import Params, apply_linear, init_linear, softplus_beta


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


def energy_scalar(params: Params, shift: torch.Tensor) -> torch.Tensor:
    """E(shift) / E(1) (color_correction.py ``scalar``); ``params`` is the
    ``gamma`` subtree."""
    max_e = torch.mean(energy_apply(params["energy"], torch.ones_like(shift)), -1,
                       keepdim=True)
    e = torch.mean(energy_apply(params["energy"], shift), -1, keepdim=True)
    return e / torch.clamp(max_e, 1e-4, 1.0)


def energy_apply(params: Params, shift: torch.Tensor) -> torch.Tensor:
    """[N, 1] shift -> [N, 3] softplus energy (energy_integral.py)."""
    h = positional_encoding(shift, _ENERGY_PE)
    n = len(_ENERGY_DIMS) + 1
    for i in range(n):
        h = apply_linear(params[f"lin{i}"], h)
        if i < n - 1:
            h = torch.relu(h)
    return softplus_beta(h, 1.0)


def fit_energy(init: Params, masked_pixels: torch.Tensor,
               ldr2hdr_fn: Callable, step_draws: Callable[[int], Draws],
               n_steps: int = 1000, batch_px: int = 8192, batch_shift: int = 512,
               lr: float = 5e-4) -> ParamTree:
    """Fit E(shift) ~ mean over pixels of ``ldr2hdr_fn(pixel, shift)``
    (energy_integral.py:51-77), from the weights ``init`` (an
    ``init_energy`` tree), on ``masked_pixels`` [P, 3] in [0, 1]'s device.
    Each of the ``n_steps`` Adam steps (b2 0.99) draws from
    ``step_draws(step)``: ``energy_shift`` (U[0, 1) [batch_shift, 1],
    clipped to [1e-4, 1 - 1e-4]) and ``energy_pixels`` ([batch_px] indices
    into the pixels). Returns the fitted weights."""
    params = from_jax(init, masked_pixels.device)
    opt = torch.optim.Adam(params.parameters(), lr=lr, betas=(0.9, 0.99), eps=1e-8)
    px = torch.clamp(masked_pixels, 1e-4, 1.0)
    for i in range(n_steps):
        draws = step_draws(i)
        shift = torch.clamp(draws.uniform("energy_shift", (batch_shift, 1)), 1e-4, 1 - 1e-4)
        batch = px[draws.integers("energy_pixels", (batch_px,), px.shape[0])]
        with torch.no_grad():
            gt = torch.mean(ldr2hdr_fn(batch[:, None, :], shift), dim=0)
        loss = torch.mean((gt - energy_apply(params, shift)) ** 2)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
    return params
