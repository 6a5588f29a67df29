"""Dense layers as init/apply pairs: plain and weight-normalized linear
(counterpart of ``robir_tpu/fields/mlp.py``).

Parameters keep the JAX package's layout: ``v``/``w`` as ``[in, out]``,
``g`` and ``b`` as ``[out]``. Weight norm is W = g * v / ||v|| with the norm
per output unit (over axis 0), and ``g`` starts at ||v|| so the initial
effective weight equals the raw init. The default init is
``torch.nn.Linear``'s: U(-1/sqrt(in), 1/sqrt(in)) for weight and bias.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

Params = dict


def torch_linear_init(gen: torch.Generator, in_dim: int,
                      out_dim: int) -> tuple[torch.Tensor, torch.Tensor]:
    bound = 1.0 / np.sqrt(in_dim)
    w = (torch.rand((in_dim, out_dim), generator=gen) * 2 - 1) * bound
    b = (torch.rand((out_dim,), generator=gen) * 2 - 1) * bound
    return w, b


def init_linear(gen: torch.Generator, in_dim: int, out_dim: int, *,
                weight_norm: bool = False,
                w_init: Callable | None = None,
                b_init: Callable | None = None) -> Params:
    """``w_init(gen, (in, out))`` / ``b_init(gen, (out,))`` override the
    torch-default initialization. Tensors are made on the CPU from ``gen``
    (a CPU generator); the caller moves the tree to its device."""
    if w_init is None and b_init is None:
        w, b = torch_linear_init(gen, in_dim, out_dim)
    else:
        w = (w_init(gen, (in_dim, out_dim)) if w_init is not None
             else torch_linear_init(gen, in_dim, out_dim)[0])
        b = b_init(gen, (out_dim,)) if b_init is not None else torch.zeros(out_dim)
    if weight_norm:
        return {"v": w, "g": torch.linalg.norm(w, dim=0), "b": b}
    return {"w": w, "b": b}


def effective_weight(params: Params) -> torch.Tensor:
    """The weight-norm fold ``w = v * g / ||v||_col``, or the plain ``w``."""
    if "v" in params:
        v = params["v"]
        return v * (params["g"] / torch.linalg.norm(v, dim=0))
    return params["w"]


def _store(dtype) -> torch.dtype | None:
    if dtype is None:
        return None
    if dtype in ("bfloat16", torch.bfloat16):
        return torch.bfloat16
    raise ValueError(f"unsupported storage dtype {dtype!r}")


def apply_linear(params: Params, x: torch.Tensor,
                 storage_dtype=None) -> torch.Tensor:
    """``x @ w + b``. With ``storage_dtype="bfloat16"`` the operands are
    rounded to bf16 and the output is returned in bf16, as the JAX package's
    storage path does (the colour net in ``configs/neus_blender.json``)."""
    return apply_linear_parts(params, [x], storage_dtype)


def apply_linear_parts(params: Params, parts: list[torch.Tensor],
                       storage_dtype=None,
                       pre_scale: float | None = None) -> torch.Tensor:
    """``apply_linear(params, concat(parts, -1) * pre_scale)`` as a sum of
    partial products over the weight's row blocks (equal up to fp32
    reassociation over the contracted dim)."""
    store = _store(storage_dtype)
    w = effective_weight(params)
    b = params["b"]
    off = 0
    y = None
    for p in parts:
        k = p.shape[-1]
        wp = w[off:off + k]
        off += k
        if pre_scale is not None:
            p = p * pre_scale
        if store is not None:
            t = p.to(store) @ wp.to(store)
        else:
            t = p @ wp
        y = t if y is None else y + t
    if off != w.shape[0]:
        raise ValueError(f"parts cover {off} inputs of {w.shape[0]}")
    if store is not None:
        return y + b.to(store)
    return y + b


def softplus_beta(x: torch.Tensor, beta: float = 100.0) -> torch.Tensor:
    """Softplus(beta) = log(1 + exp(beta x)) / beta in the stable form
    jax.nn.softplus uses."""
    t = beta * x
    return (torch.clamp_min(t, 0.0) + torch.log1p(torch.exp(-t.abs()))) / beta
