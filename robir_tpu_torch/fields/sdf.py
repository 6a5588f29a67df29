"""SDF field MLP: geometric init, weight norm, skip connection, softplus-100
(counterpart of ``robir_tpu/fields/sdf.py``).

PE-encoded input, 8x256 trunk with a concat-skip at layer 4 (divided by
sqrt(2)), SAL geometric initialization (sphere of radius ``bias``),
softplus(beta=100) activations, output = [sdf / scale, geometry feature].

In the port the trunk goes through the two fused ops of ``render/cuda``:
``fused_mlp`` (K1, with its recompute backward K2) for the value and
``fused_value_grad`` (K3, with its hand VJP K4) for value + spatial
gradient, in fp32, on the weights ``fold_weight_norm`` folds (the ops alone
pack them). They launch the CUDA kernels for CUDA tensors and run their
plain versions for CPU tensors. So ``fused_kernel``, ``fused_block_rows``,
``grad_mode`` and ``storage_dtype`` stay accepted keys (configs load
unchanged) but select nothing. That is a difference from the JAX package,
whose default path (``fused_kernel=False``) runs the trunk layer by layer
and, at every shipped config's ``storage_dtype: "bfloat16"``, stores each
layer's activations in bf16; only its fused path (``fused_kernel=True``) is
fp32 as the port is (ROADMAP C).

``sdf_apply(compute_dtype=bf16)`` is the sampling phase's low-precision
path (``NeusRenderConfig.sampling_dtype``): the trunk layer by layer on
bf16 operands with fp32 sums and fp32 activations, as the JAX package's
``compute_dtype`` path without storage (its Pallas kernel is skipped
there too): one bf16 GEMM a layer on the card, no K1.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..render.cuda.fused_mlp import frozen_mlp, fused_mlp, plan_from_sdf_config
from ..render.cuda.fused_value_grad import fused_value_grad
from .encoding import (PEConfig, positional_encoding,
                       positional_encoding_vjp)
from .mlp import (Params, apply_linear, apply_linear_parts, effective_weight, init_linear,
                  softplus_beta)


@dataclasses.dataclass(frozen=True)
class SDFConfig:
    d_in: int = 3
    d_out: int = 257  # 1 sdf + 256 feature
    d_hidden: int = 256
    n_layers: int = 8
    skip_in: tuple[int, ...] = (4,)
    multires: int = 10
    bias: float = 0.5
    scale: float = 1.0
    geometric_init: bool = True
    weight_norm: bool = True
    inside_outside: bool = False
    grad_mode: str = "manual"
    fused_kernel: bool = False
    fused_block_rows: int = 256
    storage_dtype: str | None = None

    def __post_init__(self):
        if self.grad_mode not in ("vjp", "manual"):
            raise ValueError(f"grad_mode {self.grad_mode!r} not in "
                             f"('vjp', 'manual')")

    @property
    def pe(self) -> PEConfig:
        return PEConfig(num_freqs=self.multires, input_dims=self.d_in)

    @property
    def dims(self) -> tuple[int, ...]:
        d0 = self.pe.out_dim if self.multires > 0 else self.d_in
        return (d0,) + (self.d_hidden,) * self.n_layers + (self.d_out,)


def init_sdf(gen: torch.Generator, cfg: SDFConfig) -> Params:
    """Parameters from a CPU generator, on the CPU. Same distributions as the
    JAX package's init (the numbers differ: the generators differ)."""
    dims = cfg.dims
    num_layers = len(dims)
    params: Params = {}
    for layer in range(num_layers - 1):
        out_dim = (dims[layer + 1] - dims[0] if layer + 1 in cfg.skip_in
                   else dims[layer + 1])
        in_dim = dims[layer]
        if cfg.geometric_init:
            w_init, b_init = _geometric_init(cfg, dims, layer, num_layers,
                                             in_dim, out_dim)
        else:
            w_init = b_init = None
        params[f"lin{layer}"] = init_linear(
            gen, in_dim, out_dim, weight_norm=cfg.weight_norm,
            w_init=w_init, b_init=b_init)
    return params


def _geometric_init(cfg: SDFConfig, dims, layer, num_layers, in_dim, out_dim):
    """SAL geometric initialization: last layer ~ N(sqrt(pi)/sqrt(in), 1e-4)
    with bias -cfg.bias so the initial SDF is approximately a sphere; PE
    channels zeroed at the input and skip layers."""
    std = np.sqrt(2) / np.sqrt(out_dim)

    def normal(gen, shape):
        return torch.randn(shape, generator=gen)

    if layer == num_layers - 2:
        mean = np.sqrt(np.pi) / np.sqrt(in_dim)
        if cfg.inside_outside:
            mean, bias_val = -mean, cfg.bias
        else:
            bias_val = -cfg.bias

        def w_init(gen, shape):
            return mean + 1e-4 * normal(gen, shape)

        def b_init(gen, shape):
            return torch.full(shape, float(bias_val))
    elif cfg.multires > 0 and layer == 0:
        def w_init(gen, shape):
            w = torch.zeros(shape)
            w[:3, :] = std * normal(gen, (3, shape[1]))
            return w

        def b_init(gen, shape):
            return torch.zeros(shape)
    elif cfg.multires > 0 and layer in cfg.skip_in:
        def w_init(gen, shape):
            w = std * normal(gen, shape)
            w[-(dims[0] - 3):, :] = 0.0  # zero the PE part of the skip input
            return w

        def b_init(gen, shape):
            return torch.zeros(shape)
    else:
        def w_init(gen, shape):
            return std * normal(gen, shape)

        def b_init(gen, shape):
            return torch.zeros(shape)
    return w_init, b_init


def fold_weight_norm(params: Params, n_layers: int):
    """(weights, biases) tuples with weight-norm applied, in PyTorch so that
    autograd carries gradients back to ``v`` and ``g``."""
    layers = [params[f"lin{i}"] for i in range(n_layers)]
    return (tuple(effective_weight(lp) for lp in layers),
            tuple(lp["b"] for lp in layers))


def _encode(cfg: SDFConfig, x: torch.Tensor) -> torch.Tensor:
    inputs = x * cfg.scale
    if cfg.multires > 0:
        inputs = positional_encoding(inputs, cfg.pe)
    return inputs


def sdf_apply(params: Params, cfg: SDFConfig, x: torch.Tensor,
              out_cols: int | None = None, compute_dtype=None) -> torch.Tensor:
    """[N, 3] -> [N, d_out] = [sdf, features] through K1 (and K2 in the
    backward, when the weights or x need a gradient). All columns are
    computed and then sliced to ``out_cols``, as the JAX fused path does.
    With ``compute_dtype`` (bf16): ``_layers_apply``, no kernel."""
    if x.dim() != 2:
        raise ValueError(f"sdf_apply takes [N, {cfg.d_in}] points, got {tuple(x.shape)}")
    if compute_dtype is not None:
        return _layers_apply(params, cfg, x, compute_dtype, out_cols)
    plan = plan_from_sdf_config(cfg)
    ws, bs = fold_weight_norm(params, plan.n_layers)
    h = fused_mlp(plan, _encode(cfg, x), ws, bs)
    out = torch.cat([h[..., :1] / cfg.scale, h[..., 1:]], dim=-1)
    return out[..., :out_cols] if out_cols is not None else out


def _layers_apply(params: Params, cfg: SDFConfig, x: torch.Tensor, compute_dtype,
                  out_cols: int | None) -> torch.Tensor:
    """The trunk layer by layer (the JAX package's ``sdf_apply`` without
    its kernel, robir_tpu/fields/sdf.py:183-210), each product on
    ``compute_dtype`` operands summed in fp32 (``low_precision_mm``), the
    skip layer's two parts scaled by 1/sqrt(2) before the rounding, the
    activations fp32. ``out_cols`` keeps that many output columns of the
    last layer (exact: the weight-norm fold is per column)."""
    inputs = _encode(cfg, x)
    h = inputs
    num_layers = len(cfg.dims)
    for layer in range(num_layers - 1):
        lin = params[f"lin{layer}"]
        if out_cols is not None and layer == num_layers - 2:
            lin = {"w": effective_weight(lin)[:, :out_cols], "b": lin["b"][:out_cols]}
        if layer in cfg.skip_in:
            h = apply_linear_parts(lin, [h, inputs], pre_scale=float(1.0 / np.sqrt(2)),
                                   compute_dtype=compute_dtype)
        else:
            h = apply_linear(lin, h, compute_dtype=compute_dtype)
        if layer < num_layers - 2:
            h = softplus_beta(h, 100.0)
    return torch.cat([h[..., :1] / cfg.scale, h[..., 1:]], dim=-1)


def frozen_sdf(params: Params, cfg: SDFConfig, out_cols: int | None = None):
    """``x -> sdf_apply(params, cfg, x, out_cols)`` without a graph, for
    many queries of weights that stay fixed between them (the sphere
    tracer's 51 per trace): the weight-norm fold, and on the card the
    kernels' weight packing (``frozen_mlp``), are done once here."""
    plan = plan_from_sdf_config(cfg)
    with torch.no_grad():
        trunk = frozen_mlp(plan, *fold_weight_norm(params, plan.n_layers))

    @torch.no_grad()
    def query(x: torch.Tensor) -> torch.Tensor:
        h = trunk(_encode(cfg, x))[..., :out_cols]
        return torch.cat([h[..., :1] / cfg.scale, h[..., 1:]], dim=-1)

    return query


def sdf_full_and_gradient(params: Params, cfg: SDFConfig, x: torch.Tensor):
    """(full [N, d_out], spatial grad of the sdf channel [N, 3]): PE in
    PyTorch, the trunk value + gradient through K3 (its backward K4), then
    PE's VJP (d(x * scale)/dx = scale, then the JAX package's ``/ scale``),
    which autograd differentiates once more for the train step's
    second-order terms."""
    plan = plan_from_sdf_config(cfg)
    ws, bs = fold_weight_norm(params, plan.n_layers)
    xs = x * cfg.scale
    e = positional_encoding(xs, cfg.pe) if cfg.multires > 0 else xs
    y, de = fused_value_grad(plan, e, ws, bs)
    g = positional_encoding_vjp(xs, de, cfg.pe) if cfg.multires > 0 else de
    full = torch.cat([y[..., :1] / cfg.scale, y[..., 1:]], dim=-1)
    return full, g * cfg.scale / cfg.scale
