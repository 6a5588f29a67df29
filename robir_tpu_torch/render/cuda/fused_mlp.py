"""SDF trunk forward as a hand-written CUDA kernel (K1).

Counterpart of ``robir_tpu/render/pallas/fused_mlp.py``. The kernel
(``csrc/fused_mlp.cu``) replaces the Pallas ``_fwd_kernel`` launched by
``_fused_forward``: one block per 16-row tile keeps the tile's activations
in shared memory through all layers and streams each layer's weights from
L2. It is bound by its fp32 multiply-adds (2 x 524,544 per row of the
full-width trunk) on the CUDA cores.

On the port's main path the op is forward only: it serves the no-grad
sampling phase of ``render_neus``. The Pallas recompute backward
(``_bwd_kernel``) is not ported yet, so on CUDA ``fused_mlp`` raises when
its inputs need a gradient; it never falls back to the plain version.
``_forward_rows`` is the plain PyTorch version: the CPU tests run it, and
``chip_smoke.py`` holds the kernel to it on the card.

Weights arrive pre-folded (``fold_weight_norm``, O(params), in PyTorch so
autograd carries gradients back to ``v`` and ``g``) as ``[in, out]``
tensors, in the JAX package's layout.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Sequence

import numpy as np
import torch

from ...fields.mlp import effective_weight
from .build import Kernel, int_array, ptr

_SQ2 = float(np.float32(1.0 / np.sqrt(2.0)))

# fixed limits of the CUDA kernels (csrc/trunk.cuh)
MAX_LAYERS = 16
MAX_WIDTH = 264
MAX_IN = 64


@dataclasses.dataclass(frozen=True)
class MLPPlan:
    """Static description of a dense trunk.

    dims[i] -> dims[i+1] per layer; at layer l in ``skip_in`` the (scaled)
    input is concatenated first: h = concat([h, x0]) / sqrt(2).
    """

    dims: tuple[int, ...]            # layer input sizes, incl. input dim
    out_dim: int
    skip_in: tuple[int, ...] = ()
    activation: str = "softplus100"  # softplus100 | relu | none

    @property
    def n_layers(self) -> int:
        return len(self.dims)

    def layer_in_dim(self, layer: int) -> int:
        d = self.dims[layer]
        if layer in self.skip_in:
            d += self.dims[0]
        return d

    def layer_out_dim(self, layer: int) -> int:
        return self.dims[layer + 1] if layer + 1 < len(self.dims) else self.out_dim

    def n_weights(self) -> int:
        return sum(self.layer_in_dim(i) * self.layer_out_dim(i)
                   for i in range(self.n_layers))

    def meta(self) -> list[int]:
        """The kernels' plan: [n, d0, then din, dout, dh, skip per layer]."""
        m = [self.n_layers, self.dims[0]]
        for i in range(self.n_layers):
            m += [self.layer_in_dim(i), self.layer_out_dim(i), self.dims[i],
                  int(i in self.skip_in)]
        return m


def plan_from_sdf_config(sdf_cfg) -> MLPPlan:
    """Build the trunk plan for an SDFConfig (accounting for the reference's
    reduced pre-skip layer widths: the layer before a skip outputs
    d_hidden - d_pe so the concat lands back at d_hidden)."""
    d0 = sdf_cfg.dims[0]
    full = sdf_cfg.dims
    ins = [d0]
    for layer in range(1, len(full) - 1):
        out = full[layer] - (d0 if layer in sdf_cfg.skip_in else 0)
        ins.append(out)
    return MLPPlan(dims=tuple(ins), out_dim=sdf_cfg.d_out,
                   skip_in=tuple(sdf_cfg.skip_in),
                   activation="softplus100")


def fold_weight_norm(params, n_layers: int):
    """(weights, biases) tuples with weight-norm applied — O(params) work
    done once per step outside the kernel, differentiable by autograd."""
    layers = [params[f"lin{i}"] for i in range(n_layers)]
    return (tuple(effective_weight(lp) for lp in layers),
            tuple(lp["b"] for lp in layers))


def softplus100(h: torch.Tensor) -> torch.Tensor:
    """softplus(100 h) / 100 in the stable max(t, 0) + log1p(exp(-|t|)) form
    that jax.nn.softplus and the kernels use."""
    t = 100.0 * h
    return (torch.clamp_min(t, 0.0) + torch.log1p(torch.exp(-t.abs()))) * 0.01


def _act(plan: MLPPlan, h):
    if plan.activation == "softplus100":
        return softplus100(h)
    if plan.activation == "relu":
        return torch.relu(h)
    return h


def _forward_rows(plan: MLPPlan, x, weights, biases):
    """Plain PyTorch trunk (the version the kernel is held to)."""
    h = x
    x0 = x
    n = plan.n_layers
    for i in range(n):
        if i in plan.skip_in:
            h = torch.cat([h, x0], dim=-1) * _SQ2
        h = h @ weights[i] + biases[i]
        if i < n - 1:
            h = _act(plan, h)
    return h


def check_cuda_inputs(plan: MLPPlan, x: torch.Tensor,
                      weights: Sequence[torch.Tensor],
                      biases: Sequence[torch.Tensor]) -> None:
    """Raise on anything the CUDA kernels do not take."""
    if plan.activation != "softplus100":
        raise ValueError(f"the kernels apply softplus100 only, not {plan.activation!r}")
    if plan.n_layers > MAX_LAYERS or plan.dims[0] > MAX_IN or 0 in plan.skip_in:
        raise ValueError(f"plan outside the kernels' limits: {plan}")
    if len(weights) != plan.n_layers or len(biases) != plan.n_layers:
        raise ValueError("one weight and one bias per layer expected")
    if x.dim() != 2 or x.shape[1] != plan.dims[0]:
        raise ValueError(f"x {tuple(x.shape)} does not match plan input {plan.dims[0]}")
    for i, (w, b) in enumerate(zip(weights, biases)):
        shape = (plan.layer_in_dim(i), plan.layer_out_dim(i))
        if tuple(w.shape) != shape or tuple(b.shape) != shape[1:]:
            raise ValueError(f"layer {i}: weight {tuple(w.shape)} / bias "
                             f"{tuple(b.shape)}, expected {shape}")
        if max(shape) > MAX_WIDTH:
            raise ValueError(f"layer {i} wider than {MAX_WIDTH}")
    for t in (x, *weights, *biases):
        if t.device != x.device or t.dtype != torch.float32:
            raise ValueError("all inputs must be float32 on one CUDA device")


def pack_weights(weights, biases, transposed: bool = False):
    """Flat fp32 buffers the kernels read: W as row-major [in, out] blocks
    (and, if asked, W^T as [out, in] blocks at the same offsets), b flat."""
    W = torch.cat([w.reshape(-1) for w in weights])
    b = torch.cat([bb.reshape(-1) for bb in biases])
    if not transposed:
        return W, b
    Wt = torch.cat([w.t().reshape(-1) for w in weights])
    return W, Wt, b


def stream_handle(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


FORWARD = Kernel("fused_mlp.cu", "fused_mlp_forward",
                 [ctypes.c_void_p] * 4 + [ctypes.POINTER(ctypes.c_int),
                                          ctypes.c_longlong, ctypes.c_void_p])


def fused_mlp_cuda(plan: MLPPlan, x, weights, biases) -> torch.Tensor:
    """Launch K1 on CUDA tensors: x [N, dims[0]] -> [N, out_dim]."""
    check_cuda_inputs(plan, x, weights, biases)
    x = x.contiguous()
    W, b = pack_weights(weights, biases)
    y = torch.empty((x.shape[0], plan.out_dim), device=x.device,
                    dtype=torch.float32)
    FORWARD(ptr(x), ptr(W), ptr(b), ptr(y), int_array(plan.meta()),
            x.shape[0], stream_handle(x))
    return y


def fused_mlp(plan: MLPPlan, x, weights, biases) -> torch.Tensor:
    """x [N, dims[0]] -> [N, out_dim] through the trunk: the CUDA kernel for
    CUDA tensors, the plain version for CPU tensors."""
    if x.device.type == "cpu":
        return _forward_rows(plan, x, weights, biases)
    if x.device.type != "cuda":
        raise ValueError(f"fused_mlp runs on cuda or cpu, not {x.device}")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, *weights, *biases)):
        raise RuntimeError(
            "fused_mlp on CUDA is forward only (the recompute backward is not "
            "ported): call it under torch.no_grad() or on detached inputs")
    return fused_mlp_cuda(plan, x, weights, biases)
