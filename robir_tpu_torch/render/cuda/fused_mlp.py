"""Dense trunk forward (K1) and its recompute backward (K2) as hand-written
CUDA kernels.

Counterpart of ``robir_tpu/render/pallas/fused_mlp.py``. The kernels live in
``csrc/fused_mlp.cu``:

- K1 (``fused_mlp_fwd_kernel``) replaces the Pallas ``_fwd_kernel`` launched
  by ``_fused_forward``: one block per 16-row tile keeps the tile's
  activations in shared memory through all layers and streams each layer's
  weights from L2.
- K2 (``mlp_bwd_rows_kernel`` + ``mlp_wgrad_kernel``) replaces the Pallas
  ``_bwd_kernel`` launched by ``_fused_backward``: recompute the tile's
  forward (layer inputs and sigma' to a global scratch buffer allocated
  here), backpropagate to dx, then reduce dW_i = c_i^T g_i and db_i over
  rows in 128x128 tiles added with fp32 atomics.

Both are bound by fp32 multiply-adds on the CUDA cores: 2 (K1) and 6 (K2)
FLOPs per weight per row. The kernels take layers up to 264 wide (the SDF
trunk) or 520 (the 512-wide CESR nets).

``fused_mlp`` is a ``torch.autograd.Function`` whenever an input needs a
gradient: K1 forward, K2 backward, dx only where x needs it. Without
gradients it is K1 alone. ``_forward_rows`` and ``_backward_rows`` are the
plain PyTorch versions: the CPU tests run them (CPU tensors take them, and
only CPU tensors), and ``chip_smoke.py`` holds the kernels to them on the
card.

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
from .build import Kernel, int_array, library, ptr

_SQ2 = float(np.float32(1.0 / np.sqrt(2.0)))

# fixed limits of the CUDA kernels (csrc/trunk.cuh): K3 and K4 take layers
# up to MAX_WIDTH wide, K1 and K2 up to MAX_WIDTH_WIDE
MAX_LAYERS = 16
MAX_WIDTH = 264
MAX_WIDTH_WIDE = 520
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

    def width(self) -> int:
        """The widest layer input or output."""
        return max(max(self.layer_in_dim(i), self.layer_out_dim(i))
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


def _sigma_p(plan: MLPPlan, z):
    """sigma'(z) for the plan activation."""
    if plan.activation == "softplus100":
        return torch.sigmoid(100.0 * z)
    if plan.activation == "relu":
        return (z > 0).to(z.dtype)
    return torch.ones_like(z)


def _forward_rows(plan: MLPPlan, x, weights, biases):
    """Plain PyTorch trunk (the version K1 is held to)."""
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


def _backward_rows(plan: MLPPlan, x, weights, biases, dy, need_dx: bool = True):
    """Plain version of K2 (the Pallas ``_bwd_kernel``): recompute the
    forward, then backpropagate ``dy`` -> (dx or None, dWs, dbs)."""
    n = plan.n_layers
    cs, ss = [], []
    h = x
    for i in range(n):
        c = torch.cat([h, x], dim=-1) * _SQ2 if i in plan.skip_in else h
        cs.append(c)
        z = c @ weights[i] + biases[i]
        if i < n - 1:
            ss.append(_sigma_p(plan, z))
            h = _act(plan, z)
    g = dy
    dx = torch.zeros_like(x) if need_dx else None
    dws, dbs = [None] * n, [None] * n
    for i in range(n - 1, -1, -1):
        dws[i] = cs[i].t() @ g
        dbs[i] = g.sum(0)
        if i == 0 and not need_dx:
            break
        cbar = g @ weights[i].t()
        if i in plan.skip_in:
            d = plan.dims[i]
            if need_dx:
                dx = dx + cbar[:, d:] * _SQ2
            cbar = cbar[:, :d] * _SQ2
        if i > 0:
            g = cbar * ss[i - 1]
        else:
            dx = dx + cbar
    return dx, dws, dbs


def check_cuda_inputs(plan: MLPPlan, x: torch.Tensor,
                      weights: Sequence[torch.Tensor],
                      biases: Sequence[torch.Tensor],
                      max_width: int = MAX_WIDTH) -> None:
    """Raise on anything the CUDA kernels do not take (layers at most
    ``max_width`` wide)."""
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
        if max(shape) > max_width:
            raise ValueError(f"layer {i} wider than {max_width}")
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
BACKWARD = Kernel("fused_mlp.cu", "fused_mlp_backward",
                  [ctypes.c_void_p] * 9 + [ctypes.POINTER(ctypes.c_int),
                                           ctypes.c_longlong, ctypes.c_void_p])


def fused_mlp_cuda(plan: MLPPlan, x, weights, biases, packed=None) -> torch.Tensor:
    """Launch K1 on CUDA tensors: x [N, dims[0]] -> [N, out_dim].
    ``packed`` is ``pack_weights(weights, biases)`` made once for weights
    that many launches share."""
    check_cuda_inputs(plan, x, weights, biases, MAX_WIDTH_WIDE)
    x = x.contiguous()
    W, b = packed if packed is not None else pack_weights(weights, biases)
    y = torch.empty((x.shape[0], plan.out_dim), device=x.device,
                    dtype=torch.float32)
    FORWARD(ptr(x), ptr(W), ptr(b), ptr(y), int_array(plan.meta()),
            x.shape[0], stream_handle(x), shape=(build_width(plan), x.shape[0]))
    return y


def build_width(plan: MLPPlan) -> int:
    """The widest layer of the trunk-kernel build a plan runs: 264 or 520."""
    return MAX_WIDTH if plan.width() <= MAX_WIDTH else MAX_WIDTH_WIDE


def bwd_scratch_floats(plan: MLPPlan, n_rows: int) -> int:
    """Floats of global scratch K2 needs for n_rows (the kernel library lays
    the buffer out: each layer's input and its g, per row)."""
    fn = library("fused_mlp.cu").fused_mlp_bwd_scratch_floats
    fn.argtypes = [ctypes.POINTER(ctypes.c_int), ctypes.c_longlong]
    fn.restype = ctypes.c_longlong
    n = fn(int_array(plan.meta()), n_rows)
    if n < 0:
        raise ValueError(f"plan outside the kernels' limits: {plan}")
    return n


def mlp_backward_cuda(plan: MLPPlan, x, weights, biases, dy, need_dx: bool = True):
    """Launch K2: cotangent dy [N, out_dim] -> (dx or None, dWs, dbs)."""
    check_cuda_inputs(plan, x, weights, biases, MAX_WIDTH_WIDE)
    x, dy = x.contiguous(), dy.to(torch.float32).contiguous()
    if dy.shape != (x.shape[0], plan.out_dim) or dy.device != x.device:
        raise ValueError(f"cotangent {tuple(dy.shape)} does not match the "
                         f"output ({x.shape[0]}, {plan.out_dim}) on {x.device}")
    W, Wt, b = pack_weights(weights, biases, transposed=True)
    n = x.shape[0]
    dx = torch.empty_like(x) if need_dx else None
    dW = torch.zeros_like(W)
    db = torch.zeros_like(b)
    scratch = torch.empty(bwd_scratch_floats(plan, n), device=x.device,
                          dtype=torch.float32)
    BACKWARD(ptr(x), ptr(dy), ptr(W), ptr(Wt), ptr(b),
             ptr(dx) if need_dx else ctypes.c_void_p(None), ptr(dW), ptr(db),
             ptr(scratch), int_array(plan.meta()), n, stream_handle(x),
             shape=(build_width(plan), n))
    return dx, *unpack_grads(dW, db, weights, biases)


def unpack_grads(dW, db, weights, biases):
    """Flat dW/db buffers -> per-layer lists shaped like the weights."""
    dws, dbs, wo, bo = [], [], 0, 0
    for w, bb in zip(weights, biases):
        dws.append(dW[wo:wo + w.numel()].view(w.shape))
        dbs.append(db[bo:bo + bb.numel()])
        wo += w.numel()
        bo += bb.numel()
    return dws, dbs


class _FusedMLP(torch.autograd.Function):
    """K1 forward, K2 backward on CUDA tensors; the plain versions on CPU
    tensors."""

    @staticmethod
    def forward(ctx, plan, x, *wb):
        n = plan.n_layers
        ctx.plan = plan
        ctx.save_for_backward(x, *wb)
        if x.is_cuda:
            return fused_mlp_cuda(plan, x, wb[:n], wb[n:])
        return _forward_rows(plan, x, wb[:n], wb[n:])

    @staticmethod
    def backward(ctx, dy):
        plan = ctx.plan
        x, *wb = ctx.saved_tensors
        n = plan.n_layers
        backward = mlp_backward_cuda if x.is_cuda else _backward_rows
        dx, dws, dbs = backward(plan, x, wb[:n], wb[n:], dy,
                                need_dx=ctx.needs_input_grad[1])
        return (None, dx, *dws, *dbs)


def fused_mlp(plan: MLPPlan, x, weights, biases, packed=None) -> torch.Tensor:
    """x [N, dims[0]] -> [N, out_dim] through the trunk: the CUDA kernels for
    CUDA tensors (K1; K2 in the backward when an input needs a gradient),
    the plain versions for CPU tensors. ``packed`` (see ``fused_mlp_cuda``)
    serves the launches without a gradient."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_mlp runs on cuda or cpu, not {x.device}")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, *weights, *biases)):
        return _FusedMLP.apply(plan, x, *weights, *biases)
    if x.is_cuda:
        return fused_mlp_cuda(plan, x, weights, biases, packed)
    return _forward_rows(plan, x, weights, biases)
