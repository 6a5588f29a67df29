"""Dense trunk forward (K1) and its recompute backward (K2) as hand-written
CUDA kernels.

Counterpart of ``robir_tpu/render/pallas/fused_mlp.py``. The kernels live in
``csrc/fused_mlp.cu``:

- K1 (``fused_mlp_fwd_kernel``) replaces the Pallas ``_fwd_kernel`` launched
  by ``_fused_forward``: a 16-row tile keeps its activations in shared
  memory through all layers and stages each layer's weights from L2.
- K2 (``mlp_bwd_rows_kernel`` + ``wgrad_kernel`` in ``csrc/wgrad.cuh``)
  replaces the Pallas ``_bwd_kernel`` launched by ``_fused_backward``:
  recompute the tile's forward (layer inputs and sigma' to a global scratch
  buffer allocated here), backpropagate to dx, then reduce dW_i = c_i^T g_i
  and db_i over rows in 128x128 tiles added with fp32 atomics.

Both are bound by fp32 multiply-adds on the CUDA cores: 2 (K1) and 6 (K2)
FLOPs per weight per row. The kernels take layers up to 264 wide (the SDF
trunk) or 520 (the 512-wide CESR nets). ``launch_geometry`` decides how a
launch spreads over the card: below one 16-row tile per SM a cluster of
``CLUSTER`` blocks shares each tile and splits every layer's columns into
windows; the plan's meta carries the windows to the kernels.

``fused_mlp`` is a ``torch.autograd.Function`` whenever an input needs a
gradient: K1 forward, K2 backward, dx only where x needs it. Without
gradients it is K1 alone. ``_forward_rows`` and ``_backward_rows`` are the
plain PyTorch versions: the CPU tests run them (CPU tensors take them, and
only CPU tensors), and ``chip_smoke.py`` holds the kernels to them on the
card.

Weights arrive as per-layer ``[in, out]`` tensors, folded by the SDF field.
``pack_weights`` alone lays them out for the launchers (K1-K4); K2 and K4
launch from the pack their forward made.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import NamedTuple, Sequence

import numpy as np
import torch

from .build import Kernel, int_array, library, ptr

_SQ2 = float(np.float32(1.0 / np.sqrt(2.0)))

# fixed limits of the CUDA kernels (csrc/trunk.cuh): K3 and K4 take layers
# up to MAX_WIDTH wide, K1 and K2 up to MAX_WIDTH_WIDE
MAX_LAYERS = 16
MAX_WIDTH = 264
MAX_WIDTH_WIDE = 520
MAX_IN = 64
# K1 and K2's launch geometry (csrc/fused_mlp.cu): rows per tile, blocks
# per tile below one tile per SM, columns of the register tiles (a wider
# window is split into windows of RT_COLS), windows per layer and direction
# over all ranks
TILE_ROWS = 16
CLUSTER = 2
RT_COLS = 256
MAX_WINDOWS = 8


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


@dataclasses.dataclass(frozen=True)
class LaunchGeometry:
    """How K1 or K2 spreads one launch over the card.

    ``cluster`` blocks share each 16-row tile; ``out[i]`` and ``inp[i]``
    list layer i's column windows over its outputs (the W product: K1, K2's
    recompute) and its inputs (the W^T product: K2's backward), rank-major:
    rank r owns the r-th run of ``len(windows) // cluster`` of them. Each
    window is one call of the register-tiled rt_mm. At one block per tile
    K1 runs its tile_mm kernel instead, whose small shared memory lets
    several blocks share an SM, and ignores the windows.
    """

    cluster: int
    tiles: int
    out: tuple[tuple[tuple[int, int], ...], ...]
    inp: tuple[tuple[tuple[int, int], ...], ...]

    @property
    def ctas(self) -> int:
        return self.tiles * self.cluster

    def rank_windows(self, windows, rank: int):
        per = len(windows) // self.cluster
        return windows[rank * per:(rank + 1) * per]

    def meta(self) -> list[int]:
        """The kernels' geometry, after the plan's meta: [cluster, then per
        layer: the count and cuts of its output windows, then of its input
        windows]."""
        m = [self.cluster]
        for out, inp in zip(self.out, self.inp):
            for windows in (out, inp):
                m += [len(windows), 0] + [e for _, e in windows]
        return m


def column_windows(width: int, cluster: int) -> tuple[tuple[int, int], ...]:
    """[0, width) split into ``cluster`` rank ranges at 4-aligned cuts (as
    even as that allows; the last rank takes the ragged end), each range
    into windows of RT_COLS while more than MAX_WIDTH columns remain. (Only
    one block per tile meets a range that wide, so every rank gets as many
    windows as the others, as the kernels require.)"""
    cuts = [4 * (r * width // (4 * cluster)) for r in range(cluster)] + [width]
    windows = []
    for a, e in zip(cuts, cuts[1:]):
        while e - a > MAX_WIDTH:
            windows.append((a, a + RT_COLS))
            a += RT_COLS
        windows.append((a, e))
    return tuple(windows)


def launch_geometry(plan: MLPPlan, n_rows: int, sms: int) -> LaunchGeometry:
    """K1's and K2's geometry for ``n_rows`` on a card of ``sms`` SMs: while
    the launch has fewer rows than one tile per SM, a cluster of CLUSTER
    blocks per tile, multiplying with rt_mm; else one block per tile, where
    K1 runs its tile_mm kernel and K2 rt_mm."""
    tiles = -(-n_rows // TILE_ROWS)
    c = CLUSTER if n_rows < TILE_ROWS * sms else 1
    out = tuple(column_windows(plan.layer_out_dim(i), c) for i in range(plan.n_layers))
    inp = tuple(column_windows(plan.layer_in_dim(i), c) for i in range(plan.n_layers))
    if any(len(w) > MAX_WINDOWS for w in out + inp):
        raise ValueError(f"plan too wide for the kernels' windows: {plan}")
    return LaunchGeometry(cluster=c, tiles=tiles, out=out, inp=inp)


@functools.lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


@functools.lru_cache(maxsize=256)
def _launch_meta(plan: MLPPlan, n_rows: int, sms: int) -> ctypes.Array:
    """The kernels' meta (plan, then geometry), made once per shape: the
    CESR tracer launches K1 51 times a step at two shapes."""
    return int_array(plan.meta() + launch_geometry(plan, n_rows, sms).meta())


def launch_meta(plan: MLPPlan, x: torch.Tensor) -> ctypes.Array:
    return _launch_meta(plan, x.shape[0], sm_count(x.device))


class PackedWeights(NamedTuple):
    """The flat buffers the kernels read: W as row-major [in, out] blocks,
    b, and W^T as [out, in] blocks at W's offsets (None where only K1 reads)."""

    W: torch.Tensor
    b: torch.Tensor
    Wt: torch.Tensor | None = None


def pack_weights(plan: MLPPlan, weights: Sequence[torch.Tensor],
                 biases: Sequence[torch.Tensor], reverse: bool = False) -> PackedWeights:
    """Check per-layer [in, out] weights and biases against the plan (fp32,
    on one device) and pack them, once for the launches that share them;
    with ``reverse`` also W^T, which K2, K3 and K4 read."""
    shapes = [(plan.layer_in_dim(i), plan.layer_out_dim(i)) for i in range(plan.n_layers)]
    got = [tuple(w.shape) for w in weights], [tuple(b.shape) for b in biases]
    if got != (shapes, [(o,) for _, o in shapes]):
        raise ValueError(f"weights and biases of shapes {got}, not the plan's {shapes}")
    if any(t.device != weights[0].device or t.dtype != torch.float32 for t in (*weights, *biases)):
        raise ValueError("weights and biases must be float32 on one device")
    W = torch.cat([w.reshape(-1) for w in weights])
    b = torch.cat([bb.reshape(-1) for bb in biases])
    Wt = torch.cat([w.t().reshape(-1) for w in weights]) if reverse else None
    return PackedWeights(W, b, Wt)


def check_cuda_inputs(plan: MLPPlan, x: torch.Tensor, packed: PackedWeights,
                      max_width: int = MAX_WIDTH) -> None:
    """Raise on a launch the CUDA kernels do not take: a plan outside their
    limits (at most ``max_width`` wide), or an x that does not fit it."""
    if plan.activation != "softplus100":
        raise ValueError(f"the kernels apply softplus100 only, not {plan.activation!r}")
    if plan.n_layers > MAX_LAYERS or plan.dims[0] > MAX_IN or 0 in plan.skip_in:
        raise ValueError(f"plan outside the kernels' limits: {plan}")
    if plan.width() > max_width:
        raise ValueError(f"plan wider than {max_width}: {plan}")
    if x.dim() != 2 or x.shape[1] != plan.dims[0]:
        raise ValueError(f"x {tuple(x.shape)} does not match plan input {plan.dims[0]}")
    if x.device != packed.W.device or x.dtype != torch.float32:
        raise ValueError("x must be float32 on the weights' CUDA device")


def stream_handle(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


FORWARD = Kernel("fused_mlp.cu", "fused_mlp_forward",
                 [ctypes.c_void_p] * 4 + [ctypes.POINTER(ctypes.c_int),
                                          ctypes.c_longlong, ctypes.c_void_p])
BACKWARD = Kernel("fused_mlp.cu", "fused_mlp_backward",
                  [ctypes.c_void_p] * 9 + [ctypes.POINTER(ctypes.c_int),
                                           ctypes.c_longlong, ctypes.c_void_p])


def fused_mlp_cuda(plan: MLPPlan, x, packed: PackedWeights) -> torch.Tensor:
    """Launch K1 on CUDA tensors: x [N, dims[0]] -> [N, out_dim]."""
    check_cuda_inputs(plan, x, packed, MAX_WIDTH_WIDE)
    x = x.contiguous()
    n = x.shape[0]
    y = torch.empty((n, plan.out_dim), device=x.device, dtype=torch.float32)
    FORWARD(ptr(x), ptr(packed.W), ptr(packed.b), ptr(y), launch_meta(plan, x), n,
            stream_handle(x), shape=(build_width(plan), n))
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


def mlp_backward_cuda(plan: MLPPlan, x, packed: PackedWeights, dy, need_dx: bool = True):
    """Launch K2: cotangent dy [N, out_dim] -> (dx or None, dWs, dbs)."""
    check_cuda_inputs(plan, x, packed, MAX_WIDTH_WIDE)
    x, dy = x.contiguous(), dy.to(torch.float32).contiguous()
    if dy.shape != (x.shape[0], plan.out_dim) or dy.device != x.device:
        raise ValueError(f"cotangent {tuple(dy.shape)} does not match the "
                         f"output ({x.shape[0]}, {plan.out_dim}) on {x.device}")
    n = x.shape[0]
    dx = torch.empty_like(x) if need_dx else None
    dW = torch.zeros_like(packed.W)
    db = torch.zeros_like(packed.b)
    scratch = torch.empty(bwd_scratch_floats(plan, n), device=x.device,
                          dtype=torch.float32)
    BACKWARD(ptr(x), ptr(dy), ptr(packed.W), ptr(packed.Wt), ptr(packed.b),
             ptr(dx) if need_dx else ctypes.c_void_p(None), ptr(dW), ptr(db),
             ptr(scratch), launch_meta(plan, x), n, stream_handle(x),
             shape=(build_width(plan), n))
    return dx, *unpack_grads(dW, db, plan)


def max_active_clusters(plan: MLPPlan, backward: bool) -> int:
    """Clusters of CLUSTER blocks of K1 (or K2's rows kernel) at the plan's
    build width that the current card holds at once
    (``cudaOccupancyMaxActiveClusters``)."""
    lib = library("fused_mlp.cu")
    fn = lib.fused_mlp_max_active_clusters
    fn.argtypes = [ctypes.c_int] * 2 + [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    out = ctypes.c_int(0)
    err = fn(build_width(plan), int(backward), ctypes.byref(out))
    if err:
        raise RuntimeError(f"cudaOccupancyMaxActiveClusters: CUDA error {err}")
    return out.value


def unpack_grads(dW, db, plan: MLPPlan):
    """Flat buffers laid out as a pack's W and b -> per-layer lists of
    views at the plan's [in, out] and [out] shapes."""
    shapes = [(plan.layer_in_dim(i), plan.layer_out_dim(i)) for i in range(plan.n_layers)]
    dws = [w.view(shape) for w, shape in zip(dW.split([i * o for i, o in shapes]), shapes)]
    return dws, list(db.split([o for _, o in shapes]))


class _FusedMLP(torch.autograd.Function):
    """K1 forward, K2 backward on CUDA tensors, both from one pack; the
    plain versions on CPU tensors."""

    @staticmethod
    def forward(ctx, plan, x, *wb):
        n = plan.n_layers
        ctx.plan = plan
        if x.is_cuda:
            packed = pack_weights(plan, wb[:n], wb[n:], reverse=True)
            ctx.save_for_backward(x, *packed)
            return fused_mlp_cuda(plan, x, packed)
        ctx.save_for_backward(x, *wb)
        return _forward_rows(plan, x, wb[:n], wb[n:])

    @staticmethod
    def backward(ctx, dy):
        plan = ctx.plan
        x, *held = ctx.saved_tensors
        n = plan.n_layers
        need_dx = ctx.needs_input_grad[1]
        if x.is_cuda:
            dx, dws, dbs = mlp_backward_cuda(plan, x, PackedWeights(*held), dy, need_dx)
        else:
            dx, dws, dbs = _backward_rows(plan, x, held[:n], held[n:], dy, need_dx)
        return (None, dx, *dws, *dbs)


def frozen_mlp(plan: MLPPlan, weights, biases):
    """``x -> fused_mlp(plan, x, weights, biases)`` without a graph, for
    queries of weights that stay fixed between them (a tracer's, a bake's):
    on the card the weights are packed once, here."""
    if not weights[0].is_cuda:
        return lambda x: _forward_rows(plan, x, weights, biases)
    packed = pack_weights(plan, weights, biases)
    return lambda x: fused_mlp_cuda(plan, x, packed)


def fused_mlp(plan: MLPPlan, x, weights, biases) -> torch.Tensor:
    """x [N, dims[0]] -> [N, out_dim] through the trunk: the CUDA kernels for
    CUDA tensors (K1; K2 in the backward when an input needs a gradient),
    the plain versions for CPU tensors."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_mlp runs on cuda or cpu, not {x.device}")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, *weights, *biases)):
        return _FusedMLP.apply(plan, x, *weights, *biases)
    return frozen_mlp(plan, weights, biases)(x)
