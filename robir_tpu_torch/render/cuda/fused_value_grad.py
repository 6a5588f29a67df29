"""SDF trunk value + spatial gradient, and its hand VJP, as CUDA kernels.

Counterpart of ``robir_tpu/render/pallas/fused_value_grad.py``:

- K3 (``csrc/fused_value_grad.cu:vg_fwd_kernel``) replaces the Pallas
  ``_fwd_kernel`` launched by ``_fused_vg_forward``: trunk forward saving
  ``s_i = sigma'(z_i)``, then the reverse chain that yields
  ``de = d y[:, 0] / d x``.
- K4 (``vg_bwd_rows_kernel`` + ``wgrad_kernel``) replaces the Pallas
  ``_bwd_kernel`` launched by ``_fused_vg_backward``: the ascending sweep
  through the reverse chain, the descending backward with ``sigma''``
  injections, then a reduction of ``dW``/``db`` over rows.

Both are bound by fp32 multiply-adds on the CUDA cores (about 4 and 8 x
524,544 FLOPs per row of the full-width trunk). Per-layer row state that
the TPU kept in VMEM goes to global scratch buffers allocated here (their
sizes in floats are ``scratch_floats``, which asks the kernel library, the
one place that lays them out). Where a backward can follow (grad mode on
and an input that needs a gradient), K3 writes the whole forward state
(``c_i, s_i, u_i, q_i``) and the autograd function keeps it for K4, which
starts from it; otherwise K3 writes ``s_i`` alone and keeps nothing. The
trunk products run as register tiles (8 x 8 per thread in 64-row tiles,
which the kernel library picks once the rows fill about two tiles per SM;
2 x 8 in 16-row tiles below that), fed by float4 shared loads from weight
k-slabs that ``cp.async`` stages ahead of the arithmetic. ``dW``/``db``
are summed over rows by the reduction K2 also uses (128 x 128 tiles, both
operand pairs of a layer in one launch), across blocks with fp32 atomics,
so their sums run in an order that changes from run to run.

``_forward_phases`` and ``_backward_phases`` are the plain PyTorch
versions, the same sweeps as the Pallas kernels: the CPU tests run them,
and ``chip_smoke.py`` holds the kernels to them on the card. The
``torch.autograd.Function`` launches the kernels for CUDA tensors and runs
the plain versions only for CPU tensors, with the same split: the forward
keeps its phases' state where a backward can follow, and on the card the
weights' pack (``fused_mlp.pack_weights``) beside it, so K4 packs nothing.
"""

from __future__ import annotations

import ctypes

import torch

from ...tools.profiler import count
from .build import Kernel, LaunchCount, int_array, library, ptr
from .fused_mlp import (_SQ2, MAX_WIDTH, MLPPlan, PackedWeights, _act, _sigma_p,
                        check_cuda_inputs, pack_weights, stream_handle,
                        unpack_grads)

_SOURCE = "fused_value_grad.cu"


def _sigma_pp(plan: MLPPlan, s):
    """sigma''(z) expressed through s = sigma'(z)."""
    if plan.activation == "softplus100":
        return 100.0 * s * (1.0 - s)
    return torch.zeros_like(s)


def _forward_phases(plan: MLPPlan, x, weights, biases):
    """Plain version of K3's math: returns (y, de, cs, ss, us, qs)."""
    n = plan.n_layers
    # phase 1: forward, saving layer inputs c_i and s_i = sigma'(z_i)
    cs, ss = [], []
    h = x
    y = None
    for i in range(n):
        c = torch.cat([h, x], dim=-1) * _SQ2 if i in plan.skip_in else h
        cs.append(c)
        z = c @ weights[i] + biases[i]
        if i < n - 1:
            ss.append(_sigma_p(plan, z))
            h = _act(plan, z)
        else:
            y = z
    # phase 2: reverse chain for de = d y_0 / d x from the one-hot seed e0
    e0 = torch.zeros((x.shape[0], plan.layer_out_dim(n - 1)), dtype=x.dtype,
                     device=x.device)
    e0[:, 0] = 1.0
    us = [None] * n
    qs = [None] * n
    us[n - 1] = e0
    de = torch.zeros_like(x)
    u = e0
    for i in range(n - 1, -1, -1):
        p = u @ weights[i].t()
        if i in plan.skip_in:
            d = plan.dims[i]
            de = de + p[:, d:] * _SQ2
            q = p[:, :d] * _SQ2
        else:
            q = p
        qs[i] = q
        if i > 0:
            u = ss[i - 1] * q
            us[i - 1] = u
        else:
            de = de + q
    return y, de, cs, ss, us, qs


def _backward_phases(plan: MLPPlan, x, weights, biases, dy, dde, saved=None):
    """Plain version of K4's math: the hand VJP of (y, de) -> (dx, dWs, dbs),
    from ``saved``, the (cs, ss, us, qs) of ``_forward_phases`` on the same
    inputs, or, without it, from running those phases here."""
    n = plan.n_layers
    if saved is None:
        saved = _forward_phases(plan, x, weights, biases)[2:]
    cs, ss, us, qs = saved

    # ascending sweep: VJP of the reverse (grad) chain
    sbars = [None] * (n - 1)
    ubar = None
    dws = [None] * n
    for i in range(n):
        if i == 0:
            qbar = dde
        else:
            qbar = ss[i - 1] * ubar
            sbars[i - 1] = qs[i] * ubar
        if i in plan.skip_in:
            pbar = torch.cat([qbar * _SQ2, dde * _SQ2], dim=-1)
        else:
            pbar = qbar
        dws[i] = pbar.t() @ us[i]
        ubar = pbar @ weights[i]

    # descending sweep: standard backward with sigma'' injections
    zbar = dy
    dx = torch.zeros_like(x)
    dbs = [None] * n
    for i in range(n - 1, -1, -1):
        dws[i] = dws[i] + cs[i].t() @ zbar
        dbs[i] = zbar.sum(0)
        cbar = zbar @ weights[i].t()
        if i in plan.skip_in:
            d = plan.dims[i]
            dx = dx + cbar[:, d:] * _SQ2
            abar = cbar[:, :d] * _SQ2
        else:
            abar = cbar
        if i > 0:
            zbar = ss[i - 1] * abar + _sigma_pp(plan, ss[i - 1]) * sbars[i - 1]
        else:
            dx = dx + abar
    return dx, dws, dbs


FORWARD = Kernel(_SOURCE, "fused_vg_forward",
                 [ctypes.c_void_p] * 7 + [ctypes.POINTER(ctypes.c_int), ctypes.c_longlong,
                                          ctypes.c_int, ctypes.c_void_p])
BACKWARD = Kernel(_SOURCE, "fused_vg_backward",
                  [ctypes.c_void_p] * 9 + [ctypes.POINTER(ctypes.c_int),
                                           ctypes.c_longlong, ctypes.c_void_p])
# the K3 launches (each also counted in FORWARD) that kept their state for K4
KEPT = LaunchCount()

# the scratch buffers, as the kernel library numbers them: K3's when no
# backward follows (s_i), the state K3 keeps for K4 (c_i, s_i, u_i, q_i),
# and K4's own (pbar_i, zbar_i, sigma''(z_{i-1}) * sbar_{i-1})
SCRATCH_BUFFERS = ("forward", "state", "backward")


def scratch_floats(plan: MLPPlan, n_rows: int, buffer: str) -> int:
    """Floats of one of ``SCRATCH_BUFFERS`` for n_rows."""
    fn = library(_SOURCE).fused_vg_scratch_floats
    fn.argtypes = [ctypes.POINTER(ctypes.c_int), ctypes.c_longlong, ctypes.c_int]
    fn.restype = ctypes.c_longlong
    n = fn(int_array(plan.meta()), n_rows, SCRATCH_BUFFERS.index(buffer))
    if n < 0:
        raise ValueError(f"plan outside the kernels' limits: {plan}")
    return n


def _launch_forward(plan: MLPPlan, x, packed: PackedWeights, keep: bool):
    check_cuda_inputs(plan, x, packed)
    x = x.contiguous()
    n = x.shape[0]
    y = torch.empty((n, plan.out_dim), device=x.device, dtype=torch.float32)
    de = torch.empty_like(x)
    scratch = torch.empty(scratch_floats(plan, n, "state" if keep else "forward"),
                          device=x.device, dtype=torch.float32)
    FORWARD(ptr(x), ptr(packed.W), ptr(packed.Wt), ptr(packed.b), ptr(y), ptr(de), ptr(scratch),
            int_array(plan.meta()), n, int(keep), stream_handle(x), shape=(MAX_WIDTH, n))
    if keep:
        KEPT.add((MAX_WIDTH, n))
    return y, de, scratch


def vg_forward_cuda(plan: MLPPlan, x, packed: PackedWeights):
    """Launch K3: x [N, d0] -> (y [N, out_dim], de [N, d0]), keeping
    nothing."""
    return _launch_forward(plan, x, packed, False)[:2]


def vg_forward_saving_cuda(plan: MLPPlan, x, packed: PackedWeights):
    """Launch K3 for a backward: x [N, d0] -> (y, de, saved), where saved
    is the per-row state K4 starts from (``saved`` of
    ``vg_backward_cuda``)."""
    return _launch_forward(plan, x, packed, True)


def vg_backward_cuda(plan: MLPPlan, x, packed: PackedWeights, dy, dde, saved):
    """Launch K4: cotangents (dy, dde) -> (dx, dWs, dbs), from ``saved``,
    the state ``vg_forward_saving_cuda`` returned for the same x and pack,
    which K4 only reads."""
    check_cuda_inputs(plan, x, packed)
    dy, dde = dy.contiguous(), dde.contiguous()
    if dy.shape != (x.shape[0], plan.out_dim) or dde.shape != x.shape:
        raise ValueError(f"cotangents {tuple(dy.shape)}, {tuple(dde.shape)} "
                         f"do not match x {tuple(x.shape)}")
    n = x.shape[0]
    if saved.shape != (scratch_floats(plan, n, "state"),):
        raise ValueError(f"saved state of {tuple(saved.shape)} floats does not match "
                         f"{n} rows of {plan}")
    dx = torch.empty((n, plan.dims[0]), device=x.device, dtype=torch.float32)
    dW = torch.zeros_like(packed.W)
    db = torch.zeros_like(packed.b)
    work = torch.empty(scratch_floats(plan, n, "backward"), device=x.device,
                       dtype=torch.float32)
    BACKWARD(ptr(dy), ptr(dde), ptr(packed.W), ptr(packed.Wt), ptr(dx), ptr(dW), ptr(db),
             ptr(saved), ptr(work), int_array(plan.meta()), n, stream_handle(x),
             shape=(MAX_WIDTH, n))
    return dx, *unpack_grads(dW, db, plan)


class _FusedValueGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, plan, grad_enabled, x, *wb):
        n = plan.n_layers
        ws, bs = wb[:n], wb[n:]
        ctx.plan = plan
        # needs_input_grad reads the inputs alone, also under no_grad (and
        # forward runs without grad mode): the caller's mode comes along
        keep = grad_enabled and any(ctx.needs_input_grad[2:])
        if x.is_cuda:
            wb = packed = pack_weights(plan, ws, bs, reverse=True)
            y, de, *state = (vg_forward_saving_cuda if keep else vg_forward_cuda)(plan, x, packed)
        else:
            y, de, *phases = _forward_phases(plan, x, ws, bs)
            state = [t for ts in phases for t in ts] if keep else []
        if keep:
            count("vg.saved_rows", x.shape[0])
        # with retain_graph False, autograd frees these after the backward
        ctx.save_for_backward(x, *wb, *state)
        return y, de

    @staticmethod
    def backward(ctx, dy, dde):
        plan = ctx.plan
        n = plan.n_layers
        x, *rest = ctx.saved_tensors
        if dy is None:
            dy = x.new_zeros((x.shape[0], plan.out_dim))
        if dde is None:
            dde = torch.zeros_like(x)
        if x.is_cuda:
            dx, dws, dbs = vg_backward_cuda(plan, x, PackedWeights(*rest[:3]), dy, dde, rest[3])
        else:
            ws, bs, state = rest[:n], rest[n:2 * n], rest[2 * n:]
            dx, dws, dbs = _backward_phases(plan, x, ws, bs, dy, dde,
                                            saved=(state[:n], state[n:2 * n - 1],
                                                   state[2 * n - 1:3 * n - 1],
                                                   state[3 * n - 1:]))
        return (None, None, dx, *dws, *dbs)


def fused_value_grad(plan: MLPPlan, x, weights, biases):
    """x [N, dims[0]] -> (y [N, out_dim], de = d y[:,0] / d x [N, dims[0]]).

    Differentiable once, through the hand VJP (K4 on CUDA); the train step
    needs exactly first derivatives of (y, de). Where a backward can follow,
    the forward keeps its per-row state for it (``vg.saved_rows`` counts
    those rows while a profiler runs)."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_value_grad runs on cuda or cpu, not {x.device}")
    return _FusedValueGrad.apply(plan, torch.is_grad_enabled(), x, *weights, *biases)
