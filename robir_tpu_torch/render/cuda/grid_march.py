"""The grid march as a hand-written CUDA kernel (``csrc/grid_march.cu``).

Counterpart of the march inside ``robir_tpu/tracing/grid.py:grid_cast``
(``_march`` and ``_refine``, a ``lax.while_loop`` in the JAX package, not
a Pallas kernel): one thread per ray runs the sphere trace of the cached
SDF grid and the bisection and Newton refinement in registers, reading
each lookup's eight corners from the base [R, R, R] grid.

``tracing/grid.py:grid_cast`` launches it for CUDA tensors, with the
config's scalars rounded as the plain version rounds them; its plain
version is ``tracing/grid.py:grid_cast_plain``, which the CPU tests run and
``chip_smoke.py`` holds the kernel to on the card. The kernel is compiled
without multiply-add contraction, so that its hits are the plain
version's bit for bit.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from .build import Kernel, ptr
from .fused_mlp import stream_handle

MARCH = Kernel("grid_march.cu", "grid_march",
               [ctypes.c_void_p] * 6 + [ctypes.POINTER(ctypes.c_float)]
               + [ctypes.c_int] * 4 + [ctypes.c_longlong, ctypes.c_void_p])


def grid_march_cuda(grid: torch.Tensor, rays_o: torch.Tensor, rays_d: torch.Tensor,
                    consts: Sequence[float], max_steps: int, over: bool):
    """(t [N], hit [N] bool, x [N, 3]) of the rays [N, 3] against ``grid``
    ([R, R, R], float32 or bfloat16), all on one CUDA device. ``consts``
    are the 16 scalars of ``tracing/grid.py:march_constants``; ``over``
    turns on over-relaxation. Raises on inputs the kernel does not take or
    if the launch fails."""
    R = grid.shape[0]
    if (grid.dim() != 3 or tuple(grid.shape) != (R, R, R) or R < 2
            or grid.dtype not in (torch.float32, torch.bfloat16) or not grid.is_contiguous()):
        raise ValueError(f"grid {tuple(grid.shape)} {grid.dtype}: expected a contiguous "
                         f"[R, R, R] float32 or bfloat16 grid")
    if len(consts) != 16:
        raise ValueError(f"{len(consts)} march constants, expected 16")
    for name, a in (("rays_o", rays_o), ("rays_d", rays_d)):
        if a.dim() != 2 or a.shape[1] != 3 or a.dtype != torch.float32:
            raise ValueError(f"{name} {tuple(a.shape)} {a.dtype}: expected [N, 3] float32")
        if not (a.is_cuda and a.device == grid.device):
            raise ValueError("the grid and the rays must lie on one CUDA device")
    o, d = rays_o.contiguous(), rays_d.contiguous()
    n = o.shape[0]
    t = torch.empty(n, device=o.device)
    hit = torch.empty(n, dtype=torch.bool, device=o.device)
    x = torch.empty(n, 3, device=o.device)
    MARCH(ptr(grid), ptr(o), ptr(d), ptr(t), ptr(hit), ptr(x), (ctypes.c_float * 16)(*consts),
          R, max_steps, int(grid.dtype == torch.bfloat16), int(over), n, stream_handle(o),
          shape=(R, n))
    return t, hit, x
