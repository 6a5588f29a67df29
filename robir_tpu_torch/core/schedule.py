"""Learning-rate schedule (counterpart of ``robir_tpu/core/schedule.py``;
only the stage-1 schedule, ``log_lerp_lr``, is ported)."""

from __future__ import annotations

from typing import Callable

import numpy as np


def log_lerp_lr(lr_init: float, lr_final: float, max_steps: int,
                lr_delay_steps: int = 0,
                lr_delay_mult: float = 1.0) -> Callable[[int], float]:
    """Mip-NeRF continuous LR decay: log-linear interpolation from lr_init
    to lr_final with an optional reverse-cosine warmup. Computed in float32,
    as the JAX package's traced schedule is."""
    f32 = np.float32

    def fn(step: int) -> float:
        s = f32(step)
        if lr_delay_steps > 0:
            delay_rate = f32(lr_delay_mult) + f32(1 - lr_delay_mult) * np.sin(
                f32(0.5 * np.pi) * np.clip(s / f32(lr_delay_steps), f32(0), f32(1)))
        else:
            delay_rate = f32(1.0)
        t = np.clip(s / f32(max_steps), f32(0), f32(1))
        log_lerp = np.exp(f32(np.log(lr_init)) * (f32(1) - t)
                          + f32(np.log(lr_final)) * t)
        return float(f32(delay_rate * log_lerp))

    return fn
