"""Scalar schedules (counterpart of ``robir_tpu/core/schedule.py``; the
reference's ``utils/schedule.py:23-157`` and ``neus/misc/schedule.py``).

Each schedule is a pure function of the step, computed on the host in
float32 as the JAX package's traced schedules are: constant, linear,
exponential, cosine easing, step decay, piecewise and delayed, built by
``from_config`` from a scalar, a ``(type, *args)`` tuple, a mapping with a
``type`` key, or a callable; and the mip-NeRF log-lerp learning rate of the
stage-1 trainer (``neus/misc/math.py:91-124``). A step may be a number or
a numpy array; the value is a float32 numpy array of the step's shape.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Mapping, Sequence, Union

import numpy as np

ScheduleFn = Callable[[Any], np.ndarray]
f32 = np.float32


def _steps(step) -> np.ndarray:
    return np.asarray(step, f32)


def constant(value: float) -> ScheduleFn:
    return lambda step: np.full_like(_steps(step), value)


def linear(initial_value: float, final_value: float, num_steps: int) -> ScheduleFn:
    def fn(step):
        s = _steps(step)
        if num_steps == 0:
            return np.full_like(s, final_value)
        alpha = np.minimum(s / f32(num_steps), f32(1.0))
        return (f32(1.0) - alpha) * f32(initial_value) + alpha * f32(final_value)

    return fn


def exponential(initial_value: float, final_value: float, num_steps: int,
                eps: float = 1e-10) -> ScheduleFn:
    if initial_value <= final_value:
        raise ValueError("final value must be less than initial value")
    base = f32(max(final_value, eps) / initial_value)

    def fn(step):
        s = _steps(step)
        val = f32(initial_value) * base ** (s / f32(max(num_steps - 1, 1)))
        return np.where(s >= num_steps, f32(final_value), val).astype(f32)

    return fn


def cosine_easing(initial_value: float, final_value: float, num_steps: int) -> ScheduleFn:
    def fn(step):
        x = np.clip(_steps(step) / f32(num_steps), f32(0.0), f32(1.0))
        scale = f32(final_value - initial_value)
        return f32(initial_value) + scale * f32(0.5) * (f32(1) + np.cos(f32(np.pi) * x
                                                                          + f32(np.pi)))

    return fn


def step_decay(initial_value: float, decay_interval: int, decay_factor: float,
               max_decays: int, final_value: float | None = None) -> ScheduleFn:
    if final_value is None:
        final_value = initial_value * decay_factor ** max_decays

    def fn(step):
        phase = np.floor(_steps(step) / f32(decay_interval))
        val = f32(initial_value) * f32(decay_factor) ** phase
        return np.where(phase >= max_decays, f32(final_value), val).astype(f32)

    return fn


def piecewise(segments: Sequence[tuple[int, Any]]) -> ScheduleFn:
    """``segments`` = [(num_steps, schedule_config), ...]; each sub-schedule
    sees a step counted from its own start."""
    fns = [from_config(cfg) for _, cfg in segments]
    milestones = np.cumsum([n for n, _ in segments])[:-1]

    def fn(step):
        s = _steps(step)
        out = fns[0](s)
        for i, m in enumerate(milestones):
            out = np.where(s >= m, fns[i + 1](s - f32(m)), out)
        return np.asarray(out, f32)

    return fn


def delayed(base: Any, delay_steps: int, delay_mult: float) -> ScheduleFn:
    base_fn = from_config(base)

    def fn(step):
        s = _steps(step)
        rate = f32(delay_mult) + f32(1 - delay_mult) * np.sin(
            f32(0.5 * np.pi) * np.clip(s / f32(delay_steps), f32(0), f32(1)))
        return rate * base_fn(s)

    return fn


_SCHEDULE_MAP = {
    "constant": constant,
    "linear": linear,
    "exponential": exponential,
    "cosine_easing": cosine_easing,
    "step": step_decay,
    "piecewise": piecewise,
    "delayed": delayed,
}


def from_config(cfg: Union[float, int, Sequence, Mapping, ScheduleFn]) -> ScheduleFn:
    """A schedule from a scalar (constant), a ``(type, *args)`` tuple or
    list, a mapping ``{"type": ..., **kwargs}``, or a callable (as it is);
    an unknown type raises KeyError naming it."""
    if callable(cfg):
        return cfg
    if isinstance(cfg, (int, float)):
        return constant(float(cfg))
    if isinstance(cfg, (tuple, list)):
        kind, *args = cfg
        return _SCHEDULE_MAP[kind](*args)
    if isinstance(cfg, Mapping):
        d = dict(cfg)
        kind = d.pop("type")
        return _SCHEDULE_MAP[kind](**d)
    raise ValueError(f"unknown schedule config: {cfg!r}")


def log_lerp_lr(lr_init: float, lr_final: float, max_steps: int,
                lr_delay_steps: int = 0,
                lr_delay_mult: float = 1.0) -> Callable[[int], float]:
    """Mip-NeRF continuous LR decay: log-linear interpolation from lr_init
    to lr_final with an optional reverse-cosine warmup. Computed in float32,
    as the JAX package's traced schedule is."""

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


@dataclasses.dataclass(frozen=True)
class ScheduleConfig:
    """A schedule as a hashable value: its type and positional arguments."""

    kind: str
    args: tuple = ()

    def build(self) -> ScheduleFn:
        return _SCHEDULE_MAP[self.kind](*self.args)
