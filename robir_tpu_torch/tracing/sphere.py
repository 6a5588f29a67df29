"""IDR sphere tracer: root finding against the live SDF (counterpart of
``robir_tpu/tracing/sphere.py``, the reference's ``model/ray_tracing.py``
RayTracing when ``use_octree=False``).

Dual-ended sphere tracing inside the bounding sphere (10 iterations, with
the back-stepping line search on overshoot), then for rays that did not
converge a 100-step dense search for the first negative sample and 8
secant steps, and the minimal-SDF point for rays that miss. Every branch
is masked dense compute over the whole ray batch, with static iteration
counts, as in the JAX package. Each SDF query is one call of ``sdf``
(for ``Stage2Model.sdf``: one K1 launch), 51 per trace with the default
config; the tracer runs under ``torch.no_grad()``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import torch

SDFFn = Callable[[torch.Tensor], torch.Tensor]  # [N, 3] -> [N] or [N, 1]


@dataclasses.dataclass(frozen=True)
class SphereTracerConfig:
    object_bounding_sphere: float = 1.0
    sdf_threshold: float = 5.0e-5
    line_search_step: float = 0.5
    line_step_iters: int = 1
    sphere_tracing_iters: int = 10
    n_steps: int = 100
    n_secant_steps: int = 8

    def sdf_calls(self) -> int:
        """SDF queries of one trace: the two ends, two per iteration and
        line-search step, the dense search, the secant steps."""
        return (2 + 2 * self.sphere_tracing_iters * (1 + self.line_step_iters)
                + 1 + self.n_secant_steps)


class TraceResult(NamedTuple):
    points: torch.Tensor  # [N, 3]
    mask: torch.Tensor    # [N] bool: converged surface hit
    dists: torch.Tensor   # [N]


def _sdf1(sdf: SDFFn, x: torch.Tensor) -> torch.Tensor:
    out = sdf(x)
    return out.reshape(out.shape[0]) if out.dim() > 1 else out


def sphere_intersection(cam_loc: torch.Tensor, dirs: torch.Tensor, r: float):
    """Ray-sphere near/far (reference ``utils/rend_util.py:141-163``).
    Returns (near [N], far [N], hit [N])."""
    b = torch.sum(dirs * cam_loc, dim=-1)
    c = torch.sum(cam_loc * cam_loc, dim=-1) - r * r
    under = b * b - c
    sq = torch.sqrt(torch.clamp(under, min=0.0))
    return (torch.clamp(-b - sq, min=0.0), torch.clamp(-b + sq, min=0.0),
            under > 0)


@torch.no_grad()
def sphere_trace(sdf: SDFFn, cam_loc: torch.Tensor, dirs: torch.Tensor,
                 cfg: SphereTracerConfig = SphereTracerConfig()) -> TraceResult:
    """Dual-ended sphere tracing plus the dense secant fallback."""
    n = dirs.shape[0]
    near, far, mask_intersect = sphere_intersection(cam_loc, dirs,
                                                    cfg.object_bounding_sphere)
    thr = cfg.sdf_threshold

    def eval_sdf(t):
        return _sdf1(sdf, cam_loc + t[:, None] * dirs)

    zero = torch.zeros((), dtype=near.dtype, device=near.device)
    t_s, t_e = near, far
    unf_s, unf_e = mask_intersect, mask_intersect
    next_s, next_e = eval_sdf(near), eval_sdf(far)
    for _ in range(cfg.sphere_tracing_iters):
        curr_s = torch.where(unf_s, next_s, zero)
        curr_e = torch.where(unf_e, next_e, zero)
        curr_s = torch.where(curr_s <= thr, zero, curr_s)
        curr_e = torch.where(curr_e <= thr, zero, curr_e)
        unf_s = unf_s & (curr_s > thr)
        unf_e = unf_e & (curr_e > thr)
        t_s = t_s + curr_s
        t_e = t_e - curr_e
        next_s = eval_sdf(t_s)
        next_e = eval_sdf(t_e)
        for i in range(cfg.line_step_iters):
            factor = (1.0 - cfg.line_search_step) / (2.0 ** i)
            back_s = unf_s & (next_s < 0)
            back_e = unf_e & (next_e < 0)
            t_s = torch.where(back_s, t_s - factor * curr_s, t_s)
            t_e = torch.where(back_e, t_e + factor * curr_e, t_e)
            next_s = torch.where(back_s, eval_sdf(t_s), next_s)
            next_e = torch.where(back_e, eval_sdf(t_e), next_e)
        crossed = t_s < t_e
        unf_s, unf_e = unf_s & crossed, unf_e & crossed
    t_start, t_end, unfinished_start = t_s, t_e, unf_s
    network_mask = t_start < t_end

    # dense sampling + secant for the rays that did not converge
    need_sampler = unfinished_start & mask_intersect
    steps = torch.linspace(0.0, 1.0, cfg.n_steps, dtype=near.dtype, device=near.device)
    t_samples = t_start[:, None] + (t_end - t_start)[:, None] * steps[None, :]
    pts = cam_loc[:, None, :] + t_samples[..., None] * dirs[:, None, :]
    s_samples = _sdf1(sdf, pts.reshape(-1, 3)).reshape(n, cfg.n_steps)

    # first negative sample, secant over (first - 1, first)
    neg = s_samples < 0
    any_change = torch.any(neg, dim=-1)
    first = torch.argmax(neg.to(torch.int8), dim=-1)
    lo = torch.clamp(first - 1, min=0)

    def pick(a, i):
        return torch.gather(a, 1, i[:, None])[:, 0]

    t_lo, t_hi = pick(t_samples, lo), pick(t_samples, first)
    s_lo, s_hi = pick(s_samples, lo), pick(s_samples, first)
    for _ in range(cfg.n_secant_steps):
        t_mid = t_lo - s_lo * (t_hi - t_lo) / (s_hi - s_lo + 1e-10)
        s_mid = _sdf1(sdf, cam_loc + t_mid[:, None] * dirs)
        neg = s_mid < 0
        t_hi = torch.where(neg, t_mid, t_hi)
        s_hi = torch.where(neg, s_mid, s_hi)
        t_lo = torch.where(neg, t_lo, t_mid)
        s_lo = torch.where(neg, s_lo, s_mid)
    t_secant = t_lo - s_lo * (t_hi - t_lo) / (s_hi - s_lo + 1e-10)

    t_final = torch.where(need_sampler & any_change, t_secant, t_start)
    mask_final = torch.where(need_sampler, any_change, network_mask) & mask_intersect

    # misses: the minimal-(signed)-sdf sample along the segment
    t_min = pick(t_samples, torch.argmin(s_samples, dim=-1))
    t_final = torch.where(mask_final, t_final,
                          torch.where(mask_intersect, t_min,
                                      -torch.sum(dirs * cam_loc, -1)))
    return TraceResult(points=cam_loc + t_final[:, None] * dirs,
                       mask=mask_final, dists=t_final)
