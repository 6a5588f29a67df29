"""Cached-SDF grid tracer (counterpart of ``robir_tpu/tracing/grid.py``):
the frozen SDF baked onto the nodes of a dense [R, R, R] grid, looked up
by trilinear interpolation and sphere-traced, and the hard-visibility
oracle built on the cast.

The lookup is JAX's arithmetic exactly: the clip to ``R - 1 - 1e-6`` and
the cell index clamped to ``R - 2`` (``_prologue``), the four (x, y)
corners blended in the order r00, r01, r10, r11, then the two z nodes
blended. Storage is bfloat16 when ``storage_dtype="bfloat16"``; the
interpolation runs in fp32. JAX's ``quad_rows`` and ``blocked_gather``
are lookup layouts for the TPU's row gathers, bit-exact with the plain
lookup there; the port accepts both keys and its lookup reads the eight
corners from the base grid whatever they say.

``grid_cast`` on a CUDA tensor launches the grid-march kernel
(``csrc/grid_march.cu``, one thread per ray) or raises; on a CPU tensor it
runs ``grid_cast_plain``, the kernel's plain version: one masked march of
``max_steps`` steps over all rays (stopping once no ray is active, a host
check per step), then the bisection and Newton refinement. JAX splits the
march into a head and a compacted tail; each ray's trajectory is
independent of the others, so the split changes no result and the port
has none.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from .. import resolve_device
from ..render.cuda.grid_march import grid_march_cuda


@dataclasses.dataclass(frozen=True)
class GridConfig:
    resolution: int = 256
    bbox_min: tuple[float, float, float] = (-1.0, -1.0, -1.0)
    bbox_max: tuple[float, float, float] = (1.0, 1.0, 1.0)
    max_steps: int = 128        # sphere-trace iterations (masked)
    relax: float = 0.9          # step = relax * |sdf|
    hit_eps_cells: float = 0.25  # hit when sdf < hit_eps_cells * cell
    start_offset: float = 5e-3
    # JAX's compacted march tail: a TPU device for ragged work, no result
    # of its own; read by nothing in the port
    compact_after: int = 2
    compact_chunk: int = 4096
    # JAX's TPU lookup layouts (bit-exact there); the port's lookup ignores them
    blocked_gather: bool = False
    quad_rows: bool = False
    # over-relaxed sphere tracing with rejection (Keinert et al. 2014);
    # 0.0 = off
    over_relax: float = 0.0
    storage_dtype: str | None = None

    @property
    def store(self) -> torch.dtype:
        return torch.bfloat16 if self.storage_dtype == "bfloat16" else torch.float32

    @property
    def bbox_lo(self) -> np.ndarray:
        return np.asarray(self.bbox_min, np.float32)

    @property
    def bbox_hi(self) -> np.ndarray:
        return np.asarray(self.bbox_max, np.float32)

    @property
    def cell(self) -> float:
        return float(np.max((self.bbox_hi - self.bbox_lo) / self.resolution))


def f32(v: float) -> float:
    """``v`` rounded to float32, as JAX rounds a Python scalar that meets a
    float32 array."""
    return float(np.float32(v))


@dataclasses.dataclass(frozen=True)
class MarchConstants:
    """The march's scalars, each rounded to float32 where the JAX package
    rounds it (Python arithmetic in double first). The plain version and
    the kernel both read these."""
    eps_hit: float
    min_step: float
    max_dt: float            # the Newton step's clip, 10 * min_step
    omega: float             # over_relax if over else relax
    relax: float
    over: bool
    start_offset: float
    normal_eps: float        # grid_normal's difference step (one cell)
    two_eps: float

    @classmethod
    def of(cls, cfg: GridConfig) -> "MarchConstants":
        over = cfg.over_relax > 1.0
        min_step = 0.5 * cfg.cell
        return cls(eps_hit=f32(cfg.hit_eps_cells * cfg.cell), min_step=f32(min_step),
                   max_dt=f32(10 * min_step),
                   omega=f32(cfg.over_relax if over else cfg.relax),
                   relax=f32(cfg.relax), over=over, start_offset=f32(cfg.start_offset),
                   normal_eps=f32(cfg.cell), two_eps=f32(2 * cfg.cell))


# over-relaxation's "was the previous step over-relaxed" margin, 1 + 1e-6
OVER_MARGIN = f32(1 + 1e-6)


def march_constants(cfg: GridConfig) -> list[float]:
    """The grid-march kernel's 16 fp32 scalars, in the order it reads them."""
    k = MarchConstants.of(cfg)
    return [*map(float, cfg.bbox_lo), *map(float, cfg.bbox_hi), k.eps_hit, k.min_step,
            k.max_dt, k.omega, k.relax, OVER_MARGIN, k.start_offset, k.normal_eps,
            k.two_eps, f32(cfg.resolution - 1 - 1e-6)]


BAKE_CHUNK = 65536  # grid nodes per sdf_fn call in the bake, as in JAX


def node_points(cfg: GridConfig, start: int, stop: int, device) -> torch.Tensor:
    """The grid nodes ``start:stop`` (in x-major order) as [stop - start, 3]
    points on ``device``, built there from the three axes
    ``np.linspace(lo, hi, R, dtype=float32)`` (JAX's axes)."""
    R = cfg.resolution
    axes = [torch.as_tensor(np.linspace(cfg.bbox_lo[i], cfg.bbox_hi[i], R, dtype=np.float32),
                            device=device) for i in range(3)]
    idx = torch.arange(start, stop, device=device)
    return torch.stack([axes[0][idx // (R * R)], axes[1][(idx // R) % R], axes[2][idx % R]], -1)


def build_sdf_grid(sdf_fn: Callable[[torch.Tensor], torch.Tensor], cfg: GridConfig,
                   chunk: int = BAKE_CHUNK, device="cuda") -> torch.Tensor:
    """Bake ``sdf_fn`` ([N, 3] -> [N] or [N, 1]) on the grid's nodes: an
    [R, R, R] tensor of ``cfg.store`` on ``device`` (``cuda`` unless the
    caller asks for the CPU), R nodes spanning [lo, hi] on each axis, one
    call per ``chunk`` nodes, whose points are built on the device (only
    the three axes are uploaded)."""
    device = resolve_device(device)
    n = cfg.resolution ** 3
    vals = torch.empty(n, device=device)
    with torch.no_grad():
        for start in range(0, n, chunk):
            stop = min(start + chunk, n)
            vals[start:stop] = sdf_fn(node_points(cfg, start, stop, device)).reshape(-1)
    return vals.reshape((cfg.resolution,) * 3).to(cfg.store)


def _prologue(cfg: GridConfig, x: torch.Tensor):
    """(cell index [N, 3] int64, fraction [N, 3]): grid coordinates clipped
    to [0, R - 1 - 1e-6], the cell index clamped to R - 2 (the inset can
    round back to R - 1 in fp32; f = 1 then lands on node R - 1)."""
    R = cfg.resolution
    lo = torch.as_tensor(cfg.bbox_lo, device=x.device)
    span = torch.as_tensor(cfg.bbox_hi - cfg.bbox_lo, device=x.device)
    g = (x - lo) / span * (R - 1)
    g = torch.clamp(g, 0.0, f32(R - 1 - 1e-6))
    i0 = torch.clamp(torch.floor(g), max=R - 2)
    return i0.to(torch.int64), g - i0


def grid_sdf(grid: torch.Tensor, cfg: GridConfig, x: torch.Tensor) -> torch.Tensor:
    """Trilinear SDF lookup, [N, 3] -> [N] in fp32. Outside the bbox it
    clamps to the boundary value."""
    R = cfg.resolution
    i0, f = _prologue(cfg, x)
    flat = grid.reshape(-1)
    base = (i0[:, 0] * R + i0[:, 1]) * R + i0[:, 2]
    fx, fy, fz = f[:, 0], f[:, 1], f[:, 2]
    w00, w01 = (1 - fx) * (1 - fy), (1 - fx) * fy
    w10, w11 = fx * (1 - fy), fx * fy

    def blend(dz: int) -> torch.Tensor:
        c = [flat[base + dxy + dz].float() for dxy in (0, R, R * R, R * R + R)]
        return c[0] * w00 + c[1] * w01 + c[2] * w10 + c[3] * w11

    return blend(0) * (1 - fz) + blend(1) * fz


def grid_normal(grid: torch.Tensor, cfg: GridConfig, x: torch.Tensor) -> torch.Tensor:
    """Unit central-difference normal of the interpolated SDF, one cell
    each way."""
    k = MarchConstants.of(cfg)
    grads = []
    for i in range(3):
        xp, xm = x.clone(), x.clone()
        xp[:, i] = x[:, i] + k.normal_eps
        xm[:, i] = x[:, i] - k.normal_eps
        grads.append((grid_sdf(grid, cfg, xp) - grid_sdf(grid, cfg, xm)) / k.two_eps)
    n0, n1, n2 = grads
    norm = torch.sqrt(n0 * n0 + n1 * n1 + n2 * n2)
    return torch.stack(grads, -1) / torch.clamp(norm, min=1e-4)[:, None]


def _ray_bbox(cfg: GridConfig, o: torch.Tensor, d: torch.Tensor):
    """(valid, t_near, t_far) of each ray against the grid's box."""
    lo = torch.as_tensor(cfg.bbox_lo, device=o.device)
    hi = torch.as_tensor(cfg.bbox_hi, device=o.device)
    inv = 1.0 / torch.where(torch.abs(d) < f32(1e-9), f32(1e-9), d)
    t0 = (lo - o) * inv
    t1 = (hi - o) * inv
    tmin = torch.amax(torch.minimum(t0, t1), dim=-1)
    tmax = torch.amin(torch.maximum(t0, t1), dim=-1)
    near = torch.clamp(tmin, min=0.0)
    return tmax > near, near, tmax


def _along(o, d, t):
    return o + t[:, None] * d


def grid_cast_plain(grid: torch.Tensor, cfg: GridConfig, rays_o: torch.Tensor,
                    rays_d: torch.Tensor):
    """The grid march in plain PyTorch -> (t [N], hit [N], x [N, 3],
    lookups [N]): ``_march`` then ``_refine`` of the JAX package, masked
    over all rays. ``lookups`` counts the SDF lookups each ray needs (its
    march steps, and for a hit the refinement's 8 or 16), which the
    kernel's bound is computed from."""
    k = MarchConstants.of(cfg)
    sdf = lambda p: grid_sdf(grid, cfg, p)  # noqa: E731
    o, d = rays_o, rays_d
    valid, t_near, t_far = _ray_bbox(cfg, o, d)
    t = t_near + k.start_offset
    t_prev = t
    active, hit = valid, torch.zeros_like(valid)
    lookups = torch.zeros(o.shape[0], dtype=torch.int32, device=o.device)
    s_prev = step_prev = torch.zeros_like(t)
    for _ in range(cfg.max_steps):
        if not bool(active.any()):
            break
        lookups += active.to(torch.int32)
        s = sdf(_along(o, d, t))
        if k.over:
            cons_prev = torch.clamp(k.relax * s_prev, min=k.min_step)
            was_over = step_prev > cons_prev * OVER_MARGIN
            fail = active & was_over & (step_prev > torch.abs(s_prev) + torch.abs(s))
        else:
            fail = torch.zeros_like(active)
        new_hit = active & ~fail & (s < k.eps_hit)
        step = torch.clamp(k.omega * s, min=k.min_step)
        if k.over:
            cons_now = torch.clamp(k.relax * s, min=k.min_step)
            step = torch.where((t + step > t_far) & (t + cons_now <= t_far), cons_now, step)
        adv = active & ~new_hit & ~fail
        t_next = torch.where(adv, t + step, t)
        if k.over:
            t_next = torch.where(fail, t_prev + cons_prev, t_next)
            s_prev_n = torch.where(adv, s, s_prev)
            step_prev = torch.where(adv, step, torch.where(fail, cons_prev, step_prev))
            s_prev = s_prev_n
        active = active & ~new_hit & (t_next <= t_far)
        t_prev = torch.where(adv, t, t_prev)
        hit = hit | new_hit
        t = t_next

    # refinement: bisection on [t_prev, t] where the last step overshot,
    # then one Newton step along the normal
    lo, hi = t_prev, t
    bracketed = hit & (sdf(_along(o, d, hi)) < 0.0)
    for _ in range(8):
        mid = 0.5 * (lo + hi)
        go_lo = sdf(_along(o, d, mid)) > 0.0
        lo = torch.where(bracketed & go_lo, mid, lo)
        hi = torch.where(bracketed & ~go_lo, mid, hi)
    t = torch.where(bracketed, 0.5 * (lo + hi), t)
    x = _along(o, d, t)
    n = grid_normal(grid, cfg, x)
    s = sdf(x)
    speed = d[:, 0] * n[:, 0] + d[:, 1] * n[:, 1] + d[:, 2] * n[:, 2]
    speed = torch.where(torch.abs(speed) < f32(1e-4), f32(1e-4), speed)
    dt = torch.clamp(-s / speed, -k.max_dt, k.max_dt)
    t = torch.where(hit, t + dt, t)
    lookups += hit.to(torch.int32) * 8 + bracketed.to(torch.int32) * 8
    return t, hit, _along(o, d, t), lookups


def grid_cast(grid: torch.Tensor, cfg: GridConfig, rays_o: torch.Tensor,
              rays_d: torch.Tensor):
    """Sphere-trace the cached SDF: [N, 3], [N, 3] -> (t [N], hit [N],
    x [N, 3]), without a graph. CUDA tensors go through the grid-march
    kernel (or raise), CPU tensors through ``grid_cast_plain``."""
    R = cfg.resolution
    if tuple(grid.shape) != (R, R, R) or grid.dtype != cfg.store:
        raise ValueError(f"grid {tuple(grid.shape)} {grid.dtype}: the config's is "
                         f"[{R}, {R}, {R}] {cfg.store}")
    with torch.no_grad():
        if rays_o.is_cuda:
            return grid_march_cuda(grid, rays_o, rays_d, march_constants(cfg),
                                   cfg.max_steps, cfg.over_relax > 1.0)
        return grid_cast_plain(grid, cfg, rays_o, rays_d)[:3]


def grid_visibility_logits(grid: torch.Tensor, cfg: GridConfig, points: torch.Tensor,
                           dirs: torch.Tensor, mag: float = 10.0) -> torch.Tensor:
    """Hard visibility oracle: [..., 3], [..., 3] -> [..., 2] logits
    (occluded, visible) of +-mag. Origins within max(start_offset,
    2 * hit_eps) of the surface are first pushed out along the local
    normal, so that grazing directions do not hit their own surface."""
    shape = points.shape[:-1]
    p = points.reshape(-1, 3)
    d = dirs.reshape(-1, 3)
    d = d / torch.clamp(torch.linalg.norm(d, dim=-1, keepdim=True), min=1e-9)
    offset = f32(max(cfg.start_offset, 2.0 * (cfg.hit_eps_cells * cfg.cell)))
    s = grid_sdf(grid, cfg, p)
    n = grid_normal(grid, cfg, p)
    p = torch.where((s < offset)[:, None],
                    p + n * torch.clamp(offset - s, min=0.0)[:, None], p)
    _, hit, _ = grid_cast(grid, cfg, p, d)
    logits = torch.stack([torch.where(hit, mag, -mag), torch.where(hit, -mag, mag)], -1)
    return logits.reshape(shape + (2,))


@dataclasses.dataclass
class SDFGrid:
    """A baked grid and its config: the stage-2 tracer."""
    values: torch.Tensor
    cfg: GridConfig

    @classmethod
    def build(cls, sdf_fn, cfg: GridConfig = GridConfig(), device="cuda") -> "SDFGrid":
        return cls(build_sdf_grid(sdf_fn, cfg, device=device), cfg)

    def sdf(self, x):
        return grid_sdf(self.values, self.cfg, x)

    def normal(self, x):
        return grid_normal(self.values, self.cfg, x)

    def cast(self, rays_o, rays_d):
        return grid_cast(self.values, self.cfg, rays_o, rays_d)

    def visibility_logits(self, points, dirs):
        return grid_visibility_logits(self.values, self.cfg, points, dirs)
