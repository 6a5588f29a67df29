"""The benchmark's own scenes, made from a seed on the host with numpy.

A frozen copy of the procedural scenes of ``robir_tpu_torch/data/synthetic.py``
(the lambertian sphere and the two spheres with cast shadows), so that
the benchmark's inputs do not move when the program's generator does.
``Scene`` holds 8-bit-rounded RGBA images, camera-to-world matrices and
the horizontal field of view; ``rays`` gives every pixel's ray, as the
blender loader computes them, for the reference.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class Scene:
    images: np.ndarray        # [n, h, w, 4] in [0, 1], alpha last
    camtoworlds: np.ndarray   # [n, 4, 4]
    camera_angle_x: float

    @property
    def focal(self) -> float:
        return 0.5 * self.images.shape[2] / np.tan(0.5 * self.camera_angle_x)


def look_at(eye, target, up=(0.0, 0.0, 1.0)) -> np.ndarray:
    forward = target - eye
    forward = forward / np.linalg.norm(forward)
    right = np.cross(forward, np.asarray(up, np.float64))
    right = right / np.linalg.norm(right)
    true_up = np.cross(right, forward)
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = right, true_up, -forward, eye
    return c2w


def orbit(rng: np.random.Generator, n: int, cam_dist: float, phi_range, target) -> list:
    cams = []
    for i in range(n):
        theta = (i / n) * 2 * np.pi + float(rng.uniform(0, 0.1))
        phi = float(rng.uniform(*phi_range))
        eye = cam_dist * np.array([np.cos(theta) * np.cos(phi),
                                   np.sin(theta) * np.cos(phi), np.sin(phi)], np.float32)
        cams.append(look_at(eye, np.asarray(target, np.float32)))
    return cams


def pixel_dirs(c2w, h, w, focal) -> np.ndarray:
    x, y = np.meshgrid(np.arange(w, dtype=np.float32), np.arange(h, dtype=np.float32),
                       indexing="xy")
    dirs = np.stack([(x - w * 0.5 + 0.5) / focal, -(y - h * 0.5 + 0.5) / focal,
                     -np.ones_like(x)], -1) @ c2w[:3, :3].T
    return dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)


def sphere_hit(origins, d, center, r):
    oc = origins - np.asarray(center, np.float32)
    b = 2.0 * np.sum(oc * d, -1)
    cc = np.sum(oc * oc, -1) - r * r
    disc = b * b - 4 * cc
    t = (-b - np.sqrt(np.maximum(disc, 0.0))) / 2.0
    hit = (disc > 0) & (t > 1e-4)
    return np.where(hit, t, np.inf), hit


def render_spheres(c2w, h, w, focal, centers, radii, albedos,
                   light_dir=(0.5, 0.3, 0.8), shadows=True) -> np.ndarray:
    """Lambertian spheres (0.8 of the light plus 0.2 ambient) on white,
    RGBA [h, w, 4]; with ``shadows`` each sphere shadows the others."""
    d = pixel_dirs(c2w, h, w, focal).reshape(-1, 3)
    o = np.broadcast_to(c2w[:3, 3], d.shape)
    ld = np.asarray(light_dir, np.float32)
    ld = ld / np.linalg.norm(ld)
    ts = [sphere_hit(o, d, c, r) for c, r in zip(centers, radii)]
    t = np.min([ti for ti, _ in ts], 0)
    which = np.argmin([ti for ti, _ in ts], 0)
    hit = np.any([hi for _, hi in ts], 0)
    pts = o + np.where(np.isfinite(t), t, 0.0)[:, None] * d
    out = np.ones((h * w, 4), np.float32)
    out[:, 3] = 0.0
    for si, (c, r) in enumerate(zip(centers, radii)):
        sel = hit & (which == si)
        if not sel.any():
            continue
        p = pts[sel]
        n = (p - np.asarray(c, np.float32)) / r
        shadow = np.zeros(len(p), bool)
        if shadows:
            for sj, (c2, r2) in enumerate(zip(centers, radii)):
                if sj != si:
                    shadow |= sphere_hit(p + 1e-3 * n, np.broadcast_to(ld, p.shape), c2, r2)[1]
        lam = np.where(shadow, 0.0, np.clip(n @ ld, 0.0, 1.0))
        out[sel, :3] = (lam[:, None] * 0.8 + 0.2) * np.asarray(albedos[si], np.float32)
        out[sel, 3] = 1.0
    return out.reshape(h, w, 4)


def make_scene(kind: str, seed: int, n_views: int, size: int, camera_angle_x: float) -> Scene:
    """``kind`` "sphere": one sphere of radius 0.5 at the origin, cameras at
    distance 3.0; "two_spheres": the shadow scene (a second sphere of radius
    0.18 casting a shadow on the first), cameras at 3.2. Cameras orbit at
    elevations drawn from ``seed``; images are rounded to 8 bits."""
    rng = np.random.default_rng(seed)
    if kind == "sphere":
        cams = orbit(rng, n_views, 3.0, (0.2, 1.2), (0.0, 0.0, 0.0))
        spheres = dict(centers=((0.0, 0.0, 0.0),), radii=(0.5,), albedos=((0.8, 0.3, 0.2),))
    elif kind == "two_spheres":
        cams = orbit(rng, n_views, 3.2, (0.15, 1.1), (0.2, 0.1, 0.35))
        spheres = dict(centers=((0.0, 0.0, 0.0), (0.37, 0.22, 0.61)), radii=(0.5, 0.18),
                       albedos=((0.8, 0.3, 0.2), (0.25, 0.45, 0.8)))
    else:
        raise KeyError(f"unknown scene kind {kind!r}")
    focal = 0.5 * size / np.tan(0.5 * camera_angle_x)
    images = [np.round(render_spheres(c2w, size, size, focal, **spheres) * 255) / 255
              for c2w in cams]
    return Scene(np.stack(images).astype(np.float32), np.stack(cams), float(camera_angle_x))


def rays(scene: Scene, near: float, far: float) -> dict:
    """Every pixel's ray, flat over (view, row, column): ``origins``,
    ``directions`` (not unit: camera z is -1), ``pixels`` (white background
    composited), ``mask`` [N, 1], ``near``, ``far`` [N, 1]."""
    n, h, w, _ = scene.images.shape
    x, y = np.meshgrid(np.arange(w, dtype=np.float32), np.arange(h, dtype=np.float32),
                       indexing="xy")
    cam = np.stack([(x - w * 0.5 + 0.5) / scene.focal, -(y - h * 0.5 + 0.5) / scene.focal,
                    -np.ones_like(x)], -1)
    c2w = scene.camtoworlds
    dirs = (cam[None, ..., None, :] * c2w[:, None, None, :3, :3]).sum(-1)
    origins = np.broadcast_to(c2w[:, None, None, :3, 3], dirs.shape)
    alpha = scene.images[..., 3:]
    pixels = scene.images[..., :3] * alpha + (1.0 - alpha)
    ones = np.ones(dirs.shape[:-1] + (1,), np.float32)
    return {"origins": origins.reshape(-1, 3).astype(np.float32),
            "directions": dirs.reshape(-1, 3).astype(np.float32),
            "pixels": pixels.reshape(-1, 3).astype(np.float32),
            "mask": alpha.reshape(-1, 1).astype(np.float32),
            "near": (ones * near).reshape(-1, 1), "far": (ones * far).reshape(-1, 1)}
