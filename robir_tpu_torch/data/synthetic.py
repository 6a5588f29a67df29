"""Procedural sphere scene with analytic ground truth (the port's own copy
of ``look_at`` and ``render_sphere_gt`` from ``robir_tpu/data/synthetic.py``).

``make_sphere_scene`` builds the blender-format sphere scene of the JAX
package's ``make_sphere_dataset`` (same cameras from the same seed, same
8-bit quantisation) in memory, without writing PNGs.
"""

from __future__ import annotations

import numpy as np

from .blender import BlenderConfig, BlenderScene


def look_at(eye: np.ndarray, target: np.ndarray, up=(0.0, 0.0, 1.0)) -> np.ndarray:
    """OpenGL-style c2w: camera -z looks at target (blender convention)."""
    forward = target - eye
    forward = forward / np.linalg.norm(forward)
    right = np.cross(forward, np.asarray(up, np.float64))
    right = right / np.linalg.norm(right)
    true_up = np.cross(right, forward)
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, 0] = right
    c2w[:3, 1] = true_up
    c2w[:3, 2] = -forward  # camera looks along -z
    c2w[:3, 3] = eye
    return c2w


def render_sphere_gt(c2w: np.ndarray, h: int, w: int, focal: float,
                     radius: float = 0.5,
                     albedo=(0.8, 0.3, 0.2),
                     light_dir=(0.5, 0.3, 0.8)) -> np.ndarray:
    """Analytic RGBA image of a lambertian sphere at the origin."""
    x, y = np.meshgrid(np.arange(w, dtype=np.float32),
                       np.arange(h, dtype=np.float32), indexing="xy")
    dirs = np.stack([(x - w * 0.5 + 0.5) / focal,
                     -(y - h * 0.5 + 0.5) / focal,
                     -np.ones_like(x)], -1)
    dirs = dirs @ c2w[:3, :3].T
    dirs = dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)
    o = c2w[:3, 3]

    # |o + t d|^2 = r^2
    b = 2.0 * dirs @ o
    c = float(o @ o) - radius * radius
    disc = b * b - 4 * c
    hit = disc > 0
    t = (-b - np.sqrt(np.maximum(disc, 0.0))) / 2.0
    hit &= t > 0

    pts = o[None, None] + t[..., None] * dirs
    normals = pts / radius
    ld = np.asarray(light_dir, np.float32)
    ld = ld / np.linalg.norm(ld)
    lambert = np.clip(normals @ ld, 0.0, 1.0) * 0.8 + 0.2  # + ambient
    rgb = lambert[..., None] * np.asarray(albedo, np.float32)

    img = np.zeros((h, w, 4), np.float32)
    img[..., :3] = np.where(hit[..., None], rgb, 1.0)
    img[..., 3] = hit.astype(np.float32)
    return img


def make_sphere_scene(split: str = "train", n_train: int = 20,
                      n_test: int = 4, h: int = 64, w: int = 64,
                      camera_angle_x: float = 0.6911112070083618,
                      cam_dist: float = 3.0, radius: float = 0.5,
                      seed: int = 0,
                      cfg: BlenderConfig | None = None) -> BlenderScene:
    """One split of the lambertian-sphere scene as a ``BlenderScene``. The
    cameras follow ``make_sphere_dataset``'s draws for the same seed, and the
    images are rounded to 8 bits as its PNGs are."""
    focal = 0.5 * w / np.tan(0.5 * camera_angle_x)
    rng = np.random.default_rng(seed)
    for sp, n in (("train", n_train), ("test", n_test), ("val", 2)):
        images, cams = [], []
        for i in range(n):
            theta = (i / n) * 2 * np.pi + float(rng.uniform(0, 0.1))
            phi = float(rng.uniform(0.2, 1.2))
            eye = cam_dist * np.array([
                np.cos(theta) * np.cos(phi),
                np.sin(theta) * np.cos(phi),
                np.sin(phi)], np.float32)
            c2w = look_at(eye, np.zeros(3, np.float32))
            img = render_sphere_gt(c2w, h, w, focal, radius=radius)
            images.append((img * 255).astype(np.uint8).astype(np.float32) / 255.0)
            cams.append(c2w)
        if sp == split:
            return BlenderScene.from_arrays(cfg or BlenderConfig(),
                                            np.stack(images), np.stack(cams),
                                            camera_angle_x)
    raise ValueError(f"unknown split {split!r}")
