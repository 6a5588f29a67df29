"""Procedural scenes with analytic ground truth (the port's own copy of
``robir_tpu/data/synthetic.py``): a lambertian sphere, and two spheres with
hard cast shadows.

``make_sphere_dataset`` and ``make_shadow_dataset`` (its main sphere of one
colour, or ``textured``) write a scene to disk in
the blender format, as the JAX package's writers of the same name do (the
same cameras from the same seed, the same files): ``transforms_<split>.json``
and RGBA PNGs for the train, test and val splits, the test split's
``_rgba.png`` copies and its relit ground truth under ``test_rli/``.
``make_sphere_scene`` builds the sphere scene's split in memory instead,
without writing PNGs; ``sphere_scene`` writes it and reads the train split
back.
"""

from __future__ import annotations

import json
import os

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


# analytic stand-ins for the reference's relit test conditions
# (datasets/syn_dataset.py:101-115 loads envmap6/envmap12 renders)
RELIT_LIGHT_DIRS = {"envmap6": (-0.6, 0.4, 0.7), "envmap12": (0.2, -0.7, 0.7)}


def textured_albedo(p: np.ndarray) -> np.ndarray:
    """The textured scene's albedo of the main sphere: a smooth two-colour
    sinusoidal weave in world coordinates, [N, 3] points -> [N, 3] in
    (0, 1), about three periods across the 0.5-radius sphere."""
    a = np.asarray([0.8, 0.3, 0.2], np.float32)
    b = np.asarray([0.2, 0.5, 0.8], np.float32)
    w = 0.5 * (1.0 + np.sin(9.0 * p[..., 0]) * np.cos(9.0 * p[..., 1]))
    w = w.astype(np.float32)[..., None]
    return a * w + b * (1.0 - w)


def render_two_sphere_gt(c2w: np.ndarray, h: int, w: int, focal: float,
                         centers=((0.0, 0.0, 0.0), (0.37, 0.22, 0.61)),
                         radii=(0.5, 0.18),
                         albedos=((0.8, 0.3, 0.2), (0.25, 0.45, 0.8)),
                         light_dir=(0.5, 0.3, 0.8)) -> np.ndarray:
    """Two lambertian spheres with hard cast shadows, RGBA [h, w, 4]. An
    ``albedos`` entry may be a callable, [N, 3] world points -> [N, 3]
    (``textured_albedo``)."""
    x, y = np.meshgrid(np.arange(w, dtype=np.float32),
                       np.arange(h, dtype=np.float32), indexing="xy")
    dirs = np.stack([(x - w * 0.5 + 0.5) / focal, -(y - h * 0.5 + 0.5) / focal,
                     -np.ones_like(x)], -1)
    dirs = dirs @ c2w[:3, :3].T
    dirs = dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)
    o = c2w[:3, 3]
    ld = np.asarray(light_dir, np.float32)
    ld = ld / np.linalg.norm(ld)

    def sphere_hit(origins, d, c, r):
        oc = origins - np.asarray(c, np.float32)
        b = 2.0 * np.sum(oc * d, -1)
        cc = np.sum(oc * oc, -1) - r * r
        disc = b * b - 4 * cc
        t = (-b - np.sqrt(np.maximum(disc, 0.0))) / 2.0
        hit = (disc > 0) & (t > 1e-4)
        return np.where(hit, t, np.inf), hit

    flat_o = np.broadcast_to(o, dirs.reshape(-1, 3).shape)
    d = dirs.reshape(-1, 3)
    t0, h0 = sphere_hit(flat_o, d, centers[0], radii[0])
    t1, h1 = sphere_hit(flat_o, d, centers[1], radii[1])
    t = np.minimum(t0, t1)
    which = (t1 < t0).astype(np.int32)
    hit = h0 | h1
    pts = flat_o + np.where(np.isfinite(t), t, 0.0)[:, None] * d
    out = np.zeros((h * w, 4), np.float32)
    out[:, :3] = 1.0
    for si in range(2):
        sel = hit & (which == si)
        if not sel.any():
            continue
        p = pts[sel]
        n = (p - np.asarray(centers[si], np.float32)) / radii[si]
        shadow = np.zeros(len(p), bool)
        for sj in range(2):
            if sj != si:
                _, sh = sphere_hit(p + 1e-3 * n, np.broadcast_to(ld, p.shape),
                                   centers[sj], radii[sj])
                shadow |= sh
        lam = np.where(shadow, 0.0, np.clip(n @ ld, 0.0, 1.0))
        alb = albedos[si](p) if callable(albedos[si]) else np.asarray(albedos[si], np.float32)
        out[np.where(sel)[0], :3] = (lam[:, None] * 0.8 + 0.2) * alb
        out[np.where(sel)[0], 3] = 1.0
    return out.reshape(h, w, 4)


def _write_scene(out_dir: str, splits, camera_angle_x: float, render) -> str:
    """Write each (split, [c2w, ...]) of ``splits`` as blender-format frames:
    ``render(c2w, light_dir)`` gives an RGBA image in [0, 1] (the default
    light where ``light_dir`` is None); the test split also gets its
    ``_rgba.png`` copy and the relit images of RELIT_LIGHT_DIRS."""
    from PIL import Image

    def png(img, path, mode):
        Image.fromarray((img * 255).astype(np.uint8), mode).save(path)

    for split, cams in splits:
        frames = []
        os.makedirs(os.path.join(out_dir, split), exist_ok=True)
        for i, c2w in enumerate(cams):
            img = render(c2w, None)
            name = f"{split}/r_{i}"
            png(img, os.path.join(out_dir, name + ".png"), "RGBA")
            if split == "test":
                png(img, os.path.join(out_dir, name + "_rgba.png"), "RGBA")
                os.makedirs(os.path.join(out_dir, "test_rli"), exist_ok=True)
                for env, ld in RELIT_LIGHT_DIRS.items():
                    png(render(c2w, ld)[..., :3],
                        os.path.join(out_dir, "test_rli", f"{env}_r_{i}.png"), "RGB")
            frames.append({"file_path": name, "transform_matrix": c2w.tolist()})
        with open(os.path.join(out_dir, f"transforms_{split}.json"), "w") as fp:
            json.dump({"camera_angle_x": camera_angle_x, "frames": frames}, fp)
    return out_dir


def _orbit(rng: np.random.Generator, n: int, cam_dist: float, phi_range, target) -> list:
    """``n`` cameras around ``target``, one per 2 pi / n of azimuth with a
    small jitter, at random elevations in ``phi_range``."""
    cams = []
    for i in range(n):
        theta = (i / n) * 2 * np.pi + float(rng.uniform(0, 0.1))
        phi = float(rng.uniform(*phi_range))
        eye = cam_dist * np.array([np.cos(theta) * np.cos(phi),
                                   np.sin(theta) * np.cos(phi), np.sin(phi)], np.float32)
        cams.append(look_at(eye, np.asarray(target, np.float32)))
    return cams


SPHERE_PHI = (0.2, 1.2)
SHADOW_PHI, SHADOW_TARGET = (0.15, 1.1), (0.2, 0.1, 0.35)


def make_sphere_dataset(out_dir: str, n_train: int = 20, n_test: int = 4,
                        h: int = 64, w: int = 64,
                        camera_angle_x: float = 0.6911112070083618,
                        cam_dist: float = 3.0, radius: float = 0.5,
                        seed: int = 0) -> str:
    """Write the blender-format sphere scene under ``out_dir``; returns it."""
    focal = 0.5 * w / np.tan(0.5 * camera_angle_x)
    rng = np.random.default_rng(seed)
    splits = [(sp, _orbit(rng, n, cam_dist, SPHERE_PHI, (0, 0, 0)))
              for sp, n in (("train", n_train), ("test", n_test), ("val", 2))]
    return _write_scene(out_dir, splits, camera_angle_x, lambda c2w, ld: render_sphere_gt(
        c2w, h, w, focal, radius=radius, **({} if ld is None else {"light_dir": ld})))


def make_shadow_dataset(out_dir: str, n_train: int = 20, n_test: int = 3,
                        h: int = 128, w: int = 128,
                        camera_angle_x: float = 0.6911112070083618,
                        cam_dist: float = 3.2, seed: int = 0, textured: bool = False) -> str:
    """Write the blender-format two-sphere scene with cast shadows under
    ``out_dir``; returns it. ``textured`` gives the main sphere the
    spatially varying ``textured_albedo`` (the scene of the shadow
    pipeline's albedo-recovery gates)."""
    albedos = (textured_albedo if textured else (0.8, 0.3, 0.2)), (0.25, 0.45, 0.8)
    focal = 0.5 * w / np.tan(0.5 * camera_angle_x)
    rng = np.random.default_rng(seed)
    splits = [(sp, _orbit(rng, n, cam_dist, SHADOW_PHI, SHADOW_TARGET))
              for sp, n in (("train", n_train), ("test", n_test), ("val", 2))]
    return _write_scene(out_dir, splits, camera_angle_x, lambda c2w, ld: render_two_sphere_gt(
        c2w, h, w, focal, albedos=albedos, **({} if ld is None else {"light_dir": ld})))


def sphere_scene(tmp_dir: str, **kwargs) -> BlenderScene:
    """``make_sphere_dataset(tmp_dir, **kwargs)``, then its train split as
    a ``BlenderScene``."""
    make_sphere_dataset(tmp_dir, **kwargs)
    return BlenderScene(BlenderConfig(dataset_dir=tmp_dir), "train")


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
        cams = _orbit(rng, n, cam_dist, SPHERE_PHI, (0, 0, 0))
        if sp == split:
            images = [(render_sphere_gt(c2w, h, w, focal, radius=radius) * 255)
                      .astype(np.uint8).astype(np.float32) / 255.0 for c2w in cams]
            return BlenderScene.from_arrays(cfg or BlenderConfig(), np.stack(images),
                                            np.stack(cams), camera_angle_x)
    raise ValueError(f"unknown split {split!r}")
