"""LLFF real-scene loader (forward-facing captures, poses_bounds.npy): the
port's own copy of ``robir_tpu/data/llff.py`` (numpy and PIL only).

Parity: the stage-1 LLFF dataset (``neus/dataset/mip_dateset.py:404-520``):
rotation-column reorder, bound-based rescale, pose recentering, optional
spherification for 360 captures, NDC ray conversion for forward-facing
scenes, every-Nth-image test split, and spiral/spherical render paths.
The pose maths is numpy float64 in the JAX package's order of operations,
cast to float32 at the end, so that rays agree with it to 1e-6.
"""

from __future__ import annotations

import dataclasses
import glob
import os

import numpy as np

from .blender import RayBatch, generate_rays


def _normalize(x):
    return x / np.linalg.norm(x)


def _viewmatrix(z, up, pos):
    vec2 = _normalize(z)
    vec1_avg = up
    vec0 = _normalize(np.cross(vec1_avg, vec2))
    vec1 = _normalize(np.cross(vec2, vec0))
    return np.stack([vec0, vec1, vec2, pos], 1)


def _poses_avg(poses):
    hwf = poses[0, :3, -1:]
    center = poses[:, :3, 3].mean(0)
    vec2 = _normalize(poses[:, :3, 2].sum(0))
    up = poses[:, :3, 1].sum(0)
    return np.concatenate([_viewmatrix(vec2, up, center), hwf], 1)


def recenter_poses(poses):
    """Center the pose cloud at the average camera."""
    poses_ = poses.copy()
    bottom = np.reshape([0, 0, 0, 1.0], [1, 4])
    c2w = _poses_avg(poses)
    c2w = np.concatenate([c2w[:3, :4], bottom], -2)
    bottom = np.tile(np.reshape(bottom, [1, 1, 4]), [poses.shape[0], 1, 1])
    poses_h = np.concatenate([poses[:, :3, :4], bottom], -2)
    poses_h = np.linalg.inv(c2w) @ poses_h
    poses_[:, :3, :4] = poses_h[:, :3, :4]
    return poses_


def spiral_path(poses, bds, focal_scale: float = 1.0, n_frames: int = 120,
                n_rots: int = 2, zrate: float = 0.5):
    """Spiral render path for forward-facing scenes."""
    c2w = _poses_avg(poses)
    up = _normalize(poses[:, :3, 1].sum(0))
    close_depth, inf_depth = bds.min() * 0.9, bds.max() * 5.0
    dt = 0.75
    focal = 1.0 / ((1 - dt) / close_depth + dt / inf_depth) * focal_scale
    rads = np.percentile(np.abs(poses[:, :3, 3] - c2w[:3, 3]), 90, 0)
    render_poses = []
    for theta in np.linspace(0, 2 * np.pi * n_rots, n_frames, endpoint=False):
        c = c2w[:3, :4] @ (np.array([np.cos(theta), -np.sin(theta),
                                     -np.sin(theta * zrate), 1.0]) *
                           np.concatenate([rads, [1.0]]))
        z = _normalize(c - c2w[:3, :4] @ np.array([0, 0, -focal, 1.0]))
        render_poses.append(_viewmatrix(z, up, c))
    return np.stack(render_poses).astype(np.float32)


def spherify_poses(poses, bds, n_frames: int = 120):
    """Full spherified-pose resampling for inward-facing captures
    (mip_dateset.py:431-489): recenter on the least-squares point nearest
    all optical axes, rescale to unit mean camera radius, and emit a
    circular render path at the mean camera height.

    Returns (poses [N,3,4], render_poses [n_frames,3,4], bds)."""
    def pad4(p):
        bottom = np.broadcast_to([0, 0, 0, 1.0], p[..., :1, :4].shape)
        return np.concatenate([p[..., :3, :4], bottom], -2)

    rays_d = poses[:, :3, 2:3]
    rays_o = poses[:, :3, 3:4]
    # point minimizing distance to all camera optical axes
    a = np.eye(3) - rays_d @ np.transpose(rays_d, (0, 2, 1))
    b = -a @ rays_o
    # pinv: forward-facing captures make this singular (parallel axes)
    pt_mindist = np.squeeze(-np.linalg.pinv(
        (np.transpose(a, (0, 2, 1)) @ a).mean(0)) @ b.mean(0))

    center = pt_mindist
    up = (poses[:, :3, 3] - center).mean(0)
    if np.linalg.norm(up) < 1e-8:
        raise ValueError(
            "spherify_poses: degenerate capture (cameras have no common "
            "attention point — is this a forward-facing scene? use "
            "spherify=False)")
    vec0 = _normalize(up)
    vec1 = _normalize(np.cross([0.1, 0.2, 0.3], vec0))
    vec2 = _normalize(np.cross(vec0, vec1))
    c2w = np.stack([vec1, vec2, vec0, center], 1)

    poses_reset = (np.linalg.inv(pad4(c2w[None])) @
                   pad4(poses[:, :3, :4]))[:, :3, :4]
    rad = np.sqrt(np.mean(np.sum(poses_reset[:, :3, 3] ** 2, -1)))
    sc = 1.0 / rad
    poses_reset[:, :3, 3] *= sc
    bds = bds * sc

    centroid = poses_reset[:, :3, 3].mean(0)
    zh = centroid[2]
    radcircle = np.sqrt(max(1.0 - zh * zh, 1e-6))
    render_poses = []
    for th in np.linspace(0.0, 2.0 * np.pi, n_frames, endpoint=False):
        campos = np.array([radcircle * np.cos(th),
                           radcircle * np.sin(th), zh])
        back = _normalize(campos)                 # camera z points away
        upv = np.array([0.0, 0.0, -1.0])
        right = _normalize(np.cross(upv, back))
        true_up = _normalize(np.cross(back, right))
        render_poses.append(np.stack([right, true_up, back, campos], 1))
    return (poses_reset.astype(np.float32),
            np.stack(render_poses).astype(np.float32),
            bds)


def convert_to_ndc(origins, directions, focal, w, h, near: float = 1.0):
    """Shift rays to the near plane and map to NDC (mip_render convention)."""
    t = -(near + origins[..., 2]) / directions[..., 2]
    origins = origins + t[..., None] * directions

    dx, dy, dz = np.moveaxis(directions, -1, 0)
    ox, oy, oz = np.moveaxis(origins, -1, 0)
    o0 = -((2 * focal) / w) * (ox / oz)
    o1 = -((2 * focal) / h) * (oy / oz)
    o2 = 1 + 2 * near / oz
    d0 = -((2 * focal) / w) * (dx / dz - ox / oz)
    d1 = -((2 * focal) / h) * (dy / dz - oy / oz)
    d2 = -2 * near / oz
    origins = np.stack([o0, o1, o2], -1)
    directions = np.stack([d0, d1, d2], -1)
    return origins.astype(np.float32), directions.astype(np.float32)


@dataclasses.dataclass
class LLFFConfig:
    data_dir: str = ""
    factor: int = 0
    llffhold: int = 8
    spherify: bool = False
    near_ndc: float = 1.0


class LLFFScene:
    """Loads an LLFF capture; exposes the BlenderScene-style interface
    (flat ray pool + per-image rays) with NDC rays for forward-facing
    scenes."""

    def __init__(self, cfg: LLFFConfig, split: str = "train"):
        from PIL import Image

        self.cfg = cfg
        suffix = f"_{cfg.factor}" if cfg.factor > 0 else ""
        imgdir = os.path.join(cfg.data_dir, "images" + suffix)
        files = sorted(f for f in glob.glob(os.path.join(imgdir, "*"))
                       if f.lower().endswith((".jpg", ".png", ".jpeg")))
        images = np.stack([np.asarray(Image.open(f), np.float32) / 255.0
                           for f in files])[..., :3]

        poses_arr = np.load(os.path.join(cfg.data_dir, "poses_bounds.npy"))
        poses = poses_arr[:, :-2].reshape(-1, 3, 5)
        bds = poses_arr[:, -2:]
        if len(poses) != len(images):
            raise RuntimeError(f"{len(images)} images vs {len(poses)} poses")

        factor = max(cfg.factor, 1)
        poses[:, 0, 4] = images.shape[1]
        poses[:, 1, 4] = images.shape[2]
        poses[:, 2, 4] = poses[:, 2, 4] / factor
        # [down right back] -> [right up back] column reorder
        poses = np.concatenate(
            [poses[:, :, 1:2], -poses[:, :, 0:1], poses[:, :, 2:]], 2)

        scale = 1.0 / (bds.min() * 0.75)
        poses[:, :3, 3] *= scale
        bds = bds * scale
        poses = recenter_poses(poses.astype(np.float32))
        if cfg.spherify:
            p34, sph_render, bds = spherify_poses(poses[:, :3, :4], bds)
            poses = np.concatenate([p34, poses[:, :3, 4:5]], 2)

        i_test = np.arange(len(images))[::cfg.llffhold]
        i_train = np.array([i for i in range(len(images)) if i not in i_test])
        idx = i_train if split == "train" else i_test

        self.images = images[idx]
        self.poses = poses[idx]
        self.bds = bds[idx]
        self.focal = float(poses[0, 2, 4])
        self.h, self.w = images.shape[1:3]
        self.n_images = len(idx)
        self.render_poses = (sph_render if cfg.spherify
                             else spiral_path(poses, bds))

        rays = generate_rays(self.h, self.w, self.focal,
                             self.poses[:, :3, :4], 0.0, 1.0)
        origins, directions, viewdirs, radii, lm, near, far = rays
        if not cfg.spherify:
            ndc_o, ndc_d = convert_to_ndc(origins, directions, self.focal,
                                          self.w, self.h, cfg.near_ndc)
            # radii from NDC origin spacing (mip_dateset.py:502-512)
            dx = np.sqrt(np.sum((ndc_o[:, :-1] - ndc_o[:, 1:]) ** 2, -1))
            dx = np.concatenate([dx, dx[:, -2:-1]], 1)
            dy = np.sqrt(np.sum((ndc_o[:, :, :-1] - ndc_o[:, :, 1:]) ** 2, -1))
            dy = np.concatenate([dy, dy[:, :, -2:-1]], 2)
            radii = (0.5 * (dx + dy))[..., None] * 2 / np.sqrt(12)
            viewdirs = directions / np.linalg.norm(directions, axis=-1,
                                                   keepdims=True)
            origins, directions = ndc_o, ndc_d
        else:
            near = np.full_like(near, self.bds.min() * 0.9)
            far = np.full_like(far, self.bds.max())

        self._rays = (origins.astype(np.float32), directions.astype(np.float32),
                      viewdirs.astype(np.float32), radii.astype(np.float32),
                      lm.astype(np.float32), near.astype(np.float32),
                      far.astype(np.float32))
        self.flat = RayBatch(*[r.reshape(-1, r.shape[-1]) for r in self._rays],
                             pixels=self.images.reshape(-1, 3))
        self.masks = np.ones_like(self.images[..., :1])

    def image_rays(self, idx: int) -> RayBatch:
        return RayBatch(*[r[idx].reshape(-1, r.shape[-1]) for r in self._rays],
                        pixels=self.images[idx].reshape(-1, 3))

    def sample(self, rng: np.random.Generator, batch_size: int) -> RayBatch:
        sel = rng.integers(0, self.flat.origins.shape[0], (batch_size,))
        return RayBatch(*[f[sel] for f in self.flat])
