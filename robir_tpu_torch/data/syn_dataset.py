"""Stage-2 posed-image dataset (the port's copy of the camera model and
pixel sampling of ``robir_tpu/data/syn_dataset.py``, the reference's
``datasets/syn_dataset.py``), built in memory.

``SynDataset`` holds linear-radiance images, object masks, intrinsics and
poses (translations already / pose_scale into stage-2 coordinates);
``camera_rays`` lifts pixels (by default every pixel of the view,
``full_uv``) to rays, ``sample_pixels`` draws a random pixel batch of one
camera and ``masked_pixels`` gathers the object's pixels.
``shadow_scene`` builds a split of the two-sphere scene with cast shadows
of ``robir_tpu/data/synthetic.py:make_shadow_dataset`` (same cameras from
the same seed, same 8-bit quantisation and gamma-2.2 decode as a load of
its PNGs) without writing files. Reading a dataset from disk is not
ported yet.
"""

from __future__ import annotations

import numpy as np

from .synthetic import look_at


class SynDataset:
    def __init__(self, images: list, masks: list, poses: np.ndarray,
                 focal: float, img_res: tuple[int, int], pose_scale: float = 2.0):
        h, w = img_res
        poses = np.asarray(poses, np.float32).copy()
        poses[..., 3] /= pose_scale
        self.n_cameras = len(images)
        self.img_res = (h, w)
        self.total_pixels = h * w
        self.intrinsics = np.array([[focal, 0, w / 2], [0, focal, h / 2], [0, 0, 1]],
                                   np.float32)
        self.poses = poses
        self.rgb_images = [np.asarray(im, np.float32).reshape(-1, 3) for im in images]
        self.object_masks = [np.asarray(m, bool).reshape(-1) for m in masks]

    def full_uv(self) -> np.ndarray:
        """[H * W, 2] (x, y) pixel coordinates in row-major order
        (syn_dataset.py:122-125)."""
        h, w = self.img_res
        grid = np.mgrid[0:h, 0:w].astype(np.float32)
        return np.flip(grid, axis=0).reshape(2, -1).T.copy()

    def camera_rays(self, idx: int, uv: np.ndarray | None = None):
        """uv [N, 2] (x, y), by default every pixel (``full_uv``) ->
        (ray_dirs [N, 3], cam_loc [3]) (utils/rend_util.py:51-97)."""
        if uv is None:
            uv = self.full_uv()
        K = self.intrinsics
        pose = self.poses[idx]
        x_lift = (uv[:, 0] - K[0, 2]) / K[0, 0]
        y_lift = (uv[:, 1] - K[1, 2]) / K[1, 1]
        pts_cam = np.stack([x_lift, -y_lift, -np.ones_like(x_lift),
                            np.ones_like(x_lift)], -1)
        world = (pose @ pts_cam.T).T[:, :3]
        cam_loc = pose[:3, 3]
        dirs = world - cam_loc
        dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
        return dirs.astype(np.float32), cam_loc.astype(np.float32)

    def sample_pixels(self, rng: np.random.Generator, idx: int, n: int) -> dict:
        """A random batch of ``n`` distinct pixels of camera ``idx``."""
        return self.pixels(idx, rng.choice(self.total_pixels, size=n, replace=False))

    def pixels(self, idx: int, sel: np.ndarray) -> dict:
        """The batch of camera ``idx``'s pixels ``sel`` (flat indices)."""
        w = self.img_res[1]
        uv = np.stack([(sel % w).astype(np.float32), (sel // w).astype(np.float32)], -1)
        dirs, cam_loc = self.camera_rays(idx, uv)
        return {"uv": uv, "points": np.broadcast_to(cam_loc, dirs.shape).copy(),
                "dirs": dirs, "object_mask": self.object_masks[idx][sel],
                "rgb": self.rgb_images[idx][sel]}

    def masked_pixels(self) -> np.ndarray:
        """Every in-mask pixel of every camera, [P, 3] (the Vis stage's
        energy prologue, model/energy_integral.py:51-61)."""
        return np.concatenate([img[m] for img, m in zip(self.rgb_images, self.object_masks)], 0)


def render_two_sphere_gt(c2w: np.ndarray, h: int, w: int, focal: float,
                         centers=((0.0, 0.0, 0.0), (0.37, 0.22, 0.61)),
                         radii=(0.5, 0.18),
                         albedos=((0.8, 0.3, 0.2), (0.25, 0.45, 0.8)),
                         light_dir=(0.5, 0.3, 0.8)) -> np.ndarray:
    """Two lambertian spheres with hard cast shadows, RGBA [h, w, 4]."""
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
        alb = np.asarray(albedos[si], np.float32)
        out[np.where(sel)[0], :3] = (lam[:, None] * 0.8 + 0.2) * alb
        out[np.where(sel)[0], 3] = 1.0
    return out.reshape(h, w, 4)


def shadow_scene(n_train: int = 20, h: int = 128, w: int = 128,
                 camera_angle_x: float = 0.6911112070083618, cam_dist: float = 3.2,
                 seed: int = 0, pose_scale: float = 2.0, split: str = "train",
                 n_test: int = 3) -> SynDataset:
    """A split ("train" or "test") of the two-sphere shadow scene as a
    ``SynDataset``: the cameras of ``make_shadow_dataset`` from ``seed``
    (the test split's follow the train split's draws), each image
    quantised to 8 bits and decoded with gamma 2.2, masks from alpha."""
    focal = 0.5 * w / np.tan(0.5 * camera_angle_x)
    rng = np.random.default_rng(seed)
    for sp, n in (("train", n_train), ("test", n_test)):
        images, masks, poses = [], [], []
        for i in range(n):
            theta = (i / n) * 2 * np.pi + float(rng.uniform(0, 0.1))
            phi = float(rng.uniform(0.15, 1.1))
            eye = cam_dist * np.array([np.cos(theta) * np.cos(phi),
                                       np.sin(theta) * np.cos(phi), np.sin(phi)], np.float32)
            c2w = look_at(eye, np.array([0.2, 0.1, 0.35], np.float32))
            if sp != split:
                continue
            img = (render_two_sphere_gt(c2w, h, w, focal) * 255).astype(np.uint8)
            images.append(np.power(img[..., :3].astype(np.float32) / 255.0, 2.2))
            masks.append(img[..., 3].astype(np.float32) / 255.0 > 0.5)
            poses.append(c2w)
        if sp == split:
            return SynDataset(images, masks, np.stack(poses), focal, (h, w), pose_scale)
    raise ValueError(f"unknown split {split!r}")
