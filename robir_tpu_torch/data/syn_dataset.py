"""Stage-2 posed-image dataset (the port's copy of
``robir_tpu/data/syn_dataset.py``, the reference's
``datasets/syn_dataset.py``).

``SynDataset(cfg)`` reads a split of a blender-format scene from disk:
``transforms_<split>.json``; the train split's PNGs decoded with gamma 2.2
(or ``_rgb.exr`` HDR frames, when the train directory holds EXRs) and
their masks from ``_mask.png`` (or the PNG's alpha); the test split's
``_rgba.png`` images, masks from their alpha, and the relit ground truth
under ``test_rli/`` (``relit_images``); every ``frame_skip``-th frame;
pose translations divided by ``pose_scale`` into stage-2 coordinates.
``SynDataset.from_arrays`` builds one from arrays in memory.

It holds linear-radiance images, object masks, intrinsics and poses;
``camera_rays`` lifts pixels (by default every pixel of the view,
``full_uv``) to rays, ``sample_pixels`` draws a random pixel batch of one
camera and ``masked_pixels`` gathers the object's pixels. ``shadow_scene``
builds a split of the two-sphere scene with cast shadows of
``data/synthetic.py:make_shadow_dataset`` (same cameras from the same
seed, same 8-bit quantisation and gamma-2.2 decode as a load of its PNGs)
without writing files.
"""

from __future__ import annotations

import dataclasses
import glob
import json
import os

import numpy as np

from ..utils.exr import read_exr
from .synthetic import SHADOW_PHI, SHADOW_TARGET, _orbit, render_two_sphere_gt


def _read_png(path: str) -> np.ndarray:
    from PIL import Image
    with Image.open(path) as im:
        return np.asarray(im)


def load_rgb(path: str) -> np.ndarray:
    """Linear-radiance image (utils/rend_util.py:31-38): a PNG decoded with
    gamma 2.2, an EXR as it is; [H, W, 3] float32."""
    if path.endswith(".exr"):
        return read_exr(path)[..., :3]
    img = np.asarray(_read_png(path), dtype=np.float32)[..., :3] / 255.0
    return np.power(img, 2.2)


def load_mask(path: str) -> np.ndarray:
    """[H, W] bool: the PNG's alpha (or its one channel) above one half."""
    alpha = np.asarray(_read_png(path), dtype=np.float32)
    if alpha.ndim == 3:
        alpha = alpha[..., 3]
    return alpha / 255.0 > 0.5


@dataclasses.dataclass
class SynDatasetConfig:
    instance_dir: str = ""
    frame_skip: int = 1
    split: str = "train"
    pose_scale: float = 2.0  # translations divided by this (:56-58)


class SynDataset:
    def __init__(self, cfg: SynDatasetConfig):
        with open(os.path.join(cfg.instance_dir, f"transforms_{cfg.split}.json")) as fp:
            meta = json.load(fp)
        blender = len(glob.glob(f"{cfg.instance_dir}/train/*.exr")) == 0
        image_paths, mask_paths, poses = [], [], []
        relit_paths = {"envmap6": [], "envmap12": []}
        for frame in meta["frames"]:
            poses.append(np.array(frame["transform_matrix"], np.float32))
            base = os.path.join(cfg.instance_dir, frame["file_path"])
            if cfg.split == "train":
                image_paths.append(base + (".png" if blender else "_rgb.exr"))
                mask_paths.append(base + (".png" if blender else "_mask.png"))
            else:
                image_paths.append(base + "_rgba.png")
                ind = frame["file_path"].split("/")[1]
                for env, paths in relit_paths.items():
                    paths.append(os.path.join(cfg.instance_dir, f"test_rli/{env}_{ind}.png"))
        sk = cfg.frame_skip
        image_paths, mask_paths = image_paths[::sk], mask_paths[::sk]
        images = [load_rgb(p) for p in image_paths]
        h, w = images[0].shape[:2]
        focal = 0.5 * w / np.tan(0.5 * float(meta["camera_angle_x"]))
        if cfg.split == "train":
            masks = [load_mask(p) for p in mask_paths]
        else:
            masks = [_read_png(p)[..., 3] > 128 for p in image_paths]
        self._setup(images, masks, np.stack(poses)[::sk], focal, (h, w), cfg.pose_scale)
        if cfg.split != "train":
            self.relit_images = {
                env: [load_rgb(p).reshape(-1, 3) for p in paths[::sk]]
                for env, paths in relit_paths.items() if paths and os.path.exists(paths[0])}

    @classmethod
    def from_arrays(cls, images: list, masks: list, poses: np.ndarray, focal: float,
                    img_res: tuple[int, int], pose_scale: float = 2.0) -> "SynDataset":
        """A dataset of images (linear radiance, [H, W, 3]), masks and c2w
        poses already in memory."""
        ds = cls.__new__(cls)
        ds._setup(images, masks, poses, focal, img_res, pose_scale)
        return ds

    def _setup(self, images, masks, poses, focal, img_res, pose_scale) -> None:
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
        cams = _orbit(rng, n, cam_dist, SHADOW_PHI, SHADOW_TARGET)
        if sp == split:
            imgs = [(render_two_sphere_gt(c2w, h, w, focal) * 255).astype(np.uint8)
                    for c2w in cams]
            return SynDataset.from_arrays(
                [np.power(im[..., :3].astype(np.float32) / 255.0, 2.2) for im in imgs],
                [im[..., 3].astype(np.float32) / 255.0 > 0.5 for im in imgs],
                np.stack(cams), focal, (h, w), pose_scale)
    raise ValueError(f"unknown split {split!r}")
