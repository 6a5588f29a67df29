"""IDR/NeuS ``cameras_sphere.npz`` datasets, DTU-style real scenes (the
port's copy of ``robir_tpu/data/neus_npz.py``).

- ``NeuSNpzDataset``: the cameras (world and scale projection matrices
  decomposed into K and the c2w pose, ``load_K_Rt_from_P``), the images
  and masks, per-camera rays (``gen_rays_at``, ``gen_random_rays_at``),
  the slerp path between two cameras (``gen_rays_between``) and the
  unit-sphere near/far (reference ``neus/dataset/neus_dataset.py``).
- ``NeuSNpzScene``: stage 1's adapter with the ``BlenderScene`` interface
  the NeuS trainer takes (reference ``neus/dataset/interface.py``).
- ``DTUSceneDataset``: stage 2's, with the axis flip and the pose scale
  x0.5 into stage-2 coordinates and the ``SynDataset`` interface
  (reference ``datasets/DTU.py``).

The JAX package decomposes with ``cv2.decomposeProjectionMatrix`` and reads
images with ``cv2.imread``; the port uses numpy and PIL: an RQ
decomposition with the signs fixed so that K has a positive diagonal, the
camera centre as the projection's null vector, and images read as RGB and
divided by 256 as the JAX loader divides cv2's 8-bit values.
"""

from __future__ import annotations

import dataclasses
import glob
import os

import numpy as np

from .blender import RayBatch
from .syn_dataset import SynDataset


def rq3(M: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """M [3, 3] = K @ R with K upper triangular with a positive diagonal and
    R orthonormal (a proper rotation where det M > 0)."""
    flip = np.eye(3)[::-1]
    q, r = np.linalg.qr((flip @ M).T)
    K = flip @ r.T @ flip
    R = flip @ q.T
    signs = np.diag(np.sign(np.diag(K)))
    return K @ signs, signs @ R


def load_K_Rt_from_P(P: np.ndarray):
    """Decompose a [3, 4] projection into (intrinsics [4, 4], c2w pose [4, 4])."""
    P = np.asarray(P, np.float64)
    K, R = rq3(P[:, :3])
    K = K / K[2, 2]
    intrinsics = np.eye(4, dtype=np.float32)
    intrinsics[:3, :3] = K
    pose = np.eye(4, dtype=np.float32)
    pose[:3, :3] = R.T
    pose[:3, 3] = -np.linalg.solve(P[:, :3], P[:, 3])  # the camera centre: P @ [c, 1] = 0
    return intrinsics, pose


def _load_images(paths, bgr_flip=True) -> np.ndarray:
    """[N, H, W, 3] float32, 8-bit values / 256: RGB, or with ``bgr_flip``
    False the channels as cv2 stores them (BGR)."""
    from PIL import Image
    imgs = []
    for p in paths:
        with Image.open(p) as im:
            img = np.asarray(im.convert("RGB")).astype(np.float32) / 256.0
        imgs.append(img if bgr_flip else img[..., ::-1].copy())
    return np.stack(imgs)


@dataclasses.dataclass
class NeuSNpzConfig:
    data_dir: str = ""
    render_cameras_name: str = "cameras_sphere.npz"
    ext: str = "png"


class NeuSNpzDataset:
    """Stage-1 loader (neus/dataset/neus_dataset.py Dataset)."""

    def __init__(self, cfg: NeuSNpzConfig):
        self.cfg = cfg
        cams = np.load(os.path.join(cfg.data_dir, cfg.render_cameras_name))
        image_paths = sorted(glob.glob(os.path.join(cfg.data_dir, f"image/*.{cfg.ext}")))
        mask_paths = sorted(glob.glob(os.path.join(cfg.data_dir, f"mask/*.{cfg.ext}")))
        self.n_images = len(image_paths)
        self.images = _load_images(image_paths)
        self.masks = _load_images(mask_paths, bgr_flip=False)
        intrinsics, poses, self.scale_mats = [], [], []
        for i in range(self.n_images):
            scale_mat = cams[f"scale_mat_{i}"].astype(np.float32)
            world_mat = cams[f"world_mat_{i}"].astype(np.float32)
            K, pose = load_K_Rt_from_P((world_mat @ scale_mat)[:3, :4])
            intrinsics.append(K)
            poses.append(pose)
            self.scale_mats.append(scale_mat)
        self.intrinsics = np.stack(intrinsics)
        self.intrinsics_inv = np.linalg.inv(self.intrinsics)
        self.poses = np.stack(poses)
        self.h, self.w = self.images.shape[1:3]

    def gen_rays_at(self, idx: int, resolution_level: int = 1):
        """Whole-image rays -> (origins [H', W', 3], dirs [H', W', 3])."""
        ll = resolution_level
        tx = np.linspace(0, self.w - 1, self.w // ll, dtype=np.float32)
        ty = np.linspace(0, self.h - 1, self.h // ll, dtype=np.float32)
        px, py = np.meshgrid(tx, ty, indexing="xy")
        p = np.stack([px, py, np.ones_like(px)], -1)
        p = np.einsum("ij,hwj->hwi", self.intrinsics_inv[idx, :3, :3], p)
        v = p / np.linalg.norm(p, axis=-1, keepdims=True)
        v = np.einsum("ij,hwj->hwi", self.poses[idx, :3, :3], v)
        o = np.broadcast_to(self.poses[idx, :3, 3], v.shape).copy()
        return o.astype(np.float32), v.astype(np.float32)

    def gen_random_rays_at(self, rng: np.random.Generator, idx: int, n: int) -> dict:
        """A random-pixel batch -> dict(origins, dirs, rgb, mask)."""
        px = rng.integers(0, self.w, n)
        py = rng.integers(0, self.h, n)
        color = self.images[idx][py, px]
        mask = self.masks[idx][py, px, :1]
        p = np.stack([px, py, np.ones_like(px)], -1).astype(np.float32)
        p = (self.intrinsics_inv[idx, :3, :3] @ p.T).T
        v = p / np.linalg.norm(p, axis=-1, keepdims=True)
        v = (self.poses[idx, :3, :3] @ v.T).T
        o = np.broadcast_to(self.poses[idx, :3, 3], v.shape).copy()
        return {"origins": o.astype(np.float32), "dirs": v.astype(np.float32),
                "rgb": color.astype(np.float32), "mask": mask.astype(np.float32)}

    def gen_rays_between(self, idx0: int, idx1: int, ratio: float, resolution_level: int = 1):
        """A novel view on the slerp path between two cameras
        (neus_dataset.py:135-166)."""
        from scipy.spatial.transform import Rotation, Slerp
        slerp = Slerp([0, 1], Rotation.from_matrix(self.poses[[idx0, idx1], :3, :3]))
        pose = np.eye(4, dtype=np.float32)
        pose[:3, :3] = slerp(ratio).as_matrix().astype(np.float32)
        pose[:3, 3] = (1 - ratio) * self.poses[idx0, :3, 3] + ratio * self.poses[idx1, :3, 3]
        saved = self.poses[idx0].copy()
        try:
            self.poses[idx0] = pose
            return self.gen_rays_at(idx0, resolution_level)
        finally:
            self.poses[idx0] = saved

    @staticmethod
    def near_far_from_sphere(rays_o: np.ndarray, rays_d: np.ndarray):
        """Unit-sphere clip planes (neus_dataset.py:168-174)."""
        a = np.sum(rays_d ** 2, -1, keepdims=True)
        b = 2.0 * np.sum(rays_o * rays_d, -1, keepdims=True)
        mid = 0.5 * (-b) / a
        return mid - 1.0, mid + 1.0


@dataclasses.dataclass
class NeuSNpzSceneConfig:
    dataset_dir: str = ""
    batch_size: int = 512
    render_cameras_name: str = "cameras_sphere.npz"
    ext: str = "png"
    test_resolution_level: int = 4


class NeuSNpzScene:
    """Stage 1's training adapter over ``NeuSNpzDataset`` with the
    ``BlenderScene`` interface (interface.py:182-243): random-pixel batches
    with sphere-based near/far, the mask as lossmult, zero radii. The test
    split renders the train views at ``test_resolution_level`` times lower
    resolution (interface.py:197); ``base`` lets both splits share one
    loaded dataset."""

    def __init__(self, cfg: NeuSNpzSceneConfig, split: str = "train",
                 base: NeuSNpzDataset | None = None):
        self.cfg = cfg
        self.base = base if base is not None else NeuSNpzDataset(NeuSNpzConfig(
            data_dir=cfg.dataset_dir, render_cameras_name=cfg.render_cameras_name,
            ext=cfg.ext))
        self.split = split
        self._ll = 1 if split == "train" else max(1, cfg.test_resolution_level)
        self.h = self.base.h // self._ll
        self.w = self.base.w // self._ll
        self.n_images = self.base.n_images
        if self._ll == 1:
            self.images = self.base.images
            self.masks = self.base.masks[..., :1]
        else:
            # nearest neighbour at the pixel centres gen_rays_at uses
            # (linspace over [0, w - 1]), so eval rays and images align
            tx = np.rint(np.linspace(0, self.base.w - 1, self.w)).astype(int)
            ty = np.rint(np.linspace(0, self.base.h - 1, self.h)).astype(int)
            self.images = self.base.images[:, ty][:, :, tx]
            self.masks = self.base.masks[:, ty][:, :, tx, :1]

    @staticmethod
    def _bundle(o, v, rgb, mask) -> RayBatch:
        near, far = NeuSNpzDataset.near_far_from_sphere(o, v)
        ones = np.ones_like(o[..., :1])
        return RayBatch(origins=o.astype(np.float32), directions=v.astype(np.float32),
                        viewdirs=v.astype(np.float32), radii=np.zeros_like(ones),
                        lossmult=mask.astype(np.float32), near=near.astype(np.float32),
                        far=far.astype(np.float32), pixels=rgb.astype(np.float32))

    def sample(self, rng: np.random.Generator, batch_size: int | None = None) -> RayBatch:
        n = batch_size or self.cfg.batch_size
        idx = int(rng.integers(0, self.n_images))
        d = self.base.gen_random_rays_at(rng, idx, n)
        return self._bundle(d["origins"], d["dirs"], d["rgb"], d["mask"])

    def image_rays(self, idx: int) -> RayBatch:
        o, v = self.base.gen_rays_at(idx, resolution_level=self._ll)
        o = o[:self.h, :self.w].reshape(-1, 3)
        v = v[:self.h, :self.w].reshape(-1, 3)
        return self._bundle(o, v, self.images[idx].reshape(-1, 3),
                            self.masks[idx].reshape(-1, 1))


@dataclasses.dataclass
class DTUConfig:
    data_dir: str = ""
    frame_skip: int = 1
    downscale: float = 1.0
    cam_file: str | None = None


class DTUSceneDataset:
    """Stage 2's real-scene dataset (datasets/DTU.py SceneDataset) with the
    ``SynDataset`` interface the stage-2 runners take."""

    def __init__(self, cfg: DTUConfig):
        base = NeuSNpzDataset(NeuSNpzConfig(data_dir=cfg.data_dir))
        views = range(0, base.n_images, cfg.frame_skip)
        self.img_res = (base.h, base.w)
        self.total_pixels = base.h * base.w
        self.n_cameras = len(views)
        self.rgb_images = [base.images[i].reshape(-1, 3) for i in views]
        self.object_masks = [base.masks[i, ..., 0].reshape(-1) > 0.5 for i in views]
        self.intrinsics = base.intrinsics[0, :3, :3]
        S = np.eye(3, dtype=np.float32)
        S[1, 1] = S[2, 2] = -1
        poses = []
        for i in views:
            pose = base.poses[i].copy()
            # the axis flip and the scale x0.5 (datasets/DTU.py:60-80)
            pose = np.concatenate([pose[0:1], -pose[2:3], -pose[1:2], pose[3:]], 0)
            pose[1, 3] = -pose[1, 3]
            pose[2, 3] = -pose[2, 3]
            pose[:3, :3] = S @ pose[:3, :3] @ S
            pose = np.concatenate([pose[0:1], pose[2:3], pose[1:2], pose[3:]], 0)
            pose[:, 3] *= 0.5
            poses.append(pose)
        self.poses = np.stack(poses)

    full_uv = SynDataset.full_uv
    camera_rays = SynDataset.camera_rays
    sample_pixels = SynDataset.sample_pixels
    pixels = SynDataset.pixels
    masked_pixels = SynDataset.masked_pixels
