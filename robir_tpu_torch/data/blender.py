"""Blender (NeRF-synthetic) dataset: transforms_{split}.json + PNG frames
(the port's own copy of ``robir_tpu/data/blender.py``).

Pixel-center camera dirs [(x - w/2 + 0.5)/f, -(y - h/2 + 0.5)/f, -1]
rotated by c2w, white-background compositing, lossmult = alpha mask
(``alpha_as_mask``), near/far constant. All rays of a split are
precomputed into flat host arrays; a sampler draws fixed-size index batches
with a numpy generator, and a small thread prefetches them.
PIL is imported inside the PNG loader only; ``factor: 2`` halves the
images with ``utils/resize.py:resize_area`` (cv2's INTER_AREA in numpy).
"""

from __future__ import annotations

import dataclasses
import json
import os
import queue
import threading
from typing import Iterator, NamedTuple

import numpy as np

from ..utils.resize import resize_area


class RayBatch(NamedTuple):
    """Host-side ray bundle (numpy); mirrors render.neus.Rays + pixels."""

    origins: np.ndarray
    directions: np.ndarray
    viewdirs: np.ndarray
    radii: np.ndarray
    lossmult: np.ndarray
    near: np.ndarray
    far: np.ndarray
    pixels: np.ndarray


@dataclasses.dataclass
class BlenderConfig:
    dataset_dir: str = ""
    near: float = 2.0
    far: float = 6.0
    white_bkgd: bool = True
    alpha_as_mask: bool = True
    batch_size: int = 512
    test_skip: int = 8
    factor: int = 0


def _load_png(path: str) -> np.ndarray:
    from PIL import Image
    with open(path, "rb") as f:
        return np.array(Image.open(f), dtype=np.float32) / 255.0


class BlenderScene:
    """A split's images and cameras, its per-image rays and a flat training
    pool. ``BlenderScene(cfg, split)`` loads the split from disk;
    ``BlenderScene.from_arrays`` builds one from images already in memory."""

    def __init__(self, cfg: BlenderConfig, split: str = "train"):
        with open(os.path.join(cfg.dataset_dir, f"transforms_{split}.json")) as fp:
            meta = json.load(fp)
        frames = meta["frames"]
        if split == "test" and cfg.test_skip > 1:
            frames = frames[::cfg.test_skip]
        images, cams = [], []
        for frame in frames:
            fname = os.path.join(cfg.dataset_dir, frame["file_path"] + ".png")
            img = _load_png(fname)
            if cfg.factor == 2:
                img = resize_area(img, tuple(s // 2 for s in img.shape[:2]))
            images.append(img)
            cams.append(np.array(frame["transform_matrix"], dtype=np.float32))
        self._setup(cfg, np.stack(images, 0), np.stack(cams, 0),
                    float(meta["camera_angle_x"]))

    @classmethod
    def from_arrays(cls, cfg: BlenderConfig, images: np.ndarray,
                    camtoworlds: np.ndarray,
                    camera_angle_x: float) -> "BlenderScene":
        """images [n, h, w, 3 or 4] in [0, 1], camtoworlds [n, 4, 4]."""
        scene = cls.__new__(cls)
        scene._setup(cfg, np.asarray(images, np.float32),
                     np.asarray(camtoworlds, np.float32), camera_angle_x)
        return scene

    def _setup(self, cfg: BlenderConfig, images: np.ndarray,
               camtoworlds: np.ndarray, camera_angle_x: float) -> None:
        self.cfg = cfg
        if images.shape[-1] == 4:
            masks = images[..., -1:]
            if cfg.white_bkgd:
                images = images[..., :3] * masks + (1.0 - masks)
            else:
                images = images[..., :3]
        else:
            masks = np.ones_like(images[..., :1])
        if not cfg.alpha_as_mask:
            masks = np.ones_like(masks)

        self.images = images
        self.masks = masks
        self.h, self.w = images.shape[1:3]
        self.camtoworlds = camtoworlds
        self.focal = 0.5 * self.w / np.tan(0.5 * camera_angle_x)
        self.n_images = images.shape[0]
        self._rays = generate_rays(self.h, self.w, self.focal, self.camtoworlds,
                                   cfg.near, cfg.far, masks)
        # flat training pool
        self.flat = RayBatch(*[r.reshape(-1, r.shape[-1]) for r in self._rays],
                             pixels=images.reshape(-1, 3))

    def image_rays(self, idx: int) -> RayBatch:
        return RayBatch(*[r[idx].reshape(-1, r.shape[-1]) for r in self._rays],
                        pixels=self.images[idx].reshape(-1, 3))

    def sample(self, rng: np.random.Generator, batch_size: int | None = None) -> RayBatch:
        n = batch_size or self.cfg.batch_size
        idx = rng.integers(0, self.flat.origins.shape[0], (n,))
        return RayBatch(*[f[idx] for f in self.flat])


def generate_rays(h: int, w: int, focal: float, camtoworlds: np.ndarray,
                  near: float, far: float, lossmult: np.ndarray | None = None):
    """All-image ray generation (reference mip_dateset.py:180-215)."""
    x, y = np.meshgrid(np.arange(w, dtype=np.float32),
                       np.arange(h, dtype=np.float32), indexing="xy")
    camera_dirs = np.stack(
        [(x - w * 0.5 + 0.5) / focal,
         -(y - h * 0.5 + 0.5) / focal,
         -np.ones_like(x)], axis=-1)
    directions = (camera_dirs[None, ..., None, :]
                  * camtoworlds[:, None, None, :3, :3]).sum(axis=-1)
    origins = np.broadcast_to(camtoworlds[:, None, None, :3, -1], directions.shape)
    viewdirs = directions / np.linalg.norm(directions, axis=-1, keepdims=True)

    dx = np.sqrt(np.sum((directions[:, :-1] - directions[:, 1:]) ** 2, -1))
    dx = np.concatenate([dx, dx[:, -2:-1]], 1)
    radii = dx[..., None] * 2 / np.sqrt(12)

    ones = np.ones_like(origins[..., :1])
    lm = lossmult if lossmult is not None else ones
    return (origins.astype(np.float32), directions.astype(np.float32),
            viewdirs.astype(np.float32), radii.astype(np.float32),
            lm.astype(np.float32), (ones * near).astype(np.float32),
            (ones * far).astype(np.float32))


class Prefetcher:
    """Background-thread batch prefetch (reference mip_dateset.py:56-117)."""

    def __init__(self, sample_fn, depth: int = 3):
        self._q: queue.Queue = queue.Queue(depth)
        self._stop = threading.Event()
        self._error: BaseException | None = None

        def run():
            while not self._stop.is_set():
                try:
                    item = sample_fn()
                except BaseException as e:  # propagate to the consumer
                    self._error = e
                    self._stop.set()
                    return
                while not self._stop.is_set():
                    try:
                        self._q.put(item, timeout=1.0)
                        break
                    except queue.Full:
                        continue

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        while True:
            if self._error is not None and self._q.empty():
                raise self._error
            try:
                return self._q.get(timeout=1.0)
            except queue.Empty:
                continue

    def close(self):
        self._stop.set()
