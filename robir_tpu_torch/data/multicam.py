"""Multicam dataset (per-image camera metadata.json): the port's own copy
of ``robir_tpu/data/multicam.py`` (numpy and PIL only).

Parity: the stage-1 Multicam loader (``neus/dataset/mip_dateset.py:216-311``):
``metadata.json`` carries per-image ``pix2cam``/``cam2world``/``width``/
``height``/``lossmult``/``near``/``far``; images may differ in resolution, so
rays are generated per image from pixel centers through pix2cam and the
pool is a ragged concatenation.
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np

from .blender import RayBatch


@dataclasses.dataclass
class MulticamConfig:
    dataset_dir: str = ""
    white_bkgd: bool = True


class MulticamScene:
    def __init__(self, cfg: MulticamConfig, split: str = "train"):
        from PIL import Image

        with open(os.path.join(cfg.dataset_dir, "metadata.json")) as fp:
            meta = json.load(fp)[split]
        self.meta = {k: np.array(meta[k]) for k in meta}

        images = []
        for fbase in meta["file_path"]:
            img = np.asarray(Image.open(os.path.join(cfg.dataset_dir, fbase)),
                             dtype=np.float32) / 255.0
            if cfg.white_bkgd and img.shape[-1] == 4:
                img = img[..., :3] * img[..., -1:] + (1.0 - img[..., -1:])
            images.append(img[..., :3])
        self.images = images
        self.n_images = len(images)

        rays_per_img = [self._rays_for(i) for i in range(self.n_images)]
        flat_fields = []
        for field_idx in range(7):
            flat_fields.append(np.concatenate(
                [r[field_idx].reshape(-1, r[field_idx].shape[-1])
                 for r in rays_per_img], 0))
        pixels = np.concatenate([im.reshape(-1, 3) for im in images], 0)
        self.flat = RayBatch(*flat_fields, pixels=pixels)
        self._rays_per_img = rays_per_img

    def _rays_for(self, i: int):
        """Per-image ray generation through pix2cam (mip_dateset.py:260-311)."""
        pix2cam = np.asarray(self.meta["pix2cam"][i], np.float32)
        cam2world = np.asarray(self.meta["cam2world"][i], np.float32)
        w = int(self.meta["width"][i])
        h = int(self.meta["height"][i])
        x, y = np.meshgrid(np.arange(w, dtype=np.float32) + 0.5,
                           np.arange(h, dtype=np.float32) + 0.5, indexing="xy")
        pixel_dirs = np.stack([x, y, np.ones_like(x)], -1)
        camera_dirs = pixel_dirs @ pix2cam[:3, :3].T
        directions = camera_dirs @ cam2world[:3, :3].T
        origins = np.broadcast_to(cam2world[:3, -1], directions.shape).copy()
        viewdirs = directions / np.linalg.norm(directions, axis=-1, keepdims=True)

        dx = np.sqrt(np.sum((directions[:-1] - directions[1:]) ** 2, -1))
        dx = np.concatenate([dx, dx[-2:-1]], 0)
        radii = dx[..., None] * 2 / np.sqrt(12)

        ones = np.ones_like(origins[..., :1])
        lossmult = ones * float(self.meta["lossmult"][i])
        near = ones * float(self.meta["near"][i])
        far = ones * float(self.meta["far"][i])
        return tuple(a.astype(np.float32) for a in
                     (origins, directions, viewdirs, radii, lossmult, near, far))

    def image_shape(self, idx: int) -> tuple[int, int]:
        """(h, w) of image ``idx`` — resolutions differ per image, so the
        trainer's eval paths query per-index instead of scalar h/w."""
        return self.images[idx].shape[:2]

    def image_rays(self, idx: int) -> RayBatch:
        r = self._rays_per_img[idx]
        return RayBatch(*[f.reshape(-1, f.shape[-1]) for f in r],
                        pixels=self.images[idx].reshape(-1, 3))

    def sample(self, rng: np.random.Generator, batch_size: int) -> RayBatch:
        sel = rng.integers(0, self.flat.origins.shape[0], (batch_size,))
        return RayBatch(*[f[sel] for f in self.flat])
