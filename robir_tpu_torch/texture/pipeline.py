"""Texture-space pipeline: UV maps, baked attribute textures, samplers
(counterpart of ``robir_tpu/texture/pipeline.py``; the reference's
``model/texture_model.py``): ``erode_map``, the mask-aware dilation
(:24-45); ``TextureCache``, the vertex, normal and mask maps of a
UV-parameterised mesh rasterised and cached as EXR beside the mesh
(:48-106), in the JAX package's layout and file names, so that either
package reads the other's cache; ``TexSampler``, random texture-space
samples with uv-offset tangents, the vertex positions scaled by
``coord_scale`` 0.5 from stage-1 into stage-2 coordinates (:127-160).

All of it is numpy on the host, as in the JAX package: it runs once per
scene (the maps) or on small batches (the samples).
"""

from __future__ import annotations

import os

import numpy as np

from ..utils.exr import read_exr, write_exr
from .mesh import Mesh
from .native import atlas_parameterize, rasterize_attributes


def erode_map(image: np.ndarray, mask: np.ndarray) -> np.ndarray:
    """Mask-aware dilation: fill texels outside the mask with the 3x3
    average of masked neighbours (texture_model.py:24-45). One pass: the
    reference's loop (:31-44) never updates the mask, so its later passes
    recompute the first one's result; the JAX package keeps the loop's
    ``iterations`` argument and ignores it."""
    image = image.copy()

    def conv(img):
        pad = np.pad(img, ((1, 1), (1, 1), (0, 0)))
        return np.stack([pad[:-2, :-2], pad[:-2, 1:-1], pad[:-2, 2:],
                         pad[1:-1, :-2], pad[1:-1, 1:-1], pad[1:-1, 2:],
                         pad[2:, :-2], pad[2:, 1:-1], pad[2:, 2:]], 0)

    inv_mask = mask.mean(-1) < 1
    m = (mask.mean(-1) >= 1).astype(np.float32)
    rgb = conv(image * m[..., None])
    a = conv(np.ones_like(image[..., :1]) * m[..., None])
    avg = rgb.sum(0) / np.clip(a.sum(0), 1e-4, 9.0)
    image[inv_mask] = avg[inv_mask]
    return image


class TextureCache:
    """Bakes per-vertex attributes of a UV-parameterized mesh into textures,
    cached on disk as EXR (texture_model.py:48-106)."""

    def __init__(self, mesh_path: str):
        self.cache_dir = self._init_cache_dir(mesh_path)
        self.mesh = Mesh.load_ply(mesh_path) if mesh_path.endswith(".ply") else \
            _load_obj_mesh(mesh_path)
        uv_path = os.path.join(self.cache_dir, "uv.npz")
        if os.path.exists(uv_path):
            data = np.load(uv_path)
            self.uv, self.corner_idx = data["uv"], data["idx"]
        else:
            self.uv, self.corner_idx, _ = atlas_parameterize(
                self.mesh.verts, self.mesh.tris)
            np.savez(uv_path, uv=self.uv, idx=self.corner_idx)

    def _init_cache_dir(self, mesh_path: str) -> str:
        base = ".".join(os.path.basename(mesh_path).split(".")[:-1]) + ".cache"
        cache_dir = os.path.join(os.path.dirname(mesh_path), base)
        os.makedirs(cache_dir, exist_ok=True)
        return cache_dir

    def _path(self, tag: str, resolution: int) -> str:
        return os.path.join(self.cache_dir, f"{tag}x{resolution}.exr")

    def rasterize_basics(self, resolution: int = 2048) -> dict:
        """The vertex positions, vertex normals and ones rasterised over
        the atlas: {"vert", "norm", "mask"} -> [res, res, 3] float32."""
        corner_tris = np.arange(len(self.mesh.tris) * 3,
                                dtype=np.int32).reshape(-1, 3)
        vnorm = self.mesh.vertex_normals()
        out = {}
        for tag, attr in (("vert", self.mesh.verts[self.corner_idx]),
                          ("norm", vnorm[self.corner_idx]),
                          ("mask", np.ones((len(self.corner_idx), 3), np.float32))):
            out[tag], _ = rasterize_attributes(self.uv, corner_tris, attr,
                                               resolution, resolution)
        return out

    def render_basics(self, resolution: int = 2048) -> None:
        """``rasterize_basics`` written to the cache as ZIP EXRs, unless
        the cache holds them."""
        if os.path.exists(self._path("vert", resolution)):
            return
        for tag, img in self.rasterize_basics(resolution).items():
            write_exr(self._path(tag, resolution), img)

    def load_basics(self, resolution: int = 2048):
        vert = read_exr(self._path("vert", resolution))[..., :3]
        norm = read_exr(self._path("norm", resolution))[..., :3]
        mask = read_exr(self._path("mask", resolution))[..., :3]
        return vert, norm, mask


def _load_obj_mesh(path: str) -> Mesh:
    verts, tris = [], []
    with open(path) as f:
        for line in f:
            if line.startswith("v "):
                verts.append([float(x) for x in line.split()[1:4]])
            elif line.startswith("f "):
                idx = [int(tok.split("/")[0]) - 1 for tok in line.split()[1:]]
                # fan-triangulate quads/ngons (trimesh, which the reference
                # uses, triangulates too — keeping only the first 3 indices
                # would silently drop half of every quad)
                for k in range(1, len(idx) - 1):
                    tris.append([idx[0], idx[k], idx[k + 1]])
    return Mesh(np.asarray(verts, np.float32), np.asarray(tris, np.int32))


def get_vert_norm_mask_maps(mesh_path: str, resolution: int = 2048):
    """Baked + eroded maps (texture_model.py:109-125). Returns
    (vert [H,W,3], norm [H,W,3], mask [H,W] bool)."""
    cache = TextureCache(mesh_path)
    cache.render_basics(resolution)
    vert, norm, mask = cache.load_basics(resolution)
    vert = erode_map(vert, mask)
    norm = erode_map(norm, mask)
    mask = erode_map(mask, mask.copy())
    vert = erode_map(vert, mask)
    norm = erode_map(norm, mask)
    return vert, norm, mask[..., 0] > 0.5


def bilinear_sample(img: np.ndarray, uv: np.ndarray) -> np.ndarray:
    """img [H, W, C], uv [N, 2] in [0,1] (u = columns) -> [N, C]."""
    H, W = img.shape[:2]
    px = np.clip(uv[:, 0], 0, 1) * (W - 1)
    py = np.clip(uv[:, 1], 0, 1) * (H - 1)
    x0 = np.clip(np.floor(px).astype(np.int64), 0, W - 1)
    y0 = np.clip(np.floor(py).astype(np.int64), 0, H - 1)
    x1 = np.minimum(x0 + 1, W - 1)
    y1 = np.minimum(y0 + 1, H - 1)
    wx = (px - x0)[:, None]
    wy = (py - y0)[:, None]
    return (img[y0, x0] * (1 - wy) * (1 - wx) + img[y0, x1] * (1 - wy) * wx
            + img[y1, x0] * wy * (1 - wx) + img[y1, x1] * wy * wx)


class TexSampler:
    """Random texture-space surface sampling (texture_model.py:127-160)."""

    # the mesh is in stage-1 coordinates, the samples in stage-2 ones (:155)
    coord_scale = 0.5

    def __init__(self, mesh_path: str, resolution: int = 2048):
        self.vert, self.norm, self.mask = get_vert_norm_mask_maps(mesh_path,
                                                                  resolution)
        self.maskf = self.mask.astype(np.float32)[..., None]

    def sample(self, rng: np.random.Generator, n: int) -> dict:
        uv = rng.random((n, 2)).astype(np.float32)
        vert = bilinear_sample(self.vert, uv)
        norm = bilinear_sample(self.norm, uv)
        mask = bilinear_sample(self.maskf, uv)[:, 0] > 0.1
        norm = norm / np.clip(np.linalg.norm(norm, axis=-1, keepdims=True),
                              1e-4, None)

        tan_x = bilinear_sample(self.vert, uv + np.array([0.001, 0], np.float32)) - vert
        tan_y = bilinear_sample(self.vert, uv + np.array([0, 0.001], np.float32)) - vert
        tan_x /= np.clip(np.linalg.norm(tan_x, axis=-1, keepdims=True), 1e-4, None)
        tan_y /= np.clip(np.linalg.norm(tan_y, axis=-1, keepdims=True), 1e-4, None)

        return {"uv": uv, "x": vert * self.coord_scale, "normal": norm,
                "object_mask": mask, "tangent_u": tan_y, "tangent_v": tan_x}
