"""Stage-specific diagnostic image grids (the port's copy of
``robir_tpu/tools/plots.py``, numpy and PIL only, so that both packages
write the same images from the same arrays).

Parity: ``utils/plots.py`` — ``plot_norm:84-103``, ``plot_illum:38-81``,
``plot_mat:106-125``, ``plot_cesr:128-173``; tonemap = x^(1/2.2) (:8).
Images arrive as flat [H*W, C] buffers (the chunked-eval output) and are
tiled into one PNG per plot call.
"""

from __future__ import annotations

import os

import numpy as np


def tonemap(x: np.ndarray) -> np.ndarray:
    return np.power(np.clip(x, 0.0, 1.0), 1.0 / 2.2)


def lin2img(flat: np.ndarray, img_res: tuple[int, int]) -> np.ndarray:
    h, w = img_res
    if flat.ndim == 1:
        flat = flat[:, None]
    c = flat.shape[-1]
    img = flat.reshape(h, w, c)
    if c == 1:
        img = np.repeat(img, 3, axis=-1)
    return img


def _grid(images: list[np.ndarray], cols: int | None = None) -> np.ndarray:
    cols = cols or len(images)
    rows = int(np.ceil(len(images) / cols))
    h, w, c = images[0].shape
    canvas = np.ones((rows * h, cols * w, c), np.float32)
    for i, img in enumerate(images):
        r, col = divmod(i, cols)
        canvas[r * h:(r + 1) * h, col * w:(col + 1) * w] = img
    return canvas


def _save(path: str, img: np.ndarray) -> None:
    from PIL import Image
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    Image.fromarray((np.clip(img, 0, 1) * 255).astype(np.uint8)).save(path)


def plot_norm(outputs: dict, rgb_gt: np.ndarray, plots_dir: str, it: int,
              img_res: tuple[int, int]) -> str:
    """AE normals vs geometry normals vs GT (utils/plots.py:84-103)."""
    imgs = [
        lin2img(np.asarray(outputs["normals"]) * 0.5 + 0.5, img_res),
        lin2img(np.asarray(outputs["normal_neus"]) * 0.5 + 0.5, img_res),
        tonemap(lin2img(np.asarray(rgb_gt), img_res)),
    ]
    path = os.path.join(plots_dir, f"norm_{it}.png")
    _save(path, _grid(imgs))
    return path


def plot_illum(outputs: dict, rgb_gt: np.ndarray, plots_dir: str, it: int,
               img_res: tuple[int, int]) -> str:
    """Predicted visibility / traced visibility / GT (utils/plots.py:38-81)."""
    imgs = [
        lin2img(np.asarray(outputs["pred_vis"]), img_res),
        lin2img(np.asarray(outputs["gt_vis"]), img_res),
        tonemap(lin2img(np.asarray(rgb_gt), img_res)),
    ]
    path = os.path.join(plots_dir, f"illum_{it}.png")
    _save(path, _grid(imgs))
    return path


def plot_mat(outputs: dict, rgb_gt: np.ndarray, plots_dir: str, it: int,
             img_res: tuple[int, int], index: int = 0) -> str:
    """PBR decomposition grid (utils/plots.py:106-125): pred / GT / albedo /
    roughness / indirect / shadow."""
    imgs = [
        tonemap(lin2img(np.asarray(outputs["pred_rgb"]), img_res)),
        tonemap(lin2img(np.asarray(rgb_gt), img_res)),
        tonemap(lin2img(np.asarray(outputs["diffuse_albedo"]), img_res)),
        lin2img(np.asarray(outputs["roughness"]), img_res),
        tonemap(lin2img(np.asarray(outputs["indir_rgb"]), img_res)),
        lin2img(np.asarray(outputs["vis_shadow"]), img_res),
    ]
    path = os.path.join(plots_dir, f"mat_{it}_{index}.png")
    _save(path, _grid(imgs, cols=3))
    return path


def plot_cesr(outputs: dict, rgb_gt: np.ndarray, plots_dir: str, it: int,
              img_res: tuple[int, int], index: int = 0) -> str:
    """CESR grid (utils/plots.py:128-173): pred / GT / albedo / shadow /
    normal / specular."""
    imgs = [
        tonemap(lin2img(np.asarray(outputs["pred_rgb"]), img_res)),
        tonemap(lin2img(np.asarray(rgb_gt), img_res)),
        tonemap(lin2img(np.asarray(outputs["diffuse_albedo"]), img_res)),
        lin2img(np.asarray(outputs["vis_shadow"]), img_res),
        lin2img(np.asarray(outputs["normal_map"]) * 0.5 + 0.5, img_res),
        tonemap(lin2img(np.asarray(outputs["sg_specular_rgb"]), img_res)),
    ]
    path = os.path.join(plots_dir, f"cesr_{it}_{index}.png")
    _save(path, _grid(imgs, cols=3))
    return path
