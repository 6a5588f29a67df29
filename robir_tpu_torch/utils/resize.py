"""Area resize of an image in numpy: OpenCV's ``cv2.resize(img, (w, h),
interpolation=cv2.INTER_AREA)``, which the JAX package calls, without cv2
(the card's machine has none).

OpenCV's rule, per axis, as separable weights:
- shrinking on both axes (source / destination >= 1 on each): every
  destination pixel averages the source pixels its footprint covers, each
  weighted by the part of it covered (``computeResizeAreaTab``); an integer
  factor reduces to a box mean;
- otherwise (enlarging on either axis): OpenCV's area-mode variant of
  bilinear interpolation, where destination pixel dx takes source pixel
  ``sx = floor(dx * scale)`` and its right neighbour at weight
  ``fx = frac((dx + 1) - (sx + 1) / scale)`` (0 where that is not
  positive), clamped at the border; at an integer factor ``fx`` is always
  0 and pixels repeat.
"""

from __future__ import annotations

import math

import numpy as np


def _shrink_weights(n_src: int, n_dst: int) -> np.ndarray:
    """[n_dst, n_src] area weights of OpenCV's ``computeResizeAreaTab``."""
    scale = n_src / n_dst
    w = np.zeros((n_dst, n_src), np.float64)
    for d in range(n_dst):
        f1 = d * scale
        f2 = f1 + scale
        cell = min(scale, n_src - f1)
        s2 = min(math.floor(f2), n_src - 1)
        s1 = min(math.ceil(f1), s2)
        if s1 - f1 > 1e-3:
            w[d, s1 - 1] += (s1 - f1) / cell
        w[d, s1:s2] += 1.0 / cell
        if f2 - s2 > 1e-3:
            w[d, s2] += min(f2 - s2, 1.0, cell) / cell
    return w


def _enlarge_weights(n_src: int, n_dst: int) -> np.ndarray:
    """[n_dst, n_src] weights of OpenCV's area-mode bilinear branch."""
    inv_scale = n_dst / n_src
    scale = 1.0 / inv_scale
    w = np.zeros((n_dst, n_src), np.float64)
    for d in range(n_dst):
        s = math.floor(d * scale)
        fx = (d + 1) - (s + 1) * inv_scale
        fx = 0.0 if fx <= 0 else fx - math.floor(fx)
        if s < 0:
            s, fx = 0, 0.0
        if s >= n_src - 1:
            s, fx = n_src - 1, 0.0
        w[d, s] += 1.0 - fx
        if fx:
            w[d, s + 1] += fx
    return w


def resize_area(img: np.ndarray, size: tuple[int, int]) -> np.ndarray:
    """``img`` [H, W] or [H, W, C] resized to ``size`` = (h, w) by OpenCV's
    INTER_AREA rule (the module docstring); float32 out."""
    h, w = size
    sh, sw = img.shape[:2]
    if sh >= h and sw >= w:
        wy, wx = _shrink_weights(sh, h), _shrink_weights(sw, w)
    else:
        wy, wx = _enlarge_weights(sh, h), _enlarge_weights(sw, w)
    src = np.asarray(img, np.float64)
    out = np.einsum("ys,st...->yt...", wy, src)
    out = np.einsum("xt,yt...->yx...", wx, out)
    return out.astype(np.float32)
