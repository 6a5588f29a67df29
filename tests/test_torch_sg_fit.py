"""The port's SG envmap fit (``stages/sg_fit.py``) and its area resize
(``utils/resize.py``) against the JAX package's, which resizes with cv2:
``resize_area`` against ``cv2.resize(INTER_AREA)`` on six shapes
(shrinking by 4, by 1.17 and by 2, as ``BlenderScene`` at ``factor: 2``
does; enlarging by 4 and by 2.56; an odd size); ``fit_envmap`` from one
init over 20 Adam steps at 8 SGs on a 16 x 32 image; ``main``'s files.

Tolerances: the resize 1e-5 (cv2 sums in fp32, the port in fp64); the fit's
losses 1e-5 relative and its SGs 1e-4 (optax's and torch's Adam are one
formula in another rounding order, compounded over 20 steps).
"""

import os

import cv2
import numpy as np
import pytest
import torch

from robir_tpu.render import sg as jsg
from robir_tpu.stages import sg_fit as jfit
from robir_tpu_torch.render.sg import compute_envmap
from robir_tpu_torch.stages import sg_fit as tfit
from robir_tpu_torch.utils.exr import read_exr, write_exr
from robir_tpu_torch.utils.resize import resize_area

SHAPES = [((1024, 2048), (256, 512)), ((300, 600), (256, 512)), ((64, 128), (256, 512)),
          ((100, 200), (256, 512)), ((37, 75), (256, 512)), ((96, 96), (48, 48))]


@pytest.mark.parametrize("src,dst", SHAPES)
def test_resize_area_matches_cv2(src, dst):
    img = np.random.default_rng(sum(src)).random((*src, 3)).astype(np.float32) * 3
    want = cv2.resize(img, dst[::-1], interpolation=cv2.INTER_AREA)
    got = resize_area(img, dst)
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def _envmap(seed: int, num_sg: int, h: int, w: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    sgs = rng.standard_normal((num_sg, 7)).astype(np.float32)
    sgs[:, 3] = np.abs(sgs[:, 3]) * 20 + 5
    sgs[:, 4:] = np.abs(sgs[:, 4:])
    with torch.no_grad():
        return compute_envmap(torch.as_tensor(sgs), h, w).numpy()


def test_fit_envmap_matches_jax():
    gt = _envmap(0, 4, 16, 32)
    init = np.random.default_rng(1).standard_normal((8, 7)).astype(np.float32)
    init[:, 3] *= 100.0
    cfg = dict(num_sg=8, n_iters=20, H=16, W=32)
    got_log, want_log = [], []
    got, got_loss = tfit.fit_envmap(gt, tfit.SGFitConfig(**cfg), init=init, log_every=1,
                                    log_fn=lambda i, v: got_log.append(v), device="cpu")
    want, want_loss = jfit.fit_envmap(gt, jfit.SGFitConfig(**cfg), init=init, log_every=1,
                                      log_fn=lambda i, v: want_log.append(v))
    assert len(got_log) == 20 and got_log[-1] < got_log[0]
    np.testing.assert_allclose(got_log, want_log, rtol=1e-5)
    np.testing.assert_allclose(got_loss, want_loss, rtol=1e-5)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_init_and_envmap_image_match_jax():
    """``init_lgt_sgs``'s layout (lambda x100) and the fitted image that
    ``main`` writes (``compute_envmap``) against JAX's on the same SGs."""
    sgs = tfit.init_lgt_sgs(torch.Generator().manual_seed(0), 64).numpy()
    assert sgs.shape == (64, 7) and np.abs(sgs[:, 3]).mean() > 20 * np.abs(sgs[:, :3]).mean()
    with torch.no_grad():
        got = compute_envmap(torch.as_tensor(sgs), 16, 32).numpy()
    np.testing.assert_allclose(got, np.asarray(jsg.compute_envmap(sgs, 16, 32)),
                               rtol=1e-5, atol=1e-6)


def test_main_writes_the_fit(tmp_path):
    """``main`` on a 512 x 1,024 EXR (area-resized to 256 x 512): sg_8.npy
    and fit_8.exr beside it, the loss falling."""
    env = str(tmp_path / "env.exr")
    write_exr(env, _envmap(2, 3, 512, 1024))
    sgs, logged = tfit.main(["--envmap_path", env, "--num_sg", "8", "--n_iters", "3",
                             "--device", "cpu"])
    out = str(tmp_path / "env")
    assert sorted(os.listdir(out)) == ["fit_8.exr", "sg_8.npy"]
    np.testing.assert_array_equal(np.load(os.path.join(out, "sg_8.npy")), sgs)
    fit = read_exr(os.path.join(out, "fit_8.exr"))
    assert fit.shape[:2] == (256, 512) and np.isfinite(fit).all()
    assert [i for i, _ in logged] == [0, 2] and logged[1][1] < logged[0][1]
