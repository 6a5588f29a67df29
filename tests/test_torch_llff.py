"""The port's LLFF and Multicam loaders against the JAX package's on scenes
written from a seed (``torch_port_helpers.write_llff_scene``,
``write_multicam_scene``, and an inward-facing capture for ``spherify``):
the pose maths (recentering, the spiral and spherified paths, NDC), every
ray array, the radii, the images and the splits, within 1e-6; and the
ragged eval of the stage-1 trainer on a Multicam scene (each view at its
own resolution, the frames logged as images).
"""

import os

import numpy as np
import pytest

from robir_tpu.data import llff as jllff
from robir_tpu.data import multicam as jmulticam
from robir_tpu_torch.data import llff as tllff
from robir_tpu_torch.data import multicam as tmulticam
from torch_port_helpers import write_llff_scene, write_multicam_scene

TOL = dict(rtol=1e-6, atol=1e-6)


def _inward_scene(root, n=12, h=24, w=32):
    """Cameras on a ring around a target, looking at it (spherify's case)."""
    from PIL import Image
    rng = np.random.default_rng(9)
    os.makedirs(os.path.join(root, "images"), exist_ok=True)
    target = np.array([1.0, 0.5, -0.3])
    rows = []
    for i in range(n):
        img = (rng.random((h, w, 3)) * 255).astype(np.uint8)
        Image.fromarray(img).save(os.path.join(root, "images", f"{i:03d}.png"))
        th, ph = 2 * np.pi * i / n, 0.3 + 0.4 * rng.random()
        eye = target + 5.0 * np.array([np.cos(th) * np.cos(ph), np.sin(th) * np.cos(ph),
                                       np.sin(ph)])
        back = (eye - target) / np.linalg.norm(eye - target)
        right = np.cross([0, 0, 1.0], back)
        right /= np.linalg.norm(right)
        up = np.cross(back, right)
        pose = np.concatenate([np.stack([-up, right, back], 1), eye[:, None],
                               np.array([[h], [w], [50.0]])], 1)
        rows.append(np.concatenate([pose.ravel(), [2.0, 9.0]]))
    np.save(os.path.join(root, "poses_bounds.npy"), np.stack(rows))
    return str(root)


def _assert_scenes_equal(t, j):
    for a, b, what in ((t.images, j.images, "images"), (t.poses, j.poses, "poses"),
                       (t.bds, j.bds, "bds"), (t.render_poses, j.render_poses, "render path")):
        np.testing.assert_allclose(a, b, **TOL, err_msg=what)
    assert (t.h, t.w, t.n_images) == (j.h, j.w, j.n_images) and t.focal == j.focal
    for name, a, b in zip(t.flat._fields, t.flat, j.flat):
        np.testing.assert_allclose(a, b, **TOL, err_msg=name)
    for a, b in zip(t.image_rays(1), j.image_rays(1)):
        np.testing.assert_allclose(a, b, **TOL)
    rng_t, rng_j = np.random.default_rng(3), np.random.default_rng(3)
    for a, b in zip(t.sample(rng_t, 32), j.sample(rng_j, 32)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("split", ["train", "test"])
def test_llff_scene_matches_jax(tmp_path, split):
    """Forward-facing: NDC rays and their radii, the llffhold split (every
    8th view held out), the spiral render path."""
    root = write_llff_scene(tmp_path, n=10, h=24, w=32, seed=1)
    t = tllff.LLFFScene(tllff.LLFFConfig(data_dir=root), split)
    j = jllff.LLFFScene(jllff.LLFFConfig(data_dir=root), split)
    assert t.n_images == (2 if split == "test" else 8)
    _assert_scenes_equal(t, j)


def test_llff_spherify_and_refusal_match_jax(tmp_path):
    root = _inward_scene(tmp_path / "inward")
    cfg = dict(data_dir=root, spherify=True, llffhold=4)
    _assert_scenes_equal(tllff.LLFFScene(tllff.LLFFConfig(**cfg), "train"),
                         jllff.LLFFScene(jllff.LLFFConfig(**cfg), "train"))
    fwd = write_llff_scene(tmp_path / "fwd", n=6, h=8, w=8)
    for mod in (tllff, jllff):
        with pytest.raises(ValueError, match="forward-facing"):
            mod.LLFFScene(mod.LLFFConfig(data_dir=fwd, spherify=True), "train")


def test_pose_maths_match_jax():
    rng = np.random.default_rng(4)
    poses = np.concatenate([rng.standard_normal((6, 3, 4)), np.ones((6, 3, 1))], 2)
    bds = 2 + rng.random((6, 2)) * 5
    np.testing.assert_allclose(tllff.recenter_poses(poses), jllff.recenter_poses(poses), **TOL)
    np.testing.assert_allclose(tllff.spiral_path(poses, bds, n_frames=16),
                               jllff.spiral_path(poses, bds, n_frames=16), **TOL)
    for a, b in zip(tllff.spherify_poses(poses[:, :3, :4], bds, 8),
                    jllff.spherify_poses(poses[:, :3, :4], bds, 8)):
        np.testing.assert_allclose(a, b, **TOL)
    o = rng.standard_normal((5, 3)).astype(np.float32)
    d = rng.standard_normal((5, 3)).astype(np.float32) - [0, 0, 2]
    for a, b in zip(tllff.convert_to_ndc(o, d, 50.0, 40, 30, 1.0),
                    jllff.convert_to_ndc(o, d, 50.0, 40, 30, 1.0)):
        np.testing.assert_allclose(a, b, **TOL)


@pytest.mark.parametrize("split", ["train", "test"])
def test_multicam_scene_matches_jax(tmp_path, split):
    root = write_multicam_scene(tmp_path, seed=2)
    t = tmulticam.MulticamScene(tmulticam.MulticamConfig(dataset_dir=root), split)
    j = jmulticam.MulticamScene(jmulticam.MulticamConfig(dataset_dir=root), split)
    assert t.n_images == j.n_images == 2
    assert [t.image_shape(i) for i in range(2)] == [(16, 20), (24, 30)]
    for i in range(2):
        assert t.image_shape(i) == j.image_shape(i)
        np.testing.assert_allclose(t.images[i], j.images[i], **TOL)
        for a, b in zip(t.image_rays(i), j.image_rays(i)):
            np.testing.assert_allclose(a, b, **TOL)
    for a, b in zip(t.flat, j.flat):
        np.testing.assert_allclose(a, b, **TOL)


def test_multicam_trainer_ragged_eval(tmp_path):
    """VNeRF under mip on a Multicam scene, on the CPU: each test view
    rendered at its own resolution, and the test pass logging its ragged
    frames as images (no video)."""
    import torch

    from robir_tpu_torch.fields.vnerf import VNeRFConfig
    from robir_tpu_torch.render.mip import MipRenderConfig
    from robir_tpu_torch.stages.neus_stage import (NeusTrainConfig, NeusTrainer,
                                                   make_stage1_bindings)
    from robir_tpu_torch.tools.logger import Logger
    root = write_multicam_scene(tmp_path / "scene")
    cfg = tmulticam.MulticamConfig(dataset_dir=root)
    model_cfg = VNeRFConfig(width=16, depth=2, skips=(), multires=3, multires_view=2,
                            use_ipe=True, ipe_max_deg=4)
    render_cfg = MipRenderConfig(num_samples=8)
    tr = NeusTrainer(tmulticam.MulticamScene(cfg), model_cfg, render_cfg,
                     NeusTrainConfig(batch_size=8, max_steps=6, eval_chunk=64), device="cpu",
                     bindings=make_stage1_bindings("vnerf", "mip", model_cfg, render_cfg))
    try:
        assert np.isfinite(tr.run(2)["loss"])
        test_scene = tmulticam.MulticamScene(cfg, "test")
        assert tr.render_image(1, scene=test_scene)["rgb"].shape == (24, 30, 3)
        logger = Logger(str(tmp_path / "logs"), exp_name="neus")
        metrics = tr.test(test_scene, logger=logger)
        with pytest.raises(ValueError, match="density model"):
            tr.extract_mesh()
    finally:
        tr.close()
    assert np.isfinite(metrics["mean_psnr"])
    assert metrics["rays_per_sec"] > 0 and torch.get_default_dtype() == torch.float32
    plots = os.listdir(logger.plots_dir)
    assert {"test_frame_0_2.png", "test_frame_1_2.png"} <= set(plots), plots
    assert not any(p.startswith("test_frames") for p in plots), plots
