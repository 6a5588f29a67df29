"""The port's scenes on disk against the JAX package's: the procedural
writers, ``SynDataset`` (train and test splits), and the
``cameras_sphere.npz`` loaders ``NeuSNpzScene`` and ``DTUSceneDataset``.

Images, masks, poses, intrinsics and relit images are held exactly (both
packages decode the same PNG bytes with the same arithmetic); rays and the
npz cameras within 1e-5 (the JAX package decomposes the projection with
cv2, the port with a numpy RQ decomposition).
"""

import os

import cv2
import numpy as np
import pytest

from robir_tpu.data import neus_npz as jnpz
from robir_tpu.data import synthetic as jsyn
from robir_tpu.data.blender import BlenderConfig as JBlenderConfig
from robir_tpu.data.blender import BlenderScene as JBlenderScene
from robir_tpu.data.syn_dataset import SynDataset as JSynDataset
from robir_tpu.data.syn_dataset import SynDatasetConfig as JSynDatasetConfig
from robir_tpu_torch.data import neus_npz as tnpz
from robir_tpu_torch.data import synthetic as tsyn
from robir_tpu_torch.data.blender import BlenderConfig, BlenderScene
from robir_tpu_torch.data.syn_dataset import SynDataset, SynDatasetConfig, shadow_scene


def _read_all(root: str) -> dict:
    """Every file of a written scene: PNGs as arrays, JSON as text."""
    from PIL import Image
    out = {}
    for dp, _, files in os.walk(root):
        for f in files:
            path = os.path.join(dp, f)
            rel = os.path.relpath(path, root)
            if f.endswith(".png"):
                out[rel] = np.asarray(Image.open(path))
            else:
                with open(path) as fp:
                    out[rel] = fp.read()
    return out


@pytest.mark.parametrize("writer", ["make_sphere_dataset", "make_shadow_dataset"])
def test_writers_match_jax(tmp_path, writer):
    kw = dict(n_train=3, n_test=2, h=20, w=24, seed=4)
    getattr(jsyn, writer)(str(tmp_path / "jax"), **kw)
    getattr(tsyn, writer)(str(tmp_path / "port"), **kw)
    want, got = _read_all(str(tmp_path / "jax")), _read_all(str(tmp_path / "port"))
    assert sorted(got) == sorted(want) and len(got) == 3 + 2 * 2 + 2 + 2 * 2 + 3
    for k in want:
        if isinstance(want[k], str):
            assert got[k] == want[k], k
        else:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.fixture(scope="module")
def shadow_dir(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("shadow"))
    tsyn.make_shadow_dataset(root, n_train=5, n_test=3, h=24, w=20)
    return root


@pytest.mark.parametrize("split,skip", [("train", 1), ("train", 2), ("test", 1), ("test", 2)])
def test_syn_dataset_matches_jax(shadow_dir, split, skip):
    got = SynDataset(SynDatasetConfig(instance_dir=shadow_dir, split=split, frame_skip=skip))
    want = JSynDataset(JSynDatasetConfig(instance_dir=shadow_dir, split=split, frame_skip=skip))
    assert got.n_cameras == want.n_cameras == len(range(0, 5 if split == "train" else 3, skip))
    assert got.img_res == want.img_res and got.total_pixels == want.total_pixels
    np.testing.assert_array_equal(got.intrinsics, want.intrinsics)
    np.testing.assert_array_equal(got.poses, want.poses)
    for i in range(got.n_cameras):
        np.testing.assert_array_equal(got.rgb_images[i], want.rgb_images[i])
        np.testing.assert_array_equal(got.object_masks[i], want.object_masks[i])
    if split == "test":
        assert sorted(got.relit_images) == sorted(want.relit_images) == ["envmap12", "envmap6"]
        for env, imgs in want.relit_images.items():
            for a, b in zip(got.relit_images[env], imgs):
                np.testing.assert_array_equal(a, b)
    rng_a, rng_b = np.random.default_rng(1), np.random.default_rng(1)
    a, b = got.sample_pixels(rng_a, 0, 64), want.sample_pixels(rng_b, 0, 64)
    for k in b:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_shadow_scene_equals_the_written_scene(shadow_dir):
    """The in-memory scene (``SynDataset.from_arrays``) equals the port's
    loader on the port's writer's files."""
    for split in ("train", "test"):
        mem = shadow_scene(n_train=5, n_test=3, h=24, w=20, split=split)
        disk = SynDataset(SynDatasetConfig(instance_dir=shadow_dir, split=split))
        np.testing.assert_array_equal(mem.poses, disk.poses)
        for a, b in zip(mem.rgb_images + mem.object_masks, disk.rgb_images + disk.object_masks):
            np.testing.assert_array_equal(a, b)


def test_blender_scene_reads_the_ports_writer(tmp_path):
    tsyn.make_sphere_dataset(str(tmp_path), n_train=3, n_test=2, h=16, w=16)
    for split in ("train", "test"):
        got = BlenderScene(BlenderConfig(dataset_dir=str(tmp_path), test_skip=1), split)
        want = JBlenderScene(JBlenderConfig(dataset_dir=str(tmp_path), test_skip=1), split)
        np.testing.assert_array_equal(got.images, want.images)
        mem = tsyn.make_sphere_scene(split, n_train=3, n_test=2, h=16, w=16)
        np.testing.assert_allclose(mem.images, got.images, atol=1e-6)


def _make_npz_scene(root, n=6, h=40, w=48):
    """The procedural cameras_sphere.npz scene of tests/test_config_cli.py."""
    rng = np.random.default_rng(0)
    K = np.array([[60.0, 0, w / 2], [0, 60.0, h / 2], [0, 0, 1]], np.float32)
    os.makedirs(root / "image", exist_ok=True)
    os.makedirs(root / "mask", exist_ok=True)
    cams = {}
    for i in range(n):
        theta = 2 * np.pi * i / n
        center = 3.0 * np.array([np.cos(theta), np.sin(theta), 0.4], np.float32)
        z = -center / np.linalg.norm(center)
        x = np.cross(np.array([0, 0, 1.0]), z)
        x /= np.linalg.norm(x)
        y = np.cross(z, x)
        R_w2c = np.stack([x, y, z], 0).astype(np.float32)
        t_w2c = (-R_w2c @ center).astype(np.float32)
        world_mat = np.eye(4, dtype=np.float32)
        world_mat[:3, :4] = K @ np.concatenate([R_w2c, t_w2c[:, None]], 1)
        cams[f"world_mat_{i}"] = world_mat
        cams[f"scale_mat_{i}"] = np.eye(4, dtype=np.float32)
        cv2.imwrite(str(root / "image" / f"{i:03d}.png"),
                    (rng.random((h, w, 3)) * 255).astype(np.uint8))
        mask = np.zeros((h, w, 3), np.uint8)
        mask[h // 4:, : w // 2] = 255
        cv2.imwrite(str(root / "mask" / f"{i:03d}.png"), mask)
    np.savez(root / "cameras_sphere.npz", **cams)
    return str(root)


@pytest.fixture(scope="module")
def npz_dir(tmp_path_factory):
    return _make_npz_scene(tmp_path_factory.mktemp("npz"))


def test_neus_npz_scene_matches_jax(npz_dir):
    base_t = tnpz.NeuSNpzDataset(tnpz.NeuSNpzConfig(data_dir=npz_dir))
    base_j = jnpz.NeuSNpzDataset(jnpz.NeuSNpzConfig(data_dir=npz_dir))
    np.testing.assert_array_equal(base_t.images, base_j.images)
    np.testing.assert_array_equal(base_t.masks, base_j.masks)
    np.testing.assert_allclose(base_t.intrinsics, base_j.intrinsics, atol=1e-5)
    np.testing.assert_allclose(base_t.poses, base_j.poses, atol=1e-5)
    for split in ("train", "test"):
        got = tnpz.NeuSNpzScene(tnpz.NeuSNpzSceneConfig(dataset_dir=npz_dir), split)
        want = jnpz.NeuSNpzScene(jnpz.NeuSNpzSceneConfig(dataset_dir=npz_dir), split)
        assert (got.h, got.w, got.n_images) == (want.h, want.w, want.n_images)
        np.testing.assert_array_equal(got.images, want.images)
        np.testing.assert_array_equal(got.masks, want.masks)
        for a, b in zip(got.image_rays(2), want.image_rays(2)):
            np.testing.assert_allclose(a, b, atol=1e-5)
        for a, b in zip(got.sample(np.random.default_rng(3), 128),
                        want.sample(np.random.default_rng(3), 128)):
            np.testing.assert_allclose(a, b, atol=1e-5)
    for a, b in zip(base_t.gen_rays_between(0, 1, 0.3), base_j.gen_rays_between(0, 1, 0.3)):
        np.testing.assert_allclose(a, b, atol=1e-5)


@pytest.mark.parametrize("skip", [1, 2])
def test_dtu_scene_dataset_matches_jax(npz_dir, skip):
    got = tnpz.DTUSceneDataset(tnpz.DTUConfig(data_dir=npz_dir, frame_skip=skip))
    want = jnpz.DTUSceneDataset(jnpz.DTUConfig(data_dir=npz_dir, frame_skip=skip))
    assert got.n_cameras == want.n_cameras and got.img_res == want.img_res
    np.testing.assert_allclose(got.intrinsics, want.intrinsics, atol=1e-5)
    np.testing.assert_allclose(got.poses, want.poses, atol=1e-5)
    for i in range(got.n_cameras):
        np.testing.assert_array_equal(got.rgb_images[i], want.rgb_images[i])
        np.testing.assert_array_equal(got.object_masks[i], want.object_masks[i])
        for a, b in zip(got.camera_rays(i), want.camera_rays(i)):
            np.testing.assert_allclose(a, b, atol=1e-5)
    a = got.sample_pixels(np.random.default_rng(2), 1, 32)
    b = want.sample_pixels(np.random.default_rng(2), 1, 32)
    for k in ("uv", "object_mask", "rgb"):
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    np.testing.assert_allclose(a["dirs"], b["dirs"], atol=1e-5)
    np.testing.assert_array_equal(got.masked_pixels(), want.masked_pixels())


def test_rq_decomposition_matches_cv2():
    """``load_K_Rt_from_P`` on random cameras (scaled projections, skew)
    against cv2's decomposition, as the JAX package calls it."""
    rng = np.random.default_rng(0)
    for _ in range(16):
        K = np.array([[rng.uniform(50, 150), rng.uniform(-2, 2), rng.uniform(10, 30)],
                      [0, rng.uniform(50, 150), rng.uniform(10, 30)], [0, 0, 1]])
        q, r = np.linalg.qr(rng.standard_normal((3, 3)))
        R = q * np.sign(np.diag(r))
        R = R if np.linalg.det(R) > 0 else -R
        c = rng.standard_normal(3) * 3
        P = (rng.uniform(0.5, 3) * K @ np.concatenate([R, (-R @ c)[:, None]], 1)).astype(np.float32)
        for a, b in zip(tnpz.load_K_Rt_from_P(P), jnpz.load_K_Rt_from_P(P)):
            np.testing.assert_allclose(a, b, atol=1e-5)
