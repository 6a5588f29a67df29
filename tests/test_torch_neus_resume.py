"""Stage 1's checkpoints across the packages: the port's ``NeusTrainer``
writes the parameters, the step and the Adam moments in the JAX trainer's
layout and resumes from either package's file; and its ``ckpt_every``,
in-train eval and test pass write the JAX trainer's files.

Resume tolerance: the step after a resume, on one batch and one jitter, in
both packages, held as ``tests/test_torch_train_neus.py`` holds a step: the
loss to 1e-4 relative; the parameters after it to 2 * lr (one step at lr
5e-4), with 99% of entries within 1e-5. Adam's moments after it: the
schedule and Adam counts equal, each ``mu`` and ``nu`` leaf within 1e-3 of
its largest entry (they hold the gradients of two fp32 computations).
"""

import glob
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from robir_tpu.core.tree import flatten_with_paths as jflatten
from robir_tpu.core.tree import to_plain
from robir_tpu.data import blender as jblender
from robir_tpu.data.synthetic import make_sphere_dataset
from robir_tpu.fields import neus_model as jnm
from robir_tpu.fields.radiance import RenderingConfig as JRenderingConfig
from robir_tpu.fields.sdf import SDFConfig as JSDFConfig
from robir_tpu.render import neus as jneus
from robir_tpu.stages import neus_stage as jstage
from robir_tpu_torch.core import checkpoint as ckpt_lib
from robir_tpu_torch.core.draws import Draws
from robir_tpu_torch.core.tree import flatten_with_paths
from robir_tpu_torch.data.blender import BlenderConfig, BlenderScene, RayBatch
from robir_tpu_torch.fields import neus_model as tnm
from robir_tpu_torch.fields.radiance import RenderingConfig
from robir_tpu_torch.fields.sdf import SDFConfig
from robir_tpu_torch.render import neus as tneus
from robir_tpu_torch.stages import neus_stage as tstage
from robir_tpu_torch.tools.logger import Logger
from torch_port_helpers import to_t

SDF_KW = dict(d_out=17, d_hidden=32, n_layers=3, skip_in=(2,), multires=2)
COLOR_KW = dict(d_feature=16, d_hidden=32, n_layers=2)
RENDER_KW = dict(n_samples=16, n_importance=16, up_sample_steps=2)
TRAIN_KW = dict(batch_size=64, lr_init=5e-4, lr_delay_steps=0, max_steps=400,
                anneal_end=50, eval_chunk=128, mesh_resolution=24)
LR = 5e-4


@pytest.fixture(scope="module")
def scene_dir(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("sphere"))
    make_sphere_dataset(root, n_train=4, n_test=2, h=16, w=16)
    return root


def _port(scene_dir, log_dir, **train):
    cfg = tnm.NeuSConfig(sdf=SDFConfig(**SDF_KW), color=RenderingConfig(**COLOR_KW))
    return tstage.NeusTrainer(
        BlenderScene(BlenderConfig(dataset_dir=scene_dir), "train"), cfg,
        tneus.NeusRenderConfig(**RENDER_KW), tstage.NeusTrainConfig(**TRAIN_KW, **train),
        seed=0, device="cpu", log_dir=log_dir)


def _jax(scene_dir, log_dir, **train):
    cfg = jnm.NeuSConfig(sdf=JSDFConfig(**SDF_KW), color=JRenderingConfig(**COLOR_KW))
    return jstage.NeusTrainer(
        jblender.BlenderScene(jblender.BlenderConfig(dataset_dir=scene_dir), "train"), cfg,
        jneus.NeusRenderConfig(**RENDER_KW), jstage.NeusTrainConfig(**TRAIN_KW, **train),
        log_dir=log_dir, seed=0)


def _jax_state(jt) -> dict:
    return {k: np.asarray(v) for k, v in jflatten(to_plain(
        {"params": jt.params, "opt_state": jt.opt_state})).items()}


@pytest.mark.parametrize("clip", [0.0, 1.0])
def test_save_restore_round_trip_in_the_jax_layout(scene_dir, tmp_path, clip):
    tr = _port(scene_dir, str(tmp_path), grad_max_norm=clip)
    try:
        tr.run(2)
    finally:
        tr.close()
    path = tr.save()
    saved = flatten_with_paths(ckpt_lib.load(path)[0])
    jt = _jax(scene_dir, None, grad_max_norm=clip)
    layout = _jax_state(jt)
    assert sorted(saved) == sorted(layout)
    for k, v in layout.items():
        assert saved[k].dtype == v.dtype and saved[k].shape == v.shape, k
    adam = "opt_state/1/0" if clip else "opt_state/0"
    assert int(saved[f"{adam}/count"]) == 2
    assert np.abs(saved[f"{adam}/nu/sdf_network/lin0/v"]).max() > 0

    fresh = _port(scene_dir, str(tmp_path), grad_max_norm=clip)
    fresh.restore()
    assert fresh.step == 2
    got, want = fresh.state(), tr.state()
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    p = fresh.model.params["sdf_network"]["lin0"]["v"]
    assert str(fresh.optimizer.state[p]["step"].dtype) == "torch.float32"
    assert fresh.optimizer.state[p]["step"].device.type == "cpu"


def _next_step(tr, jt, scene_dir):
    """One more step in both packages on one batch and one key."""
    jscene = jblender.BlenderScene(jblender.BlenderConfig(dataset_dir=scene_dir), "train")
    batch = jscene.sample(np.random.default_rng(7), 64)
    key = jax.random.PRNGKey(11)
    jt.params, jt.opt_state, jm = jt.train_step(
        jt.params, jt.opt_state, jblender.RayBatch(*map(jnp.asarray, batch)),
        jnp.asarray(jt.step, jnp.int32), key)
    _, k1 = jax.random.split(key)
    draws = Draws(given={"t_rand": to_t(jax.random.uniform(k1, (64, 1)))})
    tm = tstage.train_step(tr.model, tr.optimizer, tr.lr_fn, RayBatch(*map(to_t, batch)),
                           tr.step, tr.train_cfg, tr.render_cfg, draws)
    tr.step += 1
    jt.step += 1
    return float(tm["loss"]), float(jm["loss"])


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_resume_across_packages(scene_dir, tmp_path, direction):
    tr, jt = _port(scene_dir, str(tmp_path)), _jax(scene_dir, str(tmp_path))
    try:
        if direction == "jax_to_port":
            jt.run(3)
            path = jt.save()
            tr.restore(path)
        else:
            tr.run(3)
            path = tr.save()
            jt.restore(path)
    finally:
        tr.close()
    assert tr.step == jt.step == 3
    before = _jax_state(jt)
    for k, v in tr.state().items():
        np.testing.assert_array_equal(v, before[k], err_msg=k)
    got_loss, want_loss = _next_step(tr, jt, scene_dir)
    np.testing.assert_allclose(got_loss, want_loss, rtol=1e-4)
    got, want = tr.state(), _jax_state(jt)
    params = [k for k in want if k.startswith("params/")]
    diffs = np.concatenate([np.abs(got[k] - want[k]).ravel() for k in params])
    assert diffs.max() <= 2 * LR, diffs.max()
    assert np.mean(diffs <= 1e-5) >= 0.99, np.mean(diffs <= 1e-5)
    for k in want:
        if k.endswith("count"):
            assert int(got[k]) == int(want[k]) == 4, k
        elif not k.startswith("params/"):
            scale = np.abs(want[k]).max()
            assert np.abs(got[k] - want[k]).max() <= 1e-3 * max(scale, 1e-30), k


def test_ckpt_every_in_train_eval_and_test_pass_write_files(scene_dir, tmp_path):
    """The files of ``tests/test_train_neus.py``'s CLI run, from the port's
    trainer: a checkpoint every ``ckpt_every`` steps, a test image and a
    mesh every ``eval_every``, and the test pass's video and
    ``description.json``."""
    log_dir = str(tmp_path / "NeuS")
    tr = _port(scene_dir, log_dir, eval_every=2, ckpt_every=3)
    test_scene = BlenderScene(BlenderConfig(dataset_dir=scene_dir, test_skip=1), "test")
    logger = Logger(log_dir, exp_name="neus")
    logged = []
    try:
        last = tr.run(6, log_every=2, metrics_cb=lambda s, m: logged.append(s),
                      test_scene=test_scene, logger=logger)
    finally:
        tr.close()
    assert logged == [2, 4, 6] and np.isfinite(last["loss"])
    names = sorted(os.path.basename(p) for p in glob.glob(os.path.join(log_dir, "ckpt_*.npz")))
    assert names == ["ckpt_000003.npz", "ckpt_000006.npz"]
    run_dir = os.path.join(log_dir, "neus")
    assert sorted(os.listdir(os.path.join(run_dir, "meshes"))) == [
        f"mesh_{s:06d}.ply" for s in (2, 4, 6)]
    assert all(os.path.exists(os.path.join(run_dir, "plots", f"test_rgb_{s}.png"))
               for s in (2, 4, 6))
    metrics = tr.test(test_scene, logger=logger)
    assert metrics["rays_per_sec"] > 0 and np.isfinite(metrics["mean_psnr"])
    assert (os.path.exists(os.path.join(run_dir, "plots", "test_frames.mp4"))
            or os.path.exists(os.path.join(run_dir, "plots", "test_frames.gif")))
    with open(os.path.join(run_dir, "description.json")) as f:
        desc = json.load(f)
    assert {"mean_psnr", "mean_mse", "render_time", "rays_per_sec"} <= set(desc)
    with open(os.path.join(run_dir, "scalars.jsonl")) as f:
        lines = [json.loads(x) for x in f]
    assert [x["step"] for x in lines if "test/psnr" in x] == [2, 4, 6]
    assert lines[-1] == {"step": 6, "perf/rays_per_sec": metrics["rays_per_sec"]}
