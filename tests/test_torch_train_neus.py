"""The port's stage-1 slice as a whole against the JAX package: a 3-step
train trajectory on fixed rays, the schedule, the config loader, the
in-memory sphere scene, and the trainer loop on the CPU.

Trajectory tolerance: the loss before each step to 1e-4 relative; the
parameters after each step to 2 * lr per step taken (atol 3e-3 after three
steps at lr 5e-4), with 99% of entries within 1e-5. Adam's first updates
are sign-like (m / sqrt(v) ~ sign(g)), so an entry whose gradient is
near zero can move by up to 2 * lr on fp32 noise of its gradient, while
the bulk of the parameters agree closely.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robir_tpu.core import config as jconfig
from robir_tpu.core.schedule import log_lerp_lr as jlog_lerp_lr
from robir_tpu.data import blender as jblender
from robir_tpu.data.synthetic import make_sphere_dataset
from robir_tpu.fields import neus_model as jnm
from robir_tpu.fields.radiance import RenderingConfig as JRenderingConfig
from robir_tpu.fields.sdf import SDFConfig as JSDFConfig
from robir_tpu.render import neus as jneus
from robir_tpu.stages import neus_stage as jstage
from robir_tpu_torch import resolve_device
from robir_tpu_torch.core import config as tconfig
from robir_tpu_torch.core.draws import Draws
from robir_tpu_torch.core.params import to_numpy
from robir_tpu_torch.core.schedule import log_lerp_lr
from robir_tpu_torch.data.blender import RayBatch
from robir_tpu_torch.data.synthetic import make_sphere_scene
from robir_tpu_torch.fields import neus_model as tnm
from robir_tpu_torch.fields.radiance import RenderingConfig
from robir_tpu_torch.fields.sdf import SDFConfig
from robir_tpu_torch.render import neus as tneus
from robir_tpu_torch.stages import neus_stage as tstage
from torch_port_helpers import to_t

SDF_KW = dict(d_out=17, d_hidden=32, n_layers=3, skip_in=(2,), multires=2)
COLOR_KW = dict(d_feature=16, d_hidden=32, n_layers=2)
RENDER_KW = dict(n_samples=16, n_importance=16, up_sample_steps=2)
TRAIN_KW = dict(batch_size=64, lr_init=5e-4, lr_delay_steps=0, max_steps=400,
                anneal_end=50, eval_chunk=128)


@pytest.fixture(scope="module")
def scene():
    return make_sphere_scene("train", n_train=4, h=16, w=16)


def test_three_step_trajectory_matches_jax(scene):
    jmodel = jnm.NeuSConfig(sdf=JSDFConfig(**SDF_KW), color=JRenderingConfig(**COLOR_KW))
    tmodel = tnm.NeuSConfig(sdf=SDFConfig(**SDF_KW), color=RenderingConfig(**COLOR_KW))
    jtrain, ttrain = jstage.NeusTrainConfig(**TRAIN_KW), tstage.NeusTrainConfig(**TRAIN_KW)
    jrender = jneus.NeusRenderConfig(**RENDER_KW)
    trender = tneus.NeusRenderConfig(**RENDER_KW)

    params = jnm.init_neus(jax.random.PRNGKey(0), jmodel)
    opt = jstage.make_optimizer(jtrain)
    opt_state = opt.init(params)
    step_fn = jstage.make_train_step(jmodel, jrender, jtrain, opt)

    model = tnm.NeuS(jax.tree_util.tree_map(np.asarray, params), tmodel, "cpu")
    topt, lr_fn = tstage.make_optimizer(model.parameters(), ttrain)

    rng = np.random.default_rng(0)
    key = jax.random.PRNGKey(5)
    for step in range(3):
        batch = scene.sample(rng, 64)
        key, sk = jax.random.split(key)
        params, opt_state, jm = step_fn(
            params, opt_state, jblender.RayBatch(*map(jnp.asarray, batch)),
            jnp.asarray(step, jnp.int32), sk)
        # the jitter render_neus draws from the step key, handed to the port
        _, k1 = jax.random.split(sk)
        draws = Draws(given={"t_rand": to_t(jax.random.uniform(k1, (64, 1)))})
        tm = tstage.train_step(model, topt, lr_fn, RayBatch(*map(to_t, batch)),
                               step, ttrain, trender, draws)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=1e-4, err_msg=f"loss, step {step}")
        got = jax.tree_util.tree_leaves(to_numpy(model.params))
        want = jax.tree_util.tree_leaves(jax.tree_util.tree_map(np.asarray, params))
        diffs = np.concatenate([np.abs(a - b).ravel() for a, b in zip(got, want)])
        assert diffs.max() <= 2 * 5e-4 * (step + 1), (step, diffs.max())
        assert np.mean(diffs <= 1e-5) >= 0.99, (step, np.mean(diffs <= 1e-5))


def test_log_lerp_lr_matches_jax():
    args = (5e-4, 5e-6, 200_000, 2500, 0.01)
    fj, ft = jlog_lerp_lr(*args), log_lerp_lr(*args)
    for s in (0, 1, 100, 2499, 2500, 50_000, 200_000, 300_000):
        np.testing.assert_allclose(ft(s), float(fj(s)), rtol=1e-6)


def test_config_matches_jax_loader():
    path = "configs/neus_blender.json"
    jcfg_d = jconfig.load_config(path)
    cfg_d = tconfig.load_config(path)
    assert cfg_d == jcfg_d
    model, render, train, dataset = tconfig.build_stage1_configs(cfg_d)
    _, _, jmodel, jrender = jconfig.build_stage1_configs(jcfg_d)
    assert dataclasses.asdict(model.sdf) == dataclasses.asdict(jmodel.sdf)
    assert dataclasses.asdict(model.color) == dataclasses.asdict(jmodel.color)
    assert dataclasses.asdict(render) == dataclasses.asdict(jrender)
    assert dataclasses.asdict(train) == dataclasses.asdict(
        jconfig._build(jstage.NeusTrainConfig, cfg_d["train"]))
    assert dataclasses.asdict(dataset) == dataclasses.asdict(
        jconfig._build(jblender.BlenderConfig, cfg_d["dataset"]))
    with pytest.raises(KeyError):
        tconfig.build_stage1_configs({"train": {"no_such_key": 1}})


def test_sphere_scene_matches_jax_dataset(tmp_path):
    """The in-memory scene equals the JAX package's PNG dataset as loaded
    by its BlenderScene."""
    make_sphere_dataset(str(tmp_path), n_train=3, n_test=1, h=16, w=16)
    jscene = jblender.BlenderScene(
        jblender.BlenderConfig(dataset_dir=str(tmp_path)), "train")
    tscene = make_sphere_scene("train", n_train=3, n_test=1, h=16, w=16)
    np.testing.assert_allclose(tscene.images, jscene.images, atol=1e-6)
    np.testing.assert_allclose(tscene.masks, jscene.masks, atol=1e-6)
    for a, b in zip(tscene.flat, jscene.flat):
        np.testing.assert_allclose(a, b, atol=1e-6)


def test_trainer_runs_on_cpu(scene):
    tmodel = tnm.NeuSConfig(sdf=SDFConfig(**SDF_KW), color=RenderingConfig(**COLOR_KW))
    tr = tstage.NeusTrainer(scene, tmodel, tneus.NeusRenderConfig(**RENDER_KW),
                            tstage.NeusTrainConfig(**TRAIN_KW), device="cpu")
    try:
        m = tr.run(2)
        assert tr.step == 2 and np.isfinite(m["loss"])
        out = tr.render_image(1)
    finally:
        tr.close()
    assert out["rgb"].shape == (16, 16, 3)
    assert np.isfinite(out["psnr"])


def test_absent_cuda_raises():
    if torch.cuda.is_available():
        assert resolve_device("cuda").type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda")
    assert resolve_device("cpu").type == "cpu"
    # the model's default device is cuda too: asked for on the CPU, it raises
    cfg = tnm.NeuSConfig(sdf=SDFConfig(**SDF_KW), color=RenderingConfig(**COLOR_KW))
    params = tnm.init_neus(torch.Generator().manual_seed(0), cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        tnm.NeuS(params, cfg)
    assert tnm.NeuS(params, cfg, "cpu").params["deviation_network"]["variance"].is_cpu
