"""The rest of the port's stage 1 against the JAX package:
``sampling_dtype="bfloat16"``, ``cosine_easing_window``, ``throughput``,
and the SDF trunk's storage difference.

- The sampling phase's SDF query on bf16 operands with fp32 sums
  (``NeuS.sdf(x, torch.bfloat16)``) against JAX's ``compute_dtype`` path
  (``sdf.storage_dtype=None``), at small widths: within 2^-8 (bf16's unit
  roundoff) of the largest |sdf|. Measured: 2.1e-3 of 1.76 at these
  weights, where bf16 itself is 1.1e-2 from fp32: each package rounds its
  own fp32 activations to bf16, and a last-bit difference there can flip a
  rounding, which the next layers carry.
- One whole train step with bf16 sampling against JAX's
  ``make_train_step``: the loss and metrics to 1e-5 relative, the
  gradients to rtol 5e-4 with an atol of 5e-4 of each tensor's largest
  entry (the tolerances of the fp32 step).
- ``cosine_easing_window`` and the windowed encoding against JAX's, to
  1e-6.
- ``throughput`` on the CPU: positive, and the trainer after it as before.
- The storage difference at ``configs/neus_blender.json``: JAX's default
  trunk (layer by layer, activations stored in bf16) against the port's
  fp32 trunk on 4,096 points in the scene's box: measured 1.43e-2 on the
  sdf column of a largest |sdf| of 1.79 (ROADMAP C; `pytest -s` prints
  the readings), asserted below
  2^-5 of it; JAX's trunk without the storage is the port's to 1e-5.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robir_tpu.core import config as jconfig
from robir_tpu.data import blender as jblender
from robir_tpu.fields import encoding as jenc
from robir_tpu.fields import neus_model as jnm
from robir_tpu.fields import sdf as jsdf
from robir_tpu.fields.radiance import RenderingConfig as JRenderingConfig
from robir_tpu.fields.sdf import SDFConfig as JSDFConfig
from robir_tpu.render import neus as jneus
from robir_tpu.stages import neus_stage as jstage
from robir_tpu_torch.core import config as tconfig
from robir_tpu_torch.core.draws import Draws
from robir_tpu_torch.core.params import to_numpy
from robir_tpu_torch.data.blender import RayBatch
from robir_tpu_torch.data.synthetic import make_sphere_scene
from robir_tpu_torch.fields import encoding as tenc
from robir_tpu_torch.fields import neus_model as tnm
from robir_tpu_torch.fields import sdf as tsdf
from robir_tpu_torch.fields.radiance import RenderingConfig
from robir_tpu_torch.fields.sdf import SDFConfig
from robir_tpu_torch.render import neus as tneus
from robir_tpu_torch.stages import neus_stage as tstage
from torch_port_helpers import assert_close, assert_grads_match, grab_grads, to_t

SDF_KW = dict(d_out=17, d_hidden=32, n_layers=3, skip_in=(2,), multires=2)
COLOR_KW = dict(d_feature=16, d_hidden=32, n_layers=2)
RENDER_KW = dict(n_samples=16, n_importance=16, up_sample_steps=2)
TRAIN_KW = dict(batch_size=64, lr_delay_steps=0, max_steps=400, anneal_end=50, eval_chunk=64)
BF16_EPS = 2.0 ** -8


def _cfgs():
    return (jnm.NeuSConfig(sdf=JSDFConfig(**SDF_KW), color=JRenderingConfig(**COLOR_KW)),
            tnm.NeuSConfig(sdf=SDFConfig(**SDF_KW), color=RenderingConfig(**COLOR_KW)))


def _params(jcfg):
    return jax.tree_util.tree_map(np.asarray, jnm.init_neus(jax.random.PRNGKey(0), jcfg))


def _points(n: int, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).uniform(-1.2, 1.2, (n, 3)).astype(np.float32)


def test_bf16_sdf_query_matches_jax():
    jcfg, tcfg = _cfgs()
    params = _params(jcfg)
    x = _points(4096)
    want = np.asarray(jax.jit(lambda p, x: jnm.NeuS(p, jcfg).sdf(x, jnp.bfloat16))(params, x))
    model = tnm.NeuS(params, tcfg, "cpu")
    with torch.no_grad():
        got = model.sdf(torch.as_tensor(x), torch.bfloat16).numpy()
        fp32 = model.sdf(torch.as_tensor(x)).numpy()
    assert got.shape == want.shape == (4096, 1) and got.dtype == np.float32
    scale = float(np.abs(fp32).max())
    print(f"bf16 query: port vs JAX {np.abs(got - want).max():.3e}, vs fp32 "
          f"{np.abs(got - fp32).max():.3e}, largest |sdf| {scale:.3f}")
    np.testing.assert_allclose(got, want, rtol=0, atol=BF16_EPS * scale)
    # it is the low-precision path: off the fp32 trunk by bf16's rounding
    assert 0 < np.abs(got - fp32).max() < 8 * BF16_EPS * scale


def test_bf16_sampling_runs_no_fused_kernel(monkeypatch):
    """``compute_dtype`` takes the layer-by-layer path, not K1's op."""
    _, tcfg = _cfgs()
    model = tnm.NeuS(tnm.init_neus(torch.Generator().manual_seed(0), tcfg), tcfg, "cpu")

    def refuse(*a, **k):
        raise AssertionError("fused_mlp called on the bf16 path")

    monkeypatch.setattr(tsdf, "fused_mlp", refuse)
    with torch.no_grad():
        out = model.sdf(torch.as_tensor(_points(64)), torch.bfloat16)
    assert out.shape == (64, 1) and torch.isfinite(out).all()


def test_bf16_sampling_step_matches_jax():
    jcfg, tcfg = _cfgs()
    params = _params(jcfg)
    batch = make_sphere_scene("train", n_train=4, h=16, w=16).sample(
        np.random.default_rng(0), 64)
    key = jax.random.PRNGKey(5)
    jrender = jneus.NeusRenderConfig(sampling_dtype="bfloat16", **RENDER_KW)
    step = jstage.make_train_step(jcfg, jrender, jstage.NeusTrainConfig(**TRAIN_KW),
                                  grab_grads())
    _, jgrads, jmetrics = step(jax.tree_util.tree_map(jnp.asarray, params), None,
                               jblender.RayBatch(*map(jnp.asarray, batch)),
                               jnp.asarray(3, jnp.int32), key)
    model = tnm.NeuS(params, tcfg, "cpu")
    render = tstage.neus_render_binding(
        tneus.NeusRenderConfig(sampling_dtype="bfloat16", **RENDER_KW))
    rays, pixels = tstage.batch_to_rays(RayBatch(*map(to_t, batch)))
    draws = Draws(given={"t_rand": to_t(jax.random.uniform(jax.random.split(key)[1], (64, 1)))})
    out = render(draws, rays, model, tstage.cos_anneal_ratio(3, TRAIN_KW["anneal_end"]))
    loss, metrics = tstage.neus_loss(out, rays.lossmult, pixels,
                                     tstage.NeusTrainConfig(**TRAIN_KW))
    for k in jmetrics:
        assert_close(metrics[k].detach(), jmetrics[k], rtol=1e-5, atol=1e-7, what=k)
    loss.backward()
    assert_grads_match(model.params, jgrads)


def test_unknown_sampling_dtype_refused():
    assert tneus.NeusRenderConfig(sampling_dtype="bfloat16").sampling_dtype == "bfloat16"
    with pytest.raises(ValueError, match="sampling_dtype"):
        tneus.NeusRenderConfig(sampling_dtype="float16")


@pytest.mark.parametrize("alpha", [0.0, 0.3, 1.0, 2.5, 5.99, 6.0, 9.0])
def test_cosine_easing_window_matches_jax(alpha):
    got = tenc.cosine_easing_window(6, alpha).numpy()
    want = np.asarray(jenc.cosine_easing_window(6, alpha))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    x = _points(32, seed=1)
    cfg = tenc.PEConfig(num_freqs=6)
    got = tenc.positional_encoding(torch.as_tensor(x), cfg, alpha=alpha).numpy()
    want = np.asarray(jenc.positional_encoding(jnp.asarray(x), jenc.PEConfig(num_freqs=6),
                                               alpha=alpha))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_throughput_leaves_the_trainer():
    """Rays/s is positive; the parameters, Adam moments, step and draws are
    as before, so the next step is the one a fresh trainer takes."""
    _, tcfg = _cfgs()
    scene = make_sphere_scene("train", n_train=4, h=16, w=16)

    def trainer():
        return tstage.NeusTrainer(scene, tcfg, tneus.NeusRenderConfig(**RENDER_KW),
                                  tstage.NeusTrainConfig(**TRAIN_KW), device="cpu")

    timed, fresh = trainer(), trainer()
    try:
        timed.run(1)
        fresh.run(1)
        before = to_numpy(timed.model.params)
        rays_per_s = timed.throughput(n_steps=2, warmup=1, reps=2)
        assert np.isfinite(rays_per_s) and rays_per_s > 0
        assert timed.step == 1
        after = to_numpy(timed.model.params)
        assert all(np.array_equal(a, b) for a, b in zip(jax.tree_util.tree_leaves(after),
                                                        jax.tree_util.tree_leaves(before)))
        assert timed.state().keys() == fresh.state().keys()
        assert all(np.array_equal(v, fresh.state()[k]) for k, v in timed.state().items())
        m1, m2 = timed.run(1), fresh.run(1)
        assert m1 == m2
    finally:
        timed.close()
        fresh.close()


def test_sdf_storage_gap_at_neus_blender():
    """JAX's default trunk at configs/neus_blender.json stores its
    activations in bf16; the port's is fp32 (ROADMAP C)."""
    _, _, jmodel, _ = jconfig.build_stage1_configs(jconfig.load_config("configs/neus_blender.json"))
    tmodel = tconfig.build_stage1_configs(tconfig.load_config("configs/neus_blender.json"))[0]
    assert jmodel.sdf.storage_dtype == "bfloat16" and not jmodel.sdf.fused_kernel
    params = jax.tree_util.tree_map(np.asarray, jnm.init_neus(jax.random.PRNGKey(0), jmodel))
    x = _points(4096)
    jfull = jax.jit(lambda p, x, c: jsdf.sdf_apply(p, c, x), static_argnums=2)
    stored = np.asarray(jfull(params["sdf_network"], x, jmodel.sdf))
    fp32 = np.asarray(jfull(params["sdf_network"], x,
                            dataclasses.replace(jmodel.sdf, storage_dtype=None)))
    with torch.no_grad():
        port = tsdf.sdf_apply(tnm.NeuS(params, tmodel, "cpu").params["sdf_network"],
                              tmodel.sdf, torch.as_tensor(x)).numpy()
    scale = float(np.abs(fp32[:, 0]).max())
    np.testing.assert_allclose(port, fp32, rtol=0, atol=1e-5 * float(np.abs(fp32).max()))
    gap = float(np.abs(port[:, 0] - stored[:, 0]).max())
    print(f"storage gap: sdf {gap:.3e} (largest |sdf| {scale:.3f}), features "
          f"{np.abs(port[:, 1:] - stored[:, 1:]).max():.3e}; without the storage "
          f"{np.abs(port - fp32).max():.3e}")
    assert 0 < gap < 2.0 ** -5 * scale, (gap, scale)
