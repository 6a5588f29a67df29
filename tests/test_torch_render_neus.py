"""The port's NeuS renderer against the JAX package on bridged weights.

Tolerances: sampling arithmetic (sample_pdf, up_sample, merge_sorted) is
elementwise fp32 and agrees to 1e-5; renders go through the trunk and
compositing, and a 1e-6 change of an SDF value moves importance samples
continuously, so rendered values are held to 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robir_tpu.fields import neus_model as jnm
from robir_tpu.fields.radiance import RenderingConfig as JRenderingConfig
from robir_tpu.fields.sdf import SDFConfig as JSDFConfig
from robir_tpu.render import neus as jneus
from robir_tpu_torch.fields import neus_model as tnm
from robir_tpu_torch.fields.radiance import RenderingConfig
from robir_tpu_torch.fields.sdf import SDFConfig
from robir_tpu_torch.render import neus as tneus
from torch_port_helpers import assert_close, to_t

SDF_KW = dict(d_out=17, d_hidden=32, n_layers=3, skip_in=(2,), multires=2)
COLOR_KW = dict(d_feature=16, d_hidden=32, n_layers=2)
RENDER_KW = dict(n_samples=16, n_importance=16, up_sample_steps=2)
RENDER_TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def models():
    jcfg = jnm.NeuSConfig(sdf=JSDFConfig(**SDF_KW), color=JRenderingConfig(**COLOR_KW))
    tcfg = tnm.NeuSConfig(sdf=SDFConfig(**SDF_KW), color=RenderingConfig(**COLOR_KW))
    params = jnm.init_neus(jax.random.PRNGKey(0), jcfg)
    params_np = jax.tree_util.tree_map(np.asarray, params)
    return jnm.NeuS(params, jcfg), tnm.NeuS(params_np, tcfg, "cpu")


def _rays(n=12, seed=0):
    """Rays from a sphere of radius 3 towards points near the origin."""
    rng = np.random.default_rng(seed)
    o = rng.standard_normal((n, 3))
    o = 3.0 * o / np.linalg.norm(o, axis=-1, keepdims=True)
    d = 0.3 * rng.standard_normal((n, 3)) - o
    d = d / np.linalg.norm(d, axis=-1, keepdims=True)
    ones = np.ones((n, 1))
    arrs = [o, d, d, 0.01 * ones, ones, 2.0 * ones, 6.0 * ones]
    arrs = [a.astype(np.float32) for a in arrs]
    return (jneus.Rays(*map(jnp.asarray, arrs)), tneus.Rays(*map(to_t, arrs)))


def _sorted_rows(rng, shape, lo=2.0, hi=6.0):
    return np.sort(rng.uniform(lo, hi, shape), axis=-1).astype(np.float32)


@pytest.mark.parametrize("det", [True, False])
def test_sample_pdf_matches_jax(det):
    rng = np.random.default_rng(1)
    bins = _sorted_rows(rng, (9, 17))
    weights = rng.uniform(0, 1, (9, 16)).astype(np.float32)
    weights[:, 3] = 0.0
    key = jax.random.PRNGKey(7)
    want = jneus.sample_pdf(None if det else key, jnp.asarray(bins),
                            jnp.asarray(weights), 8, det=det)
    u = None if det else to_t(jax.random.uniform(key, (9, 8)))
    got = tneus.sample_pdf(to_t(bins), to_t(weights), 8, det=det, u=u)
    assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_up_sample_matches_jax():
    rng = np.random.default_rng(2)
    (jr, tr) = _rays(9, 2)
    z = _sorted_rows(rng, (9, 16))
    sdf = rng.uniform(-0.5, 0.5, (9, 16)).astype(np.float32)
    want = jneus.up_sample(jr.origins, jr.directions, jnp.asarray(z),
                           jnp.asarray(sdf), 8, 64.0, 2.0)
    got = tneus.up_sample(tr.origins, tr.directions, to_t(z), to_t(sdf), 8,
                          64.0, 2.0)
    assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_merge_sorted_matches_jax_with_ties():
    """Ties keep ``a`` first, values ride along exactly."""
    rng = np.random.default_rng(3)
    a = np.sort(rng.integers(0, 6, (5, 7)), -1).astype(np.float32)
    b = np.sort(rng.integers(0, 6, (5, 4)), -1).astype(np.float32)
    va = rng.standard_normal((5, 7)).astype(np.float32)
    vb = rng.standard_normal((5, 4)).astype(np.float32)
    jm, jv = jneus.merge_sorted(*map(jnp.asarray, (a, b, va, vb)))
    tm, tv = tneus.merge_sorted(*map(to_t, (a, b, va, vb)))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=0, atol=0)
    ref = np.argsort(np.concatenate([a, b], -1), -1, kind="stable")
    np.testing.assert_array_equal(
        tv.numpy(), np.take_along_axis(np.concatenate([va, vb], -1), ref, -1))


def test_render_core_matches_jax(models):
    jm, tm = models
    jr, tr = _rays(10, 4)
    z = _sorted_rows(np.random.default_rng(4), (10, 32))
    want = jax.jit(lambda o, d, zz: jneus.render_core(
        o, d, zz, 2.0 / 16, jm, background_rgb=jnp.ones((1, 3)),
        cos_anneal_ratio=0.3))(jr.origins, jr.directions, jnp.asarray(z))
    got = tneus.render_core(tr.origins, tr.directions, to_t(z), 2.0 / 16, tm,
                            background_rgb=torch.ones((1, 3)), cos_anneal_ratio=0.3)
    for k in ("color", "sdf", "gradients", "weights", "cdf", "gradient_error"):
        assert_close(got[k], want[k], what=k, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("is_eval", [True, False])
def test_render_neus_matches_jax(models, is_eval):
    """Deterministic (eval) and perturbed renders. For the perturbed one the
    jitter is JAX's own draw: the same key split render_neus makes, handed
    to the port as t_rand."""
    jm, tm = models
    jr, tr = _rays(12, 5)
    key = jax.random.PRNGKey(11)
    jcfg = jneus.NeusRenderConfig(**RENDER_KW)
    tcfg = tneus.NeusRenderConfig(**RENDER_KW)
    want = jax.jit(lambda k, r: jneus.render_neus(k, r, jm, 0.2, jcfg,
                                                  is_eval=is_eval))(
        None if is_eval else key, jr)
    t_rand = None
    if not is_eval:
        _, k1 = jax.random.split(key)
        t_rand = to_t(jax.random.uniform(k1, (12, 1)) - 0.5)
    got = tneus.render_neus(tr, tm, 0.2, tcfg, is_eval=is_eval, t_rand=t_rand)
    for k in ("rgb", "acc", "dist", "weights", "means", "gradient_error", "s_val"):
        assert_close(got[k], want[k], what=k, **RENDER_TOL)


def test_render_config_refuses_unported_options():
    """``sampling_dtype`` is ported (bf16 sampling:
    test_torch_sampling_dtype.py); a type the port has no route for is
    refused."""
    assert tneus.NeusRenderConfig(sampling_dtype="bfloat16").sampling_dtype == "bfloat16"
    with pytest.raises(ValueError):
        tneus.NeusRenderConfig(sampling_dtype="float16")
