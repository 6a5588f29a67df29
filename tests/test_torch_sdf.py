"""The port's fields (PE, linear layers, SDF, radiance) against the JAX
package on bridged weights.

Tolerances: 1e-5 on forward values (fp32, other summation order); rtol
5e-4 on gradients, as the JAX package's fused-flag test holds its second
order parameter gradients; bf16-storage paths to bf16 rounding (2e-2).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robir_tpu.fields import encoding as jenc
from robir_tpu.fields import mlp as jmlp
from robir_tpu.fields import radiance as jrad
from robir_tpu.fields import sdf as jsdf
from robir_tpu_torch.core.params import from_jax, to_numpy
from robir_tpu_torch.fields import encoding as tenc
from robir_tpu_torch.fields import mlp as tmlp
from robir_tpu_torch.fields import radiance as trad
from robir_tpu_torch.fields import sdf as tsdf
from torch_port_helpers import assert_close, to_t

SMALL = dict(d_out=17, d_hidden=32, n_layers=3, skip_in=(2,), multires=2,
             scale=1.5, fused_block_rows=8)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def sdf_case():
    jcfg = jsdf.SDFConfig(**SMALL)
    tcfg = tsdf.SDFConfig(**SMALL)
    params = jsdf.init_sdf(jax.random.PRNGKey(0), jcfg)
    x = (0.7 * np.random.default_rng(1).standard_normal((21, 3))).astype(np.float32)
    return jcfg, tcfg, params, from_jax(_np_tree(params)), x


def test_bridge_roundtrip(sdf_case):
    _, _, params, tparams, _ = sdf_case
    back = to_numpy(tparams)
    flat_a = jax.tree_util.tree_leaves_with_path(_np_tree(params))
    flat_b = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (_, a), (_, b) in zip(flat_a, flat_b):
        np.testing.assert_array_equal(a, b)


def test_positional_encoding_and_vjp_match_jax():
    cfg_j, cfg_t = jenc.PEConfig(num_freqs=4), tenc.PEConfig(num_freqs=4)
    x = np.random.default_rng(2).standard_normal((11, 3)).astype(np.float32)
    g = np.random.default_rng(3).standard_normal((11, cfg_t.out_dim)).astype(np.float32)
    e, vjp = jax.vjp(lambda a: jenc.positional_encoding(a, cfg_j), jnp.asarray(x))
    assert_close(tenc.positional_encoding(to_t(x), cfg_t), e, rtol=1e-6, atol=1e-6)
    assert_close(tenc.positional_encoding_vjp(to_t(x), to_t(g), cfg_t),
                 vjp(jnp.asarray(g))[0], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("out_cols", [None, 1])
def test_sdf_apply_matches_jax(sdf_case, fused, out_cols):
    jcfg, tcfg, params, tparams, x = sdf_case
    jcfg = dataclasses.replace(jcfg, fused_kernel=fused)
    want = jsdf.sdf_apply(params, jcfg, jnp.asarray(x), out_cols=out_cols)
    got = tsdf.sdf_apply(tparams, tcfg, to_t(x), out_cols=out_cols)
    assert got.shape == want.shape
    assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("out_cols", [None, 1])
def test_frozen_sdf_matches_jax(sdf_case, out_cols):
    """The tracer's query (weights folded once, no graph) against JAX
    ``sdf_apply``, over two queries of the same fold."""
    jcfg, tcfg, params, tparams, x = sdf_case
    query = tsdf.frozen_sdf(tparams, tcfg, out_cols=out_cols)
    for xx in (x, x[:5] * 0.5):
        want = jsdf.sdf_apply(params, jcfg, jnp.asarray(xx), out_cols=out_cols)
        got = query(to_t(xx))
        assert got.shape == want.shape and not got.requires_grad
        assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("fused", [False, True])
def test_sdf_apply_gradient_matches_jax(sdf_case, fused):
    """Parameter and input gradients of a loss on ``sdf_apply`` (K1 forward,
    the plain K2 backward) against the JAX package's plain and fused
    (custom VJP) paths."""
    jcfg, tcfg, params, tparams, x = sdf_case
    jcfg = dataclasses.replace(jcfg, fused_kernel=fused)
    w = np.random.default_rng(7).standard_normal((x.shape[0], jcfg.d_out)).astype(np.float32)

    def jloss(p, xx):
        return jnp.sum(jsdf.sdf_apply(p, jcfg, xx) * w)

    jgp, jgx = jax.grad(jloss, argnums=(0, 1))(params, jnp.asarray(x))
    tx = to_t(x).requires_grad_()
    tparams.zero_grad(set_to_none=True)
    torch.sum(tsdf.sdf_apply(tparams, tcfg, tx) * to_t(w)).backward()
    assert_close(tx.grad, jgx, rtol=5e-4, atol=1e-5, what="dx")
    for name, lin in tparams.items():
        for k, p in lin.items():
            assert_close(p.grad, jgp[name][k], rtol=5e-4, atol=1e-5,
                         what=f"{name}.{k}")
    tparams.zero_grad(set_to_none=True)


@pytest.mark.parametrize("fused", [False, True])
def test_sdf_full_and_gradient_matches_jax(sdf_case, fused):
    """Value, spatial gradient, and the second-order parameter gradient of
    an eikonal-style loss (the train step's structure)."""
    jcfg, tcfg, params, tparams, x = sdf_case
    jcfg = dataclasses.replace(jcfg, fused_kernel=fused)

    def jloss(p):
        full, g = jsdf.sdf_full_and_gradient(p, jcfg, jnp.asarray(x))
        return (jnp.mean(full ** 2)
                + jnp.mean((jnp.sqrt(jnp.sum(g ** 2, -1) + 1e-12) - 1) ** 2))

    jfull, jg = jsdf.sdf_full_and_gradient(params, jcfg, jnp.asarray(x))
    jgrads = jax.grad(jloss)(params)

    full, g = tsdf.sdf_full_and_gradient(tparams, tcfg, to_t(x))
    assert_close(full, jfull, rtol=2e-5, atol=1e-5)
    assert_close(g, jg, rtol=2e-5, atol=1e-5)
    loss = (torch.mean(full ** 2)
            + torch.mean((torch.sqrt(torch.sum(g ** 2, -1) + 1e-12) - 1) ** 2))
    tparams.zero_grad(set_to_none=True)
    loss.backward()
    for name, lin in tparams.items():
        for k, p in lin.items():
            assert_close(p.grad, jgrads[name][k], rtol=5e-4, atol=5e-6,
                         what=f"{name}.{k}")


def test_init_sdf_statistics():
    """Same tree and shapes as the JAX init, and the geometric init's
    structure (the generators differ, so numbers are compared as
    statistics)."""
    cfg = tsdf.SDFConfig()
    tp = tsdf.init_sdf(torch.Generator().manual_seed(0), cfg)
    jp = jsdf.init_sdf(jax.random.PRNGKey(0), jsdf.SDFConfig())
    assert sorted(tp) == sorted(jp)
    for name in jp:
        assert sorted(tp[name]) == sorted(jp[name])
        for k in jp[name]:
            assert tuple(tp[name][k].shape) == tuple(jp[name][k].shape)
    # layer 0: only the raw xyz rows are non-zero
    assert float(tp["lin0"]["v"][3:].abs().max()) == 0.0
    assert abs(float(tp["lin0"]["v"][:3].std()) - np.sqrt(2 / 256)) < 0.01
    # skip layer: the PE part of the skip input is zeroed
    assert float(tp["lin4"]["v"][-60:].abs().max()) == 0.0
    # last layer: mean sqrt(pi)/sqrt(256), std 1e-4, bias -0.5
    v8 = tp["lin8"]["v"]
    assert abs(float(v8.mean()) - np.sqrt(np.pi) / 16) < 1e-5
    assert abs(float(v8.std()) - 1e-4) < 1e-5
    assert float(tp["lin8"]["b"].max()) == float(tp["lin8"]["b"].min()) == -0.5
    # weight norm: g equals the column norms at init
    assert_close(tp["lin2"]["g"], torch.linalg.norm(tp["lin2"]["v"], dim=0),
                 rtol=1e-6, atol=0)


@pytest.mark.parametrize("storage", [None, "bfloat16"])
def test_rendering_apply_matches_jax(storage):
    kw = dict(d_feature=16, d_hidden=32, n_layers=2, storage_dtype=storage)
    jcfg, tcfg = jrad.RenderingConfig(**kw), trad.RenderingConfig(**kw)
    params = jrad.init_rendering(jax.random.PRNGKey(3), jcfg)
    tparams = from_jax(_np_tree(params))
    rng = np.random.default_rng(4)
    pts, nrm, dirs = (rng.standard_normal((19, 3)).astype(np.float32) for _ in range(3))
    feat = rng.standard_normal((19, 16)).astype(np.float32)
    want = jrad.rendering_apply(params, jcfg, *map(jnp.asarray, (pts, nrm, dirs, feat)))
    got = trad.rendering_apply(tparams, tcfg, *map(to_t, (pts, nrm, dirs, feat)))
    assert got.dtype == torch.float32
    tol = 1e-5 if storage is None else 2e-2
    assert_close(got, want, rtol=tol, atol=tol)


def test_softplus_beta_matches_jax():
    x = (np.random.default_rng(7).standard_normal((5, 40)) * 0.05).astype(np.float32)
    x[0, :3] = (-30.0, 0.0, 30.0)  # saturated both ways, and the kink
    assert_close(tmlp.softplus_beta(to_t(x)), jmlp.softplus_beta(jnp.asarray(x)),
                 rtol=1e-6, atol=1e-8)


def test_apply_linear_bf16_storage_matches_jax():
    params = jmlp.init_linear(jax.random.PRNGKey(5), 24, 12, weight_norm=True)
    x = np.random.default_rng(6).standard_normal((7, 24)).astype(np.float32)
    want = jmlp.apply_linear(params, jnp.asarray(x), storage_dtype=jnp.bfloat16)
    got = tmlp.apply_linear(from_jax(_np_tree(params)), to_t(x),
                            storage_dtype="bfloat16")
    assert got.dtype == torch.bfloat16
    assert_close(got.float(), np.asarray(want, np.float32), rtol=2e-2, atol=2e-2)
    assert_close(tmlp.apply_linear(from_jax(_np_tree(params)), to_t(x)),
                 jmlp.apply_linear(params, jnp.asarray(x)), rtol=1e-5, atol=1e-5)
