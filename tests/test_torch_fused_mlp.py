"""K1 (trunk forward) and K2 (its recompute backward): the port's plain
versions against the JAX Pallas kernels in interpret mode (the kernels
themselves: ``test_torch_cuda.py``).

Tolerance 1e-5 abs/rel on outputs: the same fp32 arithmetic, summed in
another order by the two frameworks' CPU matmuls. Gradients (dx, dW, db)
to 5e-4 relative, as the JAX package holds its own VJPs.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robir_tpu.fields.neus_model import NeuSConfig as JNeuSConfig
from robir_tpu.fields.neus_model import init_neus as jinit_neus
from robir_tpu.render.pallas import fused_mlp as jfm
from robir_tpu_torch.core.params import from_jax
from robir_tpu_torch.fields.neus_model import NeuSConfig
from robir_tpu_torch.render.cuda import fused_mlp as tfm
from robir_tpu_torch.render.cuda import fused_value_grad as tfv
from robir_tpu_torch.fields import sdf as tsdf
from torch_port_helpers import assert_close, to_t, trunk_case

SMALL_PLANS = [
    dict(dims=(8, 16, 16), out_dim=9, skip_in=(), activation="softplus100"),
    dict(dims=(8, 16, 8, 16), out_dim=5, skip_in=(2,), activation="softplus100"),
    dict(dims=(8, 16, 16), out_dim=9, skip_in=(), activation="relu"),
]


@pytest.fixture(scope="module")
def full_width():
    """The full-width trunk with the JAX package's init, bridged."""
    cfg = JNeuSConfig()
    params = jinit_neus(jax.random.PRNGKey(0), cfg)["sdf_network"]
    params_np = jax.tree_util.tree_map(np.asarray, params)
    return cfg, params, from_jax(params_np)


def test_plan_matches_jax():
    jplan = jfm.plan_from_sdf_config(JNeuSConfig().sdf)
    tplan = tfm.plan_from_sdf_config(NeuSConfig().sdf)
    got = dataclasses.asdict(tplan)
    assert got == {k: v for k, v in dataclasses.asdict(jplan).items() if k in got}
    assert tplan.dims == (63, 256, 256, 256, 193, 256, 256, 256, 256)
    assert tplan.n_weights() == 524_544
    meta = tplan.meta()
    assert meta[:2] == [9, 63]
    # layer 4: input 193 + 63 = 256 through the skip, trunk part 193
    assert meta[2 + 4 * 4:2 + 4 * 5] == [256, 256, 193, 1]
    assert meta[-4:] == [256, 257, 256, 0]


def test_fold_weight_norm_matches_jax(full_width):
    _, params, tparams = full_width
    jws, jbs = jfm.fold_weight_norm(params, 9)
    tws, tbs = tfm.fold_weight_norm(tparams, 9)
    for a, b in zip(tws + tbs, jws + jbs):
        assert_close(a, b, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("n_rows", [300, 77])
def test_full_width_forward_matches_jax(full_width, n_rows):
    """Full-width trunk, rows both a multiple of the block and ragged."""
    _, params, tparams = full_width
    jplan = jfm.plan_from_sdf_config(JNeuSConfig().sdf, block_rows=128)
    tplan = tfm.plan_from_sdf_config(NeuSConfig().sdf)
    x = (0.5 * np.random.default_rng(n_rows).standard_normal((n_rows, 63))
         ).astype(np.float32)
    jws, jbs = jfm.fold_weight_norm(params, 9)
    want = jfm.fused_mlp(jplan, jnp.asarray(x), jws, jbs)
    tws, tbs = tfm.fold_weight_norm(tparams, 9)
    got = tfm.fused_mlp(tplan, to_t(x), tws, tbs)
    assert got.shape == (n_rows, 257)
    assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("plan_kw", SMALL_PLANS)
@pytest.mark.parametrize("n_rows", [24, 13])
def test_small_plans_match_jax(plan_kw, n_rows):
    jplan = jfm.MLPPlan(block_rows=8, **plan_kw)
    tplan = tfm.MLPPlan(**plan_kw)
    x, ws, bs = trunk_case(tplan, 0, n_rows)
    want = jfm.fused_mlp(jplan, jnp.asarray(x), tuple(map(jnp.asarray, ws)),
                         tuple(map(jnp.asarray, bs)))
    got = tfm.fused_mlp(tplan, to_t(x), [to_t(w) for w in ws],
                        [to_t(b) for b in bs])
    assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_cuda_input_checks():
    """What the CUDA wrapper refuses, checked before any launch."""
    plan = tfm.MLPPlan(**SMALL_PLANS[1])
    x, ws, bs = trunk_case(plan, 0, 4)
    ws_t, bs_t = [to_t(w) for w in ws], [to_t(b) for b in bs]
    tfm.check_cuda_inputs(plan, to_t(x), ws_t, bs_t)
    with pytest.raises(ValueError):
        tfm.check_cuda_inputs(plan, to_t(x[:, :5]), ws_t, bs_t)
    with pytest.raises(ValueError):
        tfm.check_cuda_inputs(plan, to_t(x), ws_t[:-1], bs_t)
    with pytest.raises(ValueError):
        tfm.check_cuda_inputs(plan, to_t(x).double(), ws_t, bs_t)
    relu = dataclasses.replace(plan, activation="relu")
    with pytest.raises(ValueError, match="softplus100"):
        tfm.check_cuda_inputs(relu, to_t(x), ws_t, bs_t)
    wide = tfm.MLPPlan(dims=(8, 300), out_dim=3)
    x, ws, bs = trunk_case(wide, 0, 4)
    with pytest.raises(ValueError):
        tfm.check_cuda_inputs(wide, to_t(x), [to_t(w) for w in ws],
                              [to_t(b) for b in bs])


def test_ops_refuse_other_devices():
    """The ops run on cuda (kernels) or cpu (plain versions), nowhere else."""
    plan = tfm.MLPPlan(**SMALL_PLANS[1])
    x, ws, bs = trunk_case(plan, 0, 4)
    meta = [torch.empty(a.shape, device="meta") for a in (x, *ws, *bs)]
    n = plan.n_layers
    with pytest.raises(ValueError, match="cuda or cpu"):
        tfm.fused_mlp(plan, meta[0], meta[1:1 + n], meta[1 + n:])
    with pytest.raises(ValueError, match="cuda or cpu"):
        tfv.fused_value_grad(plan, meta[0], meta[1:1 + n], meta[1 + n:])


@pytest.mark.parametrize("plan_kw", SMALL_PLANS[1:])
@pytest.mark.parametrize("n_rows", [24, 13])
def test_backward_matches_jax_custom_vjp(plan_kw, n_rows):
    """The plain K2 (through the port's autograd Function) against the JAX
    ``fused_mlp`` custom VJP (``_bwd_kernel`` in interpret mode): dx, every
    dW and db, on a plan with a skip layer and at a ragged row count."""
    jplan = jfm.MLPPlan(block_rows=8, **plan_kw)
    tplan = tfm.MLPPlan(**plan_kw)
    x, ws, bs = trunk_case(tplan, 3, n_rows)
    dy = np.random.default_rng(4).standard_normal((n_rows, tplan.out_dim)).astype(np.float32)
    _, vjp = jax.vjp(lambda a, w, b: jfm.fused_mlp(jplan, a, w, b), jnp.asarray(x),
                     tuple(map(jnp.asarray, ws)), tuple(map(jnp.asarray, bs)))
    jdx, jdws, jdbs = vjp(jnp.asarray(dy))
    tx = to_t(x).requires_grad_()
    tws = [to_t(w).requires_grad_() for w in ws]
    tbs = [to_t(b).requires_grad_() for b in bs]
    y = tfm.fused_mlp(tplan, tx, tws, tbs)
    grads = torch.autograd.grad(y, [tx, *tws, *tbs], to_t(dy))
    for got, want in zip(grads, [jdx, *jdws, *jdbs]):
        assert_close(got, want, rtol=5e-4, atol=1e-5)


def test_backward_rows_without_dx_matches_with():
    """K2's plain version skips dx (and layer 0's transposed product) when x
    needs no gradient; dW and db do not change."""
    plan = tfm.MLPPlan(**SMALL_PLANS[1])
    x, ws, bs = trunk_case(plan, 5, 11)
    dy = to_t(np.random.default_rng(6).standard_normal((11, plan.out_dim)))
    args = (plan, to_t(x), [to_t(w) for w in ws], [to_t(b) for b in bs], dy)
    dx, dws, dbs = tfm._backward_rows(*args)
    none, dws2, dbs2 = tfm._backward_rows(*args, need_dx=False)
    assert dx.shape == (11, 8) and none is None
    for a, b in zip(dws + dbs, dws2 + dbs2):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    ws_t = [to_t(w).requires_grad_() for w in ws]
    y = tfm.fused_mlp(plan, to_t(x), ws_t, [to_t(b) for b in bs])
    for got, want in zip(torch.autograd.grad(y, ws_t, dy), dws):
        assert_close(got, want, rtol=1e-6, atol=1e-6)


def test_normal_net_plan():
    """The CESR normal net (8x512, skip at 4, PE input 63, 3 outputs): the
    plan K1 and K2 take at width 520."""
    cfg = tsdf.SDFConfig(d_in=63, d_out=3, d_hidden=512, n_layers=8,
                         skip_in=(4,), multires=0)
    plan = tfm.plan_from_sdf_config(cfg)
    assert plan.dims == (63, 512, 512, 512, 449, 512, 512, 512, 512)
    assert plan.layer_in_dim(4) == 512 and plan.out_dim == 3
    assert plan.n_weights() == 1_836_544
    x, ws, bs = trunk_case(plan, 0, 2)
    args = (to_t(x), [to_t(w) for w in ws], [to_t(b) for b in bs])
    tfm.check_cuda_inputs(plan, *args, max_width=tfm.MAX_WIDTH_WIDE)
    with pytest.raises(ValueError, match="wider than 264"):
        tfm.check_cuda_inputs(plan, *args)
