"""K1 (SDF trunk forward): the port's plain version against the JAX Pallas
kernel in interpret mode (the kernel itself: ``test_torch_cuda.py``).

Tolerance 1e-5 abs/rel on outputs: the same fp32 arithmetic, summed in
another order by the two frameworks' CPU matmuls.
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
