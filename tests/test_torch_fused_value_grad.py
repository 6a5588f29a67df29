"""K3/K4 (SDF trunk value + spatial gradient, and its hand VJP): the port's
plain versions against the JAX Pallas kernels in interpret mode and against
PyTorch double-backward autograd (the kernels themselves:
``test_torch_cuda.py``).

Tolerances, from the JAX package's own kernel tests: 1e-5 abs/rel on the
outputs (y, de); rtol 2e-4 / atol 2e-5 on dx, dW and db, which sum many
products in another order (and, in K4, across blocks with atomics).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robir_tpu.render.pallas import fused_mlp as jfm
from robir_tpu.render.pallas import fused_value_grad as jfv
from robir_tpu_torch.render.cuda import fused_mlp as tfm
from robir_tpu_torch.render.cuda import fused_value_grad as tfv
from torch_port_helpers import assert_close, to_t, trunk_case

# the three plans of tests/test_fused_value_grad.py
PLANS = [
    dict(dims=(8, 16, 16), out_dim=9, skip_in=(), activation="softplus100"),
    dict(dims=(8, 16, 8, 16), out_dim=5, skip_in=(2,), activation="softplus100"),
    dict(dims=(8, 16, 16), out_dim=9, skip_in=(), activation="relu"),
]
OUT_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=2e-4, atol=2e-5)


def _cotangents(plan, n_rows, seed):
    rng = np.random.default_rng(seed)
    dy = rng.standard_normal((n_rows, plan.out_dim)).astype(np.float32)
    dde = rng.standard_normal((n_rows, plan.dims[0])).astype(np.float32)
    return dy, dde


@pytest.mark.parametrize("plan_kw", PLANS)
@pytest.mark.parametrize("n_rows", [24, 13])
def test_plain_forward_and_vjp_match_jax(plan_kw, n_rows):
    """Outputs and all cotangents, rows both a multiple of block_rows and
    ragged (the JAX kernel pads, the port masks)."""
    jplan = jfm.MLPPlan(block_rows=8, **plan_kw)
    tplan = tfm.MLPPlan(**plan_kw)
    x, ws, bs = trunk_case(tplan, 0, n_rows)
    dy, dde = _cotangents(tplan, n_rows, 1)

    (jy, jde), vjp = jax.vjp(
        lambda x_, w_, b_: jfv.fused_value_grad(jplan, x_, w_, b_),
        jnp.asarray(x), tuple(map(jnp.asarray, ws)), tuple(map(jnp.asarray, bs)))
    jdx, jdws, jdbs = vjp((jnp.asarray(dy), jnp.asarray(dde)))

    tws, tbs = [to_t(w) for w in ws], [to_t(b) for b in bs]
    ty, tde, *_ = tfv._forward_phases(tplan, to_t(x), tws, tbs)
    assert_close(ty, jy, what="y", **OUT_TOL)
    assert_close(tde, jde, what="de", **OUT_TOL)

    tdx, tdws, tdbs = tfv._backward_phases(tplan, to_t(x), tws, tbs,
                                           to_t(dy), to_t(dde))
    assert_close(tdx, jdx, what="dx", **GRAD_TOL)
    for i in range(tplan.n_layers):
        assert_close(tdws[i], jdws[i], what=f"dW{i}", **GRAD_TOL)
        assert_close(tdbs[i], jdbs[i], what=f"db{i}", **GRAD_TOL)


def _ref_trunk(plan, x, ws, bs):
    h = x
    for i in range(plan.n_layers):
        if i in plan.skip_in:
            h = torch.cat([h, x], dim=-1) * tfm._SQ2
        h = h @ ws[i] + bs[i]
        if i < plan.n_layers - 1:
            h = tfm._act(plan, h)
    return h


def _loss(y, de):
    return (torch.sum(torch.sin(y) * 0.3)
            + torch.sum((torch.sqrt(torch.sum(de ** 2, -1) + 1e-8) - 1.0) ** 2))


@pytest.mark.parametrize("plan_kw", PLANS)
def test_op_matches_torch_double_backward(plan_kw):
    """The autograd.Function (plain versions on CPU) against create_graph
    autograd of the same trunk: second order through the eikonal term."""
    plan = tfm.MLPPlan(**plan_kw)
    x, ws, bs = trunk_case(plan, 3, 21)

    def leaves():
        return ([to_t(x).requires_grad_()]
                + [to_t(w).requires_grad_() for w in ws]
                + [to_t(b).requires_grad_() for b in bs])

    ref = leaves()
    n = plan.n_layers
    y = _ref_trunk(plan, ref[0], ref[1:1 + n], ref[1 + n:])
    (de,) = torch.autograd.grad(y[:, 0].sum(), ref[0], create_graph=True)
    l_ref = _loss(y, de)
    g_ref = torch.autograd.grad(l_ref, ref)

    got = leaves()
    y2, de2 = tfv.fused_value_grad(plan, got[0], got[1:1 + n], got[1 + n:])
    l_got = _loss(y2, de2)
    g_got = torch.autograd.grad(l_got, got)

    assert_close(y2, y, **OUT_TOL)
    assert_close(de2, de, **OUT_TOL)
    assert_close(l_got, l_ref, rtol=1e-5, atol=0)
    for a, b in zip(g_got, g_ref):
        assert_close(a, b, **GRAD_TOL)
