"""K3/K4 (SDF trunk value + spatial gradient, and its hand VJP): the port's
plain versions against the JAX Pallas kernels in interpret mode and against
PyTorch double-backward autograd; the backward from the state the forward
kept, and where that state is kept (the kernels themselves:
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
from robir_tpu_torch.fields.sdf import SDFConfig
from robir_tpu_torch.render.cuda import fused_mlp as tfm
from robir_tpu_torch.render.cuda import fused_value_grad as tfv
from robir_tpu_torch.tools import profiler
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


def _jax_vjp(plan_kw, x, ws, bs, dy, dde):
    """((y, de), (dx, dWs, dbs)) of the JAX package's fused_value_grad
    (Pallas in interpret mode), its VJP at the cotangents (dy, dde)."""
    jplan = jfm.MLPPlan(block_rows=8, **plan_kw)
    out, vjp = jax.vjp(
        lambda x_, w_, b_: jfv.fused_value_grad(jplan, x_, w_, b_),
        jnp.asarray(x), tuple(map(jnp.asarray, ws)), tuple(map(jnp.asarray, bs)))
    return out, vjp((jnp.asarray(dy), jnp.asarray(dde)))


def _assert_grads_close(plan, got, want):
    (gdx, gdws, gdbs), (wdx, wdws, wdbs) = got, want
    assert_close(gdx, wdx, what="dx", **GRAD_TOL)
    for i in range(plan.n_layers):
        assert_close(gdws[i], wdws[i], what=f"dW{i}", **GRAD_TOL)
        assert_close(gdbs[i], wdbs[i], what=f"db{i}", **GRAD_TOL)


@pytest.mark.parametrize("plan_kw", PLANS)
@pytest.mark.parametrize("n_rows", [24, 13])
def test_plain_forward_and_vjp_match_jax(plan_kw, n_rows):
    """Outputs and all cotangents, rows both a multiple of block_rows and
    ragged (the JAX kernel pads, the port masks)."""
    tplan = tfm.MLPPlan(**plan_kw)
    x, ws, bs = trunk_case(tplan, 0, n_rows)
    dy, dde = _cotangents(tplan, n_rows, 1)
    (jy, jde), jgrads = _jax_vjp(plan_kw, x, ws, bs, dy, dde)

    tws, tbs = [to_t(w) for w in ws], [to_t(b) for b in bs]
    ty, tde, *_ = tfv._forward_phases(tplan, to_t(x), tws, tbs)
    assert_close(ty, jy, what="y", **OUT_TOL)
    assert_close(tde, jde, what="de", **OUT_TOL)

    _assert_grads_close(tplan, tfv._backward_phases(tplan, to_t(x), tws, tbs, to_t(dy),
                                                    to_t(dde)), jgrads)


@pytest.mark.parametrize("plan_kw", PLANS)
@pytest.mark.parametrize("n_rows", [24, 13])
def test_autograd_matches_jax_vjp(plan_kw, n_rows):
    """Autograd through ``fused_value_grad`` (its forward keeps the phases'
    state, its backward starts from it) against the JAX package's VJP."""
    plan = tfm.MLPPlan(**plan_kw)
    x, ws, bs = trunk_case(plan, 6, n_rows)
    dy, dde = _cotangents(plan, n_rows, 7)
    leaves = [to_t(a).requires_grad_() for a in (x, *ws, *bs)]
    n = plan.n_layers
    y, de = tfv.fused_value_grad(plan, leaves[0], leaves[1:1 + n], leaves[1 + n:])
    grads = torch.autograd.grad((y, de), leaves, (to_t(dy), to_t(dde)))
    _assert_grads_close(plan, (grads[0], grads[1:1 + n], grads[1 + n:]),
                        _jax_vjp(plan_kw, x, ws, bs, dy, dde)[1])


# the NeuS SDF trunk (8 x 256, the skip at 4, PE 10) and the shadow
# pipeline's (4 x 128, the skip at 2, PE 6)
SDF_PLANS = {"neus": SDFConfig(),
             "pipeline": SDFConfig(d_out=129, d_hidden=128, n_layers=4, skip_in=(2,),
                                   multires=6)}


@pytest.mark.parametrize("net", sorted(SDF_PLANS))
def test_backward_from_the_kept_state_is_exact(net):
    """``_backward_phases`` from the state ``_forward_phases`` returned
    equals ``_backward_phases`` running those phases itself, to the bit."""
    plan = tfm.plan_from_sdf_config(SDF_PLANS[net])
    x, ws, bs = trunk_case(plan, 8, 19)
    dy, dde = _cotangents(plan, 19, 9)
    x, dy, dde = to_t(x), to_t(dy), to_t(dde)
    ws, bs = [to_t(w) for w in ws], [to_t(b) for b in bs]
    saved = tfv._forward_phases(plan, x, ws, bs)[2:]
    got = tfv._backward_phases(plan, x, ws, bs, dy, dde, saved=saved)
    want = tfv._backward_phases(plan, x, ws, bs, dy, dde)
    for a, b in zip([got[0], *got[1], *got[2]], [want[0], *want[1], *want[2]]):
        assert torch.equal(a, b)


# which inputs need a gradient, and the grad mode, of each case below
KEEP_CASES = {"all": ("grad", True, True), "x only": ("grad", True, False),
              "weights only": ("grad", False, True), "frozen": ("grad", False, False),
              "no_grad": ("no_grad", True, True), "inference": ("inference", True, True)}


@pytest.mark.parametrize("case", list(KEEP_CASES))
def test_state_is_kept_only_where_a_backward_can_follow(case):
    """Grad mode on and an input that needs a gradient: the forward keeps
    its state for the backward (x, the weights and biases, then the
    phases' 4n - 1 tensors) and counts ``vg.saved_rows``; otherwise there is
    no graph to keep it on and nothing is counted."""
    mode, x_grad, w_grad = KEEP_CASES[case]
    plan = tfm.MLPPlan(**PLANS[1])
    x, ws, bs = trunk_case(plan, 10, 11)
    x = to_t(x).requires_grad_(x_grad)
    wb = [to_t(a).requires_grad_(w_grad) for a in (*ws, *bs)]
    n = plan.n_layers
    context = {"grad": torch.enable_grad, "no_grad": torch.no_grad,
               "inference": torch.inference_mode}[mode]
    before = len(profiler.count_log("vg.saved_rows"))
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with context():
            y, de = tfv.fused_value_grad(plan, x, wb[:n], wb[n:])
    counted = [c for _, c in profiler.count_log("vg.saved_rows")[before:]]
    if mode == "grad" and (x_grad or w_grad):
        assert counted == [11]
        assert y.grad_fn is de.grad_fn
        assert len(y.grad_fn.saved_tensors) == 1 + 2 * n + 4 * n - 1
    else:
        assert counted == []
        assert y.grad_fn is None and de.grad_fn is None


@pytest.mark.parametrize("retain", [True, False])
def test_a_second_backward_through_one_graph(retain):
    """With the graph retained, a second backward reads the same kept state
    and gives the same gradients; without, autograd freed it and raises."""
    plan = tfm.MLPPlan(**PLANS[1])
    x, ws, bs = trunk_case(plan, 12, 9)
    dy, dde = _cotangents(plan, 9, 13)
    leaves = [to_t(a).requires_grad_() for a in (x, *ws, *bs)]
    n = plan.n_layers
    y, de = tfv.fused_value_grad(plan, leaves[0], leaves[1:1 + n], leaves[1 + n:])
    first = torch.autograd.grad((y, de), leaves, (to_t(dy), to_t(dde)), retain_graph=retain)
    if not retain:
        with pytest.raises(RuntimeError, match="backward through the graph a second time"):
            torch.autograd.grad((y, de), leaves, (to_t(dy), to_t(dde)))
        return
    second = torch.autograd.grad((y, de), leaves, (to_t(dy), to_t(dde)))
    for a, b in zip(first, second):
        assert torch.equal(a, b)


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
