"""The port's CUDA kernels on the card: each against its plain version, and a
few train steps through them. Every test is marked ``cuda`` and skips
without a CUDA device.

This file imports no JAX, so that it also runs on a machine that has none:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Tolerance: |kernel - plain| within 1e-4 of each output's largest entry.
Both are fp32 (TF32 off); the kernels sum in another order, and K4 sums
dW/db across blocks with atomics.
"""

import numpy as np
import pytest
import torch

from robir_tpu_torch.data.synthetic import make_sphere_scene
from robir_tpu_torch.fields.neus_model import NeuSConfig
from robir_tpu_torch.fields.radiance import RenderingConfig
from robir_tpu_torch.fields.sdf import SDFConfig
from robir_tpu_torch.render.cuda import fused_mlp as tfm
from robir_tpu_torch.render.cuda import fused_value_grad as tfv
from robir_tpu_torch.render.neus import NeusRenderConfig
from robir_tpu_torch.stages.neus_stage import NeusTrainConfig, NeusTrainer
from torch_port_helpers import cuda_or_skip, to_t, trunk_case

pytestmark = pytest.mark.cuda
TOL = 1e-4


@pytest.fixture
def dev():
    device = cuda_or_skip()
    torch.backends.cuda.matmul.allow_tf32 = False
    return device


def _close(got, want):
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= TOL * max(scale, 1e-3)


@pytest.mark.parametrize("n_rows", [1000, 4099])
def test_k1_matches_plain(dev, n_rows):
    plan = tfm.plan_from_sdf_config(SDFConfig())
    x, ws, bs = trunk_case(plan, 1, n_rows)
    x, ws, bs = to_t(x, dev), [to_t(w, dev) for w in ws], [to_t(b, dev) for b in bs]
    before = tfm.FORWARD.launches
    with torch.no_grad():
        got = tfm.fused_mlp(plan, x, ws, bs)
    assert tfm.FORWARD.launches == before + 1
    _close(got, tfm._forward_rows(plan, x, ws, bs))


def test_k1_refuses_gradients(dev):
    plan = tfm.MLPPlan(dims=(8, 16, 8, 16), out_dim=5, skip_in=(2,))
    x, ws, bs = trunk_case(plan, 2, 8)
    ws = [to_t(w, dev).requires_grad_() for w in ws]
    with pytest.raises(RuntimeError, match="forward only"):
        tfm.fused_mlp(plan, to_t(x, dev), ws, [to_t(b, dev) for b in bs])


@pytest.mark.parametrize("n_rows", [1000, 4099])
def test_k3_k4_match_plain(dev, n_rows):
    plan = tfm.plan_from_sdf_config(SDFConfig())
    x, ws, bs = trunk_case(plan, 4, n_rows)
    rng = np.random.default_rng(5)
    dy = to_t(rng.standard_normal((n_rows, plan.out_dim)), dev)
    dde = to_t(rng.standard_normal((n_rows, plan.dims[0])), dev)
    x, ws, bs = to_t(x, dev), [to_t(w, dev) for w in ws], [to_t(b, dev) for b in bs]
    y, de = tfv.vg_forward_cuda(plan, x, ws, bs)
    yr, der, *_ = tfv._forward_phases(plan, x, ws, bs)
    dx, dws, dbs = tfv.vg_backward_cuda(plan, x, ws, bs, dy, dde)
    dxr, dwsr, dbsr = tfv._backward_phases(plan, x, ws, bs, dy, dde)
    for got, want in [(y, yr), (de, der), (dx, dxr), *zip(dws, dwsr), *zip(dbs, dbsr)]:
        _close(got, want)


def test_trainer_steps_launch_each_kernel(dev):
    """Small widths through NeusTrainer on the card: finite losses, and the
    launch counts rise by 4 K1 + 1 K3 + 1 K4 per step (4 up-sample rounds,
    the last of which queries nothing)."""
    model = NeuSConfig(sdf=SDFConfig(d_out=17, d_hidden=32, n_layers=3, skip_in=(2,),
                                     multires=2),
                       color=RenderingConfig(d_feature=16, d_hidden=32, n_layers=2))
    trainer = NeusTrainer(make_sphere_scene("train", n_train=4, h=16, w=16), model,
                          NeusRenderConfig(n_samples=16, n_importance=16),
                          NeusTrainConfig(batch_size=64), device="cuda")
    kernels = (tfm.FORWARD, tfv.FORWARD, tfv.BACKWARD)
    before = [k.launches for k in kernels]
    try:
        metrics = trainer.run(3)
    finally:
        trainer.close()
    assert np.isfinite(metrics["loss"])
    assert [k.launches - b for k, b in zip(kernels, before)] == [12, 3, 3]
