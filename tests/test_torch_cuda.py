"""The port's CUDA kernels on the card: each against its plain version, and a
few train steps through them. Every test is marked ``cuda`` and skips
without a CUDA device.

This file imports no JAX, so that it also runs on a machine that has none:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Tolerance: |kernel - plain| within 1e-4 of each output's largest entry.
Both are fp32 (TF32 off); the kernels sum in another order, and K2 and K4
sum dW/db across blocks with atomics.
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


# the CESR normal net: 8 x 512 with the skip at layer 4 (449 + 63), PE input
NORMAL_NET = SDFConfig(d_in=63, d_out=3, d_hidden=512, n_layers=8, skip_in=(4,),
                       multires=0)


@pytest.mark.parametrize("sdf_cfg,n_rows", [(SDFConfig(), 1000), (SDFConfig(), 4099),
                                            (NORMAL_NET, 1027)])
def test_k1_matches_plain(dev, sdf_cfg, n_rows):
    plan = tfm.plan_from_sdf_config(sdf_cfg)
    x, ws, bs = trunk_case(plan, 1, n_rows)
    x, ws, bs = to_t(x, dev), [to_t(w, dev) for w in ws], [to_t(b, dev) for b in bs]
    before = tfm.FORWARD.launches
    with torch.no_grad():
        got = tfm.fused_mlp(plan, x, ws, bs)
    assert tfm.FORWARD.launches == before + 1
    _close(got, tfm._forward_rows(plan, x, ws, bs))


@pytest.mark.parametrize("sdf_cfg,n_rows,need_dx", [
    (NORMAL_NET, 1024, False), (NORMAL_NET, 1027, True), (SDFConfig(), 4099, True)])
def test_k2_matches_plain(dev, sdf_cfg, n_rows, need_dx):
    plan = tfm.plan_from_sdf_config(sdf_cfg)
    x, ws, bs = trunk_case(plan, 6, n_rows)
    dy = to_t(np.random.default_rng(7).standard_normal((n_rows, plan.out_dim)), dev)
    x, ws, bs = to_t(x, dev), [to_t(w, dev) for w in ws], [to_t(b, dev) for b in bs]
    dx, dws, dbs = tfm.mlp_backward_cuda(plan, x, ws, bs, dy, need_dx)
    dxr, dwsr, dbsr = tfm._backward_rows(plan, x, ws, bs, dy, need_dx)
    assert (dx is None) == (not need_dx)
    pairs = [*zip(dws, dwsr), *zip(dbs, dbsr)] + ([(dx, dxr)] if need_dx else [])
    for got, want in pairs:
        _close(got, want)


def test_fused_mlp_under_grad_runs_k1_and_k2(dev):
    """With weights that need gradients, fused_mlp on CUDA runs K1 forward
    and K2 backward (no dx: x needs none) and matches autograd through the
    plain version."""
    plan = tfm.plan_from_sdf_config(NORMAL_NET)
    x, ws, bs = trunk_case(plan, 2, 300)
    x = to_t(x, dev)
    ws = [to_t(w, dev).requires_grad_() for w in ws]
    bs = [to_t(b, dev).requires_grad_() for b in bs]
    dy = to_t(np.random.default_rng(3).standard_normal((300, plan.out_dim)), dev)
    before = (tfm.FORWARD.launches, tfm.BACKWARD.launches)
    grads = torch.autograd.grad(tfm.fused_mlp(plan, x, ws, bs), [*ws, *bs], dy)
    assert (tfm.FORWARD.launches, tfm.BACKWARD.launches) == (before[0] + 1, before[1] + 1)
    want = torch.autograd.grad(tfm._forward_rows(plan, x, ws, bs), [*ws, *bs], dy)
    for got, w in zip(grads, want):
        _close(got, w)


# Row counts about the kernels' row tiles (16 rows, and 64 from 16,896 rows
# on a 132-SM card) and their ragged edges.
@pytest.mark.parametrize("n_rows", [1, 63, 65, 1000, 1024, 4099, 16895, 16897, 65533])
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


def test_cesr_runner_steps_launch_each_kernel(dev):
    """Small widths through CESRRunner on the card: finite losses, and per
    step 52 K1 (51 sphere-tracer queries, the normal net), 1 K2 (the normal
    net's backward) and 1 K3 (the geometry normals)."""
    import dataclasses

    from robir_tpu_torch.data.syn_dataset import shadow_scene
    from robir_tpu_torch.fields.envmap_material import EnvmapMaterialConfig
    from robir_tpu_torch.fields.visibility import IndirIllumConfig, VisNetConfig
    from robir_tpu_torch.render.stage2 import Stage2Config
    from robir_tpu_torch.stages.cesr import CESRRunner, CESRStageConfig
    from robir_tpu_torch.stages.stage2_runner import init_stage2_params

    @dataclasses.dataclass(frozen=True)
    class SmallCESR(CESRStageConfig):
        @property
        def normal_cfg(self):
            return SDFConfig(d_in=63, d_out=3, d_hidden=96, n_layers=3, skip_in=(2,),
                             multires=0)

        @property
        def shadow_cfg(self):
            return SDFConfig(d_in=63 + self.num_lights, d_out=2, d_hidden=96, n_layers=3,
                             skip_in=(2,), multires=0)

    cfg = Stage2Config(
        neus=NeuSConfig(sdf=SDFConfig(d_out=33, d_hidden=32, n_layers=3, skip_in=(2,),
                                      multires=3),
                        color=RenderingConfig(d_feature=32, d_hidden=32, n_layers=2)),
        envmap=EnvmapMaterialConfig(multires=3, num_lgt_sgs=8, encoder_dims=(48, 48),
                                    decoder_dims=(24,), latent_dim=8),
        indirect=IndirIllumConfig(multires=3, dims=(32, 32), num_lgt_sgs=6),
        visnet=VisNetConfig(points_multires=3, dirs_multires=3, dims=(32, 32),
                            storage_dtype="bfloat16"),
        tracer="sphere")
    runner = CESRRunner(cfg, init_stage2_params(torch.Generator().manual_seed(0), cfg),
                        shadow_scene(n_train=3, h=40, w=40),
                        SmallCESR(num_pixels=64, warmup_iters=1, normal_switch_iter=1,
                                  dropout_iter=2), device="cuda")
    kernels = (tfm.FORWARD, tfm.BACKWARD, tfv.FORWARD, tfv.BACKWARD)
    before = [k.launches for k in kernels]
    for _ in range(3):
        metrics = runner.run(1)
        assert all(np.isfinite(v) for v in metrics.values()), metrics
    assert [k.launches - b for k, b in zip(kernels, before)] == [156, 3, 3, 0]
