"""The port's CUDA kernels on the card: each against its plain version, and a
few train steps through them. Every test is marked ``cuda`` and skips
without a CUDA device.

This file imports no JAX, so that it also runs on a machine that has none:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Tolerance: |kernel - plain| within 1e-4 of each output's largest entry.
Both are fp32 (TF32 off); the kernels sum in another order, and K2 and K4
sum dW/db across blocks with atomics.
"""

import dataclasses

import numpy as np
import pytest
import torch

from robir_tpu_torch.data.synthetic import make_sphere_scene
from robir_tpu_torch.fields.neus_model import NeuSConfig
from robir_tpu_torch.fields.radiance import RenderingConfig
from robir_tpu_torch.fields.sdf import SDFConfig
from robir_tpu_torch.render.cuda import fused_mlp as tfm
from robir_tpu_torch.render.cuda import fused_value_grad as tfv
from robir_tpu_torch.render.cuda import grid_march as tgm
from robir_tpu_torch.render.neus import NeusRenderConfig
from robir_tpu_torch.stages.neus_stage import NeusTrainConfig, NeusTrainer
from robir_tpu_torch.tracing import grid as tg
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


# K1/K2 row counts: a tile's edges, the CESR step's 1,024 rows and a ragged
# count near it, each side of the switch from clusters of blocks per 16-row
# tile to one block (2,112 rows on a 132-SM card), and beyond
K12_ROWS = [1, 15, 17, 1000, 1024, 1027, 2111, 2113, 4099]
K12_PLANS = {"sdf": SDFConfig(), "normal_net": NORMAL_NET}


@pytest.mark.parametrize("n_rows", K12_ROWS)
@pytest.mark.parametrize("net", K12_PLANS)
def test_k1_matches_plain(dev, net, n_rows):
    plan = tfm.plan_from_sdf_config(K12_PLANS[net])
    x, ws, bs = trunk_case(plan, 1, n_rows)
    x, ws, bs = to_t(x, dev), [to_t(w, dev) for w in ws], [to_t(b, dev) for b in bs]
    before = tfm.FORWARD.launches
    with torch.no_grad():
        got = tfm.fused_mlp(plan, x, ws, bs)
    assert tfm.FORWARD.launches == before + 1
    _close(got, tfm._forward_rows(plan, x, ws, bs))


@pytest.mark.parametrize("need_dx", [False, True])
@pytest.mark.parametrize("n_rows", K12_ROWS)
@pytest.mark.parametrize("net", K12_PLANS)
def test_k2_matches_plain(dev, net, n_rows, need_dx):
    plan = tfm.plan_from_sdf_config(K12_PLANS[net])
    x, ws, bs = trunk_case(plan, 6, n_rows)
    dy = to_t(np.random.default_rng(7).standard_normal((n_rows, plan.out_dim)), dev)
    x, ws, bs = to_t(x, dev), [to_t(w, dev) for w in ws], [to_t(b, dev) for b in bs]
    dx, dws, dbs = tfm.mlp_backward_cuda(plan, x, tfm.pack_weights(plan, ws, bs, reverse=True),
                                         dy, need_dx)
    dxr, dwsr, dbsr = tfm._backward_rows(plan, x, ws, bs, dy, need_dx)
    assert (dx is None) == (not need_dx)
    pairs = [*zip(dws, dwsr), *zip(dbs, dbsr)] + ([(dx, dxr)] if need_dx else [])
    for got, want in pairs:
        _close(got, want)


def test_k1_refuses_a_geometry_it_does_not_take(dev):
    """A geometry the kernels refuse (windows past 264 columns), handed to
    the entry point in the meta, raises; no other path runs in its place."""
    from robir_tpu_torch.render.cuda.build import int_array, ptr

    plan = tfm.plan_from_sdf_config(NORMAL_NET)
    x, ws, bs = trunk_case(plan, 8, 64)
    x, ws, bs = to_t(x, dev), [to_t(w, dev) for w in ws], [to_t(b, dev) for b in bs]
    geo = tfm.launch_geometry(plan, 64, tfm.sm_count(x.device))
    wide = tuple(((0, plan.layer_out_dim(i)),) * geo.cluster for i in range(plan.n_layers))
    meta = int_array(plan.meta() + dataclasses.replace(geo, out=wide).meta())
    packed = tfm.pack_weights(plan, ws, bs)
    y = torch.full((64, plan.out_dim), float("nan"), device=dev)
    before = tfm.FORWARD.launches
    with pytest.raises(RuntimeError, match="CUDA error"):
        tfm.FORWARD(ptr(x), ptr(packed.W), ptr(packed.b), ptr(y), meta, 64, tfm.stream_handle(x),
                    shape=(tfm.MAX_WIDTH_WIDE, 64))
    assert tfm.FORWARD.launches == before and torch.isnan(y).all()


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
K34_ROWS = [1, 63, 65, 1000, 1024, 4099, 16895, 16897, 65533]


@pytest.mark.parametrize("n_rows", K34_ROWS)
def test_k3_k4_match_plain(dev, n_rows):
    plan = tfm.plan_from_sdf_config(SDFConfig())
    x, ws, bs = trunk_case(plan, 4, n_rows)
    rng = np.random.default_rng(5)
    dy = to_t(rng.standard_normal((n_rows, plan.out_dim)), dev)
    dde = to_t(rng.standard_normal((n_rows, plan.dims[0])), dev)
    x, ws, bs = to_t(x, dev), [to_t(w, dev) for w in ws], [to_t(b, dev) for b in bs]
    packed = tfm.pack_weights(plan, ws, bs, reverse=True)
    y, de = tfv.vg_forward_cuda(plan, x, packed)
    yr, der, *_ = tfv._forward_phases(plan, x, ws, bs)
    saved = tfv.vg_forward_saving_cuda(plan, x, packed)[2]
    dx, dws, dbs = tfv.vg_backward_cuda(plan, x, packed, dy, dde, saved)
    dxr, dwsr, dbsr = tfv._backward_phases(plan, x, ws, bs, dy, dde)
    for got, want in [(y, yr), (de, der), (dx, dxr), *zip(dws, dwsr), *zip(dbs, dbsr)]:
        _close(got, want)


@pytest.mark.parametrize("n_rows", K34_ROWS)
def test_k3_k4_autograd_matches_plain(dev, n_rows):
    """Autograd through ``fused_value_grad`` on the card: one K3 that keeps
    its state and one K4 that starts from it, against the plain versions.
    K3's outputs are bit-equal with and without keeping the state; K4 only
    reads it, so its dx is bit-equal from the kept state, from it a second
    time, and from the state of a K3 launched anew."""
    plan = tfm.plan_from_sdf_config(SDFConfig())
    x, ws, bs = trunk_case(plan, 14, n_rows)
    rng = np.random.default_rng(15)
    dy = to_t(rng.standard_normal((n_rows, plan.out_dim)), dev)
    dde = to_t(rng.standard_normal((n_rows, plan.dims[0])), dev)
    x, ws, bs = to_t(x, dev), [to_t(w, dev) for w in ws], [to_t(b, dev) for b in bs]
    leaves = [a.clone().requires_grad_() for a in (x, *ws, *bs)]
    n = plan.n_layers
    counters = (tfv.FORWARD, tfv.KEPT, tfv.BACKWARD)
    before = [k.launches for k in counters]
    y, de = tfv.fused_value_grad(plan, leaves[0], leaves[1:1 + n], leaves[1 + n:])
    grads = torch.autograd.grad((y, de), leaves, (dy, dde))
    assert [k.launches - b for k, b in zip(counters, before)] == [1, 1, 1]
    yr, der, *_ = tfv._forward_phases(plan, x, ws, bs)
    dxr, dwsr, dbsr = tfv._backward_phases(plan, x, ws, bs, dy, dde)
    for got, want in zip([y.detach(), de.detach(), *grads], [yr, der, dxr, *dwsr, *dbsr]):
        _close(got, want)

    packed = tfm.pack_weights(plan, ws, bs, reverse=True)
    y2, de2, saved = tfv.vg_forward_saving_cuda(plan, x, packed)
    y3, de3 = tfv.vg_forward_cuda(plan, x, packed)
    assert torch.equal(y2, y3) and torch.equal(de2, de3) and torch.equal(y2, y.detach())
    anew = tfv.vg_forward_saving_cuda(plan, x, packed)[2]
    dx = [tfv.vg_backward_cuda(plan, x, packed, dy, dde, saved)[0],
          tfv.vg_backward_cuda(plan, x, packed, dy, dde, saved)[0],
          tfv.vg_backward_cuda(plan, x, packed, dy, dde, anew)[0]]
    assert all(torch.equal(d, grads[0]) for d in dx)



# the shadow pipeline's SDF trunk (robir_tpu_torch/tools/shadow_pipeline.py:
# conf_dict): 4 layers 128 wide, the skip at 2, PE 6 (39 inputs), 129
# outputs; at a surface batch's rows, an eval chunk's and a bake chunk's
PIPELINE_SDF = SDFConfig(d_out=129, d_hidden=128, n_layers=4, skip_in=(2,), multires=6)


@pytest.mark.parametrize("n_rows", [128, 2048, 65536])
@pytest.mark.parametrize("kernel", ["K1", "K2", "K3", "K4"])
def test_trunk_kernels_at_the_pipeline_plan(dev, kernel, n_rows):
    plan = tfm.plan_from_sdf_config(PIPELINE_SDF)
    assert plan.dims[0] == 39 and plan.out_dim == 129
    x, ws, bs = trunk_case(plan, 11, n_rows)
    rng = np.random.default_rng(12)
    dy = to_t(rng.standard_normal((n_rows, plan.out_dim)), dev)
    dde = to_t(rng.standard_normal((n_rows, plan.dims[0])), dev)
    x, ws, bs = to_t(x, dev), [to_t(w, dev) for w in ws], [to_t(b, dev) for b in bs]
    packed = tfm.pack_weights(plan, ws, bs, reverse=True)
    saved = tfv.vg_forward_saving_cuda(plan, x, packed)[2] if kernel == "K4" else None
    counter = {"K1": tfm.FORWARD, "K2": tfm.BACKWARD, "K3": tfv.FORWARD,
               "K4": tfv.BACKWARD}[kernel]
    before = counter.launches
    if kernel == "K1":
        pairs = [(tfm.fused_mlp_cuda(plan, x, packed), tfm._forward_rows(plan, x, ws, bs))]
    elif kernel == "K2":
        got = tfm.mlp_backward_cuda(plan, x, packed, dy, True)
        want = tfm._backward_rows(plan, x, ws, bs, dy, True)
        pairs = [(got[0], want[0]), *zip(got[1], want[1]), *zip(got[2], want[2])]
    elif kernel == "K3":
        pairs = list(zip(tfv.vg_forward_cuda(plan, x, packed),
                         tfv._forward_phases(plan, x, ws, bs)[:2]))
    else:
        got = tfv.vg_backward_cuda(plan, x, packed, dy, dde, saved)
        want = tfv._backward_phases(plan, x, ws, bs, dy, dde)
        pairs = [(got[0], want[0]), *zip(got[1], want[1]), *zip(got[2], want[2])]
    assert counter.launches == before + 1
    for got, want in pairs:
        _close(got, want)


def test_one_pack_per_autograd_call(dev, monkeypatch):
    """A forward and a backward of ``fused_mlp`` under grad, and of
    ``fused_value_grad``, each pack the weights exactly once, with W^T:
    K2 and K4 launch from the pack their forward made."""
    calls = []
    real = tfm.pack_weights

    def counted(*args, **kw):
        calls.append(kw.get("reverse", False))
        return real(*args, **kw)

    monkeypatch.setattr(tfm, "pack_weights", counted)
    monkeypatch.setattr(tfv, "pack_weights", counted)
    for op, cfg, k2_or_k4 in ((tfm.fused_mlp, NORMAL_NET, tfm.BACKWARD),
                              (tfv.fused_value_grad, SDFConfig(), tfv.BACKWARD)):
        plan = tfm.plan_from_sdf_config(cfg)
        x, ws, bs = trunk_case(plan, 9, 300)
        leaves = [to_t(a, dev).requires_grad_() for a in (x, *ws, *bs)]
        n = plan.n_layers
        calls.clear()
        before = k2_or_k4.launches
        out = op(plan, leaves[0], leaves[1:1 + n], leaves[1 + n:])
        outs = out if isinstance(out, tuple) else (out,)
        grads = torch.autograd.grad(outs, leaves, [torch.ones_like(o) for o in outs])
        assert calls == [True] and k2_or_k4.launches == before + 1
        assert all(torch.isfinite(g).all() for g in grads)


def test_trainer_steps_launch_each_kernel(dev):
    """Small widths through NeusTrainer on the card: finite losses, and the
    launch counts rise by a step's 4 K1 + 1 K3 + 1 K4 (4 up-sample rounds,
    the last of which queries nothing) twice, the capture's warm-up and the
    capture, each K3 keeping its state for its K4; the 3 steps replay the
    CUDA graphs (``stages/step_graph.py``), which launch without the
    wrappers."""
    model = NeuSConfig(sdf=SDFConfig(d_out=17, d_hidden=32, n_layers=3, skip_in=(2,),
                                     multires=2),
                       color=RenderingConfig(d_feature=16, d_hidden=32, n_layers=2))
    trainer = NeusTrainer(make_sphere_scene("train", n_train=4, h=16, w=16), model,
                          NeusRenderConfig(n_samples=16, n_importance=16),
                          NeusTrainConfig(batch_size=64), device="cuda")
    kernels = (tfm.FORWARD, tfv.FORWARD, tfv.KEPT, tfv.BACKWARD)
    before = [k.launches for k in kernels]
    try:
        metrics = trainer.run(3)
    finally:
        trainer.close()
    assert np.isfinite(metrics["loss"])
    assert [k.launches - b for k, b in zip(kernels, before)] == [8, 2, 2, 2]
    assert (trainer.step_graph.captures, trainer.step_graph.replays) == (1, 3)


def test_cesr_runner_steps_launch_each_kernel(dev):
    """Small widths through CESRRunner on the card: finite losses, and per
    step 52 K1 (51 sphere-tracer queries, the normal net), 1 K2 (the normal
    net's backward) and 1 K3 (the geometry normals)."""
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


def _union_sdf(x):
    """A sphere of radius 0.3 beside a torus (0.4, 0.12): convex and not."""
    sphere = torch.linalg.norm(x - torch.tensor([0.45, 0.0, 0.0], device=x.device), dim=-1) - 0.3
    q = torch.stack([torch.linalg.norm(x[:, :2] + torch.tensor([0.35, 0.0], device=x.device),
                                       dim=-1) - 0.4, x[:, 2]], -1)
    return torch.minimum(sphere, torch.linalg.norm(q, dim=-1) - 0.12)


@pytest.mark.parametrize("store", [None, "bfloat16"])
@pytest.mark.parametrize("over_relax", [0.0, 1.6])
@pytest.mark.parametrize("n_rays", [1, 1000, 4099])
def test_grid_march_matches_plain(dev, store, over_relax, n_rays):
    """The grid-march kernel against grid_cast_plain on the card: the same
    hits, t and x within 1e-5 where both hit; one launch."""
    cfg = tg.GridConfig(resolution=96, max_steps=128, storage_dtype=store,
                        over_relax=over_relax)
    grid = tg.build_sdf_grid(_union_sdf, cfg, device=dev)
    gen = torch.Generator(device=dev).manual_seed(n_rays)
    o = torch.randn(n_rays, 3, generator=gen, device=dev)
    o = 1.8 * o / torch.linalg.norm(o, dim=-1, keepdim=True)
    d = torch.rand(n_rays, 3, generator=gen, device=dev) * 1.2 - 0.6 - o
    d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    before = tgm.MARCH.launches
    t, hit, x = tg.grid_cast(grid, cfg, o, d)
    torch.cuda.synchronize()
    assert tgm.MARCH.launches == before + 1
    tp, hp, xp, _ = tg.grid_cast_plain(grid, cfg, o, d)
    assert torch.equal(hit, hp), torch.nonzero(hit != hp).squeeze(1)[:20].tolist()
    assert float(torch.where(hit, t - tp, 0.0).abs().max()) <= 1e-5
    assert float(torch.where(hit[:, None], x - xp, 0.0).abs().max()) <= 1e-5
    if n_rays > 100:
        assert 0.1 < float(hit.float().mean()) < 0.9


def test_grid_march_refuses_what_it_does_not_take(dev):
    cfg = tg.GridConfig(resolution=8, storage_dtype="bfloat16")
    grid = torch.zeros(8, 8, 8, device=dev)  # fp32, not the config's bf16
    o = torch.zeros(4, 3, device=dev)
    consts = tg.march_constants(cfg)
    with pytest.raises(ValueError):
        tg.grid_cast(grid, cfg, o, o)
    with pytest.raises(ValueError):
        tgm.grid_march_cuda(grid.bfloat16(), o.cpu(), o.cpu(), consts, 8, False)
    with pytest.raises(ValueError):
        tgm.grid_march_cuda(grid.half(), o, o, consts, 8, False)
    with pytest.raises(ValueError):
        tgm.grid_march_cuda(grid.bfloat16(), o, o, consts[:15], 8, False)


# the Vis stage's K3 launches: a slice of 4,096 needed rays x 16 samples,
# and a ragged slice
@pytest.mark.parametrize("n_rows", [16 * 1000, 65536])
def test_k3_without_a_graph_matches_plain(dev, n_rows):
    """``fused_value_grad`` under no_grad, as the borrowed colour calls it:
    one K3 launch, no K4, values and d sdf/dx as the plain version's."""
    plan = tfm.plan_from_sdf_config(SDFConfig())
    x, ws, bs = trunk_case(plan, 6, n_rows)
    x, ws, bs = to_t(x, dev), [to_t(w, dev) for w in ws], [to_t(b, dev) for b in bs]
    for t in (*ws, *bs):
        t.requires_grad_(True)
    before = (tfv.FORWARD.launches, tfv.BACKWARD.launches)
    with torch.no_grad():
        y, de = tfv.fused_value_grad(plan, x, ws, bs)
        yr, der, *_ = tfv._forward_phases(plan, x, ws, bs)
    torch.cuda.synchronize()
    assert (tfv.FORWARD.launches, tfv.BACKWARD.launches) == (before[0] + 1, before[1])
    assert not y.requires_grad and y.grad_fn is None
    _close(y, yr)
    _close(de, der)


def test_grid_march_on_a_vis_fan_matches_plain(dev):
    """131,072 rays, the Vis stage's fan (256 pixels x 512 directions), from
    points near a sphere's surface pushed off by the fan's offset, in
    uniform directions, on a 320^3 bf16 grid: the same hits as the plain
    version, t within 1e-5 where both hit."""
    cfg = tg.GridConfig(resolution=320, max_steps=192, storage_dtype="bfloat16")
    grid = tg.build_sdf_grid(_union_sdf, cfg, device=dev)
    gen = torch.Generator(device=dev).manual_seed(3)
    p = torch.randn(256, 3, generator=gen, device=dev)
    n = p / torch.linalg.norm(p, dim=-1, keepdim=True)
    o = (torch.tensor([0.45, 0.0, 0.0], device=dev) + 0.305 * n)[:, None, :].expand(
        256, 512, 3).reshape(-1, 3)
    d = torch.randn(256 * 512, 3, generator=gen, device=dev)
    d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    t, hit, _ = tg.grid_cast(grid, cfg, o, d)
    tp, hp, _, _ = tg.grid_cast_plain(grid, cfg, o, d)
    assert torch.equal(hit, hp), torch.nonzero(hit != hp).squeeze(1)[:20].tolist()
    assert float(torch.where(hit, t - tp, 0.0).abs().max()) <= 1e-5
    assert 0.05 < float(hit.float().mean()) < 0.95


def _plain_k3(plan, x, packed):
    """K3's plain version in ``vg_forward_cuda``'s place."""
    return tfv._forward_phases(plan, x, *tfm.unpack_grads(packed.W, packed.b, plan))[:2]


def test_borrow_color_matches_plain(dev):
    """``Stage2Model.borrow_color`` at full width on 2,000 rays: K3 (one
    launch) against the same call with K3's plain version, within 1e-4 of
    the largest entry."""
    from robir_tpu_torch.render.stage2 import Stage2Config, Stage2Model
    from robir_tpu_torch.stages.stage2_runner import init_stage2_params

    cfg = Stage2Config()
    model = Stage2Model(init_stage2_params(torch.Generator().manual_seed(0), cfg), cfg, dev)
    gen = torch.Generator(device=dev).manual_seed(4)
    x = torch.randn(2000, 3, generator=gen, device=dev)
    x = 0.25 * x / torch.linalg.norm(x, dim=-1, keepdim=True)
    d = torch.randn(2000, 3, generator=gen, device=dev)
    before = (tfv.FORWARD.launches, tfv.BACKWARD.launches)
    with torch.no_grad():
        got = model.borrow_color(x, d)
    assert (tfv.FORWARD.launches, tfv.BACKWARD.launches) == (before[0] + 1, before[1])
    real = tfv.vg_forward_cuda
    try:
        tfv.vg_forward_cuda = _plain_k3
        with torch.no_grad():
            want = model.borrow_color(x, d)
    finally:
        tfv.vg_forward_cuda = real
    assert float(want.abs().max()) > 1e-3
    _close(got, want)


def _two_sphere_sdf(x):
    """The shadow scene's two spheres in stage-2 coordinates."""
    return torch.stack([torch.linalg.norm(x - torch.tensor(c, device=x.device), dim=-1) - r
                        for c, r in (((0.0, 0.0, 0.0), 0.25), ((0.185, 0.11, 0.305), 0.09))]
                       ).amin(0)


def _pbr_runner(dev, num_pixels: int):
    """A PBRRunner on the card at the full-width NeuS trunk (K3's build) and
    128 SG lights, narrow other nets, on the shadow scene with a 160^3 grid
    of its two spheres' analytic sdf."""
    from robir_tpu_torch.data.syn_dataset import shadow_scene
    from robir_tpu_torch.fields.visibility import IndirIllumConfig, VisNetConfig
    from robir_tpu_torch.render.stage2 import Stage2Config
    from robir_tpu_torch.stages.pbr import PBRRunner, PBRStageConfig
    from robir_tpu_torch.stages.stage2_runner import init_stage2_params

    cfg = Stage2Config(indirect=IndirIllumConfig(dims=(64, 64)),
                       visnet=VisNetConfig(dims=(64, 64), storage_dtype="bfloat16"),
                       grid=tg.GridConfig(resolution=160, storage_dtype="bfloat16"))
    runner = PBRRunner(cfg, init_stage2_params(torch.Generator().manual_seed(0), cfg),
                       shadow_scene(n_train=3, h=128, w=128),
                       PBRStageConfig(num_pixels=num_pixels), device=dev)
    runner.grid_values = tg.build_sdf_grid(_two_sphere_sdf, cfg.grid, device=dev)
    return runner


def test_pbr_steps_launch_k3_at_their_rows(dev):
    """Three PBR steps (1,024 pixels, row mode): finite metrics, and per
    step one grid march at 1,024 rays. The steps replay CUDA graphs of
    their row buckets (``stages/material_graph.py``): K3, which keeps no
    state (the frozen NeuS has no backward), passes through its wrapper
    once at one chunk of rows (the probe that notes the step's draws) and
    once at each capture, at the step's surface rows rounded up to whole
    chunks; no K1, K2 or K4. K3 at each of those row counts against its
    plain version at the SDF trunk's full width."""
    from robir_tpu_torch.core.compact import bucket_rows

    runner = _pbr_runner(dev, 1024)
    chunk = runner.stage_cfg.compact_chunk
    kernels = (tfm.FORWARD, tfm.BACKWARD, tfv.FORWARD, tfv.BACKWARD, tgm.MARCH, tfv.KEPT)
    for k in kernels:
        k.reset()
    rows = []
    for _ in range(3):
        metrics = runner.run(1)
        assert all(np.isfinite(v) for v in metrics.values()), metrics
        rows.append(bucket_rows(round(metrics["surface_frac"] * 1024), chunk))
    graphs = runner.graphs
    assert (graphs.replays, graphs.eager_fallbacks) == (3, 0)
    assert [k.launches for k in kernels] == [0, 0, 1 + graphs.captures, 0, 3, 0]
    launched = {r for (_, r) in tfv.FORWARD.by_shape}
    assert launched == {chunk} | set(rows)
    assert all(16 < r <= 1024 for r in rows)
    rows = sorted(launched)
    plan = tfm.plan_from_sdf_config(SDFConfig())
    x, ws, bs = trunk_case(plan, 7, max(rows))
    x, ws, bs = to_t(x, dev), [to_t(w, dev) for w in ws], [to_t(b, dev) for b in bs]
    packed = tfm.pack_weights(plan, ws, bs, reverse=True)
    for r in sorted(set(rows)):
        y, de = tfv.vg_forward_cuda(plan, x[:r], packed)
        yr, der, *_ = tfv._forward_phases(plan, x[:r], ws, bs)
        _close(y, yr)
        _close(de, der)


def test_pbr_render_view_matches_plain(dev):
    """``render_view`` of a 64 x 64 test view in chunks of 1,500 rays (the
    last padded) on the card: one grid march and one K3 a chunk; against
    the same call, on the same draws, with the march's and K3's plain
    versions: the same hits, each buffer within 1e-4 of its largest
    entry."""
    import functools

    from robir_tpu_torch.core.draws import Draws
    from robir_tpu_torch.data.syn_dataset import shadow_scene
    from robir_tpu_torch.render import stage2 as ts2
    from robir_tpu_torch.stages.pbr import pbr_sg_render
    from robir_tpu_torch.stages.stage2_runner import render_view

    runner = _pbr_runner(dev, 64)
    view = shadow_scene(n_train=3, h=64, w=64, split="test")
    taken = []

    def recorded(_):
        taken.append(Draws(runner.generator, device=dev, record=True))
        return taken[-1]

    kw = dict(sg_render_fn=functools.partial(pbr_sg_render, use_normal_map=True), chunk=1500)
    march, k3 = tgm.MARCH.launches, tfv.FORWARD.launches
    got = render_view(runner.model(), view, 0, draws=recorded, **kw)
    assert (tgm.MARCH.launches - march, tfv.FORWARD.launches - k3) == (3, 3)
    real_cast, real_k3 = ts2.grid_cast, tfv.vg_forward_cuda
    try:
        ts2.grid_cast = lambda g, c, o, d: tg.grid_cast_plain(g, c, o, d)[:3]
        tfv.vg_forward_cuda = _plain_k3
        want = render_view(runner.model(), view, 0,
                           draws=lambda c: Draws(given=taken[c].taken, device=dev), **kw)
    finally:
        ts2.grid_cast, tfv.vg_forward_cuda = real_cast, real_k3
    assert np.array_equal(got["mask"], want["mask"]) and 0 < got["mask"].sum() < 4096
    for k in want:
        assert got[k].shape == want[k].shape and np.isfinite(got[k]).all(), k
        scale = float(np.abs(want[k]).max())
        assert float(np.abs(got[k].astype(np.float64) - want[k]).max()) <= TOL * max(scale, 1e-3), k


def test_extract_mesh_matches_plain(dev, monkeypatch):
    """The mesh export's SDF grid at the stage-1 trunk's default widths,
    48^3 nodes in two chunks of 65,536 (the second padded): two K1
    launches, the grid within 1e-4 of the same export on K1's plain
    version, and NeusTrainer.extract_mesh meshes that grid."""
    from robir_tpu_torch.core.params import from_jax
    from robir_tpu_torch.fields.neus_model import init_neus
    from robir_tpu_torch.fields.sdf import frozen_sdf
    from robir_tpu_torch.texture import mesh as tmesh
    from robir_tpu_torch.texture.native import marching_tetrahedra

    model = NeuSConfig()
    trainer = NeusTrainer(make_sphere_scene("train", n_train=2, h=8, w=8), model,
                          NeusRenderConfig(), NeusTrainConfig(mesh_resolution=48), device="cuda")
    box = ((-1.2,) * 3, (1.2,) * 3)
    params = from_jax(init_neus(torch.Generator().manual_seed(0), model), dev)["sdf_network"]
    sdf = frozen_sdf(params, model.sdf, out_cols=1)
    tfm.FORWARD.reset()
    grid = tmesh.sdf_grid(sdf, *box, 48, device=dev)
    assert tfm.FORWARD.by_shape == {(tfm.MAX_WIDTH, 65536): 2}
    mesh = trainer.extract_mesh()
    assert tfm.FORWARD.launches == 4
    monkeypatch.setattr(tfm, "fused_mlp_cuda", lambda plan, x, packed: tfm._forward_rows(
        plan, x, *tfm.unpack_grads(packed.W, packed.b, plan)))
    want = tmesh.sdf_grid(sdf, *box, 48, device=dev)
    assert tfm.FORWARD.launches == 4
    _close(torch.as_tensor(grid), torch.as_tensor(want))
    assert want.min() < 0 < want.max()
    verts, tris = marching_tetrahedra(grid, *box)
    assert np.array_equal(mesh.tris, tris) and np.array_equal(mesh.verts, verts)


def test_norm_step_matches_the_cpu(dev):
    """One Norm step at the default normal-decoder widths on the card and on
    the CPU (fp32 and fp64), from one batch and one draw: the metrics to
    1e-4 relative of the fp64 ones, each gradient within 1e-4 of its
    largest fp64 entry or 8x the CPU fp32 step's own distance."""
    from robir_tpu_torch.core.draws import Draws
    from robir_tpu_torch.render.stage2 import Stage2Config
    from robir_tpu_torch.stages.norm import NormRunner, NormStageConfig
    from robir_tpu_torch.stages.stage2_runner import init_stage2_params

    cfg = Stage2Config()
    params = init_stage2_params(torch.Generator().manual_seed(0), cfg)
    rng = np.random.default_rng(0)
    d = rng.standard_normal((512, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    batch = {"points": to_t(0.25 * d), "normals": to_t(d),
             "object_mask": torch.as_tensor(rng.random(512) > 0.2)}
    noise = torch.randn(cfg.envmap.normal_ae.noise_shape(512), generator=torch.Generator())
    out = {}
    for side, dtype in (("cpu", torch.float32), ("cuda", torch.float32), ("cpu", torch.float64)):
        runner = NormRunner(cfg, params, None, NormStageConfig(smooth_after=-1), device=side)
        runner.params.to(dtype)
        torch.set_default_dtype(dtype)
        try:
            metrics = runner.step({k: v.to(side, dtype) if v.is_floating_point() else v.to(side)
                                   for k, v in batch.items()},
                                  Draws(given={"normal_ae": noise}, device=side))
        finally:
            torch.set_default_dtype(torch.float32)
        out[side, dtype] = ({k: float(v) for k, v in metrics.items()},
                            [p.grad.to("cpu", torch.float64) for p in runner.trainable])
    (m32, g32), (mgpu, ggpu), (m64, g64) = out.values()
    for k in m64:
        assert abs(mgpu[k] - m64[k]) <= 1e-4 * abs(m64[k]), k
    for a, c, r in zip(ggpu, g32, g64):
        scale = float(r.abs().max())
        assert float((a - r).abs().max()) <= max(1e-4 * scale, 8 * float((c - r).abs().max()))


def test_cli_neus_trains_and_resumes_on_the_card(dev, tmp_path):
    """``cli neus --device cuda`` at small widths: 2 steps (a checkpoint,
    an in-train eval and the test pass at step 2), then ``--is_continue``
    for 1 step from the step-2 file, whose parameters, Adam moments and
    step the resumed trainer holds bit for bit before it steps."""
    import json
    import os

    from robir_tpu_torch import cli
    from robir_tpu_torch.core import checkpoint as ckpt_lib
    from robir_tpu_torch.core.tree import flatten_with_paths
    from robir_tpu_torch.data.synthetic import make_sphere_dataset
    from robir_tpu_torch.stages import neus_stage

    scene = make_sphere_dataset(str(tmp_path / "scene"), n_train=4, n_test=2, h=16, w=16)
    conf = {"model": {"sdf": {"d_out": 17, "d_hidden": 32, "n_layers": 3, "skip_in": [2],
                              "multires": 2, "bias": 0.5},
                      "color": {"d_feature": 16, "d_hidden": 32, "n_layers": 2}},
            "render": {"n_samples": 16, "n_importance": 16},
            "train": {"batch_size": 64, "eval_every": 2, "ckpt_every": 2, "eval_chunk": 256,
                      "mesh_resolution": 24}}
    conf_path = str(tmp_path / "conf.json")
    with open(conf_path, "w") as f:
        json.dump(conf, f)
    log_dir = str(tmp_path / "logs")
    argv = ["neus", "--conf", conf_path, "--data", scene, "--log_dir", log_dir,
            "--device", "cuda"]
    assert cli.main([*argv, "--n_iters", "2"]).step == 2
    saved = flatten_with_paths(ckpt_lib.load(os.path.join(log_dir, "NeuS",
                                                          "ckpt_000002.npz"))[0])
    held = []
    real = neus_stage.NeusTrainer.restore

    def restore(self, path=None):
        real(self, path)
        held.append(self.state())

    neus_stage.NeusTrainer.restore = restore
    try:
        trainer = cli.main([*argv, "--n_iters", "1", "--is_continue"])
    finally:
        neus_stage.NeusTrainer.restore = real
    assert trainer.step == 3 and sorted(held[0]) == sorted(saved)
    assert all(np.array_equal(held[0][k], saved[k]) for k in saved)
    run_dir = os.path.join(log_dir, "NeuS", "neus")
    with open(os.path.join(run_dir, "description.json")) as f:
        assert json.load(f)["rays_per_sec"] > 0
    assert os.path.exists(os.path.join(run_dir, "meshes", "mesh_000002.ply"))


def test_low_precision_mm_gradients_on_the_card(dev):
    """``low_precision_mm`` on the card (one bf16 GEMM with fp32 sums) and
    its backward against the CPU route on the same operands: the output to
    fp32 summation order, each operand's gradient (rounded to bf16 on both
    sides) within one bf16 step (2^-7) of its largest entry;
    ``visnet_outer_apply`` at
    ``compute_dtype="bfloat16"`` differentiable to its inputs."""
    from robir_tpu_torch.fields.mlp import low_precision_mm
    from robir_tpu_torch.fields.visibility import VisNetConfig, init_visnet, visnet_outer_apply
    g = torch.Generator().manual_seed(0)
    a, b = torch.randn(300, 96, generator=g), torch.randn(96, 40, generator=g)
    w = torch.randn(300, 40, generator=g)
    grads = {}
    for d in ("cpu", dev):
        x, y = a.to(d).requires_grad_(), b.to(d).requires_grad_()
        out = low_precision_mm(x, y, torch.bfloat16)
        grads[str(d)] = (out.detach().cpu(), *[t.cpu() for t in torch.autograd.grad(
            torch.sum(out * w.to(d)), (x, y))])
    cpu, card = grads["cpu"], grads[str(dev)]
    _close(card[0], cpu[0])
    for got, want in zip(card[1:], cpu[1:]):
        assert float((got - want).abs().max()) <= float(want.abs().max()) / 128
    cfg = VisNetConfig(points_multires=3, dirs_multires=3, dims=(32, 32))
    params = {k: {n: t.to(dev) for n, t in v.items()} for k, v in init_visnet(g, cfg).items()}
    p = torch.randn(5, 3, device=dev, requires_grad=True)
    logits = visnet_outer_apply(params, cfg, p, torch.randn(7, 3, device=dev),
                                compute_dtype="bfloat16")
    assert logits.dtype == torch.float32 and logits.shape == (5, 7, 2)
    (gp,) = torch.autograd.grad(logits.sum(), p)
    assert torch.isfinite(gp).all() and float(gp.abs().max()) > 0
