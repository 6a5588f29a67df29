"""The port's CESR stage against the JAX package: the two CESR nets and one
whole dense CESR step (loss and every trainable gradient) in a warmup and
an explore step, at small widths, on bridged weights and the draws the
JAX step makes from its key; the runner through its schedule on the CPU,
and its switch between compacted and dense steps against the JAX
runner's. (The row-mode step on the grid tracer:
``test_torch_cesr_rows.py``; the stage-2 model, losses, optimizer and
scene: ``test_torch_stage2_model.py``.)

Tolerances: 1e-5 on forward values (fp32, other summation order); the
whole step's loss and metrics to 1e-5 relative. Gradients to rtol 5e-4
with a flat atol of 3e-3 of each tensor's largest entry: the CESR nets
read a 10-band positional encoding (sin/cos of arguments up to ~500 rad),
and on ``test_cesr_nets_match_jax``'s case the normal net's first layers'
gradients are up to 8e-4 (port) and 5e-4 (JAX) of the largest entry from
the fp64 gradient, and up to 1.4e-3 apart once XLA fuses the JAX side. A
zeroed or sign-flipped gradient misses that bound by over 300x.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from robir_tpu.core import tree as jtree
from robir_tpu.fields import sdf as jsdf
from robir_tpu.fields.envmap_material import EnvmapMaterialConfig as JEnv
from robir_tpu.fields.neus_model import NeuSConfig as JNeuS
from robir_tpu.fields.radiance import RenderingConfig as JRender
from robir_tpu.fields.visibility import IndirIllumConfig as JIndir
from robir_tpu.fields.visibility import VisNetConfig as JVis
from robir_tpu.render.color import ToneMapConfig as JTone
from robir_tpu.render.stage2 import Stage2Config as JStage2Config
from robir_tpu.render.stage2 import Stage2Model as JStage2Model
from robir_tpu.stages import cesr as jcesr
from robir_tpu.stages import stage2_runner as jrunner
from robir_tpu.tracing import grid as jg
from robir_tpu_torch.core import tree as ttree
from robir_tpu_torch.core.draws import Draws
from robir_tpu_torch.core.params import freeze, from_jax, to_numpy
from robir_tpu_torch.data.syn_dataset import shadow_scene
from robir_tpu_torch.fields import sdf as tsdf
from robir_tpu_torch.fields.envmap_material import EnvmapMaterialConfig
from robir_tpu_torch.fields.neus_model import NeuSConfig
from robir_tpu_torch.fields.radiance import RenderingConfig
from robir_tpu_torch.fields.visibility import IndirIllumConfig, VisNetConfig
from robir_tpu_torch.render.color import ToneMapConfig
from robir_tpu_torch.render.cuda import fused_mlp as tfm
from robir_tpu_torch.render.stage2 import Stage2Config
from robir_tpu_torch.stages import cesr as tcesr
from robir_tpu_torch.stages import stage2_runner as trunner
from robir_tpu_torch.tracing import grid as tg
from torch_port_helpers import assert_close, grab_grads, jax_stage2_draws, to_t

N_LIGHTS = 8
GRAD_ATOL = 3e-3  # of each gradient's largest entry
NET = dict(d_hidden=96, n_layers=3, skip_in=(2,), multires=0)  # 63 + 33 at the skip


def _stage2_kw(neus, render, sdf, env, indir, vis, tone):
    return dict(
        neus=neus(sdf=sdf(d_out=33, d_hidden=32, n_layers=3, skip_in=(2,), multires=3),
                  color=render(d_feature=32, d_hidden=32, n_layers=2)),
        envmap=env(multires=3, num_lgt_sgs=N_LIGHTS, encoder_dims=(48, 48),
                   decoder_dims=(24,), latent_dim=8),
        indirect=indir(multires=3, dims=(32, 32), num_lgt_sgs=6),
        visnet=vis(points_multires=3, dirs_multires=3, dims=(32, 32)),
        tonemap=tone(hdr_mode=0), tracer="sphere")


JCFG = JStage2Config(**_stage2_kw(JNeuS, JRender, jsdf.SDFConfig, JEnv, JIndir, JVis, JTone))
TCFG = Stage2Config(**_stage2_kw(NeuSConfig, RenderingConfig, tsdf.SDFConfig,
                                 EnvmapMaterialConfig, IndirIllumConfig, VisNetConfig,
                                 ToneMapConfig))
# the grid tracer at configs/hotdog.json's settings, at a small resolution
GRID_KW = dict(resolution=32, max_steps=64, storage_dtype="bfloat16", quad_rows=True)
JCFG_GRID = dataclasses.replace(JCFG, tracer="grid", grid=jg.GridConfig(**GRID_KW))
TCFG_GRID = dataclasses.replace(TCFG, tracer="grid", grid=tg.GridConfig(**GRID_KW))


@dataclasses.dataclass(frozen=True)
class JSmallCESR(jcesr.CESRStageConfig):
    @property
    def shadow_cfg(self):
        return jsdf.SDFConfig(d_in=63 + self.num_lights, d_out=2, **NET)

    @property
    def normal_cfg(self):
        return jsdf.SDFConfig(d_in=63, d_out=3, **NET)


@dataclasses.dataclass(frozen=True)
class TSmallCESR(tcesr.CESRStageConfig):
    @property
    def shadow_cfg(self):
        return tsdf.SDFConfig(d_in=63 + self.num_lights, d_out=2, **NET)

    @property
    def normal_cfg(self):
        return tsdf.SDFConfig(d_in=63, d_out=3, **NET)


STAGE_KW = dict(num_pixels=48, num_lights=N_LIGHTS, warmup_iters=2, explore_iter=4,
                proj_iter=1, normal_switch_iter=3, dropout_iter=5)


def shared_params():
    """One weight tree for both packages (numpy, JAX layout), from the
    port's init (the JAX init's distributions are held to it in
    ``test_torch_stage2_fields.py``): stage 2 plus the two CESR nets."""
    gen = torch.Generator().manual_seed(0)
    tree = trunner.init_stage2_params(gen, TCFG)
    stage = TSmallCESR(**STAGE_KW)
    tree["shadow_net"] = tsdf.init_sdf(gen, stage.shadow_cfg)
    tree["normal_net"] = tsdf.init_sdf(gen, stage.normal_cfg)
    return to_numpy(tree)


@pytest.fixture(scope="module")
def case():
    """The shared weights, the JAX stage config, the shadow scene and a
    pixel batch of it."""
    ds = shadow_scene(n_train=3, h=40, w=40)
    batch = ds.sample_pixels(np.random.default_rng(2), 1, 48)
    return shared_params(), JSmallCESR(compact_chunk=0, **STAGE_KW), ds, batch


def shared_grid(params):
    """JAX's grid baked from the shared NeuS (JCFG_GRID), and the same
    values as a tensor, for both packages to march."""
    jgrid = jg.build_sdf_grid(JStage2Model(params, JCFG_GRID).sdf, JCFG_GRID.grid)
    return jgrid, torch.as_tensor(np.array(jgrid.astype(jnp.float32))).to(torch.bfloat16)


def test_cesr_nets_match_jax(case):
    """shadow_net_vis (hand-factorised, plain PyTorch) and normal_net_apply
    (K1 and K2's plain versions): forward and parameter gradients."""
    params, jstage, _, batch = case
    tstage = TSmallCESR(**STAGE_KW)
    x = (0.3 * np.random.default_rng(8).standard_normal((21, 3))).astype(np.float32)
    w = np.random.default_rng(9).standard_normal((21, N_LIGHTS + 3)).astype(np.float32)

    def jloss(p):
        vis = jcesr.shadow_net_vis(p["shadow_net"], jstage, jnp.asarray(x), N_LIGHTS)
        nrm = jcesr.normal_net_apply(p["normal_net"], jstage, jnp.asarray(x))
        return jnp.sum(jnp.concatenate([vis, nrm], -1) * w), (vis, nrm)

    sub = {k: params[k] for k in ("shadow_net", "normal_net")}
    (_, (jvis, jnrm)), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(sub)
    tp = from_jax(sub)
    vis = tcesr.shadow_net_vis(tp["shadow_net"], tstage, to_t(x), N_LIGHTS)
    nrm = tcesr.normal_net_apply(tp["normal_net"], tstage, to_t(x))
    assert_close(vis, jvis, rtol=1e-5, atol=1e-5)
    assert_close(nrm, jnrm, rtol=1e-5, atol=1e-5)
    before = tfm.FORWARD.launches
    torch.sum(torch.cat([vis, nrm], -1) * to_t(w)).backward()
    assert tfm.FORWARD.launches == before  # CPU tensors: the plain versions
    flat = jtree.flatten_with_paths(jg)
    for path, leaf in ttree.flatten_with_paths(tp).items():
        scale = float(np.abs(flat[path]).max())
        assert_close(leaf.grad, flat[path], rtol=5e-4, atol=GRAD_ATOL * scale, what=path)


SPEC_VAR = (np.arange(8) % 4 == 2).astype(np.float32)
BATCH_KEYS = ("points", "dirs", "object_mask", "rgb")


def jax_step(params, cfg, jstage, batch, key, prefit, use_new_normal, use_rgb_loss,
             grid=None):
    """(gradients, metrics) of one JAX CESR step."""
    trainable, frozen = jrunner.split_params(params, jcesr.CESRRunner.TRAINABLE)
    step = jcesr.make_cesr_step(cfg, jstage, grab_grads())
    jbatch = {k: jnp.asarray(batch[k]) for k in BATCH_KEYS}
    _, grads, metrics = step(trainable, frozen, None, grid, jnp.asarray(SPEC_VAR), jbatch,
                             key, prefit=prefit, use_new_normal=use_new_normal,
                             use_rgb_loss=use_rgb_loss)
    return grads, metrics


def port_step(params, cfg, tstage, batch, draws, prefit, use_new_normal, use_rgb_loss,
              grid=None):
    """(loss, metrics, parameter tree with gradients) of one port step."""
    tparams = from_jax(params)
    freeze(tparams, tcesr.CESRRunner.TRAINABLE)
    tbatch = {k: torch.as_tensor(batch[k]) for k in BATCH_KEYS}
    loss, metrics = tcesr.cesr_loss(tparams, cfg, tstage, to_t(SPEC_VAR), tbatch,
                                    Draws(given={k: to_t(v) for k, v in draws.items()}),
                                    prefit, use_new_normal, use_rgb_loss, grid_values=grid)
    loss.backward()
    return loss, metrics, tparams


def assert_step_matches(tmetrics, tparams, metrics, jgrads):
    """Loss and metrics to 1e-5 relative; each trainable gradient to rtol
    5e-4 and GRAD_ATOL of its largest entry."""
    assert 0 < float(tmetrics["surface_frac"]) < 1
    assert float(tmetrics["surface_frac"]) == pytest.approx(float(metrics["surface_frac"]))
    for name in metrics:
        assert_close(tmetrics[name].detach(), metrics[name], rtol=1e-5, atol=1e-7, what=name)
    flat = jtree.flatten_with_paths(jgrads)
    got = {p: leaf for p, leaf in ttree.flatten_with_paths(tparams).items()
           if leaf.requires_grad}
    assert got.keys() == flat.keys()
    for path, leaf in got.items():
        want = np.asarray(flat[path])
        scale = float(np.abs(want).max())
        if scale == 0:
            assert leaf.grad is None or not leaf.grad.any(), path
            continue
        assert_close(leaf.grad, want, rtol=5e-4, atol=GRAD_ATOL * scale, what=path)


@pytest.mark.parametrize("prefit,use_new_normal,use_rgb_loss", [
    ("warmup", False, False), ("explore", True, True)])
def test_cesr_step_matches_jax(case, prefit, use_new_normal, use_rgb_loss):
    """One dense CESR step: the loss and the gradient of every trainable
    leaf (gamma, the envmap/material heads, shadow_net, normal_net)."""
    params, jstage, _, batch = case
    key = jax.random.PRNGKey(10)
    jgrads, metrics = jax_step(params, JCFG, jstage, batch, key, prefit, use_new_normal,
                               use_rgb_loss)
    _, tmetrics, tparams = port_step(params, TCFG, TSmallCESR(compact_chunk=0, **STAGE_KW),
                                     batch, jax_stage2_draws(key, 48, JCFG, N_LIGHTS),
                                     prefit, use_new_normal, use_rgb_loss)
    assert_step_matches(tmetrics, tparams, metrics, jgrads)


def test_runner_trains_through_the_schedule():
    """CESRRunner on the CPU: warmup, explore and project steps, the normal
    switch and a dropout resample; finite losses; frozen subtrees
    unchanged, trainable ones moved."""
    params = trunner.init_stage2_params(torch.Generator().manual_seed(0), TCFG)
    stage = TSmallCESR(**STAGE_KW)
    runner = tcesr.CESRRunner(TCFG, params, shadow_scene(n_train=3, h=40, w=40), stage,
                              device="cpu")
    before = {n: p.detach().clone() for n, p in runner.params.named_parameters()}
    phases = []
    for _ in range(7):
        phases.append(stage.prefit_option(runner.cur_iter))
        metrics = runner.run(1)
        assert all(np.isfinite(v) for v in metrics.values()), metrics
    assert {"warmup", "explore", "project"} <= set(phases)
    assert runner.spec_var.shape == (8,) and set(runner.spec_var.tolist()) <= {0.0, 1.0}
    for n, p in runner.params.named_parameters():
        moved = not torch.equal(p.detach(), before[n])
        top = n.split(".")[0]
        if top in ("implicit_network", "indirect_illum_network", "visibility_network"):
            assert not moved and not p.requires_grad, n
    assert any(not torch.equal(p.detach(), before[n])
               for n, p in runner.params.named_parameters() if n.startswith("normal_net."))


@pytest.mark.parametrize("cam_dist,dense_after_guard", [(0.3, True), (2.0, False)])
def test_runner_switch_matches_jax(cam_dist, dense_after_guard):
    """CESRRunner on the grid tracer, 48 pixels at compact chunk 16, the
    surface fraction read every 2 steps: compacted steps until the first
    read; then dense steps while the fraction read is above 0.6 (a camera
    close to the object: most pixels on its surface), compacted steps below
    it. Each step's choice is the JAX runner's ``_pick_step`` on the same
    fraction, and a compacted step draws its per-row noise for the surface
    rows only (for row 0 where there is none)."""
    ds = shadow_scene(n_train=2, h=16, w=16, cam_dist=cam_dist)
    ds.object_masks = [np.ones_like(m) for m in ds.object_masks]
    params = trunner.init_stage2_params(torch.Generator().manual_seed(0), TCFG_GRID)
    kw = {**STAGE_KW, "compact_chunk": 16, "guard_every": 2}
    runner = tcesr.CESRRunner(TCFG_GRID, params, ds, TSmallCESR(**kw), device="cpu")
    runner.bake_grid()
    jr = jcesr.CESRRunner(JCFG_GRID, to_numpy(params), ds, JSmallCESR(**kw))
    compacted = []
    for _ in range(5):
        jr._surface_frac = runner.surface_frac
        compacted.append(runner.step_config().compact_chunk > 0)
        assert compacted[-1] == (jr._pick_step() is jr._step)
        draws = Draws(runner.generator, record=True)
        metrics = runner.step(runner._batch(), draws)
        rows = draws.taken["spec_ae"].shape[0]
        surface = round(float(metrics["surface_frac"]) * 48)
        assert rows == (max(surface, 1) if compacted[-1] else 48)
    assert compacted == [True, True] + [not dense_after_guard] * 3
    assert (runner.surface_frac > 0.6) == dense_after_guard
