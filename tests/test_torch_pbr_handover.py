"""The stage-2 chain Vis -> PBR -> CESR through checkpoints, in the port and
across the two packages, at the small widths of ``test_torch_cesr.py``:
``PBRRunner.load_vis_checkpoint`` (the indirect and visibility nets) and
``load_norm_checkpoint`` (the normal decoder), and
``CESRRunner.load_pbr_checkpoint`` (all but the runner's own shadow and
normal nets, and the spec-BRDF autoencoder only with latent dropout off),
each on files that either package wrote, read by either package's runner:
the kept leaves are the file's, the others the receiver's own, and the
optimizer starts afresh. Then ``PBRRunner.run`` on the CPU on the grid
tracer, with the guard's switch between compacted and dense steps held to
the JAX runner's ``_pick_step``.

Tolerance: none for the checkpoints (float32 leaves move unchanged, so
every comparison is exact equality).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from robir_tpu.stages import cesr as jcesr
from robir_tpu.stages import pbr as jpbr
from robir_tpu.stages import vis as jvis
from robir_tpu_torch.core import tree as ttree
from robir_tpu_torch.core.draws import Draws
from robir_tpu_torch.core.params import to_numpy
from robir_tpu_torch.data.syn_dataset import shadow_scene
from robir_tpu_torch.stages import cesr as tcesr
from robir_tpu_torch.stages import pbr as tpbr
from robir_tpu_torch.stages import stage2_runner as trunner
from robir_tpu_torch.stages import vis as tvis
from test_torch_cesr import (JCFG, JCFG_GRID, STAGE_KW, TCFG, TCFG_GRID, JSmallCESR,
                             TSmallCESR)


def _tree(seed: int) -> dict:
    """A stage-2 tree (numpy, JAX layout) from the port's init."""
    return to_numpy(trunner.init_stage2_params(torch.Generator().manual_seed(seed), TCFG))


def _flat(tree) -> dict:
    return {k: np.array(v.detach() if torch.is_tensor(v) else v)
            for k, v in ttree.flatten_with_paths(tree).items()}


def _writer(kind: str, stage: str, ds, log_dir: str):
    """A runner of ``stage`` ("Vis" or "PBR") of either package on a tree
    whose every leaf is shifted by 0.5, so that its file tells apart from
    any receiver's init; returns (its saved file, its leaves)."""
    params = jax.tree_util.tree_map(lambda x: x + np.float32(0.5), _tree(1))
    if kind == "port":
        runner = (tvis.VisRunner(TCFG, params, ds, tvis.VisStageConfig(num_pixels=16, nsamp=8),
                                 device="cpu", log_dir=log_dir) if stage == "Vis" else
                  tpbr.PBRRunner(TCFG, params, ds, tpbr.PBRStageConfig(num_pixels=16),
                                 device="cpu", log_dir=log_dir))
    else:
        runner = (jvis.VisRunner(JCFG, params, ds, jvis.VisStageConfig(num_pixels=16, nsamp=8),
                                 log_dir=log_dir) if stage == "Vis" else
                  jpbr.PBRRunner(JCFG, params, ds, jpbr.PBRStageConfig(num_pixels=16),
                                 log_dir=log_dir))
    runner.cur_iter = 4
    return runner.save(), _flat(runner.params)


def _assert_surgery(before: dict, after: dict, saved: dict, keep) -> None:
    """Every leaf of ``after`` is the file's where ``keep`` holds, else the
    runner's own (``before``), bit for bit; some of each kind."""
    assert after.keys() == before.keys()
    for k in after:
        want = saved[k] if keep(k) else before[k]
        assert after[k].dtype == want.dtype and np.array_equal(after[k], want), k
    kept = [k for k in after if keep(k)]
    assert kept and len(kept) < len(after)
    assert all(not np.array_equal(saved[k], before[k]) for k in kept)


def _vis_keep(p: str) -> bool:
    return p.startswith(("indirect_illum_network", "visibility_network"))


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_vis_checkpoint_into_pbr(tmp_path, writer):
    """A Vis file of either package into the port's and JAX's PBR runners:
    the indirect and visibility nets are the file's; a fresh Adam. The same
    file as a Norm checkpoint: the normal decoder only."""
    ds = shadow_scene(n_train=2, h=16, w=16)
    path, saved = _writer(writer, "Vis", ds, str(tmp_path))
    params = _tree(2)
    port = tpbr.PBRRunner(TCFG, params, ds, tpbr.PBRStageConfig(num_pixels=16), device="cpu")
    before, opt = _flat(port.params), port.optimizer
    port.load_vis_checkpoint(path)
    _assert_surgery(before, _flat(port.params), saved, _vis_keep)
    assert port.optimizer is not opt and not port.optimizer.state
    assert {n.split(".")[0] for n, p in port.params.named_parameters()
            if p.requires_grad} == set(tpbr.PBRRunner.TRAINABLE)
    ref = jpbr.PBRRunner(JCFG, params, ds, jpbr.PBRStageConfig(num_pixels=16))
    ref.load_vis_checkpoint(path)
    _assert_surgery(before, _flat(ref.params), saved, _vis_keep)

    norm = tpbr.PBRRunner(TCFG, params, ds, tpbr.PBRStageConfig(num_pixels=16), device="cpu")
    norm.load_norm_checkpoint(path)
    _assert_surgery(before, _flat(norm.params), saved, lambda p: "normal_decoder_layer" in p)


@pytest.mark.parametrize("dropout_iter", [0, -1])
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_pbr_checkpoint_into_cesr(tmp_path, writer, dropout_iter):
    """A PBR file of either package into the port's and JAX's CESR runners:
    every leaf but shadow_net and normal_net is the file's, the spec-BRDF
    autoencoder only with latent dropout off (``dropout_iter`` -1); a fresh
    Adam."""
    ds = shadow_scene(n_train=2, h=16, w=16)
    path, saved = _writer(writer, "PBR", ds, str(tmp_path))
    kw = {**STAGE_KW, "dropout_iter": dropout_iter}

    def keep(p: str) -> bool:
        return (not p.startswith(("shadow_net", "normal_net"))
                and ("spec_brdf" not in p or dropout_iter == -1))

    params = _tree(2)
    port = tcesr.CESRRunner(TCFG, params, ds, TSmallCESR(**kw), device="cpu")
    before, opt = _flat(port.params), port.optimizer
    port.load_pbr_checkpoint(path)
    _assert_surgery(before, _flat(port.params), saved, keep)
    assert port.optimizer is not opt and not port.optimizer.state
    assert any("spec_brdf" in k for k in before)
    ref = jcesr.CESRRunner(JCFG, params, ds, JSmallCESR(**kw))
    ref_before = _flat(ref.params)
    ref.load_pbr_checkpoint(path)
    _assert_surgery(ref_before, _flat(ref.params), saved, keep)
    # the two receivers agree on every leaf but their own inits of the new nets
    got, want = _flat(port.params), _flat(ref.params)
    assert all(np.array_equal(got[k], want[k]) for k in got
               if not k.startswith(("shadow_net", "normal_net")))


@pytest.mark.parametrize("cam_dist,dense_after_guard", [(0.3, True), (2.0, False)])
def test_pbr_runner_switch_matches_jax(cam_dist, dense_after_guard):
    """PBRRunner on the grid tracer (baked on the CPU), 48 pixels at compact
    chunk 16, the surface fraction read every 2 steps: compacted steps
    until the first read; then dense steps while the fraction read is
    above 0.6 (a camera close to the object), compacted below it. Each
    step's choice is the JAX runner's ``_pick_step`` on the same fraction,
    and a compacted step draws its per-row noise for the surface rows
    only. Then ``run(2)``: finite metrics; only the trainable subtrees
    move."""
    ds = shadow_scene(n_train=2, h=16, w=16, cam_dist=cam_dist)
    ds.object_masks = [np.ones_like(m) for m in ds.object_masks]
    params = trunner.init_stage2_params(torch.Generator().manual_seed(0), TCFG_GRID)
    stage = dict(num_pixels=48, compact_chunk=16, guard_every=2)
    runner = tpbr.PBRRunner(TCFG_GRID, params, ds, tpbr.PBRStageConfig(**stage), device="cpu")
    runner.bake_grid()
    jr = jpbr.PBRRunner(JCFG_GRID, to_numpy(params), ds, jpbr.PBRStageConfig(**stage))
    before = {n: p.detach().clone() for n, p in runner.params.named_parameters()}
    compacted = []
    for _ in range(3):
        jr._surface_frac = runner.surface_frac
        compacted.append(runner.step_config().compact_chunk > 0)
        assert compacted[-1] == (jr._pick_step() is jr._step)
        draws = Draws(runner.generator, record=True)
        metrics = runner.step(runner._batch(), draws)
        surface = round(float(metrics["surface_frac"]) * 48)
        assert draws.taken["spec_ae"].shape[0] == (max(surface, 1) if compacted[-1] else 48)
        assert draws.taken["lobe_theta"].shape == (TCFG.envmap.num_lgt_sgs, 32)
    assert compacted == [True, True, not dense_after_guard]
    assert (runner.surface_frac > 0.6) == dense_after_guard
    metrics = runner.run(2)
    assert runner.cur_iter == 5 and set(metrics) == {
        "loss", "rgb_loss", "kl", "smooth", "white", "psnr", "surface_frac"}
    assert all(np.isfinite(v) for v in metrics.values()), metrics
    for n, p in runner.params.named_parameters():
        if n.split(".")[0] not in tpbr.PBRRunner.TRAINABLE:
            assert not p.requires_grad and torch.equal(p.detach(), before[n]), n
    assert not torch.equal(runner.params["envmap_material_network"]["lgtSGs"].detach(),
                           before["envmap_material_network.lgtSGs"])


def test_stage_config_reads_the_pbr_section():
    """configs/hotdog.json's ``pbr`` section as the JAX loader reads it;
    unknown keys raise."""
    from robir_tpu.core import config as jconfig
    from robir_tpu_torch.core import config as tconfig

    raw = tconfig.load_config("configs/hotdog.json")
    got = tconfig.build_stage_config(tpbr.PBRStageConfig, raw["pbr"])
    want = jconfig.build_stage_config(jpbr.PBRStageConfig, raw["pbr"])
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert (got.num_pixels, got.compact_chunk, got.use_normal_map) == (1024, 128, True)
    with pytest.raises(KeyError):
        tconfig.build_stage_config(tpbr.PBRStageConfig, {"no_such_key": 1})
