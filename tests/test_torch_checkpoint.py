"""The port's checkpoints against the JAX package's: a file written by either
package restores into the other bit for bit; ``keep`` and
``ignore_unknown`` filter as in JAX, and an unknown path raises; a JAX
stage-1 trainer checkpoint seeds the port's stage 2 and the port's stage-1
file resumes a JAX trainer; a stage-2 runner's ``save``,
``restore_latest`` and ``restore_surgical`` (read by the JAX runner too).

Tolerance: none. Checkpoints move float32 leaves unchanged, so every
comparison is exact equality.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robir_tpu.core import checkpoint as jckpt
from robir_tpu.core import tree as jtree
from robir_tpu.fields.neus_model import NeuSConfig as JNeuS
from robir_tpu.fields.radiance import RenderingConfig as JRender
from robir_tpu.fields.sdf import SDFConfig as JSDF
from robir_tpu.render.neus import NeusRenderConfig as JRenderCfg
from robir_tpu.render.stage2 import Stage2Model as JStage2Model
from robir_tpu.stages import neus_stage as jneus
from robir_tpu.stages import stage2_runner as jrunner
from robir_tpu.stages import vis as jvis
from robir_tpu_torch.core import checkpoint as tckpt
from robir_tpu_torch.core import tree as ttree
from robir_tpu_torch.core.params import from_jax, to_numpy
from robir_tpu_torch.data.syn_dataset import shadow_scene
from robir_tpu_torch.data.synthetic import make_sphere_scene
from robir_tpu_torch.fields.neus_model import NeuSConfig
from robir_tpu_torch.fields.radiance import RenderingConfig
from robir_tpu_torch.fields.sdf import SDFConfig
from robir_tpu_torch.render.neus import NeusRenderConfig
from robir_tpu_torch.render.stage2 import Stage2Model
from robir_tpu_torch.stages import neus_stage as tneus
from robir_tpu_torch.stages import stage2_runner as trunner
from robir_tpu_torch.stages import vis as tvis
from test_torch_cesr import JCFG, TCFG
from torch_port_helpers import to_t


def _tree():
    """A stage-2 tree (numpy, JAX layout) from the port's init."""
    return to_numpy(trunner.init_stage2_params(torch.Generator().manual_seed(3), TCFG))


def _flat_np(tree):
    return {k: np.asarray(v.detach() if torch.is_tensor(v) else v)
            for k, v in ttree.flatten_with_paths(tree).items()}


def _zeros_like(tree):
    return jax.tree_util.tree_map(np.zeros_like, tree)


def _assert_equal(got, want):
    got, want = _flat_np(got), _flat_np(want)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k


def test_jax_file_restores_into_the_port_bit_exact(tmp_path):
    tree = _tree()
    path = str(tmp_path / "jax.npz")
    jckpt.save(path, jax.tree_util.tree_map(jnp.asarray, tree), step=7, extra={"a": 1})
    base = from_jax(_zeros_like(tree))
    ids = [id(p) for p in base.parameters()]
    got, meta = tckpt.restore_into(base, path)
    assert got is base and [id(p) for p in base.parameters()] == ids  # in place
    assert meta == {"step": 7, "extra": {"a": 1}}
    _assert_equal(base, tree)
    loaded, _ = tckpt.load(path)
    _assert_equal(loaded, tree)


def test_port_file_restores_into_jax_bit_exact(tmp_path):
    tree = _tree()
    path = str(tmp_path / "port.npz")
    tckpt.save(path, from_jax(tree), step=11)
    assert not os.path.exists(path + ".tmp")
    got, meta = jckpt.restore_into(jax.tree_util.tree_map(jnp.zeros_like, tree), path)
    assert meta["step"] == 11
    _assert_equal(jax.tree_util.tree_map(np.asarray, got), tree)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_keep_filters_as_in_jax(tmp_path, writer):
    """Only the kept paths change, in both packages, from either's file."""
    tree = _tree()
    path = str(tmp_path / "ckpt.npz")
    if writer == "jax":
        jckpt.save(path, tree)
    else:
        tckpt.save(path, from_jax(tree))
    keep = lambda p: p.startswith("visibility_network/") or p.endswith("/b")  # noqa: E731
    base = _zeros_like(tree)
    want, _ = jckpt.restore_into(jax.tree_util.tree_map(jnp.asarray, base), path, keep=keep)
    got, _ = tckpt.restore_into(from_jax(base), path, keep=keep)
    merged_dict, _ = tckpt.restore_into(base, path, keep=keep)
    want = _flat_np(jax.tree_util.tree_map(np.asarray, want))
    _assert_equal(got, want)
    _assert_equal(merged_dict, want)
    full = _flat_np(tree)
    for k, v in _flat_np(got).items():
        assert np.array_equal(v, full[k] if keep(k) else np.zeros_like(v)), k


def test_unknown_paths_raise_unless_ignored(tmp_path):
    """A file with a path the base lacks: KeyError in both packages; with
    ``ignore_unknown`` both skip it and restore the rest. A leaf of another
    shape raises ValueError in the port."""
    tree = _tree()
    path = str(tmp_path / "extra.npz")
    jckpt.save(path, {**tree, "shadow_net": {"lin0": {"w": np.ones((2, 3), np.float32)}}})
    base = _zeros_like(tree)
    with pytest.raises(KeyError):
        jckpt.restore_into(jax.tree_util.tree_map(jnp.asarray, base), path)
    with pytest.raises(KeyError):
        tckpt.restore_into(from_jax(base), path)
    want, _ = jckpt.restore_into(jax.tree_util.tree_map(jnp.asarray, base), path,
                                 ignore_unknown=True)
    got, _ = tckpt.restore_into(from_jax(base), path, ignore_unknown=True)
    _assert_equal(got, jax.tree_util.tree_map(np.asarray, want))
    _assert_equal(got, tree)
    bad = _zeros_like(tree)
    bad["gamma"]["adapt_illum"] = np.zeros(2, np.float32)
    with pytest.raises(ValueError):
        tckpt.restore_into(from_jax(bad), path, ignore_unknown=True)


def test_step_paths_match_jax(tmp_path):
    d = str(tmp_path)
    assert tckpt.latest_path(d) is None and tckpt.latest_path(d + "/none") is None
    for step in (5, 120, 40):
        tckpt.save(tckpt.step_path(d, step), {"x": np.zeros(1)}, step=step)
    open(os.path.join(d, "latest.npz"), "wb").close()
    assert tckpt.step_path(d, 5) == jckpt.step_path(d, 5)
    assert tckpt.latest_path(d) == jckpt.latest_path(d) == jckpt.step_path(d, 120)


NEUS_KW = dict(sdf=dict(d_out=33, d_hidden=32, n_layers=3, skip_in=(2,), multires=3),
               color=dict(d_feature=32, d_hidden=32, n_layers=2))


def test_jax_stage1_checkpoint_seeds_the_port_stage2(tmp_path):
    """A JAX ``NeusTrainer.save`` file (params and Adam state) becomes the
    port's ``implicit_network``: the same leaves, and the stage-2 bridge's
    sdf on them equals the JAX stage-2 model's."""
    cfg = JNeuS(sdf=JSDF(**NEUS_KW["sdf"]), color=JRender(**NEUS_KW["color"]))
    trainer = jneus.NeusTrainer(None, cfg, JRenderCfg(), jneus.NeusTrainConfig(),
                                log_dir=str(tmp_path), seed=4)
    trainer.step = 30
    trainer.save()
    neus = trunner.load_neus_checkpoint(str(tmp_path))
    _assert_equal(neus, jax.tree_util.tree_map(np.asarray, trainer.params))
    assert trunner.load_neus_checkpoint(jckpt.step_path(str(tmp_path), 30)).keys() == neus.keys()
    with pytest.raises(FileNotFoundError):
        trunner.load_neus_checkpoint(str(tmp_path / "empty"))
    params = trunner.init_stage2_params(torch.Generator().manual_seed(0), TCFG)
    params["implicit_network"] = neus
    x = (0.4 * np.random.default_rng(0).standard_normal((17, 3))).astype(np.float32)
    want = JStage2Model(to_numpy(from_jax(params)), JCFG).sdf(jnp.asarray(x))
    got = Stage2Model(params, TCFG, "cpu").sdf(to_t(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


def test_port_stage1_checkpoint_resumes_a_jax_trainer(tmp_path):
    """The port's ``NeusTrainer.save``: ``params/...``, the step and the
    Adam state in the JAX trainer's layout (``opt_state/...``; zero moments
    before the first update), all of which a JAX trainer restores."""
    tcfg = NeuSConfig(sdf=SDFConfig(**NEUS_KW["sdf"]), color=RenderingConfig(**NEUS_KW["color"]))
    trainer = tneus.NeusTrainer(make_sphere_scene("train", n_train=2, h=8, w=8), tcfg,
                                NeusRenderConfig(), tneus.NeusTrainConfig(), seed=1,
                                device="cpu", log_dir=str(tmp_path))
    trainer.step = 12
    path = trainer.save()
    assert path == jckpt.step_path(str(tmp_path), 12)
    with pytest.raises(ValueError):
        tneus.NeusTrainer(trainer.scene, tcfg, NeusRenderConfig(), tneus.NeusTrainConfig(),
                          device="cpu").save()
    jcfg = JNeuS(sdf=JSDF(**NEUS_KW["sdf"]), color=JRender(**NEUS_KW["color"]))
    jt = jneus.NeusTrainer(None, jcfg, JRenderCfg(), jneus.NeusTrainConfig(), log_dir=str(tmp_path),
                           seed=9)
    jt.restore()
    assert jt.step == 12
    _assert_equal(jax.tree_util.tree_map(np.asarray, jt.params), to_numpy(trainer.model.params))
    saved = trainer.state()
    restored = jtree.flatten_with_paths(jtree.to_plain(jt.opt_state))
    assert sorted(f"opt_state/{k}" for k in restored) == sorted(
        k for k in saved if k.startswith("opt_state/"))
    for k, v in restored.items():
        assert np.array_equal(np.asarray(v), saved[f"opt_state/{k}"]), k
    assert int(restored["0/count"]) == int(restored["1/count"]) == 12


def test_runner_checkpoints(tmp_path):
    """A Vis runner's ``save`` (a step file and ``latest.npz``) restores bit
    for bit into a fresh runner and into the JAX runner; ``restore_surgical``
    changes only the kept leaves; both rebuild the optimizers with fresh
    moments over the restored parameters."""
    params = trunner.init_stage2_params(torch.Generator().manual_seed(0), TCFG)
    ds = shadow_scene(n_train=2, h=16, w=16)
    stage = tvis.VisStageConfig(num_pixels=16, nsamp=8)
    runner = tvis.VisRunner(TCFG, params, ds, stage, device="cpu", log_dir=str(tmp_path))
    with torch.no_grad():
        for p in runner.params.parameters():
            p.add_(0.5)
    runner.cur_iter = 3
    path = runner.save()
    assert path == os.path.join(str(tmp_path), "Vis", "checkpoints", "ckpt_000003.npz")
    assert os.path.exists(os.path.join(str(tmp_path), "Vis", "checkpoints", "latest.npz"))

    fresh = tvis.VisRunner(TCFG, params, ds, stage, device="cpu", log_dir=str(tmp_path))
    old_opt = fresh.vis_opt
    assert fresh.restore_latest() and fresh.cur_iter == 3
    _assert_equal(fresh.params, runner.params)
    assert fresh.vis_opt is not old_opt and not fresh.vis_opt.state
    assert [n for n, p in fresh.params.named_parameters() if p.requires_grad] == [
        n for n, p in runner.params.named_parameters() if p.requires_grad]
    assert not tvis.VisRunner(TCFG, params, ds, stage, device="cpu",
                              log_dir=str(tmp_path / "none")).restore_latest()

    jr = jvis.VisRunner(JCFG, to_numpy(params), ds, jvis.VisStageConfig(num_pixels=16, nsamp=8),
                        log_dir=str(tmp_path))
    assert jr.restore_latest() and jr.cur_iter == 3
    _assert_equal(jax.tree_util.tree_map(np.asarray, jr.params), runner.params)

    surgical = tvis.VisRunner(TCFG, params, ds, stage, device="cpu")
    keep = lambda p: "normal_decoder_layer" in p  # noqa: E731
    surgical.restore_surgical(path, keep)
    before = _flat_np(params)
    for k, v in _flat_np(surgical.params).items():
        assert np.array_equal(v, before[k] + 0.5 if keep(k) else before[k]), k
    assert any(keep(k) for k in before)
    ref = jrunner.Stage2RunnerBase(JCFG, to_numpy(params))
    ref.params, _ = jckpt.restore_into(ref.params, path, keep=keep)
    _assert_equal(surgical.params, jax.tree_util.tree_map(np.asarray, ref.params))
