"""The port's Norm stage (``stages/norm.py``) against the JAX package's, at
the small widths of ``test_torch_cesr.py`` on bridged weights: one step
(``NormRunner.step``) against ``make_norm_step`` before and after
``smooth_after``, with JAX's draw replayed (the normal AE's input noise,
from the step's key): the loss and metrics, the normal decoder's gradients
and its weights after the Adam update; the runner's batches against the
JAX runner's for one seed; Norm checkpoints written by either package read
into the other's Vis parameters (as ``robir_tpu/cli.py:cmd_vis`` restores
them) and by its ``PBRRunner.load_norm_checkpoint``; ``get_neus_surface``
against JAX's; and the runner through its smoothness switch on the CPU.

Tolerances: the loss and metrics to 1e-5 relative, except
``smooth_loss``, which is held to the port's loss in fp64 on the same
inputs: it is the mean |difference| of two unit vectors about 5e-4
apart, so the fp32 rounding of its unit-scale terms (6e-8) is ~1e-4 of it.
JAX's fp32 value lies 2.9e-6 and 1.6e-5 of it from fp64 (before and after
the switch), the port's 1.1e-5 and 3.2e-5; so the port's is held within
8x JAX's own distance (or 1e-5 relative), and JAX's within 1e-4 relative
of the fp64 loss, which ties that loss to JAX's formula. Gradients to rtol 5e-4
with an atol of 5e-4 of each tensor's largest entry; the weights after one
Adam step (lr 5e-4) to 1e-6; ``get_neus_surface`` to 1e-5; checkpoints
and batches exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robir_tpu.core import checkpoint as jckpt
from robir_tpu.core import tree as jtree
from robir_tpu.render.stage2 import Stage2Model as JStage2Model
from robir_tpu.stages import norm as jnorm
from robir_tpu.stages import pbr as jpbr
from robir_tpu.stages import stage2_runner as jrunner
from robir_tpu.texture import focus_sampler as jfs
from robir_tpu_torch.core import checkpoint as tckpt
from robir_tpu_torch.core import tree as ttree
from robir_tpu_torch.core.draws import Draws
from robir_tpu_torch.core.params import to_numpy
from robir_tpu_torch.data.syn_dataset import shadow_scene
from robir_tpu_torch.render.stage2 import Stage2Model
from robir_tpu_torch.stages import norm as tnorm
from robir_tpu_torch.stages import pbr as tpbr
from robir_tpu_torch.stages import stage2_runner as trunner
from robir_tpu_torch.stages import vis as tvis
from robir_tpu_torch.texture import focus_sampler as tfs
from test_torch_cesr import JCFG, TCFG
from test_torch_vis_step import _recording_adam
from torch_port_helpers import assert_close, two_sphere_tex_sampler

N, SMOOTH, KEY = 64, 3, 5
DECODER = "envmap_material_network/normal_decoder_layer"


def _params(seed: int = 0) -> dict:
    return to_numpy(trunner.init_stage2_params(torch.Generator().manual_seed(seed), TCFG))


def _batch(seed: int) -> dict:
    """Points near a sphere of radius 0.25, unit normals near the radial
    ones, a quarter of them masked out."""
    rng = np.random.default_rng(seed)
    d = rng.standard_normal((N, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    n = d + 0.1 * rng.standard_normal((N, 3))
    return {"points": (0.25 * d).astype(np.float32),
            "normals": (n / np.linalg.norm(n, axis=-1, keepdims=True)).astype(np.float32),
            "object_mask": rng.random(N) > 0.25}


def _metrics_fp64(params: dict, batch: dict, noise: np.ndarray, cur_iter: int) -> dict:
    """The port's Norm loss metrics in fp64 on ``params``, ``batch`` and the
    normal AE's ``noise``."""
    runner = tnorm.NormRunner(TCFG, params, None,
                              tnorm.NormStageConfig(num_pixels=N, smooth_after=SMOOTH),
                              device="cpu")
    runner.params.to(torch.float64)
    inp = {k: torch.as_tensor(v, dtype=torch.float64) if v.dtype.kind == "f"
           else torch.as_tensor(v) for k, v in batch.items()}
    draws = Draws(given={"normal_ae": torch.tensor(noise, dtype=torch.float64)})
    _, metrics = tnorm.norm_loss(runner.params, TCFG, runner.stage_cfg, inp, cur_iter, draws)
    return {k: float(v) for k, v in metrics.items()}


@pytest.mark.parametrize("cur_iter", [0, SMOOTH + 1])
def test_norm_step_matches_jax(cur_iter):
    """Before the smoothness switch (the loss is the MSE) and after it (MSE
    + L1 to the perturbed twin): metrics, gradients, updated weights."""
    params, batch = _params(), _batch(cur_iter)
    key = jax.random.PRNGKey(KEY)
    opt = _recording_adam()
    trainable, frozen = jrunner.split_params(params, jnorm.NormRunner.TRAINABLE)
    step = jnorm.make_norm_step(JCFG, jnorm.NormStageConfig(num_pixels=N, smooth_after=SMOOTH),
                                opt)
    new, state, metrics = step(trainable, frozen, opt.init(trainable),
                               {k: jnp.asarray(v) for k, v in batch.items()},
                               jnp.asarray(cur_iter, jnp.int32), key)
    noise = np.asarray(jax.random.normal(key, TCFG.envmap.normal_ae.noise_shape(N)))

    runner = tnorm.NormRunner(TCFG, params, None,
                              tnorm.NormStageConfig(num_pixels=N, smooth_after=SMOOTH),
                              device="cpu")
    runner.cur_iter = cur_iter
    got = runner.step({k: torch.as_tensor(v) for k, v in batch.items()},
                      Draws(given={"normal_ae": torch.tensor(noise)}))
    ref = _metrics_fp64(params, batch, noise, cur_iter)
    for k, v in metrics.items():
        want, own = float(v), abs(float(v) - ref[k])
        assert own <= 1e-4 * abs(ref[k]), (k, want, ref[k])
        if k == "smooth_loss":
            assert abs(float(got[k]) - ref[k]) <= max(1e-5 * abs(ref[k]), 8 * own), \
                (k, float(got[k]), want, ref[k])
        else:
            assert_close(got[k], want, rtol=1e-5, atol=1e-8, what=k)
    want_loss = float(metrics["normal_loss"]) + (cur_iter > SMOOTH) * float(
        metrics["smooth_loss"])
    assert float(metrics["loss"]) == pytest.approx(want_loss, rel=1e-6)
    assert float(metrics["smooth_loss"]) > 0 and runner.cur_iter == cur_iter + 1

    grads = jtree.flatten_with_paths(state[1])
    new = jtree.flatten_with_paths(new)
    trained = {p: leaf for p, leaf in ttree.flatten_with_paths(runner.params).items()
               if leaf.requires_grad}
    assert trained.keys() == grads.keys() and all(p.startswith(DECODER) for p in trained)
    for path, leaf in trained.items():
        g = np.asarray(grads[path])
        assert np.abs(g).max() > 0, path
        assert_close(leaf.grad, g, rtol=5e-4, atol=5e-4 * np.abs(g).max(), what=path)
        assert_close(leaf, new[path], rtol=0, atol=1e-6, what=path)
    before = ttree.flatten_with_paths(params)
    for path, leaf in ttree.flatten_with_paths(runner.params).items():
        if path not in trained:
            assert np.array_equal(leaf.detach().numpy(), before[path]), path


@pytest.fixture(scope="module")
def tex_sampler(tmp_path_factory):
    return two_sphere_tex_sampler(str(tmp_path_factory.mktemp("norm")), resolution=128)


def test_runner_batches_as_jax(tex_sampler):
    """The same seed gives the JAX runner's batches (its float32 device
    arrays)."""
    port = tnorm.NormRunner(TCFG, _params(), tfs.TexSpaceSampler(tex_sampler, None, None,
                                                                  device="cpu"),
                            tnorm.NormStageConfig(num_pixels=N), seed=3, device="cpu")
    ref = jnorm.NormRunner(JCFG, _params(), jfs.TexSpaceSampler(tex_sampler, None, None),
                           jnorm.NormStageConfig(num_pixels=N), seed=3)
    for _ in range(3):
        got, want = port._batch(), ref._batch()
        assert got.keys() == want.keys() == set(tnorm.BATCH_KEYS)
        for k in got:
            assert got[k].numpy().dtype == np.asarray(want[k]).dtype, k
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    assert got["object_mask"].float().mean() > 0.2


def test_runner_runs_the_stage_on_the_cpu(tex_sampler, tmp_path):
    """A few steps through the smoothness switch: finite metrics, the loss
    the MSE up to smooth_after and the sum after; only the decoder moves;
    save writes the JAX runner's two files."""
    params = _params()
    runner = tnorm.NormRunner(TCFG, params, tfs.TexSpaceSampler(tex_sampler, None, None,
                                                                device="cpu"),
                              tnorm.NormStageConfig(num_pixels=N, smooth_after=1), device="cpu",
                              log_dir=str(tmp_path))
    for it in range(3):
        m = runner.run(1)
        assert all(np.isfinite(v) for v in m.values()), m
        smooth = m["smooth_loss"] if it > 1 else 0.0
        assert m["loss"] == pytest.approx(m["normal_loss"] + smooth, rel=1e-6)
    before = ttree.flatten_with_paths(params)
    for path, leaf in ttree.flatten_with_paths(runner.params).items():
        assert np.array_equal(leaf.detach().numpy(), before[path]) != path.startswith(DECODER)
    path = runner.save()
    assert path.endswith("Norm/checkpoints/ckpt_000003.npz")
    assert (tmp_path / "Norm" / "checkpoints" / "latest.npz").exists()


def _norm_writer(kind: str, log_dir: str):
    """A Norm runner of either package whose decoder is shifted by 0.5,
    saved; returns (the file, the decoder's leaves)."""
    params = jax.tree_util.tree_map(lambda x: x + np.float32(0.5), _params(1))
    if kind == "port":
        runner = tnorm.NormRunner(TCFG, params, None, device="cpu", log_dir=log_dir)
    else:
        runner = jnorm.NormRunner(JCFG, params, None, log_dir=log_dir)
    runner.cur_iter = 7
    path = runner.save()
    flat = {k: np.asarray(v) for k, v in jtree.flatten_with_paths(params).items()
            if "normal_decoder_layer" in k}
    return path, flat


def _check_decoder(got: dict, base: dict, saved: dict):
    """Every decoder leaf the file's and every other leaf the receiver's,
    bit for bit."""
    assert got.keys() == base.keys()
    for k, v in got.items():
        want = saved[k] if "normal_decoder_layer" in k else base[k]
        assert v.dtype == want.dtype and np.array_equal(v, want), k
    assert sum("normal_decoder_layer" in k for k in got) == len(saved) > 0


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_norm_checkpoint_into_vis_and_pbr(writer, tmp_path):
    """A Norm checkpoint of either package reaches both packages' Vis
    parameters (``cmd_vis``'s restore before the runner is built) and
    PBRRunner.load_norm_checkpoint, bit-equal."""
    path, saved = _norm_writer(writer, str(tmp_path))
    base = _params(2)
    flat_base = {k: np.asarray(v) for k, v in jtree.flatten_with_paths(base).items()}
    keep = lambda p: "normal_decoder_layer" in p  # noqa: E731
    ds = shadow_scene(n_train=2, h=8, w=8)

    tparams, _ = tckpt.restore_into(base, path, keep=keep)
    vis = tvis.VisRunner(TCFG, tparams, ds, tvis.VisStageConfig(num_pixels=8, nsamp=4),
                         device="cpu")
    _check_decoder({k: v.detach().numpy() for k, v in
                    ttree.flatten_with_paths(vis.params).items()}, flat_base, saved)
    jparams, _ = jckpt.restore_into(base, path, keep=keep)
    _check_decoder({k: np.asarray(v) for k, v in jtree.flatten_with_paths(jparams).items()},
                   flat_base, saved)

    pbr = tpbr.PBRRunner(TCFG, base, ds, tpbr.PBRStageConfig(num_pixels=8), device="cpu")
    pbr.load_norm_checkpoint(path)
    _check_decoder({k: v.detach().numpy() for k, v in
                    ttree.flatten_with_paths(pbr.params).items()}, flat_base, saved)
    jpbr_runner = jpbr.PBRRunner(JCFG, base, ds, jpbr.PBRStageConfig(num_pixels=8))
    jpbr_runner.load_norm_checkpoint(path)
    _check_decoder({k: np.asarray(v) for k, v in
                    jtree.flatten_with_paths(jpbr_runner.params).items()}, flat_base, saved)


def test_get_neus_surface_matches_jax():
    """The short-segment integration on the seeded NeuS: positions,
    normals and the gradient error."""
    params = _params()
    rng = np.random.default_rng(4)
    d = rng.standard_normal((40, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    pts = (0.3 * d).astype(np.float32)
    view = -(d + 0.3 * rng.standard_normal((40, 3)))
    view = (view / np.linalg.norm(view, axis=-1, keepdims=True)).astype(np.float32)
    pred = d.astype(np.float32)
    want = jnorm.get_neus_surface(JStage2Model(params, JCFG), jnp.asarray(pts),
                                  jnp.asarray(view), jnp.asarray(pred))
    got = tnorm.get_neus_surface(Stage2Model(params, TCFG, "cpu"), torch.as_tensor(pts),
                                 torch.as_tensor(view), torch.as_tensor(pred))
    for g, w, what in zip(got, want, ("final_x", "final_normal", "grad_err")):
        assert_close(g, np.asarray(w), rtol=1e-5, atol=1e-5, what=what)
    assert not np.allclose(got[0].detach().numpy(), pts, atol=1e-4)  # the samples weigh in
