"""The port's stage-2 model (``render/stage2.py``), losses, stage-2
optimizer and shadow scene against the JAX package, at the small widths of
``test_torch_cesr.py``, on bridged weights.

Tolerances: 1e-5 on forward values (fp32, other summation order); the
optimizer's parameters after each update to 1e-6 relative.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from robir_tpu.data.syn_dataset import SynDataset as JSynDataset
from robir_tpu.data.syn_dataset import SynDatasetConfig
from robir_tpu.data.synthetic import make_shadow_dataset
from robir_tpu.render.stage2 import Stage2Model as JStage2Model
from robir_tpu.render.stage2 import stage2_forward as jstage2_forward
from robir_tpu.stages import losses as jlosses
from robir_tpu.stages import pbr as jpbr
from robir_tpu.stages import stage2_runner as jrunner
from robir_tpu_torch.core.params import from_jax
from robir_tpu_torch.data.syn_dataset import shadow_scene
from robir_tpu_torch.core.draws import Draws
from robir_tpu_torch.render.stage2 import Stage2Model, stage2_forward
from robir_tpu_torch.stages import losses as tlosses
from robir_tpu_torch.stages import stage2_runner as trunner
from test_torch_cesr import JCFG, N_LIGHTS, TCFG, shared_params
from torch_port_helpers import assert_close, jax_stage2_draws, to_t


@pytest.fixture(scope="module")
def case():
    batch = shadow_scene(n_train=3, h=40, w=40).sample_pixels(np.random.default_rng(2), 1, 48)
    return shared_params(), None, None, batch


def test_stage2_model_matches_jax(case):
    """The NeuS bridge (sdf, sdf_full, sdf_gradient at coordinate scale 2),
    the heads, and the sphere-traced primary rays."""
    params, _, _, batch = case
    jm = JStage2Model(params, JCFG)
    tm = Stage2Model(params, TCFG, "cpu")
    x = (0.3 * np.random.default_rng(3).standard_normal((17, 3))).astype(np.float32)
    assert_close(tm.sdf(to_t(x)), jm.sdf(jnp.asarray(x)), rtol=1e-5, atol=1e-5)
    assert_close(tm.sdf_full(to_t(x)), jm.sdf_full(jnp.asarray(x)), rtol=1e-5, atol=1e-5)
    assert_close(tm.sdf_gradient(to_t(x)), jm.sdf_gradient(jnp.asarray(x)),
                 rtol=1e-5, atol=1e-5)
    d = x / np.linalg.norm(x, axis=-1, keepdims=True)
    assert_close(tm.vis_logits(to_t(x), to_t(d)), jm.vis_logits(jnp.asarray(x), jnp.asarray(d)),
                 rtol=1e-5, atol=1e-5)
    assert_close(tm.vis_logits_outer(to_t(x), to_t(d[:5])),
                 jm.vis_logits_outer(jnp.asarray(x), jnp.asarray(d[:5])), rtol=1e-5, atol=1e-5)
    mat = tm.material(to_t(x), None, train_spec=True)
    jmat = jm.material(jnp.asarray(x), None, train_spec=True)
    for name, a, b in zip(mat._fields, mat, jmat):
        assert_close(a, b, rtol=1e-5, atol=1e-5, what=name)
    want = jax.jit(jm.trace)(jnp.asarray(batch["points"]), jnp.asarray(batch["dirs"]))
    got = tm.trace(to_t(batch["points"]), to_t(batch["dirs"]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    assert 0 < int(got[1].sum()) < 48
    assert_close(got[0], want[0], rtol=1e-5, atol=1e-5)
    assert_close(got[2], want[2], rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="bake_grid"):  # the grid tracer needs its grid
        Stage2Model({}, dataclasses.replace(TCFG, tracer="grid"), "cpu").trace(to_t(x), to_t(d))


def test_losses_match_jax():
    rng = np.random.default_rng(4)
    pred, gt = rng.uniform(0, 1, (2, 23, 3)).astype(np.float32)
    mask = rng.uniform(size=23) > 0.3
    for loss_type in ("L1", "L2"):
        jc = jlosses.InvLossConfig(loss_type=loss_type)
        tc = tlosses.InvLossConfig(loss_type=loss_type)
        assert_close(tlosses.rgb_loss(tc, to_t(pred), to_t(gt), torch.as_tensor(mask)),
                     jlosses.rgb_loss(jc, jnp.asarray(pred), jnp.asarray(gt),
                                      jnp.asarray(mask)), rtol=1e-6, atol=1e-7)
    a, b = rng.uniform(0, 1, (2, 23, 4)).astype(np.float32)
    assert_close(tlosses.latent_smooth_loss(to_t(a[:, :3]), to_t(a[:, 3:]), to_t(b[:, :3]),
                                            to_t(b[:, 3:])),
                 jlosses.latent_smooth_loss(a[:, :3], a[:, 3:], b[:, :3], b[:, 3:]),
                 rtol=1e-6, atol=1e-7)
    sgs = rng.standard_normal((N_LIGHTS, 7)).astype(np.float32)
    assert_close(tlosses.white_loss(to_t(sgs)), jpbr.white_loss(jnp.asarray(sgs)),
                 rtol=1e-5, atol=1e-8)
    env = shared_params()["envmap_material_network"]
    pts = (0.3 * rng.standard_normal((23, 3))).astype(np.float32)
    var = (np.arange(8) % 3 == 0).astype(np.float32)
    assert_close(tlosses.masked_spec_kl(from_jax(env), TCFG.envmap, to_t(pts),
                                        torch.as_tensor(mask), var=to_t(var)),
                 jlosses.masked_spec_kl(env, JCFG.envmap, jnp.asarray(pts), jnp.asarray(mask),
                                        var=jnp.asarray(var)), rtol=1e-5, atol=1e-6)


def test_adam_and_multistep_schedule_match_optax():
    cfg_j = jrunner.StageOptConfig(lr=1e-2, sched_milestones=(2, 4), sched_factor=0.5)
    cfg_t = trunner.StageOptConfig(lr=1e-2, sched_milestones=(2, 4), sched_factor=0.5)
    sched, lr = jrunner.multistep_lr(cfg_j), trunner.multistep_lr(cfg_t)
    assert [lr(s) for s in range(7)] == pytest.approx([float(sched(s)) for s in range(7)])
    w0 = np.random.default_rng(6).standard_normal(5).astype(np.float32)
    tx = jrunner.make_adam(cfg_j)
    jw, state = jnp.asarray(w0), tx.init(jnp.asarray(w0))
    tw = torch.nn.Parameter(to_t(w0))
    opt, lr_fn = trunner.make_adam([tw], cfg_t)
    for step in range(6):
        g = np.cos(np.arange(5) + step).astype(np.float32)
        upd, state = tx.update(jnp.asarray(g), state, jw)
        jw = optax.apply_updates(jw, upd)
        tw.grad = to_t(g)
        for group in opt.param_groups:
            group["lr"] = lr_fn(step)
        opt.step()
        assert_close(tw.detach(), jw, rtol=1e-6, atol=1e-7)


def test_shadow_scene_matches_jax(tmp_path):
    """The in-memory shadow scene against the JAX package's files read back
    by its SynDataset: images, masks, camera model and pixel sampling."""
    make_shadow_dataset(str(tmp_path), n_train=3, n_test=1, h=40, w=40)
    want = JSynDataset(SynDatasetConfig(instance_dir=str(tmp_path)))
    got = shadow_scene(n_train=3, h=40, w=40)
    assert got.n_cameras == want.n_cameras and got.img_res == want.img_res
    np.testing.assert_allclose(got.intrinsics, want.intrinsics, rtol=1e-6)
    np.testing.assert_allclose(got.poses, want.poses, rtol=1e-6, atol=1e-7)
    for a, b, ma, mb in zip(got.rgb_images, want.rgb_images, got.object_masks,
                            want.object_masks):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)
        np.testing.assert_array_equal(ma, mb)
    sa = got.sample_pixels(np.random.default_rng(7), 2, 31)
    sb = want.sample_pixels(np.random.default_rng(7), 2, 31)
    for k in sb:
        np.testing.assert_allclose(sa[k], sb[k], rtol=1e-6, atol=1e-6, err_msg=k)


def test_stage2_forward_with_default_render_matches_jax(case):
    """The dense forward with the PBR-style ``default_sg_render`` (geometry
    normals, 32-sample diffuse sweep): every output of the JAX forward but
    ``sdf_output``, which the port does not compute (nothing reads it)."""
    params, _, _, batch = case
    key = jax.random.PRNGKey(11)
    shift = np.full((48, 1), 0.45, np.float32)
    jinp = {"points": jnp.asarray(batch["points"]), "dirs": jnp.asarray(batch["dirs"]),
            "object_mask": jnp.asarray(batch["object_mask"]), "hdr_shift": jnp.asarray(shift)}
    want = jax.jit(lambda p, k, i: jstage2_forward(JStage2Model(p, JCFG), k, i,
                                                   train_spec=True))(params, key, jinp)
    draws = Draws(given={k: to_t(v) for k, v in jax_stage2_draws(
        key, 48, JCFG, N_LIGHTS, diffuse_nsamp=32).items()})
    tinp = {"points": to_t(batch["points"]), "dirs": to_t(batch["dirs"]),
            "object_mask": torch.as_tensor(batch["object_mask"]), "hdr_shift": to_t(shift)}
    got = stage2_forward(Stage2Model(params, TCFG, "cpu"), draws, tinp, train_spec=True)
    assert 0 < int(got["network_object_mask"].sum()) < 48
    shared = sorted(set(got) & set(want))
    assert set(want) - set(got) == {"sdf_output"} and len(shared) == 24
    for k in shared:
        rtol = 1e-4 if "rgb" in k else 1e-5  # the SG cosine integrals (test_torch_sg.py)
        assert_close(got[k].detach(), want[k], rtol=rtol, atol=1e-5, what=k)
