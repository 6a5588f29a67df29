"""The port's NeRF background shell against the JAX package: ``nerf_bg_apply``
(values and gradients), ``render_core_outside``, ``render_neus`` with
``n_outside`` > 0 in training (JAX's two draws handed in: the jitter and
the shell's stratified samples) and in eval, one stage-1 train step with
the shell (loss, metrics, every gradient, ``nerf_outside``'s included),
stage-1 checkpoints with the shell read across both packages, and a
reference ``.tar`` with ``nerf_outside.*`` keys imported as the JAX
package imports it.

``render_neus`` slices its weights to the first 128 samples for the
distance, so both packages need n_samples + n_importance = 128 with a
shell: the cases run 64 + 64 samples on narrow nets.

Tolerances: forward values 1e-5; gradients rtol 5e-4 with an atol of 5e-4
of each tensor's largest entry.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robir_tpu.core import import_ref as jimport
from robir_tpu.data import blender as jblender
from robir_tpu.data.synthetic import make_sphere_dataset
from robir_tpu.fields import neus_model as jnm
from robir_tpu.fields import radiance as jrad
from robir_tpu.fields.sdf import SDFConfig as JSDFConfig
from robir_tpu.render import neus as jneus
from robir_tpu.stages import neus_stage as jstage
from robir_tpu_torch.core import checkpoint as ckpt_lib
from robir_tpu_torch.core import import_ref as timport
from robir_tpu_torch.core.draws import Draws
from robir_tpu_torch.core.params import from_jax, to_numpy
from robir_tpu_torch.core.tree import flatten_with_paths
from robir_tpu_torch.data.blender import BlenderConfig, BlenderScene, RayBatch
from robir_tpu_torch.fields import neus_model as tnm
from robir_tpu_torch.fields import radiance as trad
from robir_tpu_torch.fields.sdf import SDFConfig
from robir_tpu_torch.render import neus as tneus
from robir_tpu_torch.stages import neus_stage as tstage
from torch_port_helpers import (assert_close, assert_grads_match, grab_grads,
                                reference_state_dict, to_t)

FWD = dict(rtol=1e-5, atol=1e-5)
# a small initial sphere (bias 0.1) and every pixel in the loss's mask: the
# rays reach the shell, whose gradients are otherwise fp32 noise (~1e-7)
SDF_KW = dict(d_out=9, d_hidden=16, n_layers=3, skip_in=(2,), multires=2, bias=0.1)
COLOR_KW = dict(d_feature=8, d_hidden=16, n_layers=2)
BG_KW = dict(depth=3, width=16, skips=(1,), multires=3, multires_view=2)
RENDER_KW = dict(n_samples=64, n_importance=64, up_sample_steps=2, n_outside=8,
                 white_bkgd=False)
N = 8


def _cfgs():
    t = tnm.NeuSConfig(sdf=SDFConfig(**SDF_KW), color=trad.RenderingConfig(**COLOR_KW),
                       background=trad.NeRFBgConfig(**BG_KW))
    j = jnm.NeuSConfig(sdf=JSDFConfig(**SDF_KW), color=jrad.RenderingConfig(**COLOR_KW),
                       background=jrad.NeRFBgConfig(**BG_KW))
    return t, j


def _params(cfg, seed=0):
    return to_numpy(tnm.init_neus(torch.Generator().manual_seed(seed), cfg))


@pytest.fixture(scope="module")
def batch(tmp_path_factory):
    scene = make_sphere_dataset(str(tmp_path_factory.mktemp("scene")), n_train=2, n_test=1,
                                h=16, w=16)
    return scene, BlenderScene(BlenderConfig(dataset_dir=scene, alpha_as_mask=False),
                               "train").sample(np.random.default_rng(2), N)


def test_nerf_bg_apply_matches_jax():
    """The shell's density and colour, and every gradient: the skip input
    appended after the activation."""
    tcfg, jcfg = trad.NeRFBgConfig(**BG_KW), jrad.NeRFBgConfig(**BG_KW)
    params = to_numpy(trad.init_nerf_bg(torch.Generator().manual_seed(1), tcfg))
    rng = np.random.default_rng(3)
    pts4 = rng.uniform(-1, 1, (40, 4)).astype(np.float32)
    views = rng.standard_normal((40, 3)).astype(np.float32)
    w = rng.standard_normal((40, 4)).astype(np.float32)

    def jf(p):
        a, rgb = jrad.nerf_bg_apply(p, jcfg, pts4, views)
        return jnp.sum(jnp.concatenate([a, rgb], -1) * w), (a, rgb)

    (_, (ja, jrgb)), jg = jax.value_and_grad(jf, has_aux=True)(params)
    tp = from_jax(params)
    a, rgb = trad.nerf_bg_apply(tp, tcfg, to_t(pts4), to_t(views))
    assert_close(a, ja, **FWD)
    assert_close(rgb, jrgb, **FWD)
    torch.sum(torch.cat([a, rgb], -1) * to_t(w)).backward()
    assert_grads_match(tp, jg)


def test_render_core_outside_matches_jax(batch):
    tcfg, jcfg = _cfgs()
    params = _params(tcfg)
    _, b = batch
    z = np.sort(np.random.default_rng(4).uniform(2, 30, (N, 12)), -1).astype(np.float32)
    want = jneus.render_core_outside(b.origins, b.directions, z, 0.03,
                                     jnm.NeuS(params, jcfg), background_rgb=jnp.ones((1, 3)))
    got = tneus.render_core_outside(to_t(b.origins), to_t(b.directions), to_t(z), 0.03,
                                    tnm.NeuS(params, tcfg, "cpu"),
                                    background_rgb=torch.ones((1, 3)))
    for k in ("color", "sampled_color", "alpha", "weights"):
        assert_close(got[k], want[k], **FWD, what=k)


def _jax_draws(key):
    """The two draws ``robir_tpu.render.neus.render_neus`` makes from
    ``key`` with a shell, by the port's names."""
    key, k1 = jax.random.split(key)
    _, k2 = jax.random.split(key)
    return {"t_rand": to_t(jax.random.uniform(k1, (N, 1))),
            "t_rand_outside": to_t(jax.random.uniform(k2, (N, RENDER_KW["n_outside"])))}


def test_render_neus_with_the_shell_matches_jax(batch):
    """A training render (JAX's draws) to 1e-5 and an eval render to
    ``test_torch_render_neus.py``'s 1e-4 for whole renders: the eval
    samples' inverse-CDF search meets a near-tie here that fp32 rounding
    settles differently, moving a weight by 9e-5."""
    tcfg, jcfg = _cfgs()
    params = _params(tcfg)
    _, b = batch
    jr = jneus.Rays(*[jnp.asarray(x) for x in b[:7]])
    tr = tneus.Rays(*[to_t(x) for x in b[:7]])
    model = tnm.NeuS(params, tcfg, "cpu")
    binding = tstage.neus_render_binding(tneus.NeusRenderConfig(**RENDER_KW))
    key = jax.random.PRNGKey(5)
    for is_eval in (False, True):
        want = jax.jit(lambda k, r: jneus.render_neus(
            k, r, jnm.NeuS(params, jcfg), 0.4, jneus.NeusRenderConfig(**RENDER_KW),
            is_eval=is_eval))(None if is_eval else key, jr)
        got = binding(Draws(given=_jax_draws(key)), tr, model, 0.4, is_eval=is_eval)
        assert got["weights"].shape == (N, 128 + RENDER_KW["n_outside"])
        tol = dict(rtol=1e-4, atol=1e-4) if is_eval else FWD
        for k in ("rgb", "acc", "dist", "weights", "gradient_error"):
            assert_close(got[k], want[k], **tol, what=f"{k} eval={is_eval}")


def test_train_step_with_the_shell_matches_jax(batch):
    tcfg, jcfg = _cfgs()
    params = _params(tcfg)
    _, b = batch
    train_kw = dict(batch_size=N, lr_delay_steps=0, max_steps=100, anneal_end=10)
    jrender = jneus.NeusRenderConfig(**RENDER_KW)
    step = jstage.make_train_step(jcfg, jrender, jstage.NeusTrainConfig(**train_kw),
                                  grab_grads())
    key = jax.random.PRNGKey(6)
    _, jg, jm = step(jax.tree_util.tree_map(jnp.asarray, params), None,
                     jblender.RayBatch(*map(jnp.asarray, b)), jnp.asarray(2, jnp.int32), key)
    bindings = tstage.make_stage1_bindings("neus", "neus", tcfg,
                                           tneus.NeusRenderConfig(**RENDER_KW))
    model = bindings.model(params, "cpu")
    rays, pixels = tstage.batch_to_rays(RayBatch(*map(to_t, b)))
    out = bindings.render(Draws(given=_jax_draws(key)), rays, model,
                          tstage.cos_anneal_ratio(2, 10))
    loss, metrics = tstage.neus_loss(out, rays.lossmult, pixels,
                                     tstage.NeusTrainConfig(**train_kw))
    for k in jm:
        assert_close(metrics[k].detach(), jm[k], rtol=1e-5, atol=1e-7, what=k)
    loss.backward()
    assert "nerf_outside" in model.params
    assert_grads_match(model.params, jg)


def test_checkpoints_with_the_shell_cross_both_packages(tmp_path, batch):
    """The port trainer's file (after a step) resumes a JAX trainer with the
    shell; a JAX trainer's file resumes the port's; bit-equal."""
    from robir_tpu.core.tree import flatten_with_paths as jflat
    from robir_tpu.core.tree import to_plain
    tcfg, jcfg = _cfgs()
    scene, _ = batch
    train_kw = dict(batch_size=N, lr_delay_steps=0, max_steps=100)
    trender = tneus.NeusRenderConfig(**RENDER_KW)
    tt = tstage.NeusTrainer(BlenderScene(BlenderConfig(dataset_dir=scene), "train"), tcfg,
                            trender, tstage.NeusTrainConfig(**train_kw), device="cpu",
                            log_dir=str(tmp_path / "port"))
    try:
        tt.run(1)
        port_file = tt.save()
    finally:
        tt.close()
    jt = jstage.NeusTrainer(jblender.BlenderScene(jblender.BlenderConfig(dataset_dir=scene),
                                                  "train"),
                            jcfg, jneus.NeusRenderConfig(**RENDER_KW),
                            jstage.NeusTrainConfig(**train_kw), log_dir=str(tmp_path / "jax"),
                            seed=4)
    jax_file = jt.save()
    jt.restore(port_file)
    saved = flatten_with_paths(ckpt_lib.load(port_file)[0])
    got = jflat(to_plain({"params": jt.params, "opt_state": jt.opt_state}))
    assert sorted(got) == sorted(saved) and any("nerf_outside" in k for k in saved)
    assert all(np.array_equal(np.asarray(got[k]), saved[k]) for k in saved)
    tt.restore(jax_file)
    want = flatten_with_paths(ckpt_lib.load(jax_file)[0])
    state = tt.state()
    assert sorted(state) == sorted(want)
    assert all(np.array_equal(state[k], want[k]) for k in want)


def test_import_ref_keeps_the_shell(tmp_path):
    """A reference stage-1 ``.tar`` with ``nerf_outside.*`` keys: both
    packages' imports write the same file, which the port's trainer with
    the shell restores."""
    tcfg, _ = _cfgs()
    neus = _params(tcfg, seed=7)
    tar = str(tmp_path / "000042.tar")
    sd = reference_state_dict(neus)
    assert any(k.startswith("nerf_outside.pts_linears.") for k in sd)
    torch.save({"global_step": 42, "model": sd}, tar)
    got = timport.import_stage1(tar, str(tmp_path / "port"))
    want = jimport.import_stage1(tar, str(tmp_path / "jax"))
    a, b = (flatten_with_paths(ckpt_lib.load(p)[0]) for p in (got, want))
    assert sorted(a) == sorted(b) and all(np.array_equal(a[k], b[k]) for k in a)
    model = tnm.NeuS(_params(tcfg), tcfg, "cpu")
    ckpt_lib.copy_into(model.params, flatten_with_paths(ckpt_lib.load(got)[0]["params"]))
    src = flatten_with_paths(neus)
    assert all(np.array_equal(v.detach().numpy(), src[k])
               for k, v in flatten_with_paths(model.params).items())
