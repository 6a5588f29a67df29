"""The port's VNeRF/MipNeRF fields and mip renderer against the JAX
package: ``vnerf_apply``/``mipnerf_apply`` and ``eval_sh``; the cone
Gaussians, stratified sampling, the sorted piecewise-constant PDF and the
blurpool resampling on the same draws; ``density_process`` and each
``similarity_process`` sub-mode (``sdf`` over a NeuS, whose gradient is
K3's plain version here); ``render_mip`` in each mode on JAX's per-level
draws; and one stage-1 train step under ``mip_render_binding`` (VNeRF and
MipNeRF), its loss and every gradient against ``make_train_step``'s.

Tolerances: forward values 1e-5; gradients rtol 5e-4 with an atol of 5e-4
of each tensor's largest entry (the fused-MLP and field tests' bounds).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robir_tpu.data import blender as jblender
from robir_tpu.fields import neus_model as jnm
from robir_tpu.fields import vnerf as jvnerf
from robir_tpu.fields.radiance import RenderingConfig as JRenderingConfig
from robir_tpu.fields.sdf import SDFConfig as JSDFConfig
from robir_tpu.render import mip as jmip
from robir_tpu.render.neus import Rays as JRays
from robir_tpu.stages import neus_stage as jstage
from robir_tpu_torch.core.draws import Draws
from robir_tpu_torch.core.params import from_jax, to_numpy
from robir_tpu_torch.data.blender import RayBatch
from robir_tpu_torch.data.synthetic import make_sphere_scene
from robir_tpu_torch.fields import neus_model as tnm
from robir_tpu_torch.fields import vnerf as tvnerf
from robir_tpu_torch.fields.radiance import RenderingConfig
from robir_tpu_torch.fields.sdf import SDFConfig
from robir_tpu_torch.render import mip as tmip
from robir_tpu_torch.render.neus import Rays
from robir_tpu_torch.stages import neus_stage as tstage
from torch_port_helpers import assert_close, assert_grads_match, grab_grads, to_t

FWD = dict(rtol=1e-5, atol=1e-5)
VNERF_KW = dict(width=32, depth=4, skips=(2,), multires=3, multires_view=2, ipe_max_deg=5)
B, S = 12, 8


@pytest.fixture(scope="module")
def batch():
    scene = make_sphere_scene("train", n_train=2, h=16, w=16)
    return scene.sample(np.random.default_rng(3), B)


def _rays(batch, pkg):
    if pkg == "jax":
        return JRays(*[jnp.asarray(x) for x in batch[:7]])
    return Rays(*[torch.as_tensor(np.asarray(x)) for x in batch[:7]])


def _params(cfg):
    return to_numpy(tvnerf.init_vnerf(torch.Generator().manual_seed(0), cfg))


@pytest.mark.parametrize("use_ipe", [False, True])
def test_vnerf_and_mipnerf_apply_match_jax(use_ipe):
    tcfg = tvnerf.VNeRFConfig(use_ipe=use_ipe, **VNERF_KW)
    jcfg = jvnerf.VNeRFConfig(use_ipe=use_ipe, **VNERF_KW)
    params = _params(tcfg)
    rng = np.random.default_rng(1)
    pts = rng.standard_normal((4, 5, 3)).astype(np.float32)
    covs = (0.01 * rng.random((4, 5, 3))).astype(np.float32)
    dirs = rng.standard_normal((4, 3)).astype(np.float32)
    w = rng.standard_normal((4, 5, 4)).astype(np.float32)

    def jf(p):
        rgb, dens = (jvnerf.mipnerf_apply(p, jcfg, pts, covs, dirs) if use_ipe
                     else jvnerf.vnerf_apply(p, jcfg, pts, dirs))
        return jnp.sum(jnp.concatenate([rgb, dens], -1) * w), (rgb, dens)

    (_, (jrgb, jdens)), jg = jax.value_and_grad(jf, has_aux=True)(params)
    model = tvnerf.VNeRF(params, tcfg, "cpu")
    rgb, dens = model(to_t(pts), to_t(covs), to_t(dirs))
    assert_close(rgb, jrgb, **FWD)
    assert_close(dens, jdens, **FWD)
    torch.sum(torch.cat([rgb, dens], -1) * to_t(w)).backward()
    assert_grads_match(model.params, jg)


def test_eval_sh_matches_jax():
    rng = np.random.default_rng(2)
    dirs = rng.standard_normal((7, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    for deg in range(5):
        sh = rng.standard_normal((7, 3, (deg + 1) ** 2)).astype(np.float32)
        assert_close(tvnerf.eval_sh(deg, to_t(sh), to_t(dirs)[:, None]),
                     jvnerf.eval_sh(deg, sh, dirs[:, None]), **FWD, what=f"deg {deg}")


def test_sampling_and_resampling_match_jax(batch):
    """Stratified sampling and blurpool resampling on the same draws (and
    without draws, as in eval), and the PDF inversion's ties."""
    jr, tr = _rays(batch, "jax"), _rays(batch, "torch")
    key = jax.random.PRNGKey(4)
    u0 = jax.random.uniform(key, (B, S + 1))
    for u in (u0, None):
        jt, (jm, jc) = jmip.sample_along_rays(key, jr.origins, jr.directions, jr.radii, S,
                                              jr.near, jr.far, randomized=u is not None)
        tt, (tm, tc) = tmip.sample_along_rays(None if u is None else to_t(u), tr.origins,
                                              tr.directions, tr.radii, S, tr.near, tr.far)
        for a, b, what in ((tt, jt, "t"), (tm, jm, "means"), (tc, jc, "covs")):
            assert_close(a, b, **FWD, what=what)
    weights = np.random.default_rng(5).random((B, S)).astype(np.float32)
    weights[0] = 0.0  # all-zero weights: the padding branch
    weights[1, 3:] = 0.0  # ties in the cdf
    k1 = jax.random.PRNGKey(6)
    for randomized in (True, False):
        jt2, (jm2, jc2) = jmip.resample_along_rays(k1, jr.origins, jr.directions, jr.radii,
                                                   jt, jnp.asarray(weights), randomized)
        u1 = to_t(jax.random.uniform(k1, (B, S + 1))) if randomized else None
        tt2, (tm2, tc2) = tmip.resample_along_rays(u1, tr.origins, tr.directions, tr.radii,
                                                   tt, to_t(weights))
        for a, b, what in ((tt2, jt2, "t"), (tm2, jm2, "means"), (tc2, jc2, "covs")):
            assert_close(a, b, **FWD, what=f"{what} randomized={randomized}")


def _compositor_inputs(batch):
    jr = _rays(batch, "jax")
    t, (means, _) = jmip.sample_along_rays(None, jr.origins, jr.directions, jr.radii, S,
                                           jr.near, jr.far, randomized=False)
    rng = np.random.default_rng(7)
    raw_rgb = rng.standard_normal((B, S, 3)).astype(np.float32)
    raw_density = rng.standard_normal((B, S, 1)).astype(np.float32)
    return raw_rgb, raw_density, np.asarray(means), np.asarray(t), np.asarray(jr.directions)


def test_density_process_matches_jax(batch):
    raw_rgb, raw_density, _, t, d = _compositor_inputs(batch)
    for act in ("softplus", "relu"):
        jcfg = jmip.MipRenderConfig(density_activation=act)
        tcfg = tmip.MipRenderConfig(density_activation=act)
        want = jmip.density_process(raw_rgb, raw_density, t, d, jcfg)
        got = tmip.density_process(to_t(raw_rgb), to_t(raw_density), to_t(t), to_t(d), tcfg)
        for k in ("rgb", "dist", "acc", "weights", "sim_or_grad"):
            assert_close(got[k], want[k], **FWD, what=f"{k} {act}")


SDF_KW = dict(d_out=9, d_hidden=16, n_layers=3, skip_in=(2,), multires=2, bias=0.5)
COLOR_KW = dict(d_feature=8, d_hidden=16, n_layers=2)


class JaxNeuSSDF:
    """The JAX package's NeuS under the sdf sub-mode's grad/dev/radius."""

    def __init__(self, neus):
        self.neus = neus

    def grad(self, x):
        return self.neus.grad(x)

    def dev(self, x):
        return jnp.broadcast_to(self.neus.inv_s(), (x.shape[0], 1))

    def radius(self):
        return self.neus.radius()


@pytest.mark.parametrize("mode", ["sim", "raw", "sdf"])
def test_similarity_process_matches_jax(batch, mode):
    """Each sub-mode's outputs, and in 'sdf' (a NeuS's sdf channel, its
    gradient through K3's plain version) the gradients of the NeuS."""
    raw_rgb, raw_density, means, t, d = _compositor_inputs(batch)
    jcfg, tcfg = jmip.MipRenderConfig(mode=mode), tmip.MipRenderConfig(mode=mode)
    scaled = 0.3 * means / np.linalg.norm(means, axis=-1, keepdims=True).max()
    tneus_cfg = tnm.NeuSConfig(sdf=SDFConfig(**SDF_KW), color=RenderingConfig(**COLOR_KW))
    jneus_cfg = jnm.NeuSConfig(sdf=JSDFConfig(**SDF_KW), color=JRenderingConfig(**COLOR_KW))
    params = to_numpy(tnm.init_neus(torch.Generator().manual_seed(1), tneus_cfg))
    w = np.random.default_rng(8).standard_normal((B, 3)).astype(np.float32)

    def jf(p):
        out = jmip.similarity_process(raw_rgb, raw_density, scaled, t, d, jcfg, mode=mode,
                                      model=JaxNeuSSDF(jnm.NeuS(p, jneus_cfg)),
                                      cos_anneal_ratio=0.3)
        return jnp.sum(out["rgb"] * w) + jnp.sum(out["sim_or_grad"]), out

    (_, want), jg = jax.value_and_grad(jf, has_aux=True)(params)
    neus = tnm.NeuS(params, tneus_cfg, "cpu")
    got = tmip.similarity_process(to_t(raw_rgb), to_t(raw_density), to_t(scaled), to_t(t),
                                  to_t(d), tcfg, mode=mode, model=tmip.NeuSSDF(neus),
                                  cos_anneal_ratio=0.3)
    for k in ("rgb", "dist", "acc", "weights", "sim_or_grad"):
        assert_close(got[k], want[k], **FWD, what=k)
    if mode == "sdf":
        (torch.sum(got["rgb"] * to_t(w)) + torch.sum(got["sim_or_grad"])).backward()
        assert_grads_match(neus.params, jg)


def jax_mip_draws(key, n_levels: int, n_rays: int, num_samples: int) -> dict:
    """The per-level draws ``robir_tpu.render.mip.render_mip`` makes from
    ``key``, by the port's names."""
    draws = {}
    for level in range(n_levels):
        key, k = jax.random.split(key)
        draws[f"mip_u{level}"] = to_t(jax.random.uniform(k, (n_rays, num_samples + 1)))
    return draws


@pytest.mark.parametrize("mode", ["mip", "sim", "raw"])
def test_render_mip_matches_jax(batch, mode):
    """Both levels of a training render (JAX's draws handed in) and an eval
    render, per mode."""
    tcfg = tvnerf.VNeRFConfig(**VNERF_KW)
    jcfg = jvnerf.VNeRFConfig(**VNERF_KW)
    params = _params(tcfg)
    model = tvnerf.VNeRF(params, tcfg, "cpu")
    key = jax.random.PRNGKey(9)
    jr, tr = _rays(batch, "jax"), _rays(batch, "torch")
    for is_eval in (False, True):
        want = jmip.render_mip(None if is_eval else key, jr,
                               lambda m, c, v: jvnerf.vnerf_apply(params, jcfg, m, v),
                               jmip.MipRenderConfig(num_samples=S, mode=mode), is_eval=is_eval)
        draws = Draws(given=jax_mip_draws(key, 2, B, S))
        got = tmip.render_mip(draws, tr, model, tmip.MipRenderConfig(num_samples=S, mode=mode),
                              is_eval=is_eval)
        for level, (g, w) in enumerate(zip(got, want)):
            for k in ("rgb", "dist", "acc", "weights", "means", "sim_or_grad"):
                assert_close(g[k], w[k], **FWD, what=f"{k} level {level} eval={is_eval}")


TRAIN_KW = dict(batch_size=B, lr_init=5e-4, lr_delay_steps=0, max_steps=100,
                sparsity_weight=0.01, similarity_weight=0.1)


@pytest.mark.parametrize("use_ipe,mode", [(False, "mip"), (True, "mip"), (False, "sim")])
def test_train_step_matches_jax(batch, use_ipe, mode):
    """One stage-1 step under the mip binding: the loss, every metric and
    the gradient of every parameter, on JAX's draws."""
    tcfg = tvnerf.VNeRFConfig(use_ipe=use_ipe, **VNERF_KW)
    jcfg = jvnerf.VNeRFConfig(use_ipe=use_ipe, **VNERF_KW)
    trender = tmip.MipRenderConfig(num_samples=S, mode=mode)
    jrender = jmip.MipRenderConfig(num_samples=S, mode=mode)
    params = _params(tcfg)
    jtrain = jstage.NeusTrainConfig(**TRAIN_KW)
    _, jrender_fn, _ = jstage.make_stage1_bindings("vnerf", "mip", jcfg, jrender)
    step = jstage.make_train_step(jcfg, jrender, jtrain, grab_grads(), render_fn=jrender_fn)
    key = jax.random.PRNGKey(11)
    _, jg, jm = step(jax.tree_util.tree_map(jnp.asarray, params), None,
                     jblender.RayBatch(*map(jnp.asarray, batch)), jnp.asarray(0, jnp.int32),
                     key)
    bindings = tstage.make_stage1_bindings("vnerf", "mip", tcfg, trender)
    model = bindings.model(params, "cpu")
    rays, pixels = tstage.batch_to_rays(RayBatch(*map(to_t, batch)))
    out = bindings.render(Draws(given=jax_mip_draws(key, 2, B, S)), rays, model, 0.0)
    loss, metrics = tstage.neus_loss(out, rays.lossmult, pixels,
                                     tstage.NeusTrainConfig(**TRAIN_KW))
    assert sorted(metrics) == sorted(jm)
    for k in jm:
        assert_close(metrics[k].detach(), jm[k], rtol=1e-5, atol=1e-7, what=k)
    loss.backward()
    assert_grads_match(model.params, jg)


def test_sdf_mode_binding_refused_as_jax():
    cfg = tvnerf.VNeRFConfig(**VNERF_KW)
    msg = "requires an SDF model"
    with pytest.raises(ValueError, match=msg):
        jstage.make_stage1_bindings("vnerf", "mip", jvnerf.VNeRFConfig(**VNERF_KW),
                                    jmip.MipRenderConfig(mode="sdf"))
    with pytest.raises(ValueError, match=msg):
        tstage.make_stage1_bindings("vnerf", "mip", cfg, tmip.MipRenderConfig(mode="sdf"))
    with pytest.raises(KeyError):
        tstage.make_stage1_bindings("vnerf", "neus", cfg, tmip.MipRenderConfig())
    assert from_jax(_params(cfg))["density"]["w"].shape == (cfg.width, 1)
