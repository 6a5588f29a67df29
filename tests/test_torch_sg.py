"""The port's SG shading (``render/sg.py``) and sphere tracer
(``tracing/sphere.py``) against the JAX package, on shared draws.

Tolerances: 1e-5 on forward values (fp32, other summation order), except
the SG cosine integrals (``shade_with_sg_lights``, ``diffuse_sg_integral``
and the rgb built on them) at rtol 1e-4: the clamped cosine is a
difference of two terms ~32x the result (MU_COS 32.7, ALPHA_COS 31.7), so
fp32 cancellation leaves both packages ~6.5e-5 from the fp64 value. rtol
5e-4 (atol 1e-6 of the largest entry's scale) on gradients. The visibility
function is an analytic one, the same in both frameworks, so that the
sweeps' directions and their gradients are what is compared.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robir_tpu.render import sg as jsg
from robir_tpu.tracing import sphere as jsphere
from robir_tpu_torch.core.draws import Draws
from robir_tpu_torch.render import sg as tsg
from robir_tpu_torch.tracing import sphere as tsphere
from torch_port_helpers import assert_close, jax_sg_draws, to_t

N, M = 11, 6


def _jvis(p, d):
    return jnp.stack([jnp.sum(p * d, -1), 0.3 * jnp.sum(d * d, -1) - p[..., 0]
                      + 0.7 * d[..., 2]], -1)


def _tvis(p, d):
    return torch.stack([torch.sum(p * d, -1), 0.3 * torch.sum(d * d, -1) - p[..., 0]
                        + 0.7 * d[..., 2]], -1)


def _jouter(p, d):
    return _jvis(p[:, None, :], d[None])


def _touter(p, d):
    return _tvis(p[:, None, :], d[None])


def _case(seed=0):
    rng = np.random.default_rng(seed)
    pts = (0.4 * rng.standard_normal((N, 3))).astype(np.float32)
    normal = rng.standard_normal((N, 3)).astype(np.float32)
    normal /= np.linalg.norm(normal, axis=-1, keepdims=True)
    view = rng.standard_normal((N, 3)).astype(np.float32)
    view /= np.linalg.norm(view, axis=-1, keepdims=True)
    view = np.where(np.sum(view * normal, -1, keepdims=True) < 0, -view, view)
    sgs = rng.standard_normal((M, 7)).astype(np.float32)
    sgs[:, 3] = 5 + 20 * np.abs(sgs[:, 3])
    # roughness >= 0.35 keeps the warped lobes' sharpness 2 / r^4 / (4 n.v)
    # below ~10^3, where exp(lambda (cos - 1)) still holds fp32 rounding of
    # its inputs to the 1e-5 compared here
    rough = rng.uniform(0.35, 0.9, (N, 1)).astype(np.float32)
    albedo = rng.uniform(0.1, 0.9, (N, 3)).astype(np.float32)
    indir = rng.standard_normal((N, 4, 7)).astype(np.float32)
    indir[..., 3] = 0.1 + 20 * np.abs(indir[..., 3])
    integral = rng.uniform(0.1, 1.0, (N, 3)).astype(np.float32)
    dvis = rng.uniform(0.05, 0.95, (N, M)).astype(np.float32)
    return pts, normal, view, sgs, rough, albedo, indir, integral, dvis


def test_closed_form_pieces_match_jax():
    pts, normal, view, sgs, rough, albedo, indir, *_ = _case()
    lam = np.abs(sgs[:, 3:4])
    cos = np.random.default_rng(1).uniform(-1, 1, (M, 1)).astype(np.float32)
    assert_close(tsg.hemisphere_int(to_t(lam), to_t(cos)),
                 jsg.hemisphere_int(jnp.asarray(lam), jnp.asarray(cos)), rtol=1e-5, atol=1e-5)
    args = [to_t(normal), to_t(view), to_t(rough), to_t(np.full((N, 3), 0.04, np.float32))]
    jargs = [jnp.asarray(a.numpy()) for a in args]
    for got, want in zip(tsg.specular_sg(*args), jsg.specular_sg(*jargs)):
        assert_close(got, want, rtol=1e-5, atol=1e-5)
    for got, want in zip(tsg.specular_sg(*args, metallic=to_t(rough), diffuse_albedo=to_t(albedo)),
                         jsg.specular_sg(*jargs, metallic=jnp.asarray(rough),
                                         diffuse_albedo=jnp.asarray(albedo))):
        assert_close(got, want, rtol=1e-5, atol=1e-5)
    lobes, lams, mus = jsg.split_sgs(jnp.asarray(indir))
    wl, wlam, wmu = jsg.specular_sg(*jargs)
    want = jsg.shade_with_sg_lights(jnp.asarray(normal), lobes, lams, mus, wl, wlam, wmu)
    got = tsg.shade_with_sg_lights(to_t(normal), *(to_t(a) for a in (lobes, lams, mus, wl,
                                                                     wlam, wmu)))
    assert_close(got, want, rtol=1e-4, atol=1e-5)
    want = jsg.diffuse_sg_integral(jnp.asarray(normal), lobes, lams, mus)
    got = tsg.diffuse_sg_integral(to_t(normal), to_t(lobes), to_t(lams), to_t(mus))
    assert_close(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("weighted", [False, True])
def test_kl_divergence_matches_jax(weighted):
    rng = np.random.default_rng(2)
    x = rng.uniform(0, 1, (N, M)).astype(np.float32)
    w = (rng.uniform(size=N) > 0.4).astype(np.float32) if weighted else None
    lw = rng.uniform(0.5, 2, M).astype(np.float32) if weighted else None
    want = jsg.kl_divergence(jnp.asarray(x), 0.01, weight=None if w is None else jnp.asarray(w),
                             lobe_weight=None if lw is None else jnp.asarray(lw))
    got = tsg.kl_divergence(to_t(x), 0.01, weight=None if w is None else to_t(w),
                            lobe_weight=None if lw is None else to_t(lw))
    assert_close(got, want, rtol=1e-5, atol=1e-6)


def test_visibility_sweeps_match_jax():
    pts, normal, view, sgs, rough, *_ = _case(3)
    key = jax.random.PRNGKey(4)
    lobes = jsg.norm_axis(jnp.asarray(sgs[:, :3]))
    lam = jnp.abs(jnp.asarray(sgs[:, 3]))
    d = jax_sg_draws(key, N, M, indirect=False)
    k_diff = jax.random.split(jax.random.split(key)[0])[0]
    want = jsg.sample_lobe_dirs(k_diff, lobes, lam, 8)
    got = tsg.sample_lobe_dirs(to_t(lobes), to_t(lam), to_t(d["lobe_theta"]),
                               to_t(d["lobe_phi"]))
    assert_close(got, want, rtol=1e-5, atol=1e-6)
    want = jsg.get_diffuse_visibility(k_diff, jnp.asarray(pts), jnp.asarray(normal), _jvis,
                                      lobes, lam, nsamp=8, vis_outer_fn=_jouter)
    for outer in (_touter, None):
        got = tsg.get_diffuse_visibility(to_t(pts), to_t(normal), _tvis, to_t(lobes),
                                         to_t(lam), to_t(d["lobe_theta"]),
                                         to_t(d["lobe_phi"]), vis_outer_fn=outer)
        assert got.shape == (M, N)
        assert_close(got, want, rtol=1e-5, atol=1e-6)
    k_spec = jax.random.split(jax.random.split(jax.random.split(key)[0])[1])[0]
    for inv in (False, True):
        want = jsg.get_specular_visibility(k_spec, jnp.asarray(pts), jnp.asarray(normal),
                                           jnp.asarray(view), _jvis, None,
                                           jnp.asarray(rough[:, 0] * 7), inv=inv)
        got = tsg.get_specular_visibility(to_t(pts), to_t(normal), to_t(view), _tvis,
                                          to_t(rough[:, 0] * 7), to_t(d["spec_theta"]),
                                          to_t(d["spec_phi"]), inv=inv)
        assert_close(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("prefit,with_dvis", [("warmup", True), ("explore", True),
                                              ("project", True), (None, False)])
def test_render_with_all_sg_matches_jax(prefit, with_dvis):
    """The whole direct + indirect render with the CESR hooks (per-light
    visibility, the KL supervision weighted by a surface mask), forward
    and the gradients w.r.t. the lights, roughness, albedo, normal and the
    per-light visibility."""
    pts, normal, view, sgs, rough, albedo, indir, integral, dvis = _case(5)
    sw = (np.arange(N) % 3 != 0).astype(np.float32)
    key = jax.random.PRNGKey(6)
    nsamp = 8 if with_dvis else 32
    draws = {k: to_t(v) for k, v in jax_sg_draws(key, N, M, diffuse_nsamp=nsamp).items()}
    spec = np.full((1, 1), 0.05, np.float32)
    wts = np.random.default_rng(7).standard_normal((3, N, 3)).astype(np.float32)

    def jrun(sgs_, rough_, albedo_, normal_, dvis_):
        out = jsg.render_with_all_sg(
            key, jnp.asarray(pts), normal_, jnp.asarray(view), sgs_, jnp.asarray(spec),
            rough_, albedo_, indir_integral=jnp.asarray(integral),
            indir_lgt_sgs=jnp.asarray(indir), vis_fn=_jvis, vis_outer_fn=_jouter,
            lin_diff=with_dvis, diffuse_vis=dvis_ if with_dvis else None, prefit=prefit,
            supervise_weight=jnp.asarray(sw) if with_dvis else None)
        loss = (jnp.sum(out.sg_rgb * wts[0]) + jnp.sum(out.indir_rgb * wts[1])
                + jnp.sum(out.sg_diffuse_rgb * wts[2]) + out.supervise)
        return loss, out

    jargs = [jnp.asarray(a) for a in (sgs, rough, albedo, normal, dvis)]
    (_, jout), jgrads = jax.jit(jax.value_and_grad(jrun, argnums=(0, 1, 2, 3, 4),
                                                   has_aux=True))(*jargs)
    targs = [to_t(a).requires_grad_() for a in (sgs, rough, albedo, normal, dvis)]
    out = tsg.render_with_all_sg(
        Draws(given=draws), to_t(pts), targs[3], to_t(view), targs[0], to_t(spec), targs[1],
        targs[2], indir_integral=to_t(integral), indir_lgt_sgs=to_t(indir), vis_fn=_tvis,
        vis_outer_fn=_touter, lin_diff=with_dvis,
        diffuse_vis=targs[4] if with_dvis else None, prefit=prefit,
        supervise_weight=to_t(sw) if with_dvis else None)
    for name, a, b in zip(out._fields, out, jout):
        rtol = 1e-5 if name in ("vis_shadow", "supervise") else 1e-4  # SG integrals
        assert_close(a, b, rtol=rtol, atol=1e-5, what=name)
    loss = (torch.sum(out.sg_rgb * to_t(wts[0])) + torch.sum(out.indir_rgb * to_t(wts[1]))
            + torch.sum(out.sg_diffuse_rgb * to_t(wts[2])) + out.supervise)
    grads = torch.autograd.grad(loss, targs, allow_unused=True)
    for name, g, jg in zip(("lgt_sgs", "roughness", "albedo", "normal", "diffuse_vis"),
                           grads, jgrads):
        if g is None:
            assert not np.any(np.asarray(jg)), name
            continue
        scale = float(np.abs(np.asarray(jg)).max())
        assert_close(g, jg, rtol=5e-4, atol=1e-6 * max(scale, 1.0), what=name)


def _jsphere_sdf(x):
    return jnp.linalg.norm(x - jnp.asarray([0.05, 0.0, 0.02]), axis=-1) - 0.35


def _tsphere_sdf(x):
    return torch.linalg.norm(x - torch.tensor([0.05, 0.0, 0.02]), dim=-1) - 0.35


def test_sphere_tracer_matches_jax():
    """Rays from a camera at distance 1.5 (inside the unit bounding sphere's
    reach and outside it): hits, misses and grazing rays; points, t and
    the hit mask."""
    rng = np.random.default_rng(8)
    cam = np.broadcast_to(np.asarray([0.0, -1.5, 0.3], np.float32), (64, 3)).copy()
    target = (0.45 * rng.standard_normal((64, 3))).astype(np.float32)
    d = target - cam
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    cfg_j, cfg_t = jsphere.SphereTracerConfig(), tsphere.SphereTracerConfig()
    want = jsphere.sphere_trace(_jsphere_sdf, jnp.asarray(cam), jnp.asarray(d), cfg_j)
    calls = []
    got = tsphere.sphere_trace(lambda x: calls.append(1) or _tsphere_sdf(x),
                               to_t(cam), to_t(d), cfg_t)
    assert len(calls) == cfg_t.sdf_calls() == 51
    assert 0 < int(got.mask.sum()) < 64
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))
    assert_close(got.dists, want.dists, rtol=1e-5, atol=1e-5)
    assert_close(got.points, want.points, rtol=1e-5, atol=1e-5)
    near, far, hit = tsphere.sphere_intersection(to_t(cam), to_t(d), 1.0)
    jn, jf, jh = jsphere.sphere_intersection(jnp.asarray(cam), jnp.asarray(d), 1.0)
    assert_close(near, jn, rtol=1e-6, atol=1e-6)
    assert_close(far, jf, rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(hit.numpy(), np.asarray(jh))
