"""``fun_spec`` and multi-view SG shading (``render/sg.py``) on both
packages: the checks of ``tests/test_sg.py:test_fun_spec_closure_matches_inline``
and ``test_multi_view_specular_matches_per_view`` run on the JAX package
and on the port, and the port against JAX through ``render_with_all_sg``
with the direct and indirect light sets: the roughness function at two
roughness maps and its gradient in roughness, and [V, N, 3] view
directions.

The port's draws are JAX's (``jax_sg_draws``), or for the port-only checks
one generator: an inline and a ``fun_spec`` render from the same seed make
the same draws in the same order, and every view shares one specular draw.

Tolerances: the package-internal checks as ``tests/test_sg.py`` states
them (rtol 1e-6 for the function at the render's own roughness, 2e-5 for a
view against its single-view render); port against JAX rtol 1e-4 with an
atol of 1e-5 (the SG cosine integrals, as ``test_torch_sg.py``); gradients
rtol 5e-4 with an atol of 5e-4 of the largest entry (measured: within
1.0e-4 of it, the cosine integrals' fp32 cancellation).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robir_tpu.render import sg as jsg
from robir_tpu_torch.core.draws import Draws
from robir_tpu_torch.render import sg as tsg
from test_torch_sg import _jouter, _jvis, _touter, _tvis
from torch_port_helpers import assert_close, jax_sg_draws, to_t

SG_TOL = dict(rtol=1e-4, atol=1e-5)


def _shade_inputs(seed=21, n=12, m=8):
    """``tests/test_sg.py:_shade_inputs``."""
    rng = np.random.default_rng(seed)
    points = rng.standard_normal((n, 3)).astype(np.float32) * 0.3
    normal = rng.standard_normal((n, 3)).astype(np.float32)
    normal /= np.linalg.norm(normal, axis=-1, keepdims=True)
    viewdirs = rng.standard_normal((n, 3)).astype(np.float32)
    viewdirs /= np.linalg.norm(viewdirs, axis=-1, keepdims=True)
    lgt = rng.standard_normal((m, 7)).astype(np.float32)
    lgt[:, 3] *= 30.0
    lgt[:, 3] = np.abs(lgt[:, 3]) * 20 + 10
    roughness = (rng.random((n, 1)) * 0.8 + 0.15).astype(np.float32)
    albedo = rng.random((n, 3)).astype(np.float32)
    spec = np.full((1, 1), 0.05, np.float32)
    return points, normal, viewdirs, lgt, roughness, albedo, spec


def _jconst(p, d):
    return jnp.stack([jnp.zeros(p.shape[:-1]), jnp.full(p.shape[:-1], 50.0)], -1)


def _tconst(p, d):
    return torch.stack([torch.zeros(p.shape[:-1]), torch.full(p.shape[:-1], 50.0)], -1)


def _view_dirs(n: int, v: int = 3, seed: int = 5) -> np.ndarray:
    vds = np.random.default_rng(seed).standard_normal((v, n, 3)).astype(np.float32)
    return vds / np.linalg.norm(vds, axis=-1, keepdims=True)


def _port(package: str):
    """(render_with_sg with draws from a fixed seed, vis fn, array type, grad
    of sum(f(r)) in r) of one package, so that one check runs on both."""
    if package == "jax":
        key = jax.random.PRNGKey(3)
        return (lambda *a, **kw: jsg.render_with_sg(key, *[jnp.asarray(x) for x in a], **kw),
                _jconst, jnp.asarray,
                lambda f, r: np.asarray(jax.grad(lambda x: jnp.sum(f(x)))(jnp.asarray(r))))

    def grad(f, r):
        x = to_t(r).requires_grad_()
        return torch.autograd.grad(torch.sum(f(x)), x)[0].numpy()

    return (lambda *a, **kw: tsg.render_with_sg(Draws(torch.Generator().manual_seed(3)),
                                                *[to_t(x) for x in a], **kw),
            _tconst, to_t, grad)


@pytest.mark.parametrize("package", ["jax", "port"])
def test_fun_spec_closure_matches_inline(package):
    """``fun_spec`` gives the specular term as fn(roughness): at the
    render's roughness it is the inline render's, at half of it it differs,
    it is differentiable in roughness, and ``sg_rgb`` carries the diffuse
    term only (``tests/test_sg.py:264``)."""
    render, vis, arr, grad = _port(package)
    points, normal, viewdirs, lgt, roughness, albedo, spec = _shade_inputs()
    args = (points, normal, viewdirs, lgt, spec, roughness, albedo)
    kw = dict(vis_fn=vis, argmax_vis=True)
    inline = render(*args, **kw)
    lazy = render(*args, fun_spec=True, **kw)
    assert callable(lazy.sg_specular_rgb)
    np.testing.assert_allclose(np.asarray(lazy.sg_rgb), np.asarray(inline.sg_diffuse_rgb),
                               rtol=1e-6)
    re_spec = np.asarray(lazy.sg_specular_rgb(arr(roughness)))
    np.testing.assert_allclose(re_spec, np.asarray(inline.sg_specular_rgb), rtol=1e-6)
    shinier = np.asarray(lazy.sg_specular_rgb(arr(roughness * 0.5)))
    assert np.abs(shinier - re_spec).max() > 1e-4
    assert np.isfinite(grad(lazy.sg_specular_rgb, roughness)).all()


@pytest.mark.parametrize("package", ["jax", "port"])
def test_multi_view_specular_matches_per_view(package):
    """viewdirs [V, N, 3]: each view's specular equals a single-view render
    on the same draws, and the diffuse term is shared
    (``tests/test_sg.py:290``)."""
    render, vis, _, _ = _port(package)
    points, normal, _, lgt, roughness, albedo, spec = _shade_inputs()
    vds = _view_dirs(points.shape[0])
    kw = dict(vis_fn=vis, argmax_vis=True)
    multi = render(points, normal, vds, lgt, spec, roughness, albedo, **kw)
    assert tuple(multi.sg_specular_rgb.shape) == vds.shape
    assert tuple(multi.sg_diffuse_rgb.shape) == (points.shape[0], 3)
    assert tuple(multi.sg_rgb.shape) == vds.shape
    for v in range(vds.shape[0]):
        single = render(points, normal, vds[v], lgt, spec, roughness, albedo, **kw)
        np.testing.assert_allclose(np.asarray(multi.sg_specular_rgb[v]),
                                   np.asarray(single.sg_specular_rgb), rtol=2e-5, atol=1e-6)
        np.testing.assert_allclose(np.asarray(multi.sg_rgb[v]),
                                   np.asarray(single.sg_rgb), rtol=2e-5, atol=1e-6)


def _all_sg(package: str, views, roughness, fun_spec: bool):
    """``render_with_all_sg`` of ``_shade_inputs`` with indirect lights and
    an analytic visibility, on JAX's draws from one key."""
    points, normal, _, lgt, _, albedo, spec = _shade_inputs()
    n, m = points.shape[0], lgt.shape[0]
    indir = np.random.default_rng(8).standard_normal((n, 4, 7)).astype(np.float32)
    indir[..., 3] = 0.1 + 20 * np.abs(indir[..., 3])
    integral = np.random.default_rng(9).uniform(0.1, 1.0, (n, 3)).astype(np.float32)
    key = jax.random.PRNGKey(6)
    args = (points, normal, views, lgt, spec, roughness, albedo)
    if package == "jax":
        return jsg.render_with_all_sg(
            key, *[jnp.asarray(a) for a in args], indir_integral=jnp.asarray(integral),
            indir_lgt_sgs=jnp.asarray(indir), vis_fn=_jvis, vis_outer_fn=_jouter,
            fun_spec=fun_spec)
    draws = Draws(given=jax_sg_draws(key, n, m, diffuse_nsamp=32))
    return tsg.render_with_all_sg(
        draws, *[to_t(a) for a in args], indir_integral=to_t(integral),
        indir_lgt_sgs=to_t(indir), vis_fn=_tvis, vis_outer_fn=_touter, fun_spec=fun_spec)


def test_fun_spec_through_all_sg_matches_jax():
    """Both specular fields as functions of roughness: the port's against
    JAX's at the render's roughness and at half of it, and their gradients
    in roughness; the other fields (diffuse only in ``sg_rgb``) as JAX's."""
    _, _, view, _, rough, _, _ = _shade_inputs()
    got = _all_sg("port", view, rough, True)
    want = _all_sg("jax", view, rough, True)
    for name in ("sg_rgb", "sg_diffuse_rgb", "vis_shadow", "indir_rgb", "indir_diffuse_rgb"):
        assert_close(getattr(got, name), getattr(want, name), **SG_TOL, what=name)
    for name in ("sg_specular_rgb", "indir_specular_rgb"):
        f, jf = getattr(got, name), getattr(want, name)
        for r in (rough, 0.5 * rough):
            assert_close(f(to_t(r)), jf(jnp.asarray(r)), **SG_TOL, what=name)
        x = to_t(rough).requires_grad_()
        g = torch.autograd.grad(torch.sum(f(x) ** 2), x)[0]
        jg = jax.grad(lambda r: jnp.sum(jf(r) ** 2))(jnp.asarray(rough))
        assert_close(g, jg, rtol=5e-4, atol=5e-4 * float(np.abs(np.asarray(jg)).max()),
                     what=f"d {name} / d roughness")
    inline = _all_sg("port", view, rough, False)
    assert_close(got.sg_specular_rgb(to_t(rough)), inline.sg_specular_rgb, rtol=1e-6, atol=0)


def test_multi_view_through_all_sg_matches_jax():
    """[V, N, 3] view directions: sg_rgb and sg_specular_rgb [V, N, 3] as
    JAX's (every view on the one specular draw), the diffuse and the
    indirect terms as JAX's."""
    _, _, _, _, rough, _, _ = _shade_inputs()
    vds = _view_dirs(rough.shape[0])
    got = _all_sg("port", vds, rough, False)
    want = _all_sg("jax", vds, rough, False)
    assert tuple(got.sg_rgb.shape) == tuple(want.sg_rgb.shape) == vds.shape
    for name in got._fields:
        assert_close(getattr(got, name), getattr(want, name), **SG_TOL, what=name)
