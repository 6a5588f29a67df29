"""The PBR stage's render pieces in the port against the JAX package, at the
small widths of ``test_torch_cesr.py`` (8 SG lights x 32 diffuse samples)
on bridged weights and JAX's draws replayed: ``pbr_sg_render`` (every
output, the K3 geometry normals included, at ``use_normal_map`` True and
False); the light-chunked diffuse sweep (``sweep_light_chunk``) against
the single pass and against JAX's ``lax.map`` sweep, values and gradients
with respect to ``lgtSGs``; the SG envmap image functions; the shadow
scene's test split and whole-view rays; and ``render_view`` on a small
view of that split (two chunks, the last padded, each compacted) on the
two-sphere grid that both packages march.

Tolerances: 1e-5 relative (atol 1e-6) on forward values, fp32 in another
summation order; ``render_view``'s buffers (values up to 1) to 1e-5
relative and absolute: its unit normals come from K3's plain version
against JAX's autodiff, up to 3e-6 apart, and the shade sums in another
order; the chunked sweep against the single pass to 1e-6
relative, with an atol of 1e-7 in values and of 1e-6 of the largest entry
in gradients: fp32 rounding of the visibility net's products at other
shapes; the traced masks, the scene's arrays and the rays bit-equal.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robir_tpu.data.syn_dataset import SynDataset as JSynDataset
from robir_tpu.data.syn_dataset import SynDatasetConfig
from robir_tpu.data.synthetic import make_shadow_dataset
from robir_tpu.render import sg as jsg
from robir_tpu.render.stage2 import Stage2Model as JStage2Model
from robir_tpu.stages import pbr as jpbr
from robir_tpu.stages import stage2_runner as jrunner
from robir_tpu_torch.core.draws import Draws
from robir_tpu_torch.core.params import to_numpy
from robir_tpu_torch.data.syn_dataset import shadow_scene
from robir_tpu_torch.render import sg as tsg
from robir_tpu_torch.render.stage2 import Stage2Model
from robir_tpu_torch.stages import pbr as tpbr
from robir_tpu_torch.stages import stage2_runner as trunner
from test_torch_cesr import JCFG, JCFG_GRID, N_LIGHTS, TCFG, TCFG_GRID
from torch_port_helpers import (assert_close, jax_sg_draws, jax_stage2_draws, to_t,
                                two_sphere_grid)

NSAMP = 32  # the PBR render's diffuse samples a light


@pytest.fixture(scope="module")
def params():
    return to_numpy(trunner.init_stage2_params(torch.Generator().manual_seed(2), TCFG))


def _surface_case(params, n: int, seed: int):
    """Points on the shadow scene's larger sphere, view directions, and the
    indirect SGs and integral that the frozen indirect net gives there
    under a random shift (as ``stage2_forward`` hands them to the render),
    as float32 numpy. (SGs of random parameters would not do: at a lobe
    sharpness near 0 the specular SG integral is ill-conditioned in fp32,
    and both packages land up to 9e-5 from fp64 on outputs near 0.3.)"""
    rng = np.random.default_rng(seed)
    p = rng.standard_normal((n, 3))
    points = (0.25 * p / np.linalg.norm(p, axis=-1, keepdims=True)).astype(np.float32)
    v = rng.standard_normal((n, 3))
    shift = rng.random((n, 1)).astype(np.float32)
    isgs, integral = JStage2Model(params, JCFG).indirect(jnp.asarray(points), jnp.asarray(shift))
    return [np.asarray(a, np.float32) for a in (
        points, v / np.linalg.norm(v, axis=-1, keepdims=True), isgs, integral)]


@pytest.mark.parametrize("use_normal_map", [True, False])
def test_pbr_sg_render_matches_jax(params, use_normal_map):
    """Every output of the PBR render on 20 surface points."""
    n = 20
    points, view_dirs, isgs, integral = _surface_case(params, n, 3)
    key = jax.random.PRNGKey(4)
    want = jax.jit(lambda p, k, *a: jpbr.pbr_sg_render(
        JStage2Model(p, JCFG), k, *a[:3], indir_integral=a[3], train_spec=True,
        use_normal_map=use_normal_map))(params, key, points, view_dirs, isgs, integral)
    k_mat, k_sg = jax.random.split(key)
    k_spec, k_norm = jax.random.split(k_mat)
    env = JCFG.envmap
    draws = {"spec_ae": jax.random.normal(k_spec, (n, env.latent_dim)),
             "normal_ae": jax.random.normal(k_norm, (n, env.ipe.out_dim)),
             **jax_sg_draws(k_sg, n, N_LIGHTS, diffuse_nsamp=NSAMP)}
    got = tpbr.pbr_sg_render(Stage2Model(params, TCFG, "cpu"),
                             Draws(given={k: to_t(v) for k, v in draws.items()}),
                             to_t(points), to_t(view_dirs), to_t(isgs),
                             indir_integral=to_t(integral), train_spec=True,
                             use_normal_map=use_normal_map)
    assert got.keys() == want.keys()
    for k in want:
        assert_close(got[k], want[k], rtol=1e-5, atol=1e-6, what=k)
    assert float(np.abs(np.asarray(want["sg_rgb"])).max()) > 1e-3
    # the geometry normals are unit; with them as the shading normal the
    # shade differs from the normal map's
    np.testing.assert_allclose(np.linalg.norm(got["normals"].numpy(), axis=-1), 1.0, rtol=1e-5)


def _sweep_case(params):
    """The sweep's inputs on 10 surface points, the lights as a leaf."""
    points = _surface_case(params, 10, 5)[0]
    normals = points / np.linalg.norm(points, axis=-1, keepdims=True)
    rng = np.random.default_rng(6)
    theta, phi = (rng.random((N_LIGHTS, NSAMP)).astype(np.float32) for _ in range(2))
    lgt = np.asarray(params["envmap_material_network"]["lgtSGs"])
    return points, normals, theta, phi, lgt


def _sweep(model, case, chunk: int, outer: bool = True, calls=None):
    """(visibility [M, N], d sum(vis * w) / d lgtSGs) of the port's sweep."""
    points, normals, theta, phi, lgt = case
    lgt = to_t(lgt).requires_grad_(True)
    fn = model.vis_logits_outer if outer else model.vis_logits
    if calls is not None:
        def fn(*a, _fn=fn):
            calls.append(a[1].shape)
            return _fn(*a)
    vis = tsg.get_diffuse_visibility(
        to_t(points), to_t(normals), None if outer else fn, tsg._unit_lobes(lgt[:, :3]),
        torch.abs(lgt[:, 3]), to_t(theta), to_t(phi), chunk_lights=chunk,
        vis_outer_fn=fn if outer else None)
    w = torch.as_tensor(np.random.default_rng(7).standard_normal(vis.shape).astype(np.float32))
    (grad,) = torch.autograd.grad(torch.sum(vis * w), lgt)
    return vis.detach(), grad


def test_chunked_sweep_matches_the_single_pass(params):
    """Groups of 2 and 4 of the 8 lights (4 and 2 visibility-net calls),
    through the factorised and the broadcast net: the single pass's values
    and gradients with respect to lgtSGs. A chunk that does not divide the
    lights (3), or is not below them (8), runs one pass."""
    model = Stage2Model(params, TCFG, "cpu")
    case = _sweep_case(params)
    vis1, grad1 = _sweep(model, case, 0)
    assert float(vis1.abs().max()) > 0.1 and float(grad1.abs().max()) > 0
    for chunk, outer, n_calls in ((2, True, 4), (4, True, 2), (2, False, 4), (3, True, 1),
                                  (8, True, 1)):
        calls = []
        vis, grad = _sweep(model, case, chunk, outer, calls)
        assert len(calls) == n_calls
        assert_close(vis, vis1, rtol=1e-6, atol=1e-7, what=f"vis, chunk {chunk}")
        assert_close(grad, grad1, rtol=1e-6, atol=1e-6 * float(grad1.abs().max()),
                     what=f"grad, chunk {chunk}")


def test_chunked_sweep_matches_jax(params):
    """The port's sweep in groups of 2 lights against JAX's (lax.map over
    the groups) on the same sample directions."""
    points, normals, _, _, lgt = case = _sweep_case(params)
    key = jax.random.PRNGKey(8)
    k1, k2 = jax.random.split(key)
    theta = np.asarray(jax.random.uniform(k1, (N_LIGHTS, NSAMP)))
    phi = np.asarray(jax.random.uniform(k2, (N_LIGHTS, NSAMP)))
    jl = jnp.asarray(lgt)
    lobes = jl[:, :3] / (jnp.linalg.norm(jl[:, :3], axis=-1, keepdims=True) + jsg.TINY)
    jmodel = JStage2Model(params, JCFG)
    want = jsg.get_diffuse_visibility(key, jnp.asarray(points), jnp.asarray(normals),
                                      jmodel.vis_logits, lobes, jnp.abs(jl[:, 3]), nsamp=NSAMP,
                                      chunk_lights=2, vis_outer_fn=jmodel.vis_logits_outer)
    got, _ = _sweep(Stage2Model(params, TCFG, "cpu"), (*case[:2], theta, phi, lgt), 2)
    assert_close(got, want, rtol=1e-5, atol=1e-6)


def test_sweep_light_chunk_reaches_the_pbr_render(params):
    """``Stage2Config.sweep_light_chunk`` sets the render's sweep: 4
    visibility-net calls of 2 lights x 32 samples, and the same shade."""
    points, view_dirs, isgs, integral = [to_t(a) for a in _surface_case(params, 12, 9)]
    draws = Draws(torch.Generator().manual_seed(0), record=True)
    outs = []
    for chunk in (0, 2):
        model = Stage2Model(params, dataclasses.replace(TCFG, sweep_light_chunk=chunk), "cpu")
        calls = []
        outer = model.vis_logits_outer
        model.vis_logits_outer = lambda p, d: calls.append(d.shape[0]) or outer(p, d)
        outs.append(tpbr.pbr_sg_render(model, draws, points, view_dirs, isgs,
                                       indir_integral=integral))
        draws = Draws(given=draws.taken)
        assert calls == ([N_LIGHTS * NSAMP] if chunk == 0 else [2 * NSAMP] * 4)
    for k in outs[0]:
        assert_close(outs[1][k], outs[0][k], rtol=1e-6, atol=1e-7, what=k)


def test_envmap_functions_match_jax():
    """``envmap_dirs`` (full sphere and upper hemisphere), ``render_envmap_sg``,
    ``compute_envmap`` and ``render_envmap`` (the bilinear lat-long lookup,
    with directions along the poles and across the image's seam)."""
    rng = np.random.default_rng(10)
    lgt = rng.standard_normal((N_LIGHTS, 7)).astype(np.float32)
    lgt[:, 3] = 5 + 20 * rng.random(N_LIGHTS)
    for upper in (False, True):
        assert_close(tsg.envmap_dirs(9, 17, upper), jsg.envmap_dirs(9, 17, upper),
                     rtol=1e-5, atol=1e-6, what=f"dirs, upper {upper}")
        assert_close(tsg.compute_envmap(to_t(lgt), 9, 17, upper),
                     jsg.compute_envmap(jnp.asarray(lgt), 9, 17, upper), rtol=1e-5, atol=1e-6)
    d = rng.standard_normal((50, 3))
    d = np.concatenate([d, [[0, 0, 1], [0, 0, -1], [-1, 1e-7, 0], [-1, -1e-7, 0]]])
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    assert_close(tsg.render_envmap_sg(to_t(lgt), to_t(d)),
                 jsg.render_envmap_sg(jnp.asarray(lgt), jnp.asarray(d)), rtol=1e-5, atol=1e-6)
    env = rng.random((16, 32, 3)).astype(np.float32)
    got = tsg.render_envmap(to_t(env), to_t(d))
    assert_close(got, jsg.render_envmap(jnp.asarray(env), jnp.asarray(d)), rtol=1e-5, atol=1e-6)
    assert got.shape == (54, 3)


def test_shadow_scene_test_split_matches_jax(tmp_path):
    """The test split (its cameras follow the train split's draws): the
    JAX SynDataset's images, masks and poses of ``make_shadow_dataset``'s
    files, ``full_uv`` and a whole view's rays, bit-equal."""
    make_shadow_dataset(str(tmp_path), n_train=3, n_test=2, h=24, w=20)
    want = JSynDataset(SynDatasetConfig(instance_dir=str(tmp_path), split="test"))
    got = shadow_scene(n_train=3, n_test=2, h=24, w=20, split="test")
    assert got.n_cameras == want.n_cameras == 2 and got.img_res == want.img_res
    np.testing.assert_array_equal(got.poses, want.poses)
    np.testing.assert_array_equal(got.full_uv(), want.full_uv())
    for i in range(2):
        np.testing.assert_array_equal(got.rgb_images[i], want.rgb_images[i])
        np.testing.assert_array_equal(got.object_masks[i], want.object_masks[i])
        for a, b in zip(got.camera_rays(i), want.camera_rays(i)):
            np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError):
        shadow_scene(split="val")


def test_render_view_matches_jax():
    """``render_view`` of a 20 x 20 test view in chunks of 256 rays (the last
    one padded from 144), each compacted at 16 rows, on the two-sphere grid:
    every buffer against JAX's ``render_view`` with the per-chunk keys'
    draws replayed; the same hits."""
    params = to_numpy(trunner.init_stage2_params(torch.Generator().manual_seed(3), TCFG_GRID))
    jgrid, tgrid = two_sphere_grid(TCFG_GRID.grid)
    ds = shadow_scene(n_train=3, n_test=1, h=20, w=20, split="test")
    chunk, compact = 256, 16
    key = jax.random.PRNGKey(5)
    want = jrunner.render_view(
        JStage2Model(params, JCFG_GRID, jgrid), ds, 0,
        sg_render_fn=functools.partial(jpbr.pbr_sg_render, use_normal_map=True), key=key,
        chunk=chunk, compact_chunk=compact)

    dirs, cam_loc = ds.camera_rays(0)
    trace = jax.jit(JStage2Model(params, JCFG_GRID, jgrid).trace)
    draws = []
    for start in range(0, dirs.shape[0], chunk):
        d = dirs[start:start + chunk]
        d = np.concatenate([d, np.repeat(d[-1:], chunk - d.shape[0], 0)])
        hit = np.asarray(trace(np.broadcast_to(cam_loc, d.shape), d)[1])
        assert compact < hit.sum() < chunk  # row mode, two chunks of rows or more
        key, k = jax.random.split(key)
        draws.append(jax_stage2_draws(k, chunk, JCFG_GRID, N_LIGHTS, diffuse_nsamp=NSAMP,
                                      surface=hit, chunk=compact))
    got = trunner.render_view(
        Stage2Model(params, TCFG_GRID, "cpu", tgrid), ds, 0,
        sg_render_fn=functools.partial(tpbr.pbr_sg_render, use_normal_map=True),
        draws=lambda c: Draws(given={k: to_t(v) for k, v in draws[c].items()}),
        chunk=chunk, compact_chunk=compact)
    assert got.keys() == want.keys()
    np.testing.assert_array_equal(got["mask"], want["mask"])
    for k in want:
        assert got[k].shape == want[k].shape, k
        assert_close(got[k], want[k], rtol=1e-5, atol=1e-5, what=k)
    assert got["pred_rgb"].shape == (400, 3) and 0 < got["mask"].sum() < 400
