"""The Vis stage's modules in the port against the JAX package, at small
widths on bridged weights: the energy net (``energy_apply``,
``energy_scalar``) and a few ``fit_energy`` steps on JAX's draws replayed;
``query_indir_illum`` and ``illum_loss`` (L1 and L2, with ``anneal_t``);
``volume_render_color`` and ``borrow_color``; ``spherical_uniform``;
``masked_pixels``; and the ``vis`` config section. (The Illum forward and
``trace_radiance``: ``test_torch_vis_trace.py``; the whole step:
``test_torch_vis_step.py``.)

Tolerances: 1e-5 on forward values (fp32, other summation order), 5e-4
relative on gradients; the energy net's weights after 3 Adam steps to
1e-6 (each step moves them by about 5e-4).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robir_tpu.core.config import build_stage_config as jbuild_stage_config
from robir_tpu.data.syn_dataset import SynDataset as JSynDataset
from robir_tpu.render import color as jcolor
from robir_tpu.render.stage2 import Stage2Model as JStage2Model
from robir_tpu.render.stage2 import spherical_uniform as jspherical_uniform
from robir_tpu.stages import losses as jlosses
from robir_tpu.stages.vis import VisStageConfig as JVisStageConfig
from robir_tpu_torch.core import tree as ttree
from robir_tpu_torch.core.config import build_stage_config, load_config
from robir_tpu_torch.core.draws import Draws
from robir_tpu_torch.core.params import from_jax, to_numpy
from robir_tpu_torch.data.syn_dataset import shadow_scene
from robir_tpu_torch.render import color as tcolor
from robir_tpu_torch.render.stage2 import Stage2Model, spherical_uniform
from robir_tpu_torch.stages import losses as tlosses
from robir_tpu_torch.stages import stage2_runner as trunner
from robir_tpu_torch.stages.vis import VisStageConfig
from test_torch_cesr import JCFG, TCFG
from torch_port_helpers import assert_close, jax_energy_draws, to_t


def _np(tree):
    return jax.tree_util.tree_map(np.array, tree)


def _energy_params():
    return _np(jcolor.init_energy(jax.random.PRNGKey(2)))


def test_energy_net_matches_jax():
    """energy_apply, energy_scalar, and energy_apply's weight gradients."""
    params = _energy_params()
    shift = np.random.default_rng(0).random((37, 1)).astype(np.float32)
    w = np.random.default_rng(1).standard_normal((37, 3)).astype(np.float32)
    want = jcolor.energy_apply(params, jnp.asarray(shift))
    want_s = jcolor.energy_scalar({"energy": params}, jnp.asarray(shift))
    jgrads = jax.grad(lambda p: jnp.sum(jcolor.energy_apply(p, jnp.asarray(shift)) * w))(params)
    tp = from_jax(params)
    got = tcolor.energy_apply(tp, to_t(shift))
    assert_close(got, want, rtol=1e-5, atol=1e-6)
    assert_close(tcolor.energy_scalar({"energy": tp}, to_t(shift)), want_s, rtol=1e-5, atol=1e-6)
    torch.sum(got * to_t(w)).backward()
    flat = ttree.flatten_with_paths(jax.tree_util.tree_map(np.asarray, jgrads))
    for path, leaf in ttree.flatten_with_paths(tp).items():
        assert_close(leaf.grad, flat[path], rtol=5e-4, atol=5e-4 * np.abs(flat[path]).max(),
                     what=path)


def test_fit_energy_matches_jax():
    """Three steps of fit_energy (Adam, b2 0.99) on a pixel set, from JAX's
    init and with JAX's shift and index draws replayed."""
    px = np.random.default_rng(3).random((500, 3)).astype(np.float32)
    tone = jcolor.ToneMapConfig(hdr_mode=0)
    gamma = jcolor.init_tonemap(tone)
    key = jax.random.PRNGKey(5)
    kw = dict(n_steps=3, batch_px=64, batch_shift=16)
    want = jcolor.fit_energy(key, jnp.asarray(px),
                             lambda x, s: jcolor.ldr2hdr(gamma, tone, x, s), **kw)
    steps = jax_energy_draws(key, 3, 500, 64, 16)
    assert len(np.unique(steps[0]["energy_pixels"])) > 32
    tgamma = from_jax(_np(gamma))
    got = tcolor.fit_energy(
        _np(jcolor.init_energy(key)), to_t(px),
        lambda x, s: tcolor.ldr2hdr(tgamma, tcolor.ToneMapConfig(hdr_mode=0), x, s),
        lambda i: Draws(given={k: torch.tensor(v) for k, v in steps[i].items()}), **kw)
    flat = ttree.flatten_with_paths(jax.tree_util.tree_map(np.asarray, want))
    init = ttree.flatten_with_paths(_np(jcolor.init_energy(key)))
    for path, leaf in ttree.flatten_with_paths(got).items():
        assert not np.array_equal(leaf.detach().numpy(), init[path]), path  # it moved
        assert_close(leaf, flat[path], rtol=0, atol=1e-6, what=path)


def _illum_case(seed=4, n=9, s=11, lobes=5):
    rng = np.random.default_rng(seed)
    sgs = rng.standard_normal((n, lobes, 7)).astype(np.float32)
    sgs[..., 3] = rng.random((n, lobes)) * 20
    dirs = rng.standard_normal((n, s, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    return dict(
        indirect_sgs=sgs, indir_integral=rng.random((n, 3)).astype(np.float32),
        network_object_mask=rng.random(n) < 0.7,
        trace_radiance=rng.random((n, s, 3)).astype(np.float32), sample_dirs=dirs,
        gt_vis=rng.random((n, s)) < 0.4,
        pred_vis=rng.standard_normal((n, s, 2)).astype(np.float32),
        indir_mask=rng.random((n, s)) < 0.5,
        gt_integral=rng.random((n, 3)).astype(np.float32))


def test_query_indir_illum_matches_jax():
    case = _illum_case()
    want = jlosses.query_indir_illum(jnp.asarray(case["indirect_sgs"]),
                                     jnp.asarray(case["sample_dirs"]))
    got = tlosses.query_indir_illum(to_t(case["indirect_sgs"]), to_t(case["sample_dirs"]))
    assert got.shape == (9, 11, 3)
    assert_close(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("loss_type,anneal_t", [("L1", 0.0), ("L1", 0.3), ("L2", 0.3)])
def test_illum_loss_matches_jax(loss_type, anneal_t):
    """Both losses, and their gradients in the SGs, the integral and the
    logits."""
    case = _illum_case()
    diff = ("indirect_sgs", "indir_integral", "pred_vis")

    def jloss(args):
        r, v = jlosses.illum_loss(jlosses.IllumLossConfig(loss_type),
                                  **{**{k: jnp.asarray(x) for k, x in case.items()}, **args},
                                  anneal_t=anneal_t)
        return r + 2 * v, (r, v)

    (_, (jr, jv)), jg = jax.value_and_grad(jloss, has_aux=True)(
        {k: jnp.asarray(case[k]) for k in diff})
    targs = {k: torch.as_tensor(v) for k, v in case.items()}
    for k in diff:
        targs[k].requires_grad_(True)
    r, v = tlosses.illum_loss(tlosses.IllumLossConfig(loss_type), **targs, anneal_t=anneal_t)
    assert_close(r, jr, rtol=1e-5, atol=1e-7)
    assert_close(v, jv, rtol=1e-5, atol=1e-7)
    (r + 2 * v).backward()
    for k in diff:
        g = np.asarray(jg[k])
        assert_close(targs[k].grad, g, rtol=5e-4, atol=5e-4 * np.abs(g).max(), what=k)
    with pytest.raises(ValueError):
        tlosses.illum_loss(tlosses.IllumLossConfig("L3"), **targs)


@pytest.fixture(scope="module")
def params():
    return to_numpy(trunner.init_stage2_params(torch.Generator().manual_seed(0), TCFG))


def test_borrow_color_matches_jax(params):
    """The 16-sample mini render: borrow_color (K3's and the colour net's
    plain versions here) at points near the NeuS's surface, whole and in
    slices; the bridge's colour net (``color``, at stage-2 points); and
    volume_render_color on given samples."""
    rng = np.random.default_rng(6)
    x = rng.standard_normal((23, 3)).astype(np.float32)
    x = 0.26 * x / np.linalg.norm(x, axis=-1, keepdims=True)
    d = rng.standard_normal((23, 3)).astype(np.float32)
    jm, tm = JStage2Model(params, JCFG), Stage2Model(params, TCFG, "cpu")
    want = jax.jit(jm.borrow_color)(jnp.asarray(x), jnp.asarray(d))
    with torch.no_grad():
        got = tm.borrow_color(to_t(x), to_t(d))
    assert got.shape == (23, 3) and float(got.abs().max()) > 1e-3
    assert_close(got, want, rtol=1e-5, atol=1e-6)
    with torch.no_grad():
        assert_close(tm.borrow_color(to_t(x), to_t(d), chunk=5), got, rtol=1e-6, atol=1e-7)
    n = rng.standard_normal((23, 3)).astype(np.float32)
    feat = rng.standard_normal((23, 32)).astype(np.float32)
    with torch.no_grad():
        assert_close(tm.color(to_t(x), to_t(n), to_t(d), to_t(feat)),
                     jm.color(*map(jnp.asarray, (x, n, d, feat))), rtol=1e-5, atol=1e-6)
    sdf = (0.02 * rng.standard_normal((5, 16, 1))).astype(np.float32)
    col = rng.random((5, 16, 3)).astype(np.float32)
    assert_close(tm.volume_render_color(to_t(sdf), to_t(col)),
                 jm.volume_render_color(jnp.asarray(sdf), jnp.asarray(col)),
                 rtol=1e-5, atol=1e-6)


def test_spherical_uniform_matches_jax():
    key = jax.random.PRNGKey(8)
    want = np.asarray(jspherical_uniform(key, (7, 13)))
    k1, k2 = jax.random.split(key)
    got = spherical_uniform(Draws(given={
        "sphere_u": to_t(jax.random.uniform(k1, (7, 13))),
        "sphere_t": to_t(jax.random.uniform(k2, (7, 13)))}), (7, 13))
    assert_close(got, want, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(np.linalg.norm(got.numpy(), axis=-1), 1.0, atol=1e-6)


def test_masked_pixels_matches_jax():
    ds = shadow_scene(n_train=2, h=16, w=16)
    want = JSynDataset.masked_pixels(ds)
    got = ds.masked_pixels()
    assert got.shape == (sum(int(m.sum()) for m in ds.object_masks), 3)
    np.testing.assert_array_equal(got, want)


def test_vis_config_section_matches_jax():
    """configs/hotdog.json's vis section gives the JAX package's config;
    unknown keys are refused; shard_fan: true is taken as JAX takes it
    (with one process a rank it changes nothing: test_torch_dist_stage2.py)."""
    raw = load_config("configs/hotdog.json")["vis"]
    got = dataclasses.asdict(build_stage_config(VisStageConfig, raw))
    want = dataclasses.asdict(jbuild_stage_config(JVisStageConfig, raw))
    assert got == want and got["nsamp"] == 512 and got["fan_compact_chunk"] == 4096
    with pytest.raises(KeyError):
        build_stage_config(VisStageConfig, {**raw, "fan_chunk": 1})
    fan = {**raw, "shard_fan": True}
    assert dataclasses.asdict(build_stage_config(VisStageConfig, fan)) == dataclasses.asdict(
        jbuild_stage_config(JVisStageConfig, fan))
    assert build_stage_config(VisStageConfig, fan).shard_fan
    assert not build_stage_config(VisStageConfig, {**raw, "shard_fan": False}).shard_fan
