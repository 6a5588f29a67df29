"""The stage-2 options against the JAX package: ``bgr`` (the colour net's
channels reversed in ``Stage2Model.color``, in IDR mode's ``borrow_color``
and in ``neus_bridge_render``, but not in the NeuS bridge's mini render),
``vis_compute_dtype="bfloat16"`` (the visibility net on bf16 operands with
fp32 sums), and ``neus_bridge_render`` (the frozen NeuS rendered in
stage-2 coordinates) with a key (its jitter shared) and without one.

Widths: a 4 x 64 SDF trunk, a 2 x 32 visibility net (and
``configs/hotdog.json``'s 4 x 256 bf16 net for the storage case). Inputs
are seeded numpy, weights the port's init bridged to JAX.

Tolerances: forward values 1e-5; renders 1e-4, as
``test_torch_render_neus.py`` holds them (a 1e-6 change of an SDF value
moves the importance samples continuously; here ``dist`` of one jittered
ray moves by 3.9e-5); gradients rtol 5e-4 with an atol of 5e-4 of each
tensor's largest entry. The bf16 visibility logits, where both
packages round the same fp32 operands to bf16 and sum in fp32, within
BF16_ULPS roundoffs (2^-8) of the largest logit: the operands are each
side's own positional encoding, and an input within an fp32 ulp of a bf16
rounding boundary could round apart. Measured on this case: the two
packages' bf16 logits agree to 0.0000 roundoffs on both nets, and each is
1.30 roundoffs from the fp32 logits.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robir_tpu.core import config as jconfig
from robir_tpu.fields import sdf as jsdf
from robir_tpu.fields.radiance import RenderingConfig as JRender
from robir_tpu.render.neus import Rays as JRays
from robir_tpu.render.stage2 import Stage2Model as JStage2Model
from robir_tpu.render.stage2 import neus_bridge_render as jbridge
from robir_tpu_torch.core import config as tconfig
from robir_tpu_torch.core.params import to_numpy
from robir_tpu_torch.fields import sdf as tsdf
from robir_tpu_torch.fields.radiance import RenderingConfig
from robir_tpu_torch.render.neus import Rays
from robir_tpu_torch.render.stage2 import Stage2Model, neus_bridge_render
from robir_tpu_torch.stages import stage2_runner as trunner
from test_torch_cesr import JCFG, TCFG
from torch_port_helpers import assert_close, assert_grads_match, to_np, to_t

FWD = dict(rtol=1e-5, atol=1e-5)
RENDER_TOL = dict(rtol=1e-4, atol=1e-4)
BF16_ULPS = 1.0
TRUNK = dict(d_out=33, d_hidden=64, n_layers=4, skip_in=(2,), multires=3)
IDR_TRUNK = dict(TRUNK, skip_in=(), bias=0.3)
COLOR = dict(d_feature=32, d_hidden=32, n_layers=2)
N_RAYS = 24


def _cfgs(use_neus: bool = True, **kw):
    trunk = TRUNK if use_neus else IDR_TRUNK
    j = dataclasses.replace(JCFG, use_neus=use_neus, neus=dataclasses.replace(
        JCFG.neus, sdf=jsdf.SDFConfig(**trunk), color=JRender(**COLOR)), **kw)
    t = dataclasses.replace(TCFG, use_neus=use_neus, neus=dataclasses.replace(
        TCFG.neus, sdf=tsdf.SDFConfig(**trunk), color=RenderingConfig(**COLOR)), **kw)
    return j, t


def _params(tcfg, seed: int = 0) -> dict:
    return to_numpy(trunner.init_stage2_params(torch.Generator().manual_seed(seed), tcfg))


def _queries(seed: int = 3, n: int = 17):
    rng = np.random.default_rng(seed)
    x = (0.25 * rng.standard_normal((n, 3))).astype(np.float32)
    d = rng.standard_normal((n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    feat = rng.standard_normal((n, 32)).astype(np.float32)
    return x, d, feat


def _rays(seed: int = 5):
    """Stage-2 rays from a sphere of radius 1.6 toward the unit ball, with
    near/far around it; as both packages' ``Rays``."""
    rng = np.random.default_rng(seed)
    o = rng.standard_normal((N_RAYS, 3))
    o = (1.6 * o / np.linalg.norm(o, axis=-1, keepdims=True)).astype(np.float32)
    d = -o + 0.3 * rng.standard_normal((N_RAYS, 3))
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    near = np.full((N_RAYS, 1), 0.6, np.float32)
    far = np.full((N_RAYS, 1), 2.6, np.float32)
    arrs = (o, d, d, np.zeros_like(near), np.ones_like(near), near, far)
    return Rays(*[to_t(a) for a in arrs]), JRays(*[jnp.asarray(a) for a in arrs])


@pytest.mark.parametrize("use_neus", [True, False], ids=["neus", "idr"])
def test_bgr_in_color_and_borrow_color(use_neus):
    """``color`` reverses its channels under ``bgr``; IDR mode's
    ``borrow_color`` goes through it and flips, the NeuS bridge's mini
    render does not (the reference's ``borrow_color`` calls the stage-1
    colour net directly). Each against JAX's ``Stage2Model``."""
    (jcfg, tcfg), (jbgr, tbgr) = _cfgs(use_neus), _cfgs(use_neus, bgr=True)
    params = _params(tcfg)
    x, d, feat = _queries()
    tx, td, tf = to_t(x), to_t(d), to_t(feat)
    outs = {}
    for name, jc, tc in (("rgb", jcfg, tcfg), ("bgr", jbgr, tbgr)):
        jm, tm = JStage2Model(params, jc), Stage2Model(params, tc, "cpu")
        want = jax.jit(lambda x, d, f: (jm.color(x, x, d, f), jm.borrow_color(x, d)))(x, d, feat)
        got = (tm.color(tx, tx, td, tf), tm.borrow_color(tx, td))
        for what, a, b in zip(("color", "borrow_color"), got, want):
            assert_close(a, b, **FWD, what=f"{name} {what}")
        outs[name] = got
    flip = lambda t: torch.flip(t, (-1,))  # noqa: E731
    assert torch.equal(outs["bgr"][0], flip(outs["rgb"][0]))
    assert not torch.equal(outs["rgb"][0], flip(outs["rgb"][0]))
    if use_neus:
        assert torch.equal(outs["bgr"][1], outs["rgb"][1])
    else:
        assert torch.equal(outs["bgr"][1], flip(outs["rgb"][1]))


@pytest.mark.parametrize("keyed", [False, True], ids=["eval", "key"])
def test_neus_bridge_render_matches_jax(keyed):
    """``neus_bridge_render`` at ``storage_dtype`` null against JAX's, on
    the JAX render's jitter where it has a key (``t_rand``, JAX's first
    split) and as an eval render without one: the six outputs, and with a
    key the gradient of the colour sum to the frozen NeuS (through K3's and
    K4's plain versions). Under ``bgr`` the colours are reversed."""
    jcfg, tcfg = _cfgs()
    params = _params(tcfg)
    trays, jrays = _rays()
    key = jax.random.PRNGKey(11) if keyed else None
    t_rand = None
    if keyed:
        t_rand = to_t(np.asarray(jax.random.uniform(jax.random.split(key)[1], (N_RAYS, 1)))
                      - 0.5)

    def jrender(p, cfg=jcfg):
        return jbridge(JStage2Model(p, cfg), jrays, key=key)

    want = jax.jit(jrender)(params)
    model = Stage2Model(params, tcfg, "cpu")
    got = neus_bridge_render(model, trays, t_rand=t_rand)
    assert sorted(got) == sorted(want)
    for k in want:
        assert_close(got[k], want[k], **RENDER_TOL, what=k)
    acc = to_np(got["acc"])
    assert 0 < int((acc > 0.5).sum()) < N_RAYS  # some rays hit the sphere, some miss
    assert np.all(to_np(got["indir_rgb"]) == 0)

    jb, tb = _cfgs(bgr=True)
    flipped = neus_bridge_render(Stage2Model(params, tb, "cpu"), trays, t_rand=t_rand)
    assert torch.equal(flipped["idr_rgb"], torch.flip(got["idr_rgb"], (-1,)))
    assert_close(flipped["sg_rgb"], jax.jit(lambda p: jrender(p, jb))(params)["sg_rgb"],
                 **RENDER_TOL)

    if keyed:
        grads = jax.jit(jax.grad(lambda p: jnp.sum(jrender(p)["idr_rgb"])))(params)
        torch.sum(got["idr_rgb"]).backward()
        assert_grads_match(model.params["implicit_network"], grads["implicit_network"])


def _vis_case(seed: int = 7, n: int = 13, k: int = 9):
    rng = np.random.default_rng(seed)
    p = (0.5 * rng.standard_normal((n, 3))).astype(np.float32)
    d = rng.standard_normal((k, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return p, d


def _logits(jm, tm, p, d):
    """(port, JAX) logits of the per-pair net on every (point, direction)
    and of the outer sweep."""
    n, k = p.shape[0], d.shape[0]
    pp = np.repeat(p, k, 0)
    dd = np.tile(d, (n, 1))
    want = jax.jit(lambda a, b, c, e: (jm.vis_logits(a, b), jm.vis_logits_outer(c, e)))(
        pp, dd, p, d)
    got = (tm.vis_logits(to_t(pp), to_t(dd)), tm.vis_logits_outer(to_t(p), to_t(d)))
    return got, want


def test_vis_compute_dtype_at_fp32_storage():
    """bf16 operands with fp32 sums, on both nets: the port within
    BF16_ULPS roundoffs of JAX's bf16 route; each at least 0.25 roundoff
    from the fp32 logits, so that a route left in fp32 fails; fp32 out."""
    jcfg, tcfg = _cfgs()
    jbf, tbf = _cfgs(vis_compute_dtype="bfloat16")
    params = _params(tcfg)
    p, d = _vis_case()
    got, want = _logits(JStage2Model(params, jbf), Stage2Model(params, tbf, "cpu"), p, d)
    fp32, _ = _logits(JStage2Model(params, jcfg), Stage2Model(params, tcfg, "cpu"), p, d)
    for what, g, w, f in zip(("per pair", "outer"), got, want, fp32):
        assert g.dtype == torch.float32
        ulp = float(np.abs(to_np(f)).max()) / 256
        err = float(np.abs(to_np(g) - np.asarray(w)).max())
        gap = float((g - f).detach().abs().max())
        assert err <= BF16_ULPS * ulp, f"{what}: {err / ulp:.3f} roundoffs from JAX"
        assert gap >= 0.25 * ulp, f"{what}: {gap / ulp:.3f} roundoffs from fp32"
    assert_close(got[1].reshape(-1, 2), got[0], rtol=0, atol=BF16_ULPS * float(
        got[0].detach().abs().max()) / 256)


def test_vis_compute_dtype_changes_nothing_under_bf16_storage():
    """At ``configs/hotdog.json`` the visibility net stores bf16, and
    storage wins over ``vis_compute_dtype``: the option leaves both
    packages' logits as they were, and the port stays within bf16 storage
    rounding of JAX (1e-2 of the largest logit, the CESR tests' bf16
    bound)."""
    raw = jconfig.load_config("configs/hotdog.json")["model"]
    assert raw["visibility_network"]["storage_dtype"] == "bfloat16"
    jcfg, tcfg = jconfig.build_stage2_config(raw), tconfig.build_stage2_config(raw)
    small_j, small_t = _cfgs()
    jcfg = dataclasses.replace(small_j, visnet=jcfg.visnet)
    tcfg = dataclasses.replace(small_t, visnet=tcfg.visnet)
    params = _params(tcfg)
    p, d = _vis_case(n=5, k=4)
    base, jbase = _logits(JStage2Model(params, jcfg), Stage2Model(params, tcfg, "cpu"), p, d)
    opt = dict(vis_compute_dtype="bfloat16")
    got, want = _logits(JStage2Model(params, dataclasses.replace(jcfg, **opt)),
                        Stage2Model(params, dataclasses.replace(tcfg, **opt), "cpu"), p, d)
    for g, b, w, jb in zip(got, base, want, jbase):
        assert torch.equal(g, b)
        np.testing.assert_array_equal(np.asarray(w), np.asarray(jb))
        assert_close(g, w, rtol=0, atol=1e-2 * float(np.abs(np.asarray(w)).max()))


def test_options_build_and_refuse():
    """Both options build; an unknown ``vis_compute_dtype`` is refused."""
    _, tcfg = _cfgs(bgr=True, vis_compute_dtype="bfloat16")
    assert tcfg.bgr and tcfg.vis_compute_dtype == "bfloat16"
    with pytest.raises(ValueError, match="vis_compute_dtype"):
        dataclasses.replace(tcfg, vis_compute_dtype="float16")
