"""The library functions that no stage calls, against the JAX package: the
schedule library (``tests/test_core.py``'s ``TestSchedule`` on both
packages, and every schedule against JAX's over a range of steps),
``tangent_space`` (``test_tangent_space_parity``), ``tree_size_bytes``, the
learnable grid embedder (against JAX and against ``grid_sample``, with its
gradient), ``ipe_isotropic``, InvLoss's eikonal, mask and normal-consistency
terms (and over two ranks), ``sphere_scene`` and
``build_neus_render_config``.

Tolerances: forward values 1e-5 (schedules rtol 1e-6: both compute in
float32 from the same formulas); gradients rtol 5e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robir_tpu.core import config as jconfig
from robir_tpu.core import schedule as jsched
from robir_tpu.core import tree as jtree
from robir_tpu.data import synthetic as jsyn
from robir_tpu.fields import encoding as jenc
from robir_tpu.stages import losses as jlosses
from robir_tpu_torch.core import config as tconfig
from robir_tpu_torch.core import mesh as tmesh
from robir_tpu_torch.core import schedule as tsched
from robir_tpu_torch.core import tree as ttree
from robir_tpu_torch.core.params import from_jax, to_numpy
from robir_tpu_torch.data import synthetic as tsyn
from robir_tpu_torch.fields import encoding as tenc
from robir_tpu_torch.stages import losses as tlosses
from torch_port_helpers import assert_close, rank_inv_losses, to_t

STEPS = np.array([0, 1, 5, 9, 10, 15, 50, 99, 100, 101, 150, 1000], np.float32)
SCHEDULES = [
    ("constant", 0.3),
    ("linear", 1.0, 0.0, 100),
    ("linear", 0.5, 2.0, 0),
    ("exponential", 1.0, 0.01, 101),
    ("cosine_easing", 0.0, 1.0, 100),
    ("step", 1.0, 10, 0.5, 4),
    ("step", 2.0, 25, 0.1, 3, 1e-3),
    ("piecewise", [(10, ("constant", 1.0)), (10, ("linear", 1.0, 0.0, 10)),
                   (5, ("exponential", 0.5, 0.05, 5))]),
    ("delayed", ("linear", 1.0, 0.1, 100), 20, 0.01),
]


@pytest.mark.parametrize("sched", [tsched, jsched], ids=["port", "jax"])
class TestSchedule:
    """``tests/test_core.py:TestSchedule`` on each package."""

    def test_linear(self, sched):
        fn = sched.from_config(("linear", 1.0, 0.0, 100))
        assert float(fn(0)) == 1.0
        assert float(fn(50)) == pytest.approx(0.5)
        assert float(fn(1000)) == 0.0

    def test_exponential(self, sched):
        fn = sched.from_config({"type": "exponential", "initial_value": 1.0,
                                "final_value": 0.01, "num_steps": 101})
        assert float(fn(0)) == pytest.approx(1.0)
        assert float(fn(200)) == pytest.approx(0.01)

    def test_scalar_is_constant(self, sched):
        fn = sched.from_config(0.3)
        assert float(fn(12345)) == pytest.approx(0.3)

    def test_log_lerp_matches_reference(self, sched):
        lr_init, lr_final, max_steps, delay, mult = 5e-4, 5e-6, 200_000, 2500, 0.01
        fn = sched.log_lerp_lr(lr_init, lr_final, max_steps, delay, mult)
        for step in [0, 100, 2500, 50_000, 200_000]:
            delay_rate = mult + (1 - mult) * np.sin(0.5 * np.pi * np.clip(step / delay, 0, 1))
            t = np.clip(step / max_steps, 0, 1)
            want = delay_rate * np.exp(np.log(lr_init) * (1 - t) + np.log(lr_final) * t)
            assert float(fn(step)) == pytest.approx(float(want), rel=1e-5)

    def test_piecewise(self, sched):
        fn = sched.from_config(("piecewise", [(10, ("constant", 1.0)),
                                             (10, ("linear", 1.0, 0.0, 10))]))
        assert float(fn(5)) == 1.0
        assert float(fn(15)) == pytest.approx(0.5)


@pytest.mark.parametrize("cfg", SCHEDULES, ids=[s[0] + str(i) for i, s in enumerate(SCHEDULES)])
def test_schedules_match_jax(cfg):
    """Each schedule, as a tuple, a mapping-free tuple inside ``piecewise``
    and ``delayed``, and as a ``ScheduleConfig``, over steps on each side
    of its milestones: the port's float32 values against JAX's."""
    want = np.asarray(jsched.from_config(cfg)(jnp.asarray(STEPS)))
    got = tsched.from_config(cfg)(STEPS)
    assert got.dtype == np.float32 and got.shape == STEPS.shape
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    scalar = [float(tsched.from_config(cfg)(int(s))) for s in STEPS]
    np.testing.assert_allclose(scalar, want, rtol=1e-6, atol=1e-7)
    if cfg[0] not in ("piecewise", "delayed"):
        built = tsched.ScheduleConfig(cfg[0], tuple(cfg[1:])).build()
        np.testing.assert_allclose(built(STEPS), want, rtol=1e-6, atol=1e-7)


def test_from_config_forms():
    """A mapping, a callable (as it is), and the errors: an unknown type
    names it, an unknown form is refused, a rising exponential raises."""
    fn = tsched.from_config({"type": "cosine_easing", "initial_value": 0.0,
                             "final_value": 2.0, "num_steps": 10})
    assert float(fn(5)) == pytest.approx(float(jsched.cosine_easing(0.0, 2.0, 10)(5)))
    own = lambda s: s  # noqa: E731
    assert tsched.from_config(own) is own
    with pytest.raises(KeyError, match="nope"):
        tsched.from_config(("nope", 1.0))
    with pytest.raises(ValueError):
        tsched.from_config(object())
    with pytest.raises(ValueError):
        tsched.exponential(0.1, 1.0, 10)


def test_tangent_space_parity():
    """``tests/test_core.py:test_tangent_space_parity``: an orthogonal
    frame, and the port's equal to JAX's, degenerate normals (along x,
    where the 1e-4 clamps act) included."""
    rng = np.random.default_rng(9)
    n = rng.standard_normal((20, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    n[0] = (1.0, 0.0, 0.0)
    n[1] = 0.0
    b, c = ttree.tangent_space(to_t(n))
    assert np.abs(np.sum(b.numpy()[2:] * n[2:], -1)).max() < 1e-5
    assert np.abs(np.sum(c.numpy()[2:] * n[2:], -1)).max() < 1e-5
    wb, wc = jtree.tangent_space(jnp.asarray(n))
    assert_close(b, wb, rtol=1e-5, atol=1e-6)
    assert_close(c, wc, rtol=1e-5, atol=1e-6)


def test_tree_size_bytes_matches_jax():
    tree = {"a": {"w": np.zeros((3, 4), np.float32), "b": np.zeros(4, np.float32)},
            "c": np.zeros((2, 2), np.float16)}
    want = jtree.tree_size_bytes(jax.tree_util.tree_map(jnp.asarray, tree))
    assert ttree.tree_size_bytes(tree) == want == 48 + 16 + 8
    assert ttree.tree_size_bytes(from_jax({"a": tree["a"]})) == 64


def _grid_points(seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return np.concatenate([
        rng.uniform(-0.95, 0.95, (64, 3)),
        rng.uniform(-1.3, 1.3, (64, 3)),   # partly outside the grid
        np.array([[1.0, -1.0, 0.0], [0.0, 0.0, 0.0]]),
    ]).astype(np.float32)


def test_grid_embed_matches_jax_and_grid_sample():
    """``tests/test_fields.py:test_grid_embed_matches_torch_grid_sample`` on
    the port: the port's grid embedder against JAX's (the same grid through
    the weights bridge) and against ``F.grid_sample`` directly, inside,
    outside and on the boundary; its gradient to the grid against JAX's;
    ``init_grid_embed``'s shape and N(0, 1) values from a generator."""
    cfg = tenc.GridEmbedConfig(n_cells=9, out_dim=5)
    jcfg = jenc.GridEmbedConfig(n_cells=9, out_dim=5)
    jparams = jenc.init_grid_embed(jax.random.PRNGKey(0), jcfg)
    params = from_jax(jax.tree_util.tree_map(np.asarray, jparams))
    pts = _grid_points()
    got = tenc.grid_embed(params, cfg, to_t(pts))
    want = jenc.grid_embed(jparams, jcfg, jnp.asarray(pts))
    assert got.shape == (pts.shape[0], 5)
    assert_close(got, want, rtol=1e-5, atol=1e-5)
    ref = torch.nn.functional.grid_sample(params["grid"].detach()[None],
                                          to_t(pts).view(1, -1, 1, 1, 3), align_corners=False)
    assert_close(got, ref.view(5, -1).t(), rtol=1e-5, atol=1e-5)
    torch.sum(tenc.grid_embed(params, cfg, to_t(pts[:64])) ** 2).backward()
    jgrad = jax.grad(lambda p: jnp.sum(jenc.grid_embed(p, jcfg, jnp.asarray(pts[:64])) ** 2))(
        jparams)["grid"]
    scale = float(jnp.abs(jgrad).max())
    assert scale > 0
    assert_close(params["grid"].grad, jgrad, rtol=5e-4, atol=5e-4 * scale)
    # [..., 3] inputs keep their leading shape
    assert tenc.grid_embed(params, cfg, to_t(pts[:12]).reshape(3, 4, 3)).shape == (3, 4, 5)
    init = tenc.init_grid_embed(torch.Generator().manual_seed(0), cfg)
    assert init["grid"].shape == (5, 9, 9, 9)
    assert abs(float(init["grid"].mean())) < 0.2 and 0.8 < float(init["grid"].std()) < 1.2
    assert to_numpy(from_jax(init))["grid"].shape == (5, 9, 9, 9)


def test_ipe_isotropic_matches_jax():
    x = np.random.default_rng(1).standard_normal((23, 3)).astype(np.float32)
    for var in (0.005, 0.05):
        want = jenc.ipe_isotropic(jnp.asarray(x), jenc.IPEConfig(0, 6), var=var)
        got = tenc.ipe_isotropic(to_t(x), tenc.IPEConfig(0, 6), var=var)
        assert got.shape == (23, 36)
        assert_close(got, want, rtol=1e-5, atol=1e-5)


def _loss_case(seed: int = 2, n: int = 30):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, 3)).astype(np.float32),
            (0.1 * rng.standard_normal((n, 1))).astype(np.float32),
            rng.random(n) > 0.5, rng.random(n) > 0.5,
            rng.standard_normal((n, 3)).astype(np.float32))


def test_inv_loss_terms_match_jax():
    """eikonal, mask (BCE on -alpha sdf where not both masks) and normal
    consistency (masked MSE), forward and gradients, against JAX's; the
    empty surface mask gives 0."""
    g, sdf, net, obj, nmap = _loss_case()
    cfg, jcfg = tlosses.InvLossConfig(alpha=50.0), jlosses.InvLossConfig(alpha=50.0)
    tg, tsdf, tn = (to_t(a).requires_grad_() for a in (g, sdf, nmap))
    terms = [
        (tlosses.eikonal_loss(tg), jlosses.eikonal_loss, (g,), [tg]),
        (tlosses.mask_loss(cfg, tsdf, torch.as_tensor(net), torch.as_tensor(obj)),
         lambda s: jlosses.mask_loss(jcfg, s, jnp.asarray(net), jnp.asarray(obj)), (sdf,),
         [tsdf]),
        (tlosses.normal_consistency_loss(tn, to_t(g), torch.as_tensor(obj)),
         lambda m: jlosses.normal_consistency_loss(m, jnp.asarray(g), jnp.asarray(obj)),
         (nmap,), [tn]),
    ]
    for got, jfn, jargs, targs in terms:
        want, jgrad = jax.value_and_grad(jfn)(*[jnp.asarray(a) for a in jargs])
        assert_close(got, want, rtol=1e-5, atol=1e-6)
        (tgrad,) = torch.autograd.grad(got, targs)
        assert_close(tgrad, jgrad, rtol=5e-4, atol=1e-7)
    none = torch.zeros(30, dtype=torch.bool)
    assert float(tlosses.normal_consistency_loss(to_t(nmap), to_t(g), none)) == 0.0


def test_inv_loss_terms_over_two_ranks():
    """Under a mesh each term is this rank's share: two gloo ranks' values
    add up to the one process's on the global batch."""
    case = _loss_case(n=32)
    ranks = tmesh.spawn_ranks(rank_inv_losses, 2, *case, device="cpu", timeout_s=120.0)
    np.testing.assert_allclose(np.sum(ranks, 0), rank_inv_losses(None, *case), rtol=1e-5)


def test_sphere_scene_matches_jax(tmp_path):
    """The sphere scene written to disk and read back: the same images,
    masks, cameras and rays as the JAX package's ``sphere_scene``."""
    kw = dict(n_train=2, n_test=1, h=16, w=16)
    got = tsyn.sphere_scene(str(tmp_path / "port"), **kw)
    want = jsyn.sphere_scene(str(tmp_path / "jax"), **kw)
    for name in ("images", "masks", "camtoworlds"):
        np.testing.assert_array_equal(getattr(got, name), np.asarray(getattr(want, name)))
    assert got.n_images == want.n_images == 2 and got.focal == pytest.approx(want.focal)
    rng = np.random.default_rng(0)
    for a, b in zip(got.sample(rng, 8), want.sample(np.random.default_rng(0), 8)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-6, atol=1e-6)


def test_build_neus_render_config_matches_jax():
    raw = jconfig.load_config("configs/neus_blender.json")["render"]
    raw = {k: v for k, v in raw.items() if k != "type"}
    got = tconfig.build_neus_render_config(raw)
    want = jconfig.build_neus_render_config(raw)
    assert {f: getattr(got, f) for f in got.__dataclass_fields__} == {
        f: getattr(want, f) for f in got.__dataclass_fields__}
    assert tconfig.build_neus_render_config(None) == type(got)()
    with pytest.raises(KeyError):
        tconfig.build_neus_render_config({"no_such_key": 1})
