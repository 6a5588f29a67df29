"""The port's cached-SDF grid tracer (``robir_tpu_torch/tracing/grid.py``)
against the JAX package's (``robir_tpu/tracing/grid.py``): lookups,
normals, the bake from the frozen NeuS bridge, the cast and the
visibility oracle, on one grid that JAX bakes and both sides read.

Tolerances: the lookups and normals to 1e-6 absolute (both fp32 with the
same association; JAX's quad-row layout is the same arithmetic). The
bake to 1e-5 in fp32 (the trunk sums in another order); in bf16 to one
bf16 ulp of the fp32 value, where the two sides may round to different
neighbours. The cast's hit masks must be identical, and t within 1e-5
where both hit. On the CPU the port runs the march's plain version, which
``chip_smoke.py`` holds the CUDA kernel to on the card.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robir_tpu.render.stage2 import Stage2Model as JStage2Model
from robir_tpu.tracing import grid as jg
from robir_tpu_torch.render.cuda import grid_march
from robir_tpu_torch.stages.stage2_runner import Stage2RunnerBase
from robir_tpu_torch.tracing import grid as tg
from test_torch_cesr import JCFG, TCFG, shared_params
from torch_port_helpers import to_t

RADIUS = 0.5


def sphere_sdf(x):
    return jnp.linalg.norm(x, axis=-1) - RADIUS


def torus_sdf(x, R=0.5, r=0.2):
    q = jnp.stack([jnp.linalg.norm(x[..., :2], axis=-1) - R, x[..., 2]], -1)
    return jnp.linalg.norm(q, axis=-1) - r


SHAPES = {"sphere": sphere_sdf, "torus": torus_sdf}


def configs(**kw):
    return jg.GridConfig(**kw), tg.GridConfig(**kw)


def shared_grid(shape: str, jcfg):
    """JAX's grid of an analytic SDF, and the same values as a tensor."""
    g = jg.build_sdf_grid(SHAPES[shape], jcfg)
    return g, torch.as_tensor(np.array(g.astype(jnp.float32))).to(
        torch.bfloat16 if jcfg.storage_dtype == "bfloat16" else torch.float32)


def lookup_points(seed: int) -> np.ndarray:
    """Points inside and outside the bbox, on its upper faces and corners
    (where the cell index is clamped to R - 2) and near the surface."""
    rng = np.random.default_rng(seed)
    faces = rng.uniform(-1, 1, (60, 3))
    faces[np.arange(60), np.arange(60) % 3] = 1.0
    return np.concatenate([
        rng.uniform(-1.3, 1.3, (400, 3)), faces,
        [[1.0, 1.0, 1.0], [-1.0, -1.0, -1.0], [1.0, -1.0, 1.0], [0.0, 0.0, 1.0]],
        rng.uniform(0.49, 0.51, (64, 3)) * np.array([1, 0, 0]),
    ]).astype(np.float32)


@pytest.mark.parametrize("shape", ["sphere", "torus"])
@pytest.mark.parametrize("store", [None, "bfloat16"])
def test_lookups_match_jax(shape, store):
    """grid_sdf and grid_normal on one fp32 or bf16 grid, against JAX's
    row lookup and its quad-row layout (quad_rows=True)."""
    jcfg, tcfg = configs(resolution=32, storage_dtype=store)
    jgrid, tgrid = shared_grid(shape, jcfg)
    x = lookup_points(1)
    got = tg.grid_sdf(tgrid, tcfg, to_t(x))
    want = np.asarray(jg.grid_sdf(jgrid, jcfg, jnp.asarray(x)))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    qcfg = dataclasses.replace(jcfg, quad_rows=True)
    quad = np.asarray(jg._sdf_quad(jg._to_quad(jgrid, qcfg), qcfg, jnp.asarray(x)))
    np.testing.assert_allclose(got.numpy(), quad, rtol=0, atol=1e-6)
    assert np.abs(want).max() > 0.3
    n = tg.grid_normal(tgrid, tcfg, to_t(x))
    np.testing.assert_allclose(n.numpy(), np.asarray(jg.grid_normal(jgrid, jcfg, jnp.asarray(x))),
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("store", [None, "bfloat16"])
def test_bake_matches_jax(store):
    """Stage2RunnerBase.bake_grid (the NeuS bridge's sdf, weights folded
    once, chunks built from the three axes) against JAX's build_sdf_grid
    of Stage2Model.sdf, on bridged weights."""
    grid_kw = dict(resolution=24, storage_dtype=store)
    jcfg = dataclasses.replace(JCFG, grid=jg.GridConfig(**grid_kw))
    tcfg = dataclasses.replace(TCFG, grid=tg.GridConfig(**grid_kw))
    params = shared_params()
    runner = Stage2RunnerBase(tcfg, params, device="cpu")
    runner.bake_grid()
    got = runner.grid_values
    want = jg.build_sdf_grid(JStage2Model(params, jcfg).sdf, jcfg.grid)
    assert got.shape == (24, 24, 24) and got.dtype == tcfg.grid.store
    ref = np.asarray(jg.build_sdf_grid(
        JStage2Model(params, jcfg).sdf, dataclasses.replace(jcfg.grid, storage_dtype=None)))
    if store is None:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)
    else:
        ulp = 2.0 ** (np.floor(np.log2(np.abs(ref))) - 7)
        diff = np.abs(got.float().numpy() - np.asarray(want.astype(jnp.float32)))
        assert np.all(diff <= ulp), float((diff / ulp).max())
    assert ref.min() < 0 < ref.max()


def rays(seed: int, n: int = 96):
    """Primary rays from distance 2 at the shape, rays that point away
    (misses), rays that start inside the bbox, and rays grazing the sphere
    (tangent to within +-0.01 of its radius)."""
    rng = np.random.default_rng(seed)
    o = rng.standard_normal((n, 3))
    o = o / np.linalg.norm(o, axis=-1, keepdims=True) * 2.0
    d = rng.uniform(-0.6, 0.6, (n, 3)) - o
    away = o[: n // 4] * 0.5
    inside = rng.uniform(-0.9, 0.9, (n // 2, 3))
    d_in = rng.standard_normal((n // 2, 3))
    off = np.linspace(-0.01, 0.01, n // 2)
    graze_o = np.stack([np.full(n // 2, -1.5), RADIUS + off, np.zeros(n // 2)], -1)
    graze_d = np.tile([[1.0, 0.0, 0.0]], (n // 2, 1)) + rng.uniform(-1e-3, 1e-3, (n // 2, 3))
    o = np.concatenate([o, o[: n // 4], inside, graze_o])
    d = np.concatenate([d, away, d_in, graze_d])
    d = d / np.linalg.norm(d, axis=-1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


@pytest.mark.parametrize("over_relax", [0.0, 1.6])
@pytest.mark.parametrize("store", [None, "bfloat16"])
def test_cast_matches_jax(over_relax, store):
    """grid_cast on JAX's grid: identical hits, t and x where both hit, on
    the sphere and the torus; the CPU runs the plain version, not the
    kernel."""
    jcfg, tcfg = configs(resolution=48, max_steps=96, storage_dtype=store,
                         over_relax=over_relax, quad_rows=True)
    for k, shape in enumerate(SHAPES):
        jgrid, tgrid = shared_grid(shape, jcfg)
        o, d = rays(10 + k)
        jt, jhit, jx = jax.jit(lambda o, d: jg.grid_cast(jgrid, jcfg, o, d))(
            jnp.asarray(o), jnp.asarray(d))
        before = grid_march.MARCH.launches
        t, hit, x = tg.grid_cast(tgrid, tcfg, to_t(o), to_t(d))
        assert grid_march.MARCH.launches == before
        jhit = np.asarray(jhit)
        differ = np.flatnonzero(hit.numpy() != jhit)
        assert differ.size == 0, f"{shape}: hits differ at rays {differ.tolist()}"
        assert 0.2 < jhit.mean() < 0.8, (shape, jhit.mean())
        np.testing.assert_allclose(t.numpy()[jhit], np.asarray(jt)[jhit], rtol=0, atol=1e-5)
        np.testing.assert_allclose(x.numpy()[jhit], np.asarray(jx)[jhit], rtol=0, atol=1e-5)


def test_plain_cast_counts_lookups():
    """grid_cast_plain's lookup count (the kernel's bound reads it): the
    march steps of every ray, and 8 more for a hit, 16 when the last step
    overshot."""
    jcfg, tcfg = configs(resolution=48, max_steps=96)
    _, tgrid = shared_grid("sphere", jcfg)
    o, d = rays(3)
    t, hit, _, lookups = tg.grid_cast_plain(tgrid, tcfg, to_t(o), to_t(d))
    valid = tg._ray_bbox(tcfg, to_t(o), to_t(d))[0]
    assert torch.all(lookups[~valid] == 0)
    assert torch.all(lookups[hit] >= 9) and torch.all(lookups[valid] >= 1)
    assert int(lookups.max()) <= tcfg.max_steps + 16


def test_visibility_logits_match_jax():
    """The oracle at surface points of a coarse sphere grid, with grazing
    (tangent), outward and inward directions: identical logits."""
    jcfg, tcfg = configs(resolution=64)
    jgrid, tgrid = shared_grid("sphere", jcfg)
    th = np.linspace(0.1, np.pi - 0.1, 64).astype(np.float32)
    p = np.stack([np.sin(th), np.zeros(64, np.float32), np.cos(th)], -1) * RADIUS
    tang = np.stack([np.cos(th), np.zeros(64, np.float32), -np.sin(th)], -1)
    for dirs in (tang, p, -p):
        want = np.asarray(jg.grid_visibility_logits(jgrid, jcfg, jnp.asarray(p),
                                                    jnp.asarray(dirs)))
        got = tg.SDFGrid(tgrid, tcfg).visibility_logits(to_t(p), to_t(dirs))
        np.testing.assert_array_equal(got.numpy(), want)
    assert (want[:, 1] > 0).mean() < 0.05  # the inward directions are occluded


def test_cast_refuses_a_grid_unlike_its_config():
    """grid_cast takes only a grid of the config's resolution and storage."""
    cfg = tg.GridConfig(resolution=8, storage_dtype="bfloat16")
    o = torch.zeros(4, 3)
    for grid in (torch.zeros(8, 8, 8), torch.zeros(8, 8, 9, dtype=torch.bfloat16)):
        with pytest.raises(ValueError, match="the config's is"):
            tg.grid_cast(grid, cfg, o, o)


def test_march_constants_are_the_plain_versions():
    """The kernel's 16 scalars are the fp32 values the plain version reads."""
    cfg = tg.GridConfig(resolution=320, over_relax=1.6, bbox_min=(-1.1, -1.0, -0.9))
    k = tg.MarchConstants.of(cfg)
    consts = tg.march_constants(cfg)
    assert consts == [float(np.float32(v)) for v in consts]
    assert consts[:6] == [*map(float, cfg.bbox_lo), *map(float, cfg.bbox_hi)]
    assert consts[6:] == [k.eps_hit, k.min_step, k.max_dt, k.omega, k.relax, tg.OVER_MARGIN,
                          k.start_offset, k.normal_eps, k.two_eps, tg.f32(320 - 1 - 1e-6)]
