"""The port's observation samplers (``texture/focus_sampler.py``) against
the JAX package's: ``FocusSampler.project`` and ``scatter_sample`` on the
same arrays, ``focus_sampler_from_dataset``, and ``TexSpaceSampler``'s
``sample_observations``, ``data_batch`` and ``simple_data_batch`` on one
numpy seed, over a mesh of the shadow scene's two spheres, each package's
grid tracer marching the two spheres' analytic grid
(``torch_port_helpers.two_sphere_grid``).

Tolerance: none. The projections and samples are the same numpy
arithmetic, and the two grid tracers give identical hits on one grid
(``test_torch_grid.py``), so every output is compared for equality.
"""

import jax
import numpy as np
import pytest
import torch

from robir_tpu.texture import focus_sampler as jfs
from robir_tpu.tracing import grid as jg
from robir_tpu_torch.data.syn_dataset import shadow_scene
from robir_tpu_torch.texture import focus_sampler as tfs
from robir_tpu_torch.tracing import grid as tg
from torch_port_helpers import two_sphere_grid, two_sphere_tex_sampler

GRID_KW = dict(resolution=32, max_steps=64, storage_dtype="bfloat16", quad_rows=True)
N = 256


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    """The shadow scene, the port's TexSampler on a mesh of its two spheres
    (``two_sphere_tex_sampler``), and both packages' grids and grid
    configs."""
    ts = two_sphere_tex_sampler(str(tmp_path_factory.mktemp("fs")))
    ds = shadow_scene(n_train=4, h=32, w=32, seed=0)
    tcfg, jcfg = tg.GridConfig(**GRID_KW), jg.GridConfig(**GRID_KW)
    jgrid, tgrid = two_sphere_grid(tcfg)
    return ds, ts, (jcfg, jgrid), (tcfg, tgrid)


def samplers(scene):
    """(port, JAX) TexSpaceSamplers on one TexSampler, each tracing its own
    package's grid tracer."""
    ds, ts, (jcfg, jgrid), (tcfg, tgrid) = scene
    jtrace = jax.jit(lambda o, d: jg.grid_cast(jgrid, jcfg, o, d))
    port = tfs.TexSpaceSampler(ts, tfs.focus_sampler_from_dataset(ds),
                               lambda o, d: tg.grid_cast(tgrid, tcfg, o, d),
                               offset=tfs.TexSpaceSampler.offset_for_grid(tcfg), device="cpu")
    ref = jfs.TexSpaceSampler(ts, jfs.focus_sampler_from_dataset(ds), jtrace,
                              offset=jfs.TexSpaceSampler.offset_for_grid(jcfg))
    assert port.offset == ref.offset > 0.005
    return port, ref


def _equal(got, want, what=""):
    assert type(got) is type(want) or isinstance(got, np.ndarray), what
    if isinstance(got, dict):
        assert got.keys() == want.keys(), what
        for k in got:
            _equal(got[k], want[k], f"{what}/{k}")
    elif isinstance(got, (tuple, list)):
        assert len(got) == len(want), what
        for i, (a, b) in enumerate(zip(got, want)):
            _equal(a, b, f"{what}[{i}]")
    else:
        a, b = np.asarray(got), np.asarray(want)
        assert a.dtype == b.dtype and a.shape == b.shape, (what, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=what)


def test_focus_sampler_matches_jax(scene):
    """project and scatter_sample, on all cameras and on a subset, from
    the same arrays; the dataset's sampler from either package."""
    ds = scene[0]
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((100, 3)) * 0.3).astype(np.float32)
    port, ref = tfs.focus_sampler_from_dataset(ds), jfs.focus_sampler_from_dataset(ds)
    for attr in ("images", "masks", "poses", "cam_loc", "pose_inv", "intrinsics", "img_size"):
        _equal(getattr(port, attr), getattr(ref, attr), attr)
    for cameras in (None, [2, 0]):
        _equal(port.project(x, cameras), ref.project(x, cameras), "project")
        got = port.scatter_sample(x, cameras)
        _equal(got, ref.scatter_sample(x, cameras), "scatter_sample")
    assert got[0]["object_mask"].mean() > 0.2  # points on the spheres' side seen


def test_sample_observations_matches_jax(scene):
    """One random camera's colours, directions, visibility and position
    for the texture samples, the occlusion test traced by each package."""
    port, ref = samplers(scene)
    tex = port.tex_sampler.sample(np.random.default_rng(2), N)
    for seed in (3, 4):
        got = port.sample_observations(np.random.default_rng(seed), tex["x"], tex["normal"])
        _equal(got, ref.sample_observations(np.random.default_rng(seed), tex["x"],
                                            tex["normal"]), "sample_observations")
    vis = got[2] & tex["object_mask"]
    assert 0 < vis.sum() < tex["object_mask"].sum()  # some samples occluded or turned away


def test_batches_match_jax(scene):
    """data_batch and simple_data_batch over three draws of one numpy RNG
    each: every array equal."""
    port, ref = samplers(scene)
    for name in ("data_batch", "simple_data_batch"):
        rp, rj = np.random.default_rng(7), np.random.default_rng(7)
        for _ in range(3):
            _equal(getattr(port, name)(rp, N), getattr(ref, name)(rj, N), name)
    inputs, normals, rgb = port.data_batch(np.random.default_rng(8), N)
    assert inputs["object_mask"].any() and rgb.shape == (N, 3) and normals.shape == (N, 3)
    b = port.simple_data_batch(np.random.default_rng(8), N)
    assert b["points"].shape == (N, 3) and 0.2 < b["object_mask"].mean()


def test_trace_fn_gets_the_sampler_device(scene):
    """The occlusion test hands trace_fn tensors on the sampler's device."""
    port, _ = samplers(scene)
    seen, real = [], port.trace_fn

    def trace(o, d):
        seen.append((o.device, d.device, o.dtype))
        return real(o, d)

    port.trace_fn = trace
    port.data_batch(np.random.default_rng(0), 8)
    assert seen == [(torch.device("cpu"), torch.device("cpu"), torch.float32)]
