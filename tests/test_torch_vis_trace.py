"""The Vis stage's forward in the port against the JAX package:
``stage2_forward(trainstage="Illum")`` and ``trace_radiance``, dense and
with the borrowed colour compacted, at the small widths of
``test_torch_cesr.py`` on bridged weights. Both packages march one grid:
the shadow scene's two spheres as an analytic sdf in the base layout
(``torch_port_helpers.two_sphere_grid``), so that the fan's hits, the
labels, the needed rays and the borrowed colour are all non-trivial. The
random draws are JAX's, replayed (``torch_port_helpers.jax_vis_draws``).

Tolerances: 1e-5 on forward values (fp32, other summation order); hits,
labels and masks exactly equal.
"""

import jax
import numpy as np
import pytest
import torch

from robir_tpu.render.stage2 import Stage2Model as JStage2Model
from robir_tpu.render.stage2 import stage2_forward as jstage2_forward
from robir_tpu.render.stage2 import trace_radiance as jtrace_radiance
from robir_tpu_torch.core.draws import Draws
from robir_tpu_torch.core.params import to_numpy
from robir_tpu_torch.data.syn_dataset import shadow_scene
from robir_tpu_torch.render.cuda import fused_value_grad as tfv
from robir_tpu_torch.render.stage2 import (Stage2Model, secondary_fan, stage2_forward,
                                           trace_radiance)
from robir_tpu_torch.stages import stage2_runner as trunner
from test_torch_cesr import JCFG_GRID, TCFG_GRID
from torch_port_helpers import assert_close, jax_vis_draws, two_sphere_grid

N, NSAMP, CHUNK, KEY = 16, 64, 64, 7


@pytest.fixture(scope="module")
def fan_case():
    """Shared weights, both grids, a batch of 12 pixels on the object and 4
    off it (camera 0 of the shadow scene) with random shifts, and a cache
    of JAX (forward, trace) results by compact chunk."""
    params = to_numpy(trunner.init_stage2_params(torch.Generator().manual_seed(0), TCFG_GRID))
    jgrid, tgrid = two_sphere_grid(TCFG_GRID.grid)
    ds = shadow_scene(n_train=3, h=40, w=40)
    rng = np.random.default_rng(5)
    mask = ds.object_masks[0]
    batch = ds.pixels(0, rng.permutation(np.concatenate([
        rng.choice(np.flatnonzero(mask), 12, replace=False),
        rng.choice(np.flatnonzero(~mask), 4, replace=False)])))
    batch["hdr_shift"] = rng.random((N, 1)).astype(np.float32)
    return params, jgrid, tgrid, {k: batch[k] for k in
                                  ("points", "dirs", "object_mask", "hdr_shift")}, {}


def jax_fan(fan_case, chunk):
    params, jgrid, _, batch, cache = fan_case
    if chunk not in cache:
        @jax.jit
        def run(grid, inp, key):
            model = JStage2Model(params, JCFG_GRID, grid)
            k_fwd, k_trace = jax.random.split(key)
            fwd = jstage2_forward(model, k_fwd, inp, trainstage="Illum")
            return fwd, jtrace_radiance(model, k_trace, fwd, nsamp=NSAMP, compact_chunk=chunk)

        fwd, tr = run(jgrid, batch, jax.random.PRNGKey(KEY))
        cache[chunk] = (jax.tree_util.tree_map(np.asarray, fwd),
                        jax.tree_util.tree_map(np.asarray, tr))
    return cache[chunk]


def _draws():
    return Draws(given={k: torch.tensor(v) for k, v in
                        jax_vis_draws(jax.random.PRNGKey(KEY), N, NSAMP, JCFG_GRID).items()})


def port_fan(fan_case, chunk, traced=None):
    params, _, tgrid, batch, _ = fan_case
    draws = _draws()
    model = Stage2Model(params, TCFG_GRID, "cpu", tgrid)
    with torch.no_grad():
        fwd = stage2_forward(model, draws, {k: torch.as_tensor(v) for k, v in batch.items()},
                             trainstage="Illum")
        return fwd, trace_radiance(model, draws, fwd, nsamp=NSAMP, compact_chunk=chunk,
                                   traced=traced)


def test_illum_forward_matches_jax(fan_case):
    """The primary trace's surface points and mask, the indirect SGs and
    integral at the surface pixels (defaults elsewhere), the AE normal map
    there (ones elsewhere); no render, no sdf query."""
    want, _ = jax_fan(fan_case, 0)
    got, _ = port_fan(fan_case, 0)
    surface = want["network_object_mask"]
    assert 8 <= surface.sum() < N
    np.testing.assert_array_equal(got["network_object_mask"].numpy(), surface)
    for k in ("points", "indirect_sgs", "indir_integral", "normals", "hdr_shift"):
        assert_close(got[k], want[k], rtol=1e-5, atol=1e-5, what=k)
    assert "sg_rgb" not in got and "sdf_output" not in got
    assert np.all(got["normals"].numpy()[~surface] == 1.0)


@pytest.mark.parametrize("chunk", [0, CHUNK])
def test_trace_radiance_matches_jax(fan_case, chunk):
    """Dense (chunk 0) and with the borrowed colour compacted into slices
    of CHUNK needed rays: the traced radiance, the directions, the labels,
    the visibility logits, the masks and the integral. The fan has hits,
    occluded labels and needed rays with a non-zero borrowed colour."""
    _, want = jax_fan(fan_case, chunk)
    before = tfv.FORWARD.launches
    _, got = port_fan(fan_case, chunk)
    assert tfv.FORWARD.launches == before  # CPU tensors: K3's plain version
    need = got["need"].numpy()
    assert need.sum() > CHUNK and need.sum() == want["indir_mask"].sum()
    assert 0 < want["gt_vis"].sum() < want["gt_vis"].size
    assert np.abs(want["trace_radiance"]).max() > 1e-3
    for k in ("gt_vis", "indir_mask"):
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    np.testing.assert_array_equal(got["need"].numpy().reshape(N, NSAMP), want["indir_mask"])
    for k in ("trace_radiance", "sample_dirs", "pred_vis", "gt_integral"):
        assert_close(got[k], want[k], rtol=1e-5, atol=1e-5, what=k)


def test_compacted_and_shared_traces_equal_dense(fan_case):
    """Slices of the needed rays give the dense fan's result; a fan trace
    made beforehand and handed in (``traced=``) gives the own trace's."""
    _, dense = port_fan(fan_case, 0)
    params, _, tgrid, _, _ = fan_case
    fwd, sliced = port_fan(fan_case, 7)
    for k in ("trace_radiance", "gt_integral", "pred_vis"):
        assert_close(sliced[k], dense[k], rtol=1e-6, atol=1e-6, what=k)
    model = Stage2Model(params, TCFG_GRID, "cpu", tgrid)
    fan = secondary_fan(model, _draws(), fwd, NSAMP)
    traced = model.trace(fan["origins"], fan["dirs"])
    _, shared = port_fan(fan_case, CHUNK, traced=traced)
    for k in ("trace_radiance", "gt_integral", "pred_vis"):
        assert_close(shared[k], dense[k], rtol=1e-6, atol=1e-6, what=k)
    np.testing.assert_array_equal(shared["gt_vis"].numpy(), dense["gt_vis"].numpy())
