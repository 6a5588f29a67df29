"""One whole PBR step of the port (``PBRRunner.step``) against the JAX
package's ``make_pbr_step``, at the small widths of ``test_torch_cesr.py``
(48 pixels, 8 SG lights x 32 diffuse samples, the grid tracer), on
bridged weights, one batch, the shadow scene's two-sphere grid marched by
both packages, and JAX's draws replayed (``jax_stage2_draws``, which also
replays the chunk-keyed per-row draws of JAX's compacted render): here
the dense step, in ``test_torch_pbr_rows.py`` and
``test_torch_pbr_rows_geometry.py`` row mode (compact chunk 16; the JAX
compacted step compiles for over 10 s), each shading with the AE normal
map and with the geometry normals (``use_normal_map`` True and False). Checks the loss and every metric, the gradients of ``gamma`` and
``envmap_material_network``, and the weights after the Adam update; and
the runner's batches against the JAX runner's.

Tolerances: loss and metrics to 1e-5 relative (atol 1e-7: the white-light
term is 0 on gray lights); gradients to rtol 5e-4 with an atol of
GRAD_ATOL of each tensor's largest entry; the weights after one Adam step
(lr 5e-4, so each moves by about 5e-4) to 1e-6 where the gradient is above
ADAM_FLOOR of its tensor's largest entry, and within the step's lr
elsewhere: Adam's first step moves a weight by lr x g / (|g| + 1e-8), so a
gradient entry near zero moves it by an amount its rounding decides.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from robir_tpu.core import tree as jtree
from robir_tpu.render.stage2 import Stage2Model as JStage2Model
from robir_tpu.stages import pbr as jpbr
from robir_tpu.stages import stage2_runner as jrunner
from robir_tpu_torch.core import tree as ttree
from robir_tpu_torch.core.draws import Draws
from robir_tpu_torch.core.params import to_numpy
from robir_tpu_torch.data.syn_dataset import shadow_scene
from robir_tpu_torch.stages import pbr as tpbr
from robir_tpu_torch.stages import stage2_runner as trunner
from test_torch_cesr import JCFG_GRID, N_LIGHTS, TCFG_GRID
from torch_port_helpers import assert_close, jax_stage2_draws, two_sphere_grid

N, CHUNK, KEY, LR = 48, 16, 12, 5e-4
GRAD_ATOL = 5e-4  # of each gradient's largest entry
ADAM_FLOOR = 1e-3


def recording_adam():
    """optax's Adam that also keeps the last gradients in its state, so the
    JAX step hands out both the update and the gradients."""
    adam = optax.adam(LR)

    def init(p):
        return adam.init(p), jax.tree_util.tree_map(jnp.zeros_like, p)

    def update(g, state, p=None):
        u, a = adam.update(g, state[0], p)
        return u, (a, g)

    return optax.GradientTransformation(init, update)


@pytest.fixture(scope="module")
def case():
    """Weights, the scene, the two-sphere grid in both packages, a batch of
    36 pixels on the object and 12 off it in random order, and its surface
    pixels (JAX's trace), which fill three chunks of 16."""
    params = to_numpy(trunner.init_stage2_params(torch.Generator().manual_seed(1), TCFG_GRID))
    jgrid, tgrid = two_sphere_grid(TCFG_GRID.grid)
    ds = shadow_scene(n_train=3, h=40, w=40)
    rng = np.random.default_rng(5)
    mask = ds.object_masks[0]
    b = ds.pixels(0, rng.permutation(np.concatenate([
        rng.choice(np.flatnonzero(mask), 36, replace=False),
        rng.choice(np.flatnonzero(~mask), 12, replace=False)])))
    batch = {k: b[k] for k in trunner.BATCH_KEYS}
    _, hit, _ = jax.jit(JStage2Model(params, JCFG_GRID, jgrid).trace)(batch["points"],
                                                                     batch["dirs"])
    surface = np.asarray(hit) & batch["object_mask"]
    assert 2 * CHUNK < surface.sum() < N
    return params, ds, batch, jgrid, tgrid, surface


def jax_step(case, compact_chunk: int, use_normal_map: bool):
    """(metrics, gradients, new trainable weights) of one JAX step, flat."""
    params, _, batch, jgrid, _, _ = case
    opt = recording_adam()
    stage = jpbr.PBRStageConfig(num_pixels=N, compact_chunk=compact_chunk,
                                use_normal_map=use_normal_map)
    trainable, frozen = jrunner.split_params(params, jpbr.PBRRunner.TRAINABLE)
    step = jpbr.make_pbr_step(JCFG_GRID, stage, opt)
    new, state, metrics = step(trainable, frozen, opt.init(trainable), jgrid,
                               {k: jnp.asarray(v) for k, v in batch.items()},
                               jax.random.PRNGKey(KEY))
    return ({k: float(v) for k, v in metrics.items()}, jtree.flatten_with_paths(state[1]),
            jtree.flatten_with_paths(new))


def port_step(case, compact_chunk: int, use_normal_map: bool):
    """(runner after one step, its metrics) of the port, on JAX's draws."""
    params, ds, batch, _, tgrid, surface = case
    runner = tpbr.PBRRunner(TCFG_GRID, params, ds, tpbr.PBRStageConfig(
        num_pixels=N, compact_chunk=compact_chunk, use_normal_map=use_normal_map),
        device="cpu")
    runner.grid_values = tgrid
    draws = jax_stage2_draws(jax.random.PRNGKey(KEY), N, JCFG_GRID, N_LIGHTS, diffuse_nsamp=32,
                             surface=surface, chunk=compact_chunk)
    metrics = runner.step({k: torch.as_tensor(v) for k, v in batch.items()},
                          Draws(given={k: torch.tensor(v) for k, v in draws.items()}))
    return runner, metrics


def assert_step_matches(case, compact_chunk: int, use_normal_map: bool) -> None:
    """One step in both packages: loss and metrics, the gradients and the
    updated weights."""
    want_m, want_g, want_p = jax_step(case, compact_chunk, use_normal_map)
    runner, got_m = port_step(case, compact_chunk, use_normal_map)
    assert got_m.keys() == want_m.keys()
    for k, v in want_m.items():
        assert_close(got_m[k], v, rtol=1e-5, atol=1e-7, what=k)
    assert 0 < want_m["surface_frac"] < 1 and want_m["rgb_loss"] > 0
    trained = {p: leaf for p, leaf in ttree.flatten_with_paths(runner.params).items()
               if leaf.requires_grad}
    assert trained.keys() == want_g.keys()
    assert {p.split("/")[0] for p in trained} == {"gamma", "envmap_material_network"}
    reached = 0
    for path, leaf in trained.items():
        g = np.asarray(want_g[path])
        scale = float(np.abs(g).max())
        if scale == 0:  # the normal decoder, the energy net: no loss reaches them
            assert leaf.grad is None or not leaf.grad.any(), path
            assert np.array_equal(leaf.detach().numpy(), want_p[path]), path
            continue
        reached += 1
        assert_close(leaf.grad, g, rtol=5e-4, atol=GRAD_ATOL * scale, what=path)
        firm = np.abs(g) > ADAM_FLOOR * scale
        new, ref = leaf.detach().numpy(), np.asarray(want_p[path])
        assert_close(new[firm], ref[firm], rtol=0, atol=1e-6, what=path)
        assert_close(new, ref, rtol=0, atol=LR * 1.01, what=path)
    assert {"envmap_material_network/lgtSGs", "gamma/adapt_illum"} <= {
        p for p in trained if np.abs(want_g[p]).max() > 0}
    assert reached > 10
    assert runner.cur_iter == 1


@pytest.mark.parametrize("use_normal_map", [True, False])
def test_dense_pbr_step_matches_jax(case, use_normal_map):
    assert_step_matches(case, 0, use_normal_map)


def test_runner_batches_as_jax():
    """The same seed gives the JAX runner's camera and pixels."""
    params = to_numpy(trunner.init_stage2_params(torch.Generator().manual_seed(0), TCFG_GRID))
    ds = shadow_scene(n_train=4, h=16, w=16)
    port = tpbr.PBRRunner(TCFG_GRID, params, ds, tpbr.PBRStageConfig(num_pixels=24), seed=3,
                          device="cpu")
    ref = jpbr.PBRRunner(JCFG_GRID, params, ds, jpbr.PBRStageConfig(num_pixels=24), seed=3)
    for _ in range(3):
        got, want = port._batch(), ref._batch()
        assert got.keys() == want.keys()
        for k in got:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
