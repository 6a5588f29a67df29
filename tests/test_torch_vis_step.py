"""One whole Vis step of the port (``VisRunner.step``) against the JAX
package's ``make_vis_step``, at the small widths of ``test_torch_cesr.py``
on bridged weights, one batch, the two-sphere grid of
``test_torch_vis_trace.py`` marched by both, and JAX's draws replayed: both
losses, both confidence diagnostics, each trainable subtree's gradients
(the visibility net's and the indirect net's, from their two optimizers)
and the parameters after the update. Also the runner's batches against
the JAX runner's (the numpy RNG consumed in the same order), and the
runner through its prologue and a few steps on the CPU.

Tolerances: losses and diagnostics to 1e-5 relative; gradients to rtol
5e-4 with an atol of 5e-4 of each tensor's largest entry; the parameters
after one Adam step (lr 5e-4, so each moves by about 5e-4) to 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from robir_tpu.core import tree as jtree
from robir_tpu.stages import stage2_runner as jrunner
from robir_tpu.stages import vis as jvis
from robir_tpu_torch.core import tree as ttree
from robir_tpu_torch.core.draws import Draws
from robir_tpu_torch.core.params import to_numpy
from robir_tpu_torch.data.syn_dataset import shadow_scene
from robir_tpu_torch.stages import stage2_runner as trunner
from robir_tpu_torch.stages import vis as tvis
from test_torch_cesr import JCFG_GRID, TCFG_GRID
from torch_port_helpers import assert_close, jax_vis_draws, two_sphere_grid

N, NSAMP, CHUNK, KEY = 16, 64, 64, 11
LR = 5e-4


def _recording_adam():
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
def step_case():
    """Weights, the scene, both grids and a batch (12 pixels on the object,
    4 off, random shifts); then the JAX step's metrics, gradients and new
    parameters, and the port runner after its step."""
    params = to_numpy(trunner.init_stage2_params(torch.Generator().manual_seed(1), TCFG_GRID))
    jgrid, tgrid = two_sphere_grid(TCFG_GRID.grid)
    ds = shadow_scene(n_train=3, h=40, w=40)
    rng = np.random.default_rng(9)
    mask = ds.object_masks[0]
    b = ds.pixels(0, rng.permutation(np.concatenate([
        rng.choice(np.flatnonzero(mask), 12, replace=False),
        rng.choice(np.flatnonzero(~mask), 4, replace=False)])))
    b["hdr_shift"] = rng.random((N, 1)).astype(np.float32)
    batch = {k: b[k] for k in tvis.BATCH_KEYS}
    key = jax.random.PRNGKey(KEY)

    vis_opt, illum_opt = _recording_adam(), _recording_adam()
    jstage = jvis.VisStageConfig(num_pixels=N, nsamp=NSAMP, fan_compact_chunk=CHUNK)
    vis_p, rest = jrunner.split_params(params, jvis.VisRunner.VIS_PREFIX)
    illum_p, frozen = jrunner.split_params(rest, jvis.VisRunner.ILLUM_PREFIX)
    step = jvis.make_vis_step(JCFG_GRID, jstage, vis_opt, illum_opt)
    new_vis, new_illum, vs, ist, metrics = step(
        vis_p, illum_p, frozen, vis_opt.init(vis_p), illum_opt.init(illum_p), jgrid,
        {k: jnp.asarray(v) for k, v in batch.items()}, key)
    want = {"metrics": {k: float(v) for k, v in metrics.items()},
            "grads": jtree.flatten_with_paths({**vs[1], **ist[1]}),
            "params": jtree.flatten_with_paths({**new_vis, **new_illum})}

    runner = tvis.VisRunner(TCFG_GRID, params, ds, tvis.VisStageConfig(
        num_pixels=N, nsamp=NSAMP, fan_compact_chunk=CHUNK), device="cpu")
    runner.grid_values = tgrid
    draws = jax_vis_draws(key, N, NSAMP, JCFG_GRID)
    got = runner.step({k: torch.as_tensor(v) for k, v in batch.items()},
                      Draws(given={k: torch.tensor(v) for k, v in draws.items()}))
    return params, want, runner, got


def test_vis_step_matches_jax(step_case):
    """Losses, diagnostics, gradients by subtree and the updated weights."""
    params, want, runner, got = step_case
    for k, v in want["metrics"].items():
        assert_close(got[k], v, rtol=1e-5, atol=1e-7, what=k)
    assert want["metrics"]["radiance_loss"] > 0 and want["metrics"]["vis_conf_occ"] > 0
    assert 0 < int(got["fan_need"]) < int(got["fan_hits"]) and int(got["surface_pixels"]) > 8
    trained = {p: leaf for p, leaf in ttree.flatten_with_paths(runner.params).items()
               if leaf.requires_grad}
    assert trained.keys() == want["grads"].keys()
    assert {p.split("/")[0] for p in trained} == {"visibility_network",
                                                   "indirect_illum_network"}
    for path, leaf in trained.items():
        g = np.asarray(want["grads"][path])
        assert np.abs(g).max() > 0, path
        assert_close(leaf.grad, g, rtol=5e-4, atol=5e-4 * np.abs(g).max(), what=path)
        assert_close(leaf, want["params"][path], rtol=0, atol=1e-6, what=path)
    before = ttree.flatten_with_paths(params)
    for path, leaf in ttree.flatten_with_paths(runner.params).items():
        if path not in trained:
            assert np.array_equal(leaf.detach().numpy(), before[path]), path
    assert runner.cur_iter == 1


def test_runner_batches_as_jax():
    """The same seed gives the JAX runner's camera, pixels and shifts."""
    params = to_numpy(trunner.init_stage2_params(torch.Generator().manual_seed(0), TCFG_GRID))
    ds = shadow_scene(n_train=4, h=16, w=16)
    port = tvis.VisRunner(TCFG_GRID, params, ds, tvis.VisStageConfig(num_pixels=24),
                          seed=3, device="cpu")
    ref = jvis.VisRunner(JCFG_GRID, params, ds, jvis.VisStageConfig(num_pixels=24), seed=3)
    for _ in range(3):
        got, want = port._batch(), ref._batch()
        assert got.keys() == want.keys()
        for k in got:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)


def test_runner_runs_the_stage_on_the_cpu():
    """The energy prologue (a few steps) and two steps on the two-sphere
    grid: finite metrics; the energy net refitted; only the two trainable
    nets move."""
    params = trunner.init_stage2_params(torch.Generator().manual_seed(0), TCFG_GRID)
    runner = tvis.VisRunner(TCFG_GRID, params, shadow_scene(n_train=3, h=24, w=24),
                            tvis.VisStageConfig(num_pixels=96, nsamp=16), device="cpu")
    before = {n: p.detach().clone() for n, p in runner.params.named_parameters()}
    runner.fit_energy_prologue(n_steps=3)
    runner.grid_values = two_sphere_grid(TCFG_GRID.grid)[1]
    for _ in range(2):
        metrics = runner.run(1)
        assert set(metrics) >= {"radiance_loss", "visibility_loss", "vis_conf_lit",
                                "vis_conf_occ"}
        assert all(np.isfinite(v) for v in metrics.values()), metrics
        assert metrics["surface_pixels"] > 0
    for n, p in runner.params.named_parameters():
        moved = not torch.equal(p.detach(), before[n])
        top = n.split(".")[0]
        if n.startswith("gamma.energy."):
            assert moved, n
        elif top not in tvis.VisRunner.TRAINABLE:
            assert not moved and not p.requires_grad, n
    assert any(not torch.equal(p.detach(), before[n]) for n, p in
               runner.params.named_parameters() if n.startswith("visibility_network."))
