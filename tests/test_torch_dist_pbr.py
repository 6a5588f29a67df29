"""One dense PBR step over 2 data-parallel ranks (gloo on the CPU, one
spawn with its own timeout) against JAX's ``make_pbr_step`` over the
conftest's 8-device mesh (as ``tests/test_stage2_drivers.py:172`` runs the
JAX runner on its mesh), at ``test_torch_pbr.py``'s case: 48 pixels, 36 on
the object, 8 SG lights x 32 diffuse samples, the two-sphere grid, JAX's
draws of the global batch, each rank keeping its rows. The metrics to
1e-5 relative (atol 1e-7), the summed gradients to rtol 5e-4 with an atol
of 5e-4 of each tensor's largest entry, on each rank. (The runners over 2
ranks against one process: ``test_torch_dist_stage2.py``.)
"""

import jax
import numpy as np
import pytest
import torch

from robir_tpu.core import mesh as jmesh
from robir_tpu.core import tree as jtree
from robir_tpu.stages import pbr as jpbr
from robir_tpu.stages import stage2_runner as jrunner
from robir_tpu_torch.core import mesh as tmesh
from robir_tpu_torch.core.params import to_numpy
from robir_tpu_torch.data.syn_dataset import shadow_scene
from robir_tpu_torch.stages import stage2_runner as trunner
from test_torch_cesr import JCFG_GRID, N_LIGHTS, TCFG_GRID
from torch_port_helpers import (assert_close, grab_grads, jax_stage2_draws, rank_pbr_step,
                                two_sphere_grid)

N, KEY, TIMEOUT_S = 48, 12, 180.0
DATASET_KW = dict(n_train=3, h=40, w=40)


@pytest.fixture(scope="module")
def steps():
    """(each rank's (metrics, summed gradients), JAX's (metrics,
    gradients)) of one dense step on one global batch and draws."""
    params = to_numpy(trunner.init_stage2_params(torch.Generator().manual_seed(1), TCFG_GRID))
    jgrid, tgrid = two_sphere_grid(TCFG_GRID.grid)
    ds = shadow_scene(**DATASET_KW)
    rng = np.random.default_rng(5)
    mask = ds.object_masks[0]
    b = ds.pixels(0, rng.permutation(np.concatenate([
        rng.choice(np.flatnonzero(mask), 36, replace=False),
        rng.choice(np.flatnonzero(~mask), 12, replace=False)])))
    batch = {k: b[k] for k in trunner.BATCH_KEYS}
    draws = jax_stage2_draws(jax.random.PRNGKey(KEY), N, JCFG_GRID, N_LIGHTS, diffuse_nsamp=32)
    stage_kw = dict(num_pixels=N, compact_chunk=0)
    ranks = tmesh.spawn_ranks(rank_pbr_step, 2, TCFG_GRID, params, DATASET_KW, batch, draws,
                              stage_kw, tgrid, device="cpu", timeout_s=TIMEOUT_S)
    mesh = jmesh.create_mesh(jmesh.MeshConfig(data=8))
    trainable, frozen = jrunner.split_params(params, jpbr.PBRRunner.TRAINABLE)
    opt = grab_grads()
    step = jpbr.make_pbr_step(JCFG_GRID, jpbr.PBRStageConfig(**stage_kw), opt, mesh=mesh)
    sh = jmesh.batch_sharding(mesh)
    _, jgrads, jmetrics = step(trainable, frozen, opt.init(trainable), jgrid,
                               {k: jax.device_put(v, sh) for k, v in batch.items()},
                               jax.random.PRNGKey(KEY))
    return ranks, (jmetrics, jtree.flatten_with_paths(jgrads))


def test_pbr_step_matches_jax_mesh(steps):
    ranks, (jmetrics, jgrads) = steps
    for rank, (metrics, grads) in enumerate(ranks):
        assert metrics.keys() == set(jmetrics)
        for k, v in jmetrics.items():
            assert_close(metrics[k], float(v), rtol=1e-5, atol=1e-7, what=f"rank {rank} {k}")
        reached = 0
        for path, g in jgrads.items():
            w = np.asarray(g)
            scale = float(np.abs(w).max())
            reached += scale > 0
            np.testing.assert_allclose(grads[path], w, rtol=5e-4, atol=5e-4 * scale,
                                       err_msg=f"rank {rank} {path}")
        assert reached > 4
