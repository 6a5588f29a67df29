"""The port's data parallelism (``robir_tpu_torch/core/mesh.py``) for stage 1
against the JAX package's mesh: ranks are spawned processes joined over
gloo on ``tcp://localhost`` (a free port each run), each spawn with its own
timeout (``spawn_ranks``).

- ``local_batch_slice`` against JAX's at 1, 2 and 4 processes;
- one 2-rank train step at small widths and a global batch of 16 against
  JAX's ``make_train_step`` over the conftest's 8-device CPU mesh, on the
  same weights, rays and stratified jitter (JAX's reference with
  ``sdf.storage_dtype=None``, as the other stage-1 tests): the loss and
  every metric to 1e-5 relative, every gradient to rtol 5e-4 with an atol
  of 5e-4 of its largest entry;
- ``NeusTrainer(mesh=)`` at world sizes 1 (bit-equal to no mesh), 2 and 4:
  the parameters after
  3 steps agree (the criterion of ``test_torch_train_neus.py``: within
  2 x lr a step taken, 99% of entries within 1e-5; the sums differ only in
  their order), and every rank's parameters are bit-equal to rank 0's;
- the dry run (``tools/dryrun_multichip.py``) at 2 ranks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from robir_tpu.core import mesh as jmesh
from robir_tpu.core import tree as jtree
from robir_tpu.data import blender as jblender
from robir_tpu.fields import neus_model as jnm
from robir_tpu.fields.radiance import RenderingConfig as JRenderingConfig
from robir_tpu.fields.sdf import SDFConfig as JSDFConfig
from robir_tpu.render import neus as jneus
from robir_tpu.stages import neus_stage as jstage
from robir_tpu_torch.core import mesh as tmesh
from robir_tpu_torch.data.synthetic import make_sphere_scene
from robir_tpu_torch.fields import neus_model as tnm
from robir_tpu_torch.fields.radiance import RenderingConfig
from robir_tpu_torch.fields.sdf import SDFConfig
from robir_tpu_torch.render import neus as tneus
from robir_tpu_torch.stages import neus_stage as tstage
from robir_tpu_torch.tools import dryrun_multichip
from torch_port_helpers import (assert_close, each, grab_grads, rank_train_step,
                                rank_trainer_run)

SDF_KW = dict(d_out=17, d_hidden=32, n_layers=3, skip_in=(2,), multires=2)
COLOR_KW = dict(d_feature=16, d_hidden=32, n_layers=2)
RENDER_KW = dict(n_samples=16, n_importance=16, up_sample_steps=2)
BATCH, LR, STEPS = 16, 5e-4, 3
TRAIN_KW = dict(batch_size=BATCH, lr_init=LR, lr_delay_steps=0, max_steps=400, anneal_end=50,
                eval_chunk=64)
SCENE_KW = dict(n_train=4, h=16, w=16)
TIMEOUT_S = 120.0

TMODEL = tnm.NeuSConfig(sdf=SDFConfig(**SDF_KW), color=RenderingConfig(**COLOR_KW))
TRENDER = tneus.NeusRenderConfig(**RENDER_KW)
TTRAIN = tstage.NeusTrainConfig(**TRAIN_KW)


def jax_case():
    """Weights (JAX init), a global batch and the step key's jitter."""
    jmodel = jnm.NeuSConfig(sdf=JSDFConfig(**SDF_KW), color=JRenderingConfig(**COLOR_KW))
    params = jax.tree_util.tree_map(np.asarray, jnm.init_neus(jax.random.PRNGKey(0), jmodel))
    batch = make_sphere_scene("train", **SCENE_KW).sample(np.random.default_rng(3), BATCH)
    key = jax.random.PRNGKey(7)
    t_rand = np.asarray(jax.random.uniform(jax.random.split(key)[1], (BATCH, 1)))
    return jmodel, params, batch, key, t_rand


@pytest.fixture(scope="module")
def two_ranks():
    """One spawn of 2 ranks for the step against JAX and the 3-step run;
    the JAX mesh step and the one-process run beside it."""
    jmodel, params, batch, key, t_rand = jax_case()
    step_args = (params, TMODEL, TRENDER, TTRAIN, tuple(batch), {"t_rand": t_rand})
    run_args = (SCENE_KW, TMODEL, TRENDER, TTRAIN, STEPS)
    ranks = tmesh.spawn_ranks(each, 2, (rank_train_step, step_args),
                              (rank_trainer_run, run_args), device="cpu",
                              timeout_s=TIMEOUT_S)
    mesh = jmesh.create_mesh(jmesh.MeshConfig(data=8))
    step = jstage.make_train_step(jmodel, jneus.NeusRenderConfig(**RENDER_KW),
                                  jstage.NeusTrainConfig(**TRAIN_KW), grab_grads(), mesh=mesh)
    sh = jmesh.batch_sharding(mesh)
    _, jgrads, jmetrics = step(jax.tree_util.tree_map(jnp.asarray, params), None,
                               jblender.RayBatch(*[jax.device_put(x, sh) for x in batch]),
                               jnp.asarray(0, jnp.int32), key)
    one = rank_trainer_run(None, *run_args)
    return ranks, (jtree.flatten_with_paths(jgrads), jmetrics), one


@pytest.mark.parametrize("world", [1, 2, 4])
def test_local_batch_slice_matches_jax(world, monkeypatch):
    monkeypatch.setattr(jax, "process_count", lambda: world)
    for rank in range(world):
        monkeypatch.setattr(jax, "process_index", lambda rank=rank: rank)
        mesh = tmesh.DataMesh(rank, world, "cpu")
        for n in (16, 512, 513, 7):
            assert tmesh.local_batch_slice(n, mesh) == jmesh.local_batch_slice(n), (n, rank)
    # without a mesh: the process group's, a world of one here
    assert tmesh.local_batch_slice(16) == slice(0, 16)


def test_two_rank_step_matches_jax_mesh(two_ranks):
    ranks, (jgrads, jmetrics), _ = two_ranks
    for rank, ((metrics, grads), _) in enumerate(ranks):
        assert metrics.keys() == {k for k in jmetrics}
        for k, v in jmetrics.items():
            assert_close(metrics[k], float(v), rtol=1e-5, atol=1e-7, what=f"rank {rank} {k}")
        assert grads.keys() == jgrads.keys()
        for path, g in grads.items():
            w = np.asarray(jgrads[path])
            np.testing.assert_allclose(g, w, rtol=5e-4, atol=5e-4 * float(np.abs(w).max()),
                                       err_msg=f"rank {rank} {path}")


def _assert_trajectories_agree(got: dict, want: dict) -> None:
    assert got.keys() == want.keys()
    diffs = np.concatenate([np.abs(got[k] - want[k]).ravel() for k in want])
    assert diffs.max() <= 2 * LR * STEPS, diffs.max()
    assert np.mean(diffs <= 1e-5) >= 0.99, np.mean(diffs <= 1e-5)


def test_world_sizes_agree(two_ranks):
    ranks, _, (want, want_metrics) = two_ranks
    four = tmesh.spawn_ranks(rank_trainer_run, 4, SCENE_KW, TMODEL, TRENDER, TTRAIN, STEPS,
                             device="cpu", timeout_s=TIMEOUT_S)
    # a mesh of one (no process group) is the one process, bit for bit
    one, _ = rank_trainer_run(tmesh.create_mesh(device="cpu"), SCENE_KW, TMODEL, TRENDER,
                              TTRAIN, STEPS)
    assert all(np.array_equal(one[k], want[k]) for k in want)
    for world, results in ((2, [r[1] for r in ranks]), (4, four)):
        for rank, (params, metrics) in enumerate(results):
            _assert_trajectories_agree(params, want)
            assert_close(metrics["loss"], want_metrics["loss"], rtol=1e-5, atol=0,
                         what=f"world {world} rank {rank}")
            assert all(np.array_equal(params[k], results[0][0][k]) for k in params), \
                f"world {world}: rank {rank}'s parameters are not rank 0's"


def test_replicas_bit_equal_after_the_step(two_ranks):
    """The summed gradients are bit-equal on both ranks (one all-reduce),
    and so the parameters after the 3-step run."""
    ranks, _, _ = two_ranks
    (m0, g0), (p0, _) = ranks[0]
    (m1, g1), (p1, _) = ranks[1]
    assert m0 == m1
    assert all(np.array_equal(g0[k], g1[k]) for k in g0)
    assert all(np.array_equal(p0[k], p1[k]) for k in p0)


def test_dryrun_at_two_ranks():
    res = dryrun_multichip.dryrun(2, "cpu")
    assert res["backend"] == "gloo" and res["device"] == "cpu"
    assert np.isfinite(res["metrics"]["loss"])
