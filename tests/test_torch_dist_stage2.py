"""The stage-2 runners over 2 data-parallel ranks (``mesh=``; gloo on the
CPU, one spawn for every case, with its own timeout) against the
one-process port on the same global batches and draws, and against the
JAX package where it has a mesh step:

- PBR in row mode (compact chunk 48 of 128 pixels; the dense step against
  JAX's mesh step: ``test_torch_dist_pbr.py``);
- CESR in row mode, where each rank's gate (64 rows a rank at chunk 64)
  lowers the chunk to half its rows as JAX's per-shard gate does, and the
  gate itself against JAX's ``effective_chunk`` on 2-, 4- and 8-device
  meshes;
- Vis with ``shard_fan`` True and False (the same result: each rank's fan
  is its own pixels');
- Norm, and ``get_neus_surface``'s gradient error (JAX ``norm.py:153``'s
  relax count): the ranks' shares add up to the one process's, to 1e-6
  relative; the AE latent KL of the global batch mean
  against JAX's ``ae_kl_divergence``: the ranks' values add up to JAX's
  value, their row gradients are JAX's to rtol 1e-5.

Against the one process, 4 steps at lr 1e-3: each step's metrics to 1e-5
relative (atol 1e-7), the weights within 2 x lr a step taken with 99% of
entries within 1e-5 (the sums differ only in their order; Adam's first
steps are sign-like, so an entry whose gradient is near zero moves by an
amount its rounding decides); and both ranks' weights bit-equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from robir_tpu.core import compact as jcompact
from robir_tpu.core import mesh as jmesh
from robir_tpu.fields.sparse_ae import ae_kl_divergence
from robir_tpu_torch.core import compact as tcompact
from robir_tpu_torch.core import mesh as tmesh
from torch_port_helpers import (assert_close, each, rank_ae_kl, rank_neus_surface,
                                rank_stage2_run, two_sphere_tex_sampler)

STEPS, LR, TIMEOUT_S = 4, 1e-3, 180.0
CASES = {
    "pbr_rows": ("pbr", dict(num_pixels=128, compact_chunk=48)),
    "cesr_rows": ("cesr", dict(num_pixels=128, compact_chunk=64)),
    "vis_shard_fan": ("vis", dict(num_pixels=16, nsamp=16, shard_fan=True)),
    "vis": ("vis", dict(num_pixels=16, nsamp=16, shard_fan=False)),
    "norm": ("norm", dict(num_pixels=64)),
}
@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{case: (2 ranks' results, the one process's)}, the AE KL's ranks with
    its global latent, and the neus-surface gradient error's."""
    root = str(tmp_path_factory.mktemp("tex"))
    two_sphere_tex_sampler(root, 64)  # the Norm runs' texture, written once
    latent = np.random.default_rng(2).standard_normal((24, 8)).astype(np.float32)
    calls = [(rank_stage2_run, (stage, kw, STEPS, root)) for stage, kw in CASES.values()]
    rng = np.random.default_rng(4)
    surf = tuple(rng.uniform(-0.4, 0.4, (32, 3)).astype(np.float32) for _ in range(3))
    calls += [(rank_ae_kl, (latent,)), (rank_neus_surface, surf)]
    ranks = tmesh.spawn_ranks(each, 2, *calls, device="cpu", timeout_s=TIMEOUT_S)
    stages = {name: ([r[i] for r in ranks], rank_stage2_run(None, stage, kw, STEPS, root))
              for i, (name, (stage, kw)) in enumerate(CASES.items())}
    surface = ([r[-1] for r in ranks], rank_neus_surface(None, *surf))
    return stages, ([r[-2] for r in ranks], latent), surface


def _assert_matches_one_process(case) -> None:
    ranks, (want, want_metrics) = case
    for rank, (params, metrics) in enumerate(ranks):
        assert params.keys() == want.keys()
        diffs = np.concatenate([np.abs(params[k] - want[k]).ravel() for k in want])
        assert diffs.max() <= 2 * LR * STEPS, (rank, diffs.max())
        assert np.mean(diffs <= 1e-5) >= 0.99, (rank, np.mean(diffs <= 1e-5))
        for step, (got, ref) in enumerate(zip(metrics, want_metrics)):
            assert got.keys() == ref.keys()
            for k in ref:
                assert_close(got[k], ref[k], rtol=1e-5, atol=1e-7,
                             what=f"rank {rank} step {step} {k}")
        assert all(np.array_equal(params[k], ranks[0][0][k]) for k in params), rank


def test_pbr_rows_two_ranks_match_one_process(runs):
    _assert_matches_one_process(runs[0]["pbr_rows"])
    metrics = runs[0]["pbr_rows"][1][1]
    assert all(np.isfinite(m["loss"]) for m in metrics)
    assert 0 < metrics[-1]["surface_frac"] < 1


def test_cesr_rows_two_ranks_match_one_process(runs):
    _assert_matches_one_process(runs[0]["cesr_rows"])
    # 64 rows a rank at chunk 64: the rank's gate lowers the chunk to 32 and
    # compacts, as one process compacts its 128 rows
    assert tcompact.effective_chunk(64, 64, 2) == 32
    assert tcompact.effective_chunk(128, 64) == 64


@pytest.mark.parametrize("shards", [2, 4, 8])
def test_compaction_gate_matches_jax_per_shard(shards):
    mesh = jmesh.create_mesh(jmesh.MeshConfig(data=shards))
    for rows in (8, 32, 63, 64, 96, 128, 130, 512, 1024):
        for chunk in (0, 16, 64, 128, 4096):
            want = jcompact.effective_chunk(rows * shards, chunk, mesh)
            assert tcompact.effective_chunk(rows, chunk, shards) == want, (rows, chunk)


@pytest.mark.parametrize("case", ["vis_shard_fan", "vis"])
def test_vis_two_ranks_match_one_process(runs, case):
    _assert_matches_one_process(runs[0][case])


def test_vis_shard_fan_changes_nothing(runs):
    """Each rank's fan is its own pixels': shard_fan True and False give
    the same weights and metrics, bit for bit, on the ranks and alone."""
    fan, plain = runs[0]["vis_shard_fan"], runs[0]["vis"]
    for a, b in ((fan[1], plain[1]), *zip(fan[0], plain[0])):
        assert a[1] == b[1]
        assert all(np.array_equal(a[0][k], b[0][k]) for k in a[0])


def test_norm_two_ranks_match_one_process(runs):
    _assert_matches_one_process(runs[0]["norm"])


def test_ae_kl_of_the_global_mean_matches_jax(runs):
    ranks, latent = runs[1]
    x = jnp.asarray(latent)
    want, want_grad = jax.value_and_grad(lambda z: ae_kl_divergence(z, 0.05))(x)
    assert_close(sum(v for v, _ in ranks), float(want), rtol=1e-5, atol=0, what="kl")
    got_grad = np.concatenate([g for _, g in ranks])
    np.testing.assert_allclose(got_grad, np.asarray(want_grad), rtol=1e-5,
                               atol=1e-5 * float(np.abs(want_grad).max()))


def test_neus_surface_gradient_error_global_count(runs):
    ranks, want = runs[2]
    assert_close(sum(ranks), want, rtol=1e-6, atol=0, what="gradient error")

