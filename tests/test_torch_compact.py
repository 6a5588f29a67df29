"""The port's exact compaction (``robir_tpu_torch/core/compact.py``) against
a dense call and against the JAX package's ``compact_apply`` (sort, chunk
scan, sort back), at surface fractions 0, 0.3 and 1 and with the batch at
the JAX chunk and one row past it. Exact: the needed rows go through the
same function on the same values, and the others come back as zeros.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robir_tpu.core.compact import compact_apply as jcompact_apply
from robir_tpu.core.compact import effective_chunk as jeffective_chunk
from robir_tpu_torch.core.compact import compact_apply, effective_chunk

CHUNK = 32


def jfn(x, v):
    return {"a": x * 2.0 + v[:, None], "b": v > 0.0}


def tfn(x, v):
    return {"a": x * 2.0 + v[:, None], "b": v > 0.0}


@pytest.mark.parametrize("frac", [0.0, 0.3, 1.0])
@pytest.mark.parametrize("n", [CHUNK, CHUNK + 1])
def test_compact_apply_matches_dense_and_jax(frac, n):
    rng = np.random.default_rng(3)
    need = rng.random(n) < frac
    x = rng.normal(size=(n, 3)).astype(np.float32)
    v = rng.normal(size=(n,)).astype(np.float32)
    seen = []

    def recorded(x, v):
        seen.append(x.shape[0])
        return tfn(x, v)

    got = compact_apply(recorded, torch.as_tensor(need), [torch.as_tensor(x), torch.as_tensor(v)])
    # one call, on the needed rows only (on row 0 where none is needed)
    assert seen == [max(int(need.sum()), 1)]
    dense = tfn(torch.as_tensor(x), torch.as_tensor(v))
    want = jax.jit(lambda m, x, v: jcompact_apply(jfn, m, [x, v], CHUNK))(
        jnp.asarray(need), jnp.asarray(x), jnp.asarray(v))
    assert got["a"].dtype == torch.float32 and got["b"].dtype == torch.bool
    np.testing.assert_array_equal(got["a"].numpy(), np.where(need[:, None], dense["a"].numpy(), 0))
    np.testing.assert_array_equal(got["b"].numpy(), need & dense["b"].numpy())
    np.testing.assert_array_equal(got["a"].numpy(), np.asarray(want["a"]))
    np.testing.assert_array_equal(got["b"].numpy(), np.asarray(want["b"]))


def test_compact_apply_gradients():
    """Gradients reach the needed rows' inputs through the gather and the
    scatter, and the others get none."""
    rng = np.random.default_rng(4)
    need = torch.as_tensor(rng.random(40) < 0.5)
    x = torch.tensor(rng.normal(size=(40, 3)).astype(np.float32), requires_grad=True)
    out = compact_apply(lambda x: {"y": x ** 2}, need, [x])
    out["y"].sum().backward()
    np.testing.assert_array_equal(x.grad.numpy(),
                                  np.where(need.numpy()[:, None], 2 * x.detach().numpy(), 0))


@pytest.mark.parametrize("n", [0, 16, CHUNK, CHUNK + 1, 1024])
def test_effective_chunk_matches_jax(n):
    for chunk in (0, CHUNK, 128):
        assert effective_chunk(n, chunk) == jeffective_chunk(n, chunk)
