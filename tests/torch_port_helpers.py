"""Helpers shared by the tests that hold robir_tpu_torch to robir_tpu.

Inputs are made with numpy from a seed and handed to both packages; the JAX
side runs on the CPU as its own tests run it (Pallas kernels in interpret
mode), the port's side on CPU tensors, where its ops run their plain
versions. Whether a card is present is decided inside a test
(``cuda_or_skip``), never at import.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch


def cuda_or_skip() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels run only on the card")
    return torch.device("cuda")


def to_t(x, device="cpu") -> torch.Tensor:
    return torch.as_tensor(np.array(x, np.float32), device=device)


def to_np(x) -> np.ndarray:
    if torch.is_tensor(x):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def trunk_case(plan, seed: int, n_rows: int):
    """(x, weights, biases) as float32 numpy arrays for a trunk plan with
    ``layer_in_dim``/``layer_out_dim`` (either package's MLPPlan)."""
    rng = np.random.default_rng(seed)
    ws, bs = [], []
    for i in range(plan.n_layers):
        din, dout = plan.layer_in_dim(i), plan.layer_out_dim(i)
        ws.append((rng.standard_normal((din, dout)) / np.sqrt(din)).astype(np.float32))
        bs.append((0.1 * rng.standard_normal(dout)).astype(np.float32))
    x = rng.standard_normal((n_rows, plan.dims[0])).astype(np.float32)
    return x, ws, bs


def assert_close(got, want, rtol, atol, what=""):
    np.testing.assert_allclose(to_np(got), to_np(want), rtol=rtol, atol=atol,
                               err_msg=what)
