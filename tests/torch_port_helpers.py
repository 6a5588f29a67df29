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


def jax_sg_draws(key, n_points: int, n_lights: int, diffuse_nsamp: int = 8,
                 spec_nsamp: int = 8, indirect: bool = True) -> dict:
    """The U[0,1) draws ``robir_tpu.render.sg.render_with_all_sg`` makes from
    ``key``, by the port's names (JAX imported here, so that the card-only
    tests, which import this module, need no JAX)."""
    import jax

    def pair(k, shape, prefix):
        ka, kb = jax.random.split(k)
        return {prefix + "theta": np.asarray(jax.random.uniform(ka, shape)),
                prefix + "phi": np.asarray(jax.random.uniform(kb, shape))}

    k1, k2 = jax.random.split(key)
    k_diff, rest = jax.random.split(k1)
    draws = pair(k_diff, (n_lights, diffuse_nsamp), "lobe_")
    draws.update(pair(jax.random.split(rest)[0], (n_points, spec_nsamp), "spec_"))
    if indirect:
        draws.update(pair(jax.random.split(k2)[0], (n_points, spec_nsamp), "indir_spec_"))
    return draws


def jax_stage2_draws(key, n_points: int, stage2_cfg, n_lights: int,
                     diffuse_nsamp: int = 8) -> dict:
    """Every draw of one dense ``robir_tpu.render.stage2.stage2_forward``
    with an ``hdr_shift`` (the CESR step's; ``diffuse_nsamp=32`` for
    ``default_sg_render``) from its key, by the port's names: the indirect
    AE noise, the material heads' noise, then the SG render's directions."""
    import jax

    env = stage2_cfg.envmap
    k_ind, key = jax.random.split(key)
    k_sg, _ = jax.random.split(key)
    k_mat, k_render = jax.random.split(k_sg)
    k_spec, k_norm = jax.random.split(k_mat)
    draws = {
        "indirect_ae": np.asarray(jax.random.normal(
            k_ind, (n_points, stage2_cfg.indirect.in_dim))),
        "spec_ae": np.asarray(jax.random.normal(k_spec, (n_points, env.latent_dim))),
        "normal_ae": np.asarray(jax.random.normal(k_norm, (n_points, env.ipe.out_dim))),
    }
    draws.update(jax_sg_draws(k_render, n_points, n_lights, diffuse_nsamp))
    return draws
