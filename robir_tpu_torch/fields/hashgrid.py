"""Multi-resolution hash-grid encoding, instant-NGP style (counterpart of
``robir_tpu/fields/hashgrid.py``), and the hash-encoded SDF field.

L levels of growing resolution, each a hashed feature table, trilinearly
interpolated. The JAX package hashes ``uint32`` corner coordinates times
``uint32`` primes with wraparound; torch's ``uint32`` arithmetic is
partial, so here each product is taken in ``int64`` and masked to 32 bits
(``& 0xFFFFFFFF``) before the xor, then to the table (``& (T - 1)``).
Corner coordinates stay below 2^13 (the finest default level is 7,006
nodes a side), so no ``int64`` product overflows. Plain PyTorch gathers:
the JAX package has no Pallas kernel here (its encoding is XLA gathers);
the tables' gradient is the gather's backward, a scatter-add.

Under a profiler the level loop runs in the span ``hash.encode``, and each
call then counts its points as ``hash.points`` (a host int, just after the
span); without one both are the shared no-op.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..tools.profiler import count, span
from .mlp import Params, apply_linear, init_linear

_PRIMES = (1, 2654435761, 805459861)
_MASK32 = 0xFFFFFFFF
# the eight corners of a cell, i over x, j over y, k over z (JAX's order)
_CORNERS = np.array([[i, j, k] for i in (0, 1) for j in (0, 1) for k in (0, 1)],
                    dtype=np.int64)


@dataclasses.dataclass(frozen=True)
class HashGridConfig:
    n_levels: int = 16
    n_features: int = 2
    log2_hashmap_size: int = 18
    base_resolution: int = 16
    per_level_scale: float = 1.5
    bbox_min: tuple[float, float, float] = (-1.0, -1.0, -1.0)
    bbox_max: tuple[float, float, float] = (1.0, 1.0, 1.0)

    @property
    def table_size(self) -> int:
        return 1 << self.log2_hashmap_size

    @property
    def out_dim(self) -> int:
        return self.n_levels * self.n_features

    def resolution(self, level: int) -> int:
        return int(np.floor(self.base_resolution * self.per_level_scale ** level))


def init_hashgrid(gen: torch.Generator, cfg: HashGridConfig) -> Params:
    """Tables ~ U(-1e-4, 1e-4), the instant-NGP convention."""
    shape = (cfg.n_levels, cfg.table_size, cfg.n_features)
    return {"tables": (torch.rand(shape, generator=gen) * 2 - 1) * 1e-4}


def spatial_hash(coords: torch.Tensor) -> torch.Tensor:
    """[..., 3] non-negative int64 -> [...] int64 in [0, 2^32): the
    instant-NGP hash, ``uint32`` wraparound arithmetic."""
    h = (coords[..., 0] * _PRIMES[0]) & _MASK32
    h = h ^ ((coords[..., 1] * _PRIMES[1]) & _MASK32)
    return h ^ ((coords[..., 2] * _PRIMES[2]) & _MASK32)


def hashgrid_encode(params: Params, cfg: HashGridConfig, x: torch.Tensor) -> torch.Tensor:
    """[N, 3] -> [N, n_levels * n_features] trilinear hashed features."""
    lo = torch.tensor(cfg.bbox_min, dtype=x.dtype, device=x.device)
    hi = torch.tensor(cfg.bbox_max, dtype=x.dtype, device=x.device)
    u = torch.clamp((x - lo) / (hi - lo), 0.0, 1.0)
    corners = torch.as_tensor(_CORNERS, device=x.device)
    is_one = (corners == 1)[None]                                   # [1, 8, 3]
    tables = params["tables"]
    feats = []
    with span("hash.encode"):
        for level in range(cfg.n_levels):
            g = u * (cfg.resolution(level) - 1)
            g0 = torch.floor(g)
            frac = g - g0
            idx = g0.to(torch.int64)[:, None, :] + corners[None]   # [N, 8, 3]
            h = spatial_hash(idx) & (cfg.table_size - 1)            # [N, 8]
            vals = tables[level][h]                                 # [N, 8, F]
            w = torch.where(is_one, frac[:, None, :], 1.0 - frac[:, None, :]).prod(-1)
            feats.append(torch.sum(vals * w[..., None], dim=1))
    count("hash.points", x.shape[0])
    return torch.cat(feats, dim=-1)


@dataclasses.dataclass(frozen=True)
class HashSDFConfig:
    """Hash-encoded SDF field: hash features and a small MLP head."""

    grid: HashGridConfig = HashGridConfig()
    d_out: int = 257
    width: int = 128
    depth: int = 4


def init_hash_sdf(gen: torch.Generator, cfg: HashSDFConfig) -> Params:
    params = {"hash": init_hashgrid(gen, cfg.grid)}
    dims = (cfg.grid.out_dim,) + (cfg.width,) * cfg.depth + (cfg.d_out,)
    params["mlp"] = {f"lin{i}": init_linear(gen, dims[i], dims[i + 1])
                     for i in range(len(dims) - 1)}
    return params


def hash_sdf_apply(params: Params, cfg: HashSDFConfig, x: torch.Tensor) -> torch.Tensor:
    """[N, 3] -> [N, d_out]: the encoding, then ReLU linears."""
    h = hashgrid_encode(params["hash"], cfg.grid, x)
    n = cfg.depth + 1
    for i in range(n):
        h = apply_linear(params["mlp"][f"lin{i}"], h)
        if i < n - 1:
            h = torch.relu(h)
    return h
