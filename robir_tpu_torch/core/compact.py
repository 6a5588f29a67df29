"""Exact compaction of ragged work (counterpart of
``robir_tpu/core/compact.py``): run an expensive function only on the rows
that need it.

XLA has no dynamic shapes, so the JAX package sorts the needed rows into
leading chunks, scans the chunks with a ``lax.cond`` that skips those with
no needed row, and sorts back. PyTorch has dynamic shapes, so the port
compacts exactly: it gathers the needed rows, runs the function once on
them and scatters the result back. The needed rows keep their original
order, as the JAX sort (stable) keeps them, so row j of the compacted
batch is the j-th needed row in both packages.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch

from ..tools.profiler import count, span


def effective_chunk(n: int, chunk: int, shards: int = 1) -> int:
    """The chunk to compact a rank's ``n`` rows at, or 0 to run them dense:
    the JAX package's gate per shard (``robir_tpu/core/compact.py:94-117``,
    with ``n`` its rows a shard). Compaction pays only when ``n > chunk``;
    over several ``shards`` (ranks), where the chunk was sized for a
    whole batch, it lowers to half the rank's rows from 64 rows up rather
    than fall back to dense. Compaction itself stays local: no rank waits
    for another's rows."""
    if chunk <= 0 or n <= 0:
        return 0
    if n > chunk:
        return chunk
    if shards > 1 and n >= 64:
        return max(32, n // 2)
    return 0


def compact_apply(fn: Callable, need: torch.Tensor, inputs: Sequence[torch.Tensor]):
    """``fn`` on the rows of ``inputs`` where ``need`` ([N] bool) holds.

    ``fn`` takes the needed rows of each input (in their original order)
    and returns a dict of tensors with one row per input row. Returns the
    dict at full length N, rows where ``need`` is False zero. Gradients
    flow through the gather and the scatter. Where no row is needed, ``fn``
    runs on row 0 and its output is dropped, so that every output keeps
    its shape (JAX's compaction, too, evaluates unneeded rows of a chunk
    and zeroes them). Finding the needed rows (``torch.nonzero``) waits for
    the device once per call: the number of rows sets the shapes of
    everything ``fn`` launches."""
    with span("compact.wait"):
        idx = torch.nonzero(need).squeeze(1)
    count("compact.rows", idx.numel())
    rows = idx if idx.numel() else idx.new_zeros(1)
    out = fn(*[a.index_select(0, rows) for a in inputs])
    n, k = need.shape[0], idx.numel()
    return {name: v.new_zeros((n,) + v.shape[1:]).index_copy(0, idx, v[:k])
            for name, v in out.items()}
