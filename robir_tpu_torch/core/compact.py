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

The padded variant (``bucket_rows``, ``pad_rows``, ``compact_apply_padded``)
is the one the CUDA graphs of the stage-2 train steps hold
(``stages/material_graph.py``): the function runs on B rows, a whole
number of chunks, the k needed rows first and then copies of the first of
them, and the padding rows' outputs go to a dropped row. The same k rows
come out as from ``compact_apply``, and a graph captured at B serves
every step with k in (B - chunk, B].
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


def needed_rows(need: torch.Tensor) -> torch.Tensor:
    """The indices of the rows where ``need`` ([N] bool) holds, in order:
    the one wait for the device (span ``compact.wait``), the count logged
    as ``compact.rows``."""
    with span("compact.wait"):
        idx = torch.nonzero(need).squeeze(1)
    count("compact.rows", idx.numel())
    return idx


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
    idx = needed_rows(need)
    rows = idx if idx.numel() else idx.new_zeros(1)
    out = fn(*[a.index_select(0, rows) for a in inputs])
    n, k = need.shape[0], idx.numel()
    return {name: v.new_zeros((n,) + v.shape[1:]).index_copy(0, idx, v[:k])
            for name, v in out.items()}


def bucket_rows(k: int, chunk: int) -> int:
    """The rows a padded call runs for ``k`` needed rows: whole chunks of
    ``chunk``, at least one (``compact_apply`` runs on one row where none
    is needed)."""
    return max(1, -(-k // chunk)) * chunk


def pad_rows(idx: torch.Tensor, index: torch.Tensor, valid: torch.Tensor) -> None:
    """Fill the padded call's buffers for the needed rows ``idx`` ([k]):
    ``index`` ([B], B >= k) the k rows, then copies of the first of them
    (of row 0 where k is 0); ``valid`` ([B] bool) true on the first k."""
    k = idx.numel()
    if k:
        index[:k].copy_(idx)
        index[k:].copy_(idx[:1].expand(index.shape[0] - k))
    else:
        index.zero_()
    valid[:k].fill_(True)
    valid[k:].fill_(False)


def compact_apply_padded(fn: Callable, index: torch.Tensor, valid: torch.Tensor,
                         inputs: Sequence[torch.Tensor]):
    """``compact_apply`` on the rows ``pad_rows`` put in ``index``, with no
    wait: ``fn`` takes the B rows of each input at ``index`` and returns a
    dict of tensors with one row per row it took. Returns the dict at full
    length N, the needed rows' outputs in place and every other row zero;
    the padding rows' outputs (``valid`` false) are scattered to a row past
    N that is cut, so that they reach no output and their gradient is
    exactly zero."""
    n = inputs[0].shape[0]
    out = fn(*[a.index_select(0, index) for a in inputs])
    dest = torch.where(valid, index, n)
    return {name: v.new_zeros((n + 1,) + v.shape[1:]).index_copy(0, dest, v)[:n]
            for name, v in out.items()}
