"""The PBR and CESR train steps as CUDA graphs, one a row bucket.

A compacted stage-2 step waits for the device once (``core/compact.py``:
the surface rows' count sets the shapes of the render), so no one graph
holds it. Padded to B rows, a whole number of ``compact_chunk`` chunks
(``compact_apply_padded``), the step has one shape a bucket, and
``MaterialGraphs`` captures it once a key (B and the step's host-side
flags) and replays it. A step on the graph path:

1. the prefix, eager: the batch in fixed buffers (``put``: numpy through
   pinned host buffers and one ``non_blocking`` copy each), the grid march,
   the surface mask and the wait for its rows (``compact.wait``,
   ``compact.rows``: the k rows, not B);
2. the bucket B = ``bucket_rows(k, compact_chunk)``;
3. the fill: the march's depths and hits, the padded row index and the
   row-valid mask (``pad_rows``), and every draw of the step in the order
   the eager step asks for them (``core/draws.py:PaddedDraws``: k rows of
   each per-row draw, so that the generator moves exactly as in the eager
   step);
4. the replay, in the span ``stage2.graph``: the loss call on the buffers
   (the indirect net over all rows, the gather of B rows, the render, the
   scatter of the padding rows to a dropped row, the loss) and its
   ``torch.autograd.grad`` into the graph's gradient buffers, which
   ``run`` returns with the metrics; the runner hands them to ``.grad``
   and Adam runs eagerly (``MaterialRunner._apply``).

A new key's draws are laid out from its flags' draw spec, which one eager
call at one chunk of padding rows (``_probe``, on a generator of its own)
notes at the first step of those flags; on the card it runs on a side
stream and also warms up what a capture must not do first (library loads,
kernel attributes, cuBLAS). Every input buffer is made before its capture:
to a graph, memory allocated during its capture is its own.

Memory: every graph captures its whole forward and backward, so none keeps
saved activations between replays, and all share one memory pool, whose
peak is about the largest bucket's step: a bucket above every captured one
drops the graphs and is captured first, so that the smaller ones fit in
its blocks. A graph's outputs live in that pool and another graph's replay
may overwrite them, so ``run`` copies the metrics and the runner's Adam
reads the gradients before any other replay. ``torch.cuda.graph`` frees
the cached blocks before each capture. A capture that fails (out of
memory or otherwise) drops every graph and turns the path off for the
runner, with a warning (``error`` keeps its text): its steps run eagerly
from then on, counted in ``eager_fallbacks``.

Counters (host ints, whether or not a profiler runs): ``captures``,
``replays``, ``eager_fallbacks`` and ``padded_rows`` (the sum of B - k over
the padded steps). On the CPU there is no graph: the padded step runs
eagerly on the same buffers (the tests' view of the path).

``MaterialRunner`` (``stages/stage2_runner.py``) takes this path for a
compacted step on a CUDA device without a mesh (``graphable``).
"""

from __future__ import annotations

import warnings
from typing import Callable, Sequence

import numpy as np
import torch

from ..core.compact import bucket_rows, pad_rows
from ..core.draws import Draws, PaddedDraws
from ..tools.profiler import span


def graphable(device, mesh) -> bool:
    """Whether a ``MaterialRunner``'s compacted steps take the graph path:
    on a CUDA device without a mesh (collectives are not captured, and a
    rank's per-row draws need every rank's row count)."""
    return torch.device(device).type == "cuda" and mesh is None


class _Entry:
    """One key's padded inputs, draws, graph and outputs."""

    def __init__(self, padded: int, device):
        self.padded = padded
        self.index = torch.zeros((padded,), dtype=torch.int64, device=device)
        self.valid = torch.zeros((padded,), dtype=torch.bool, device=device)
        self.draws = PaddedDraws(padded, device)
        self.graph = None
        self.names: tuple = ()
        self.metrics = None
        self.grads: tuple = ()


class MaterialGraphs:
    """The padded step's buffers and one graph a key, for the loss calls
    ``loss_fn(batch, draws, traced, padded) -> (loss, {name: 0-d tensor})``
    differentiated to ``params`` (the runner's trainables)."""

    def __init__(self, params: Sequence[torch.Tensor], chunk: int, device):
        self.params, self.chunk = list(params), chunk
        self.device = torch.device(device)
        self.batch: dict | None = None
        self._host: dict | None = None
        self._copied = None
        self.traced = None
        self.entries: dict = {}
        self._specs: dict = {}
        self._pool = None
        self.failed, self.error = False, None
        self.captures = self.replays = self.eager_fallbacks = self.padded_rows = 0

    def put(self, batch: dict) -> dict:
        """``batch`` ({name: numpy array or tensor}) in the fixed buffers,
        which it returns: numpy through pinned host buffers on the card."""
        cuda = self.device.type == "cuda"
        if self.batch is None:
            like = {k: torch.as_tensor(v) for k, v in batch.items()}
            self.batch = {k: torch.empty(t.shape, dtype=t.dtype, device=self.device)
                          for k, t in like.items()}
            if cuda:
                self._host = {k: torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                              for k, t in like.items()}
                self._copied = torch.cuda.Event()
        elif self._copied is not None:
            # the host buffers are free again once the last step's copies ran
            self._copied.synchronize()
        for k, buf in self.batch.items():
            x = batch[k]
            if x is buf:
                continue
            if tuple(x.shape) != tuple(buf.shape):
                raise ValueError(f"batch {k}: {tuple(x.shape)}, the buffers' is "
                                 f"{tuple(buf.shape)}")
            if self._host is not None and not torch.is_tensor(x):
                np.copyto(self._host[k].numpy(), x)
                x = self._host[k]
            buf.copy_(torch.as_tensor(x), non_blocking=True)
        if self._copied is not None:
            self._copied.record()
        return self.batch

    def run(self, key: tuple, idx: torch.Tensor, traced, loss_fn: Callable,
            generator: torch.Generator) -> tuple[dict, tuple] | None:
        """The step of ``key`` (the loss call's host-side flags) for the
        needed rows ``idx`` ([k]) and the march's ``traced`` (depths, hits)
        of the batch in ``put``'s buffers, its draws from ``generator``:
        (metrics, each parameter's gradient or None), or None where a
        capture failed (``failed``): the caller then runs the step eagerly,
        and it is counted."""
        k = idx.numel()
        padded = bucket_rows(k, self.chunk)
        if self.traced is None:
            self.traced = tuple(torch.empty_like(t) for t in traced)
        for buf, t in zip(self.traced, traced):
            buf.copy_(t)
        full = (padded,) + tuple(key)
        entry = self.entries.get(full)
        if entry is None:
            try:
                entry = self._make(padded, tuple(key), idx, loss_fn)
            except RuntimeError as err:  # torch.cuda.OutOfMemoryError among them
                self._drop()
                self.failed, self.error = True, repr(err)
                self.eager_fallbacks += 1
                warnings.warn(f"the padded step's CUDA graph capture failed ({err!r}); "
                              f"the runner steps eagerly from now on")
                return None
            self.entries[full] = entry
        else:
            pad_rows(idx, entry.index, entry.valid)
        entry.draws.fill(generator, k)
        self.padded_rows += padded - k
        if entry.graph is None:  # the CPU
            entry.draws.serve()
            names, stacked, grads = self._call(entry, loss_fn, entry.draws)
            return dict(zip(names, stacked.unbind(0))), grads
        with span("stage2.graph"):
            entry.graph.replay()
        self.replays += 1
        return dict(zip(entry.names, entry.metrics.clone().unbind(0))), entry.grads

    def _call(self, entry: _Entry, loss_fn: Callable, draws: Draws):
        """The loss call on the buffers, and its gradients."""
        loss, metrics = loss_fn(self.batch, draws, self.traced, (entry.index, entry.valid))
        grads = torch.autograd.grad(loss, self.params, allow_unused=True)
        return tuple(metrics), torch.stack([v.detach() for v in metrics.values()]), grads

    def _make(self, padded: int, key: tuple, idx: torch.Tensor, loss_fn: Callable) -> _Entry:
        """A new key's entry: its draws laid out from the key's flags' draw
        spec (``_probe`` at a new one), its index filled, and on the card
        its graph captured. A bucket above every captured one drops the
        graphs first, so that the pool is sized by its largest step and
        the smaller ones fit in its blocks."""
        spec = self._specs.get(key)
        if spec is None:
            spec = self._specs[key] = self._probe(loss_fn)
        cuda = self.device.type == "cuda"
        if cuda and self.entries and padded > max(e.padded for e in self.entries.values()):
            self._drop()
        entry = _Entry(padded, self.device)
        entry.draws.allocate(spec)
        pad_rows(idx, entry.index, entry.valid)
        if cuda:
            if self._pool is None:
                self._pool = torch.cuda.graph_pool_handle()
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, pool=self._pool):
                entry.draws.serve()
                entry.names, entry.metrics, entry.grads = self._call(entry, loss_fn,
                                                                     entry.draws)
            entry.graph = graph
            self.captures += 1
        return entry

    def _probe(self, loss_fn: Callable) -> list:
        """The draws the loss call asks for, in order (``PaddedDraws.spec``),
        from one eager call and its gradient at one chunk of padding rows,
        on draws of a generator of its own: on the card on a side stream,
        where it also warms up what a capture must not do first (library
        loads, kernel attributes, cuBLAS)."""
        probe = _Entry(self.chunk, self.device)
        probe.draws.draw_now(torch.Generator(device=self.device).manual_seed(0), 0)
        if self.device.type != "cuda":
            self._call(probe, loss_fn, probe.draws)
            return probe.draws.spec()
        stream = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(stream)
        with torch.cuda.stream(side):
            self._call(probe, loss_fn, probe.draws)
        stream.wait_stream(side)
        return probe.draws.spec()

    def _drop(self) -> None:
        """Free every graph and the pool."""
        self.entries.clear()
        self._pool = None
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            torch.cuda.empty_cache()

    def close(self) -> None:
        """Free every graph, the pool and the buffers."""
        self._drop()
        self.batch = self._host = self.traced = None
