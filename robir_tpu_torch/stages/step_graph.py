"""A train step's loss call and its backward as two CUDA graphs.

A step whose shapes never change and which reads nothing back to the host
can be captured once and replayed: ``StepGraph`` holds the step's inputs in
buffers that keep their addresses (the batch, each draw, the cos-anneal
ratio as a 0-d tensor), captures the loss call on them and its backward,
and then runs a step as one replay of each, as
``torch.cuda.make_graphed_callables`` structures it: an autograd Function
whose forward replays the forward graph and whose backward replays the
backward graph and hands autograd the parameters' gradients, so that
``loss.backward()`` fills ``.grad`` as the eager step's does and the
optimizer's update runs eagerly on it.

- ``fill(batch, cos_anneal, generator)`` puts a step's inputs into the
  buffers: the batch (numpy, through pinned host buffers and one
  ``non_blocking`` copy each; or tensors on the device), each draw anew
  from ``generator`` in the order the loss call asks for them (``uniform_``
  draws what ``torch.rand`` does), and the ratio. The draws are taken
  before the replay, so a graph never draws and the generator moves as in
  the eager step.
- ``loss()`` -> (loss, metrics): the first call on the card warms the loss
  call and its gradient up once on a side stream (library loads, kernel
  attributes, cuBLAS; on the buffers as filled, touching neither the
  parameters nor ``.grad``), captures both graphs in one private memory
  pool (``captures`` counts them: one) and replays; every call replays
  (``replays``) inside the span ``neus.graph``. A capture that fails raises. On
  the CPU there is no graph: the loss call runs eagerly on the buffers
  (the tests' view of the static-input path).

Stage 1's trainer is its one user and chooses the steps it holds for
(``stages/neus_stage.py:stage1_step_path``).
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import torch

from ..core.draws import Draws
from ..data.blender import RayBatch
from ..tools.profiler import span


class _Replay(torch.autograd.Function):
    """The loss of the forward graph's replay; its backward replays the
    backward graph and returns the parameters' gradients."""

    @staticmethod
    def forward(ctx, graph: "StepGraph", *params):
        ctx.graph = graph
        graph._fwd.replay()
        return graph._loss.detach()

    @staticmethod
    def backward(ctx, dloss):
        graph = ctx.graph
        graph._dloss.copy_(dloss)
        graph._bwd.replay()
        return (None, *(None if g is None else g.detach() for g in graph._grads))


class StepGraph:
    """``loss_fn(batch, draws, cos_anneal) -> (loss, {name: 0-d tensor})``
    on fixed buffers shaped as ``batch`` (a ``RayBatch``), with uniform
    draws ``draws`` ({name: shape}), differentiated to ``params``."""

    def __init__(self, loss_fn: Callable, params: Sequence[torch.Tensor], batch: RayBatch,
                 draws: dict, device):
        self.loss_fn, self.params = loss_fn, list(params)
        self.device = torch.device(device)
        cuda = self.device.type == "cuda"
        like = [torch.as_tensor(x) for x in batch]
        self.batch = RayBatch(*[torch.empty(t.shape, dtype=t.dtype, device=self.device)
                                for t in like])
        self._host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                      for t in like] if cuda else None
        self._copied = torch.cuda.Event() if cuda else None
        self._draws = {k: torch.empty(tuple(s), device=self.device) for k, s in draws.items()}
        self.draws = Draws(given=self._draws, device=self.device)
        self.cos = torch.zeros((), device=self.device)
        self.captures = self.replays = 0
        self._fwd = None

    def fill(self, batch: RayBatch, cos_anneal: float, generator: torch.Generator) -> None:
        """A step's inputs into the buffers: ``batch`` (numpy or device
        tensors, shaped as the first), its draws from ``generator`` and
        the cos-anneal ratio."""
        if self._copied is not None:
            # the host buffers are free again once the last step's copies ran
            self._copied.synchronize()
        for i, (buf, x) in enumerate(zip(self.batch, batch)):
            if tuple(x.shape) != tuple(buf.shape):
                raise ValueError(f"batch field {RayBatch._fields[i]}: {tuple(x.shape)}, the "
                                 f"graph's is {tuple(buf.shape)}")
            if self._host is not None and not torch.is_tensor(x):
                np.copyto(self._host[i].numpy(), x)
                x = self._host[i]
            buf.copy_(torch.as_tensor(x), non_blocking=True)
        if self._copied is not None:
            self._copied.record()
        for buf in self._draws.values():
            buf.uniform_(generator=generator)
        self.cos.fill_(cos_anneal)

    def _call(self):
        """The loss call on the buffers: (loss, the metrics stacked)."""
        loss, metrics = self.loss_fn(self.batch, self.draws, self.cos)
        self._names = tuple(metrics)
        return loss, torch.stack([v.detach() for v in metrics.values()])

    def _capture(self) -> None:
        stream = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(stream)
        with torch.cuda.stream(side):
            loss, _ = self._call()
            torch.autograd.grad(loss, self.params, allow_unused=True)
            del loss
        stream.wait_stream(side)
        pool = torch.cuda.graph_pool_handle()
        fwd, bwd = torch.cuda.CUDAGraph(), torch.cuda.CUDAGraph()
        with torch.cuda.graph(fwd, pool=pool):
            self._loss, self._metrics = self._call()
        self._dloss = torch.ones_like(self._loss)
        with torch.cuda.graph(bwd, pool=pool):
            self._grads = torch.autograd.grad(self._loss, self.params, self._dloss,
                                              allow_unused=True)
        self._fwd, self._bwd = fwd, bwd
        self.captures += 1

    def loss(self) -> tuple[torch.Tensor, dict]:
        """(loss, {name: 0-d tensor}) of the step on the filled buffers:
        replayed on the card (its backward replays through
        ``loss.backward()``; the metrics are copies, the loss the graph's
        own buffer), the loss call itself on the CPU."""
        if self.device.type != "cuda":
            loss, stacked = self._call()
        else:
            if self._fwd is None:
                self._capture()
            with span("neus.graph"):
                loss = _Replay.apply(self, *self.params)
            stacked = self._metrics.clone()
            self.replays += 1
        return loss, dict(zip(self._names, stacked.unbind(0)))
