"""Data parallelism over processes (counterpart of ``robir_tpu/core/mesh.py``).

The JAX package lays one ``data`` axis over every chip: ray and pixel
batches are sharded over it, the parameters replicated, and jit inserts
the gradient psum. The port runs one process per rank under
``torch.distributed``, and writes out what jit inserts:

- every rank draws the same global batch and the same global random draws
  from the shared seed and keeps its ``local_batch_slice``, so neither the
  sampling nor the noise depends on the world size;
- the parameters start as a broadcast from rank 0 (``replicate``);
- each mean over the batch in a loss is this rank's sum over the global
  count (``global_sum``, detached), and each non-linear batch statistic
  is taken of the differentiable global sum and divided by the world size,
  so that the per-rank losses add up to the global loss;
- after backward, the gradients (and the metrics, which add up the same
  way) are summed in one all-reduce of one flat buffer
  (``all_reduce_grads``), and every rank applies the same update, so the
  replicas stay bit-equal.

So a step over N ranks computes what one process computes on the whole
global batch, up to the order of the sums. The backend follows from the
device layout: ``nccl`` where each rank owns its GPU, ``gloo`` on the CPU
or where ranks share a GPU (gloo reduces CUDA tensors too). A rank that
fails or is lost fails the run within ``timeout_s`` rather than hanging it.

``spawn_ranks`` runs a function on N local ranks (spawned processes over
``tcp://localhost``) and returns each rank's result: the dry run
(``tools/dryrun_multichip.py``), the tests and ``chip_smoke.py`` use it. A
user runs ``torchrun --nproc_per_node=N`` and calls
``initialize_distributed()`` and ``create_mesh()`` in each process.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import pickle
import socket
import time
import traceback
import warnings
from typing import Any, Callable, Iterable, NamedTuple, Optional, Sequence

import torch
import torch.distributed as dist

from .. import resolve_device

DATA_AXIS = "data"
# seconds a collective may wait for a rank before the run fails
DEFAULT_TIMEOUT_S = 300.0


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """How many ranks the data axis spans: -1 all of the process group's."""

    data: int = -1


@dataclasses.dataclass(frozen=True)
class DataMesh:
    """One rank's view of the data axis: its rank, the world size, the
    process group (None: the default group), the rank's device and the
    backend (None: one process, no group)."""

    rank: int
    world: int
    device: torch.device
    backend: Optional[str] = None
    group: Any = None

    def local_slice(self, global_rows: int) -> slice:
        """This rank's rows of a global batch of ``global_rows``; raises
        ValueError where the batch does not split evenly (the JAX
        package's sharding refuses it too)."""
        if global_rows % self.world:
            raise ValueError(f"a batch of {global_rows} rows does not split over "
                             f"{self.world} ranks")
        return local_batch_slice(global_rows, self)


class RowSplit(NamedTuple):
    """This rank's rows of a row set spread over the ranks: they are rows
    ``offset`` to ``offset + count`` of the set's ``total``."""

    offset: int
    count: int
    total: int


def _local_world(world: int) -> int:
    return int(os.environ.get("LOCAL_WORLD_SIZE", world))


def _local_rank(rank: int, world: int) -> int:
    return int(os.environ.get("LOCAL_RANK", rank % _local_world(world)))


def backend_for(device, local_world: int) -> str:
    """``nccl`` when each of the node's ``local_world`` ranks owns a GPU;
    ``gloo`` on the CPU and where ranks share a GPU."""
    device = torch.device(device)
    if device.type == "cuda" and torch.cuda.device_count() >= local_world:
        return "nccl"
    return "gloo"


def initialize_distributed(coordinator_address: str | None = None,
                           num_processes: int | None = None,
                           process_id: int | None = None, device="cuda",
                           timeout_s: float = DEFAULT_TIMEOUT_S) -> str:
    """Join the process group: once per process, before ``create_mesh``.

    With all three arguments None, reads torchrun's ``env://`` variables
    (``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``); else
    ``coordinator_address`` is ``host:port`` of rank 0. The backend follows
    from ``device`` and the number of ranks on this node
    (``backend_for``); returns it."""
    world = num_processes if num_processes is not None else int(os.environ["WORLD_SIZE"])
    rank = process_id if process_id is not None else int(os.environ["RANK"])
    device = resolve_device(device)
    backend = backend_for(device, _local_world(world))
    if backend == "nccl":
        torch.cuda.set_device(_local_rank(rank, world))
    init = ("env://" if coordinator_address is None
            else f"tcp://{coordinator_address}")
    dist.init_process_group(backend, init_method=init, world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout_s))
    return backend


def create_mesh(cfg: MeshConfig | int = MeshConfig(), device="cuda") -> DataMesh:
    """The data axis over the process group's ranks (one process, no group:
    a mesh of one). The rank's device: ``cpu``, or on ``cuda`` the GPU its
    local rank owns under nccl, and under gloo the GPU it shares."""
    if isinstance(cfg, int):
        cfg = MeshConfig(data=cfg)
    device = resolve_device(device)
    if not dist.is_initialized():
        if cfg.data not in (-1, 1):
            raise ValueError(f"mesh wants {cfg.data} ranks on its {DATA_AXIS!r} axis; "
                             "no process group is initialised")
        return DataMesh(0, 1, device)
    rank, world = dist.get_rank(), dist.get_world_size()
    if cfg.data not in (-1, world):
        raise ValueError(f"mesh wants {cfg.data} ranks on its {DATA_AXIS!r} axis, "
                         f"the process group has {world}")
    backend = dist.get_backend()
    if device.type == "cuda":
        local = _local_rank(rank, world)
        device = torch.device("cuda", local if backend == "nccl"
                              else local % torch.cuda.device_count())
    return DataMesh(rank, world, device, backend)


def mesh_shards(mesh: DataMesh | None) -> int:
    """Ranks the batch splits over (1 without a mesh)."""
    return 1 if mesh is None else mesh.world


def _process_group_size() -> tuple[int, int]:
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def local_batch_slice(global_batch: int, mesh: DataMesh | None = None) -> slice:
    """This process's rows of a global batch: ``global_batch // world``
    rows from ``rank * per``, the JAX package's slice
    (``robir_tpu/core/mesh.py:local_batch_slice``; rows beyond the last
    full share are no rank's). The rank and world are the mesh's, else
    the process group's."""
    rank, world = (mesh.rank, mesh.world) if mesh is not None else _process_group_size()
    per = global_batch // world
    return slice(rank * per, (rank + 1) * per)


def pad_to_multiple(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def _collective(mesh: DataMesh | None) -> bool:
    return mesh is not None and mesh.world > 1


def _flat_apply(tensors: Sequence[torch.Tensor], op: Callable[[torch.Tensor], None]) -> None:
    """``op`` in place on one flat buffer a dtype holding ``tensors``, then
    the buffer copied back into them."""
    by_dtype: dict = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for group in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in group])
        op(flat)
        off = 0
        for t in group:
            n = t.numel()
            t.copy_(flat[off:off + n].view_as(t))
            off += n


def replicate(mesh: DataMesh | None, params: Iterable[torch.Tensor]) -> None:
    """Rank 0's values into every rank's ``params``, in place: one
    broadcast of a flat buffer a dtype."""
    if not _collective(mesh):
        return
    with torch.no_grad():
        _flat_apply(list(params), lambda flat: dist.broadcast(flat, 0, group=mesh.group))


def all_reduce_grads(mesh: DataMesh | None, params: Iterable[torch.nn.Parameter],
                     metrics: dict | None = None, shared: Sequence[str] = ()) -> dict | None:
    """Sum the gradients of ``params`` over the ranks, in place, and the
    ``metrics`` (detached scalars, each this rank's share of the global
    value) with them, in one all-reduce of one flat buffer. Metrics named
    in ``shared`` are global already and stay as they are. A parameter
    without a gradient takes none (structurally the same on every rank).
    Returns the summed metrics (``metrics`` as they are with no mesh)."""
    if not _collective(mesh):
        return metrics
    params = [p for p in params if p.grad is not None]
    names = [k for k in (metrics or {}) if k not in shared]
    flat = [p.grad for p in params]
    if names:
        flat.append(torch.stack([metrics[k].detach().to(torch.float32).reshape(())
                                 for k in names]))
    with torch.no_grad():
        _flat_apply(flat, lambda buf: dist.all_reduce(buf, group=mesh.group))
    if metrics is None:
        return None
    out = dict(metrics)
    out.update({k: flat[-1][i] for i, k in enumerate(names)})
    return out


def global_sum(mesh: DataMesh | None, *xs: torch.Tensor, differentiable: bool = False):
    """The sum over the ranks of each of ``xs`` (tensors of any shape),
    each as it is with no mesh. Detached (one all-reduce of the stacked
    values): for the counts that normalise a batch mean. With
    ``differentiable``: the gradient of a loss on the sum flows back to
    every rank's own term (``torch.distributed.nn.functional.all_reduce``,
    whose backward sums the cotangents), for the batch statistics that
    enter a loss non-linearly. Returns one tensor for one argument, else a
    tuple."""
    if _collective(mesh):
        if differentiable:
            from torch.distributed.nn.functional import all_reduce
            with warnings.catch_warnings():
                # its deprecation notice names a private successor
                warnings.simplefilter("ignore", FutureWarning)
                xs = tuple(all_reduce(x, group=mesh.group or dist.group.WORLD) for x in xs)
        else:
            flat = torch.cat([x.detach().reshape(-1).to(torch.float64) for x in xs])
            dist.all_reduce(flat, group=mesh.group)
            out, off = [], 0
            for x in xs:
                out.append(flat[off:off + x.numel()].reshape(x.shape).to(x.dtype))
                off += x.numel()
            xs = tuple(out)
    return xs[0] if len(xs) == 1 else tuple(xs)


def batch_mean(mesh: DataMesh | None, x: torch.Tensor,
               weight: torch.Tensor | None = None) -> torch.Tensor:
    """The mean over every rank's rows of ``x`` [N, ...] along its first
    axis, weighted by ``weight`` [N] (a mask: its count clamped at 1)
    where given, as a differentiable function of this rank's rows (the
    differentiable global sum of the numerator, the detached one of the
    count): a batch statistic that a loss takes non-linearly."""
    world = 1 if mesh is None else mesh.world
    if weight is None:
        return global_sum(mesh, torch.sum(x, 0), differentiable=True) / (x.shape[0] * world)
    w = weight.reshape((-1,) + (1,) * (x.dim() - 1)).to(x.dtype)
    num = global_sum(mesh, torch.sum(x * w, 0), differentiable=True)
    return num / torch.clamp(global_sum(mesh, torch.sum(w, 0)), min=1.0)


def global_max(mesh: DataMesh | None, value: float) -> float:
    """The largest of each rank's ``value``."""
    if not _collective(mesh):
        return value
    t = torch.tensor([value], dtype=torch.float64, device=mesh.device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=mesh.group)
    return float(t)


def row_split(mesh: DataMesh | None, count: int) -> RowSplit | None:
    """This rank's place in a row set whose rows each rank holds ``count``
    of, in rank order (one all-reduce of the counts; None without a
    mesh)."""
    if not _collective(mesh):
        return None
    counts = torch.zeros(mesh.world, dtype=torch.int64, device=mesh.device)
    counts[mesh.rank] = count
    dist.all_reduce(counts, group=mesh.group)
    counts = counts.tolist()
    return RowSplit(sum(counts[:mesh.rank]), count, sum(counts))


def batch_split(mesh: DataMesh | None, local_rows: int) -> RowSplit | None:
    """This rank's place in an evenly split batch of ``local_rows`` a rank
    (no collective; None without a mesh)."""
    if not _collective(mesh):
        return None
    return RowSplit(mesh.rank * local_rows, local_rows, mesh.world * local_rows)


def gather_rows(mesh: DataMesh | None, x: torch.Tensor) -> torch.Tensor:
    """Every rank's ``x`` (the same shape on each), concatenated along
    rows in rank order, on every rank."""
    if not _collective(mesh):
        return x
    parts = [torch.empty_like(x) for _ in range(mesh.world)]
    dist.all_gather(parts, x.contiguous(), group=mesh.group)
    return torch.cat(parts)


def is_writer(mesh: DataMesh | None) -> bool:
    """Whether this process writes checkpoints, logs, plots and meshes:
    rank 0, or the one process."""
    return mesh is None or mesh.rank == 0


def bit_checksum(t: torch.Tensor) -> int:
    """A checksum of ``t``'s bits (its bytes as position-weighted integers),
    for telling whether two ranks hold the same tensor."""
    b = t.detach().reshape(-1).contiguous().view(torch.uint8).to(torch.int64)
    w = torch.arange(b.numel(), device=b.device, dtype=torch.int64) % 65521 + 1
    return int(torch.sum(b * w))


def check_replicas(mesh: DataMesh | None, what: str, tensors: Iterable[torch.Tensor]) -> None:
    """Raise RuntimeError unless every rank holds the same bits in
    ``tensors`` (one all-gather of a checksum each)."""
    if not _collective(mesh):
        return
    sums = torch.tensor([bit_checksum(t) for t in tensors], dtype=torch.int64,
                        device=mesh.device)
    every = gather_rows(mesh, sums[None])
    if not bool(torch.all(every == every[:1])):
        raise RuntimeError(f"{what} differs between the ranks")


def free_port() -> int:
    """A free TCP port on localhost (the kernel's pick for port 0)."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(call: bytes, rank: int, world: int, port: int, device: str,
               timeout_s: float, queue) -> None:
    # the call and the result cross as plain pickles: the queue's own
    # pickler would hand tensors over in shared memory, which the parent
    # cannot open once this process has exited
    os.environ["LOCAL_RANK"] = str(rank)
    os.environ["LOCAL_WORLD_SIZE"] = str(world)
    try:
        fn, args = pickle.loads(call)
        initialize_distributed(f"localhost:{port}", world, rank, device, timeout_s)
        try:
            result = fn(create_mesh(MeshConfig(), device), *args)
        finally:
            dist.destroy_process_group()
        queue.put((rank, True, pickle.dumps(result)))
    except BaseException:  # reported to the parent, then the rank exits non-zero
        queue.put((rank, False, traceback.format_exc()))
        raise


def spawn_ranks(fn: Callable, world: int, *args, device="cuda",
                timeout_s: float = DEFAULT_TIMEOUT_S) -> list:
    """Run ``fn(mesh, *args)`` on ``world`` ranks, each a spawned process
    joined over ``tcp://localhost`` on a free port, on ``device``
    (``cuda``: nccl where each rank has a GPU, else gloo on the shared
    ones; ``cpu``: gloo, every rank on the one CPU). ``fn`` and ``args`` are pickled by
    import path. Returns the ranks' results in rank order; raises
    RuntimeError, with the rank's traceback, if any rank fails, and if
    the ranks are not done within ``timeout_s`` (each is then killed)."""
    import multiprocessing as mp
    import queue as queue_lib

    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    port = free_port()
    call = pickle.dumps((fn, args))
    procs = [ctx.Process(target=_rank_main, args=(call, r, world, port, str(device), timeout_s, q))
             for r in range(world)]
    for p in procs:
        p.start()
    results, failed = {}, []
    deadline = time.monotonic() + timeout_s
    try:
        # drain the queue before joining: a child blocks on a full pipe
        while len(results) < world and not failed:
            try:
                rank, ok, value = q.get(timeout=1.0)
            except queue_lib.Empty:
                dead = [r for r, p in enumerate(procs) if p.exitcode not in (None, 0)]
                if dead and q.empty():
                    failed.append(f"ranks {dead} died without a result")
                elif time.monotonic() > deadline:
                    failed.append(f"no result within {timeout_s} s")
                continue
            if ok:
                results[rank] = pickle.loads(value)
            else:
                failed.append(f"rank {rank}:\n{value}")
    finally:
        for p in procs:
            p.join(timeout=5 if failed else timeout_s)
            if p.is_alive():
                p.kill()
                p.join()
    if failed:
        raise RuntimeError("a rank failed: " + "\n".join(failed))
    bad = [r for r, p in enumerate(procs) if p.exitcode != 0]
    if bad:
        raise RuntimeError(f"ranks {bad} exited with codes "
                           f"{[procs[r].exitcode for r in bad]}")
    return [results[r] for r in range(world)]
