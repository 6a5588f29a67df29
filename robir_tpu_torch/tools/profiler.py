"""Profiling hooks: a ``torch.profiler`` trace, the program's spans and
counters on its clock, and chained-step timing (counterpart of
``robir_tpu/tools/profiler.py``).

- ``trace(log_dir)``: a ``torch.profiler`` capture of the enclosed block,
  written as a Chrome trace ``<log_dir>/<time>_<pid>.pt.trace.json``.
- ``span(name)``: a phase of the program. While a ``torch.profiler`` runs
  it is a ``record_function`` (a ``user_annotation`` event of the trace,
  on the calling thread, on the device events' clock); otherwise a shared
  no-op context, behind one check of the profiler's state.
- ``count(name, n)``, ``count_log(name)`` and ``counts(start_us,
  end_us)``: while a profiler runs, ``count`` logs ``n`` of ``name`` at
  ``time.time_ns()`` in a bounded log; ``count_log`` lists a name's
  entries; ``counts`` sums the log's entries in a window of the trace's
  microseconds (an event's ``ts`` plus the trace's
  ``baseTimeNanoseconds`` / 1e3: the same clock). Without a profiler,
  ``count`` is the same one check.
- ``summarize_trace(trace_dir)``: the device time of the newest trace under
  ``trace_dir``, by category (``kernel``, ``memcpy``, ``memset``) and by
  kernel name, with the JAX function's keys, and beside them the count of
  device events by category and by name and of the host's launches that
  have no device event. A trace of the CPU alone has no device events,
  and sums to 0.
- ``time_scanned_reps(step_fn, init_carry)``: seconds a step of
  ``n_steps`` chained ``carry -> carry`` steps, after one warmup chain, for
  each of ``reps`` runs; each run is timed with CUDA events on the card, or
  with the host clock on the CPU (``device="cpu"``).

Every function runs on ``cuda`` unless ``device="cpu"`` is passed, and
raises without a card: the CUDA timers never time on the host in its place.
``NeusTrainer.throughput`` and ``tools/vis_workload.py`` time their steps
with ``time_scanned_reps``; ``chip_smoke.py --profile`` traces with
``trace`` and reads ``summarize_trace``. The spans and the counter, where
the train loops put them, and their readers: ``PERF.md`` section 3.
"""

from __future__ import annotations

import collections
import contextlib
import glob
import gzip
import json
import os
import re
import time
from typing import Any, Callable

import torch

from .. import resolve_device

# torch.profiler's Chrome-trace categories of device work, by the name the
# summary gives them
DEVICE_CATEGORIES = {"kernel": "kernel", "gpu_memcpy": "memcpy", "gpu_memset": "memset"}

# whether a profiler records: 0.3 us a call, against 17 us for a bare
# record_function with none running
_profiling = torch._C._autograd._profiler_enabled
_NO_SPAN = contextlib.nullcontext()
# (time.time_ns(), name, n) of each count made while a profiler ran
_COUNTS: collections.deque = collections.deque(maxlen=1 << 16)


def span(name: str):
    """A context naming a phase of the program in a running profiler's
    trace (``record_function``); a shared no-op context without one."""
    if not _profiling():
        return _NO_SPAN
    return torch.profiler.record_function(name)


def count(name: str, n: int) -> None:
    """Log ``n`` (a host number: reading it must not wait for the device)
    of ``name`` now, if a profiler runs."""
    if _profiling():
        _COUNTS.append((time.time_ns(), name, n))


def count_log(name: str) -> list[tuple[int, int]]:
    """(time.time_ns(), n) of each count of ``name`` in the log, oldest
    first."""
    return [(t, n) for t, logged, n in list(_COUNTS) if logged == name]


def counts(start_us: float, end_us: float) -> dict[str, int]:
    """{name: sum of n} of the counts logged in [``start_us``,
    ``end_us``], microseconds on the trace's clock (an event's ``ts`` plus
    the trace's ``baseTimeNanoseconds`` / 1e3)."""
    lo, hi = start_us * 1e3, end_us * 1e3
    out: collections.Counter = collections.Counter()
    for t, name, n in list(_COUNTS):
        if lo <= t <= hi:
            out[name] += n
    return dict(out)


@contextlib.contextmanager
def trace(log_dir: str, device="cuda"):
    """Profile the enclosed block (the host, and the card's kernels unless
    ``device="cpu"``) and write its Chrome trace under ``log_dir``."""
    from torch.profiler import ProfilerActivity, profile

    cuda = resolve_device(device).type == "cuda"
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        try:
            yield
        finally:
            if cuda:
                torch.cuda.synchronize()
    stamp = time.strftime("%Y%m%d_%H%M%S")
    prof.export_chrome_trace(os.path.join(log_dir, f"{stamp}_{os.getpid()}.pt.trace.json"))


def _newest_trace(trace_dir: str) -> str:
    paths = [p for pattern in ("*.trace.json", "*.trace.json.gz")
             for p in glob.glob(os.path.join(trace_dir, "**", pattern), recursive=True)]
    if not paths:
        raise FileNotFoundError(f"no *.trace.json under {trace_dir}")
    return max(paths, key=os.path.getmtime)


def summarize_trace(trace_dir: str, top_ops: int = 10) -> dict:
    """``{"total_ms", "categories": {category: ms}, "top_ops": [(name, ms),
    ...], "counts": {"categories": {category: n}, "ops": {name: n},
    "lost": n, "lost_at_start": n}}`` over the device events (complete
    events of category kernel, memcpy or memset) of the newest
    ``*.trace.json`` (or ``.gz``) under ``trace_dir``; ``top_ops`` names
    sum the events of one name, and ``counts`` counts the events of every
    category and name. Of the host's kernel launches, copies and sets
    whose correlation id no device event carries, ``lost_at_start``
    counts those made before the first launch that has one, and ``lost``
    the rest: on an H100 with torch 2.11 a trace dropped the device events
    of its first 2-15 launches, never a later one."""
    path = _newest_trace(trace_dir)
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as fp:
        events = json.load(fp)["traceEvents"]
    cats: collections.Counter = collections.Counter()
    ops: collections.Counter = collections.Counter()
    n_cats: collections.Counter = collections.Counter()
    n_ops: collections.Counter = collections.Counter()
    device = {e.get("args", {}).get("correlation") for e in events
              if e.get("ph") == "X" and e.get("cat") in DEVICE_CATEGORIES}
    launches = [e["args"]["correlation"] for e in events if e.get("ph") == "X"
                and e.get("cat") in ("cuda_runtime", "cuda_driver")
                and re.search(r"LaunchKernel|Memcpy|Memset", e.get("name", ""))
                and "correlation" in e.get("args", {})]
    first = min((c for c in launches if c in device), default=float("inf"))
    unanswered = [c > first for c in launches if c not in device]
    for e in events:
        cat = DEVICE_CATEGORIES.get(e.get("cat"))
        if e.get("ph") != "X" or cat is None:
            continue
        dur, name = float(e.get("dur", 0.0)), e.get("name", "")
        cats[cat] += dur
        ops[name] += dur
        n_cats[cat] += 1
        n_ops[name] += 1
    return {"total_ms": sum(cats.values()) / 1e3,
            "categories": {k: v / 1e3 for k, v in cats.most_common()},
            "top_ops": [(k, v / 1e3) for k, v in ops.most_common(top_ops)],
            "counts": {"categories": dict(n_cats.most_common()),
                       "ops": dict(n_ops.most_common()), "lost": sum(unanswered),
                       "lost_at_start": len(unanswered) - sum(unanswered)}}


def time_scanned_reps(step_fn: Callable[[Any], Any], init_carry, n_steps: int = 20,
                      reps: int = 4, device="cuda",
                      warmup: int | None = None) -> list[float]:
    """Seconds a step for each of ``reps`` runs of ``n_steps`` chained
    ``carry = step_fn(carry)`` from ``init_carry``, after one warmup chain
    of ``warmup`` steps (default ``n_steps``); on the card from a CUDA event
    before the chain to one after it, on the CPU by the host clock. Every
    run is returned, so that a caller can record the spread."""
    cuda = resolve_device(device).type == "cuda"

    def chain(k: int) -> float:
        carry = init_carry
        if cuda:
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
        t0 = time.perf_counter()
        for _ in range(k):
            carry = step_fn(carry)
        if cuda:
            end.record()
            end.synchronize()
            return start.elapsed_time(end) / 1e3
        return time.perf_counter() - t0

    chain(max(1, n_steps if warmup is None else warmup))
    return [chain(n_steps) / n_steps for _ in range(reps)]

