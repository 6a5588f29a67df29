"""Reading a ``torch.profiler`` Chrome trace: device intervals, idle gaps,
host spans.

Device events are the complete events of category ``kernel``,
``gpu_memcpy`` and ``gpu_memset`` (as ``robir_tpu_torch/tools/profiler.py``
sums them); busy time is the length of their union, so overlapping events
on several streams count once. The traced window is given by the
harness's step spans (``user_annotation`` events named ``STEP``); the
profiler drops the device events of a trace's first few launches, so the
window opens a few steps after the profiler starts.
"""

from __future__ import annotations

import collections
import gzip
import heapq
import json

STEP = "port_bench.step"
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATEGORIES = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation")
# host calls that wait for the device
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
              "cudaMemcpy", "cudaMemcpyAsync", "cuStreamSynchronize", "cuCtxSynchronize")


class Trace:
    def __init__(self, events: list[dict]):
        complete = [e for e in events if e.get("ph") == "X" and "dur" in e]
        self.device = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
                             for e in complete if e.get("cat") in DEVICE_CATEGORIES)
        steps = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["tid"])
                       for e in complete
                       if e.get("cat") == "user_annotation" and e.get("name") == STEP)
        self.steps = [(s, t) for s, t, _ in steps]
        tid = steps[0][2] if steps else None
        self.host = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
                           for e in complete if e.get("tid") == tid
                           and e.get("cat") in HOST_CATEGORIES and e.get("name") != STEP)

    @classmethod
    def load(cls, path: str) -> "Trace":
        opener = gzip.open if path.endswith(".gz") else open
        with opener(path, "rt") as fp:
            return cls(json.load(fp)["traceEvents"])

    @property
    def window(self) -> tuple[float, float]:
        """(start, end) in microseconds: the first traced step's start to
        the last one's end."""
        if not self.steps:
            raise ValueError("the trace holds no step span")
        return self.steps[0][0], self.steps[-1][1]

    def busy_intervals(self) -> list[tuple[float, float]]:
        """The union of the device events, clipped to the window, as
        disjoint sorted intervals."""
        lo, hi = self.window
        out: list[list[float]] = []
        for s, e, _ in self.device:
            s, e = max(s, lo), min(e, hi)
            if e <= s:
                continue
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return [(s, e) for s, e in out]

    def busy_us(self) -> float:
        return sum(e - s for s, e in self.busy_intervals())

    def window_us(self) -> float:
        lo, hi = self.window
        return hi - lo

    def idle_gaps(self) -> list[tuple[float, float]]:
        lo, hi = self.window
        edges = [lo] + [x for iv in self.busy_intervals() for x in iv] + [hi]
        return [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]

    def device_us(self, patterns: list[str] | None = None) -> float:
        """Device time in the window of the events whose name holds one of
        ``patterns`` (all events where None), summed as events, not as a
        union."""
        lo, hi = self.window
        return sum(min(e, hi) - max(s, lo) for s, e, name in self.device
                   if e > lo and s < hi
                   and (patterns is None or any(p in name for p in patterns)))

    def host_self_us(self) -> list[float]:
        """Each step span less the host's time inside it in calls that wait
        for the device."""
        out = []
        i = 0
        for s, e in self.steps:
            while i < len(self.host) and self.host[i][0] < s:
                i += 1
            wait, j = 0.0, i
            while j < len(self.host) and self.host[j][0] < e:
                hs, he, name = self.host[j]
                if name in SYNC_CALLS:
                    wait += min(he, e) - hs
                j += 1
            out.append((e - s) - wait)
        return out

    def top_device_ops(self, n: int = 10) -> list[list]:
        """The ``n`` device operations that took most time in the window,
        [[name, seconds], ...]."""
        lo, hi = self.window
        total: collections.Counter = collections.Counter()
        for s, e, name in self.device:
            if e > lo and s < hi:
                total[name] += min(e, hi) - max(s, lo)
        return [[name[:64], us / 1e6] for name, us in total.most_common(n)]

    def idle_by_host_op(self, n: int = 10) -> list[list]:
        """The idle time in the window by the host operation innermost at
        each gap's middle (``host_no_operation`` where none), [[name,
        seconds], ...] for the ``n`` largest."""
        total: collections.Counter = collections.Counter()
        gaps = sorted(self.idle_gaps(), key=lambda g: (g[0] + g[1]) / 2)
        active: list = []  # heap of (-start, end, name)
        i = 0
        for s, e in gaps:
            mid = (s + e) / 2
            while i < len(self.host) and self.host[i][0] <= mid:
                hs, he, name = self.host[i]
                heapq.heappush(active, (-hs, he, name))
                i += 1
            while active and active[0][1] <= mid:
                heapq.heappop(active)
            total[active[0][2] if active else "host_no_operation"] += e - s
        return [[name[:64], us / 1e6] for name, us in total.most_common(n)]
