"""The program's spans (``robir_tpu_torch/tools/profiler.py:span``) and its
``compact.rows`` counter in a traced window.

A span is a ``user_annotation`` event on the step thread, so a ``Trace``
as ``run.py`` loads it holds it among ``Trace.host`` under its name; the
functions here read it from there by name: host time inside a span, the
idle gaps whose middle lies inside one, and the counter's rows of the
window. ``SpanTrace`` keeps besides what ``Trace`` drops (each device
event's correlation, the host calls that launched device work on any
thread, the trace's ``baseTimeNanoseconds``) and puts each device event in
the innermost span open on the step thread when its launch call started
(autograd's kernels go to the span open around ``backward``); ``phases.py``
reads a window by phase with it.
"""

from __future__ import annotations

import bisect
import collections
import gzip
import json

from port_bench.trace import DEVICE_CATEGORIES, STEP, Trace

# host calls that put work on the device, matched to its events by correlation
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx",
                "cudaMemcpyAsync", "cudaMemsetAsync")


def spans(trace: Trace, name: str) -> list[tuple[float, float]]:
    """(start, end) of the spans named ``name`` on the step thread, by start
    (spans of one name do not nest)."""
    return [(s, e) for s, e, n in trace.host if n == name]


def host_us(trace: Trace, name: str) -> float:
    """Host time in the window inside the spans named ``name``."""
    lo, hi = trace.window
    return sum(min(e, hi) - max(s, lo) for s, e in spans(trace, name) if e > lo and s < hi)


def idle_us(trace: Trace, name: str) -> float:
    """Idle time in the window of the gaps whose middle lies inside a span
    named ``name``, innermost or not."""
    opened = spans(trace, name)
    starts = [s for s, _ in opened]
    total = 0.0
    for s, e in trace.idle_gaps():
        i = bisect.bisect_right(starts, (s + e) / 2)
        # the last begun is the one open
        if i and (s + e) / 2 < opened[i - 1][1]:
            total += e - s
    return total


def rows_in_window(trace: Trace, rows: list[int]) -> int | None:
    """The rows of the ``compact.rows`` counts ``rows`` (the program's log,
    oldest first) made in the window: ``compact_apply`` counts once just
    after each ``compact.wait`` span closes, and the log and the trace end
    together, so the last count goes with the last span. None without
    either."""
    waits = spans(trace, "compact.wait")
    k = min(len(waits), len(rows))
    if not k:
        return None
    lo, hi = trace.window
    return sum(n for (s, e), n in zip(waits[len(waits) - k:], rows[len(rows) - k:])
               if s >= lo and e <= hi)


class SpanTrace(Trace):
    # the trace's baseTimeNanoseconds: an event's ts plus base_ns / 1e3 is
    # the host's time.time_ns() / 1e3 (None: not known)
    base_ns = None

    def __init__(self, events: list[dict]):
        super().__init__(events)
        complete = [e for e in events if e.get("ph") == "X" and "dur" in e]
        tids = [e["tid"] for e in complete
                if e.get("cat") == "user_annotation" and e.get("name") == STEP]
        tid = tids[0] if tids else None
        # (start, end, name, correlation) of each device event
        self.device_launched = sorted(
            (float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"],
             e.get("args", {}).get("correlation"))
            for e in complete if e.get("cat") in DEVICE_CATEGORIES)
        # {correlation: start} of the host calls that launched device work
        self.launch_start = {e["args"]["correlation"]: float(e["ts"]) for e in complete
                             if e.get("name") in LAUNCH_CALLS
                             and "correlation" in e.get("args", {})}
        # the program's spans on the step thread
        self.spans = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
                            for e in complete if e.get("tid") == tid
                            and e.get("cat") == "user_annotation" and e.get("name") != STEP)
        self._span_starts = [s for s, _, _ in self.spans]

    @classmethod
    def load(cls, path: str) -> "SpanTrace":
        opener = gzip.open if path.endswith(".gz") else open
        with opener(path, "rt") as fp:
            doc = json.load(fp)
        tr = cls(doc["traceEvents"])
        tr.base_ns = doc.get("baseTimeNanoseconds")
        return tr

    def _innermost(self, t: float) -> str | None:
        """The innermost span open at ``t``: of the spans begun by then, the
        last begun that has not ended (spans on one thread nest)."""
        i = bisect.bisect_right(self._span_starts, t)
        while i:
            i -= 1
            if t < self.spans[i][1]:
                return self.spans[i][2]
        return None

    def device_us_by_span(self) -> dict:
        """{span name: device time in the window of the events launched
        inside it, innermost span first}; None holds the events launched
        outside every span, or whose launch the trace lacks."""
        lo, hi = self.window
        total: collections.Counter = collections.Counter()
        for s, e, _, corr in self.device_launched:
            if e > lo and s < hi:
                t = self.launch_start.get(corr)
                total[None if t is None else self._innermost(t)] += min(e, hi) - max(s, lo)
        return dict(total)

    def idle_us_by_span(self) -> dict:
        """{span name: idle time in the window of the gaps whose middle lies
        inside it, innermost span first}; None outside every span."""
        total: collections.Counter = collections.Counter()
        for s, e in self.idle_gaps():
            total[self._innermost((s + e) / 2)] += e - s
        return dict(total)
