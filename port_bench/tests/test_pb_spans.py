"""The program's spans and counter in a hand-made trace: device time by the
span its launch was made in (on the step thread or autograd's), idle gaps
by span, host time in a span, the counter's counts paired with compaction's
spans, and the four readers of them; each reader reads nothing where its
span or counter is absent, as in a trace of a program without them."""

import collections
import gzip
import json

import pytest
import torch

from port_bench import manifest, spans
from port_bench.spans import SpanTrace
from port_bench.tests.test_pb_trace import EVENTS
from port_bench.trace import STEP, Trace
from robir_tpu_torch.tools import profiler


def ev(cat, name, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid, "pid": 1}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def span(name, ts, dur):
    return ev("user_annotation", name, ts, dur)


def launch(name, ts, corr, tid=1):
    return ev("cuda_runtime", name, ts, 2, tid, corr)


EVENTS_SPANS = [
    # two steps, [100, 200) and [200, 320), each: batch, forward holding
    # compact.wait and sg.diffuse_sweep, backward, update
    span(STEP, 100, 100), span(STEP, 200, 120), span("compact.wait", 40, 5),
    span("batch", 100, 10), span("forward", 110, 60), span("compact.wait", 120, 10),
    span("sg.diffuse_sweep", 140, 20), span("backward", 170, 20), span("update", 190, 8),
    span("batch", 200, 15), span("forward", 215, 85), span("compact.wait", 220, 20),
    span("sg.diffuse_sweep", 250, 30), span("backward", 300, 10), span("update", 310, 8),
    # launches: on the step thread (1) and autograd's (3), one before the window
    launch("cudaLaunchKernel", 112, 1), launch("cudaLaunchKernel", 145, 2),
    launch("cudaLaunchKernel", 175, 3, tid=3), launch("cudaMemcpyAsync", 192, 4),
    launch("cuLaunchKernel", 255, 5), launch("cudaLaunchKernelExC", 305, 6, tid=3),
    launch("cudaLaunchKernel", 50, 7),
    # the device: each launch's event, and one whose launch the trace lacks
    ev("kernel", "fwd_kernel", 113, 12, tid=7, corr=1),
    ev("kernel", "elementwise_kernel", 146, 4, tid=7, corr=2),
    ev("kernel", "bwd_kernel", 176, 10, tid=7, corr=3),
    ev("gpu_memcpy", "Memcpy DtoH", 193, 2, tid=7, corr=4),
    ev("kernel", "elementwise_kernel", 256, 10, tid=7, corr=5),
    ev("kernel", "bwd_kernel", 306, 10, tid=7, corr=6),
    ev("kernel", "early_kernel", 60, 10, tid=7, corr=7),
    ev("kernel", "lost_kernel", 290, 2, tid=7, corr=99),
]
BASE_NS = 10 ** 18


class Ctx:
    def __init__(self, trace):
        self.trace = trace


def read(name, trace):
    return manifest.metric_module(name).read(Ctx(trace))


@pytest.fixture
def trace():
    return Trace(EVENTS_SPANS)


def test_device_time_goes_to_the_span_open_at_its_launch():
    # autograd's launches (thread 3) at 175 and 305 fall in backward; the
    # copy at 192 in update; the event before the window is left out
    assert SpanTrace(EVENTS_SPANS).device_us_by_span() == {
        "forward": 12, "sg.diffuse_sweep": 4 + 10, "backward": 10 + 10, "update": 2, None: 2}


def test_idle_gaps_by_span(trace):
    # gaps (middle): [100, 113) (106.5) batch; [125, 146) (135.5) and
    # [150, 176) (163) forward; [186, 193) (189.5) backward; [195, 256)
    # (225.5) compact.wait; [266, 290) (278) sg.diffuse_sweep; [292, 306)
    # (299) forward; [316, 320) (318) no span
    assert SpanTrace(EVENTS_SPANS).idle_us_by_span() == {
        "batch": 13, "forward": 21 + 26 + 14, "backward": 7, "compact.wait": 61,
        "sg.diffuse_sweep": 24, None: 4}
    # forward holds the gaps of the spans inside it too
    assert spans.idle_us(trace, "forward") == 21 + 26 + 61 + 24 + 14
    assert spans.idle_us(trace, "update") == 0


def test_host_time_in_a_span(trace):
    """In the window only: the ``compact.wait`` span before it counts for
    nothing; the ``Trace`` that ``run.py`` loads holds the spans as host
    events of the step thread, as ``SpanTrace`` keeps them."""
    assert spans.host_us(trace, "batch") == 25
    assert spans.host_us(trace, "compact.wait") == 30
    assert [(s, e) for s, e, n in SpanTrace(EVENTS_SPANS).spans if n == "compact.wait"] \
        == spans.spans(trace, "compact.wait")


def test_counts_pair_with_compactions_spans(trace):
    """The last count goes with the last ``compact.wait`` span: the log's
    older counts (an earlier trace's) and the counts of the spans before the
    window are left out."""
    assert spans.rows_in_window(trace, [7, 1000, 40, 60]) == 100
    assert spans.rows_in_window(trace, [40, 60]) == 100
    assert spans.rows_in_window(trace, []) is None
    assert spans.rows_in_window(Trace(EVENTS), [40, 60]) is None


def test_the_four_readers(trace, monkeypatch):
    # counts after the span before the window and after the two in it, an
    # older one and another counter's
    monkeypatch.setattr(profiler, "_COUNTS", collections.deque([
        (BASE_NS, "compact.rows", 7), (BASE_NS + 46_000, "compact.rows", 1000),
        (BASE_NS + 131_000, "compact.rows", 40), (BASE_NS + 241_000, "compact.rows", 60),
        (BASE_NS + 241_000, "other", 5)]))
    assert read("batch_ms_per_step", trace) == pytest.approx(25 / 2 / 1e3)
    assert read("forward_idle_ms_per_step", trace) == pytest.approx(146 / 2 / 1e3)
    assert read("compact_wait_ms_per_step", trace) == pytest.approx(30 / 2 / 1e3)
    assert read("surface_rows_per_step", trace) == pytest.approx(50)


NEW = ("batch_ms_per_step", "forward_idle_ms_per_step", "compact_wait_ms_per_step",
       "surface_rows_per_step")


def test_readers_read_nothing_without_their_spans(monkeypatch):
    """A program without the spans and the counter: every new reader reads
    None; the row reader also where the program has no ``count_log``."""
    tr = Trace(EVENTS)
    assert all(read(name, tr) is None for name in NEW)
    monkeypatch.setattr(profiler, "_COUNTS", collections.deque())
    assert read("surface_rows_per_step", Trace(EVENTS_SPANS)) is None
    monkeypatch.setattr(profiler, "_COUNTS", collections.deque([(BASE_NS, "compact.rows", 4)]))
    assert read("surface_rows_per_step", Trace(EVENTS_SPANS)) is not None
    monkeypatch.delattr(profiler, "count_log")
    assert read("surface_rows_per_step", Trace(EVENTS_SPANS)) is None


@pytest.mark.parametrize("gz", [False, True])
def test_load_keeps_the_base_time(tmp_path, gz):
    path = str(tmp_path / ("t.json.gz" if gz else "t.json"))
    with (gzip.open if gz else open)(path, "wt") as fp:
        json.dump({"schemaVersion": 1, "baseTimeNanoseconds": BASE_NS,
                   "traceEvents": EVENTS_SPANS}, fp)
    tr = SpanTrace.load(path)
    assert tr.base_ns == BASE_NS and tr.window == (100, 320)
    assert tr.device_us_by_span() == SpanTrace(EVENTS_SPANS).device_us_by_span()
    assert SpanTrace(EVENTS_SPANS).base_ns is None


@pytest.mark.parametrize("cell, names", [("tiny.train", NEW[:2]), ("tinyhd.pbr", NEW)])
def test_a_traced_run_reads_the_spans(tiny_root, capsys, cell, names):
    """A traced run of a tiny cell on the CPU prints the new metrics whose
    spans its stage has."""
    from port_bench.tests.test_pb_run import run_cell

    out = run_cell(tiny_root, cell, capsys, trace=1)
    assert out["correct"]
    assert set(NEW) & set(out["metrics"]) == set(names)


def test_phases_of_a_tiny_pbr_cell(tiny_root, capsys):
    """``phases.py`` on the CPU: the step's phases, each count just past its
    compaction's wait, and the counter's rows a step equal to the
    reference's surface rows of the traced steps."""
    from port_bench import phases
    from port_bench.tests.test_pb_run import SEED

    assert phases.main(["--workload", "tinyhd.pbr", "--seed", SEED], device=torch.device("cpu"),
                       root=tiny_root) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert {"batch", "forward", "compact.wait", "stage2.shade", "sg.diffuse_sweep",
            "backward", "update"} <= set(out["phases"])
    assert out["phases"]["forward"]["host_ms"] > out["phases"]["stage2.shade"]["host_ms"] > 0
    assert out["clock"]["counts"] == out["steps"] == 3
    assert 0 <= out["clock"]["lag_us_min"] <= out["clock"]["lag_us_max"] < 1e4
    assert out["clock"]["rows_per_step"] == out["metrics"]["surface_rows_per_step"]
    assert out["metrics"]["surface_rows_per_step"] == pytest.approx(
        out["reference_rows_per_step"])
