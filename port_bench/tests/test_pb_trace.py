"""Busy and idle time, host self time and the breakdown from a hand-made
trace with overlapping device events."""

import pytest

from port_bench.trace import STEP, Trace


def ev(cat, name, ts, dur, tid=1):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid, "pid": 1}


EVENTS = [
    # two steps on the host thread: [100, 200) and [200, 320)
    ev("user_annotation", STEP, 100, 100), ev("user_annotation", STEP, 200, 120),
    ev("cpu_op", "aten::mm", 105, 30), ev("cuda_runtime", "cudaLaunchKernel", 110, 5),
    ev("cuda_runtime", "cudaStreamSynchronize", 150, 40),
    ev("cpu_op", "aten::add", 210, 90), ev("cuda_runtime", "cudaMemcpyAsync", 290, 20),
    # the device: a kernel before the window, two overlapping ones on two
    # streams, a copy, a kernel that runs past the window's end
    ev("kernel", "early_kernel", 50, 60, tid=7),
    ev("kernel", "vg_fwd_kernel<64>", 120, 40, tid=7),
    ev("kernel", "grid_march_kernel", 140, 40, tid=8),
    ev("gpu_memcpy", "Memcpy DtoH", 250, 10, tid=7),
    ev("kernel", "vg_bwd_rows_kernel<64>", 300, 50, tid=7),
    # another host thread's op is not the step's
    ev("cpu_op", "prefetch", 100, 300, tid=2),
]


@pytest.fixture
def trace():
    return Trace(EVENTS)


def test_window_and_busy_union(trace):
    assert trace.window == (100, 320)
    # [100, 110) of early_kernel, [120, 180) of the overlapping pair,
    # [250, 260) of the copy, [300, 320) of the last kernel
    assert trace.busy_intervals() == [(100, 110), (120, 180), (250, 260), (300, 320)]
    assert trace.busy_us() == 100
    assert trace.window_us() == 220


def test_idle_gaps_and_the_host_op_in_each(trace):
    assert trace.idle_gaps() == [(110, 120), (180, 250), (260, 300)]
    # gap middles: 115 in aten::mm (cudaLaunchKernel has ended), 215 in
    # aten::add, 280 in aten::add
    assert dict(trace.idle_by_host_op()) == pytest.approx(
        {"aten::mm": 10e-6, "aten::add": 110e-6})


def test_kernel_time_by_name(trace):
    assert trace.device_us(["vg_fwd_kernel", "vg_bwd_rows_kernel"]) == 40 + 20
    assert trace.device_us(["grid_march_kernel"]) == 40
    assert trace.device_us(["no_such_kernel"]) == 0
    assert trace.top_device_ops(1) == [["vg_fwd_kernel<64>", 40e-6]]


def test_host_self_time_leaves_out_device_waits(trace):
    # step 1: 100 less the 40 of the stream sync; step 2: 120 less the
    # 20 of the copy
    assert trace.host_self_us() == [60, 100]
