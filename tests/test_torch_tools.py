"""The port's profiler (``tools/profiler.py``) and the canonical Vis-step
workload (``tools/vis_workload.py``) on the CPU: the chained-step timer,
a trace written and summarised, the profiler's CUDA timers refusing to run
without a card; the workload's smoke build, deterministic, its batch and
record equal to the JAX package's ``build(smoke=True)`` (the same dataset
writer and seed), and one timed step that leaves the runner as it was.
"""

import gzip
import json
import os

import jax
import numpy as np
import pytest
import torch

from robir_tpu.tools import vis_workload as jvw
from robir_tpu_torch.core.params import to_numpy
from robir_tpu_torch.core.tree import flatten_with_paths
from robir_tpu_torch.tools import profiler
from robir_tpu_torch.tools import vis_workload as tvw


def test_time_scanned_chains_the_carry():
    """One warmup chain, then ``reps`` chains of ``n_steps`` from
    ``init_carry``; seconds a step for each."""
    calls = []

    def step(c):
        calls.append(c)
        torch.mm(torch.ones(64, 64), torch.ones(64, 64))
        return c + 1

    secs = profiler.time_scanned_reps(step, 10, n_steps=3, reps=2, device="cpu")
    assert len(secs) == 2 and all(s > 0 for s in secs)
    assert calls == [10, 11, 12] * 3
    calls.clear()
    profiler.time_scanned_reps(step, 0, n_steps=2, reps=1, device="cpu", warmup=1)
    assert calls == [0, 0, 1]


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present: the timers run")
def test_cuda_timers_raise_without_a_card(tmp_path):
    """The default device is the card, and without one the timers raise:
    they never time on the host in its place."""
    with pytest.raises(RuntimeError, match="CUDA"):
        profiler.time_scanned_reps(lambda c: c, 0, n_steps=1, reps=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        with profiler.trace(str(tmp_path)):
            pass


def test_summarize_trace_of_a_cpu_trace(tmp_path):
    """A trace of CPU work: written under ``log_dir`` as a Chrome trace,
    read back with JAX's keys; it has no device events, so 0 ms."""
    with profiler.trace(str(tmp_path / "t"), device="cpu"):
        torch.mm(torch.randn(128, 128), torch.randn(128, 128)).sum()
    files = os.listdir(tmp_path / "t")
    assert len(files) == 1 and files[0].endswith(".pt.trace.json")
    with open(tmp_path / "t" / files[0]) as fp:
        assert any(e.get("cat") == "cpu_op" for e in json.load(fp)["traceEvents"])
    summary = profiler.summarize_trace(str(tmp_path / "t"))
    assert summary == {"total_ms": 0.0, "categories": {}, "top_ops": [],
                       "counts": {"categories": {}, "ops": {}, "lost": 0, "lost_at_start": 0}}
    with pytest.raises(FileNotFoundError):
        profiler.summarize_trace(str(tmp_path / "empty"))


def test_summarize_trace_sums_device_events(tmp_path):
    """On a trace with device events (the categories torch.profiler gives
    the card's kernels, copies and sets), the newest file of the directory
    is read, gzipped or not: the sums by category and by name, in ms, and
    the count of events by category and by name, and of the host's
    launches, copies and sets that no device event answers: before the
    first launch that has one (correlations 1 and 2) and after it (8)."""
    def ev(name, cat, dur, ph="X", corr=None):
        return {"name": name, "cat": cat, "ph": ph, "dur": dur, "ts": 0, "pid": 0, "tid": 7,
                "args": {} if corr is None else {"correlation": corr}}

    old = {"traceEvents": [ev("old_kernel", "kernel", 5000.0)]}
    new = {"traceEvents": [
        ev("fused_mlp_fwd_kernel", "kernel", 300.0, corr=3),
        ev("fused_mlp_fwd_kernel", "kernel", 200.0, corr=4),
        ev("vg_fwd_kernel", "kernel", 250.0, corr=5), ev("Memcpy HtoD", "gpu_memcpy", 40.0, corr=6),
        ev("Memset", "gpu_memset", 10.0, corr=7), ev("aten::mm", "cpu_op", 9000.0),
        ev("cudaLaunchKernel", "cuda_runtime", 800.0, corr=3),
        ev("cuLaunchKernel", "cuda_driver", 5.0, corr=4),
        ev("cudaLaunchKernelExC", "cuda_runtime", 5.0, corr=5),
        ev("cudaMemcpyAsync", "cuda_runtime", 5.0, corr=6),
        ev("cudaMemsetAsync", "cuda_runtime", 5.0, corr=7),
        ev("cudaLaunchKernel", "cuda_runtime", 5.0, corr=8),
        ev("cudaLaunchKernel", "cuda_runtime", 5.0, corr=1),
        ev("cudaMemcpyAsync", "cuda_runtime", 5.0, corr=2),
        ev("cudaStreamSynchronize", "cuda_runtime", 5.0, corr=9), ev("flow", "kernel", 1.0, ph="s")]}
    with open(tmp_path / "a.pt.trace.json", "w") as fp:
        json.dump(old, fp)
    os.utime(tmp_path / "a.pt.trace.json", (1, 1))
    with gzip.open(tmp_path / "b.pt.trace.json.gz", "wt") as fp:
        json.dump(new, fp)
    got = profiler.summarize_trace(str(tmp_path), top_ops=2)
    assert got["total_ms"] == pytest.approx(0.8)
    assert got["categories"] == pytest.approx({"kernel": 0.75, "memcpy": 0.04, "memset": 0.01})
    assert list(got["categories"]) == ["kernel", "memcpy", "memset"]
    assert [n for n, _ in got["top_ops"]] == ["fused_mlp_fwd_kernel", "vg_fwd_kernel"]
    assert got["top_ops"][0][1] == pytest.approx(0.5)
    assert got["counts"] == {"categories": {"kernel": 3, "memcpy": 1, "memset": 1},
                             "ops": {"fused_mlp_fwd_kernel": 2, "vg_fwd_kernel": 1,
                                     "Memcpy HtoD": 1, "Memset": 1},
                             "lost": 1, "lost_at_start": 2}


@pytest.fixture(scope="module")
def smoke():
    return tvw.build(smoke=True, device="cpu")


def test_vis_workload_build_matches_jax(smoke):
    """The smoke build: 64 pixels x 32 directions on a 48^3 grid; the batch
    (points, dirs, object mask, hdr shift) and the record equal to the JAX
    package's ``build(smoke=True)``, and the same again on a second build."""
    runner, batch, carry, info = smoke
    _, jbatch, _, jinfo = jvw.build(smoke=True)
    assert info == jinfo
    assert info["vis_step_px"] == 64 and info["vis_step_nsamp"] == 32
    assert 0.0 < info["vis_step_object_frac"] < 1.0
    assert runner.cfg.grid.resolution == 48 and runner.grid_values.shape == (48,) * 3
    assert isinstance(carry, torch.Generator)
    for k, v in jbatch.items():
        np.testing.assert_array_equal(batch[k].numpy(), np.asarray(jax.device_get(v)), err_msg=k)
    _, again, _, info2 = tvw.build(smoke=True, device="cpu")
    assert info2 == info
    assert all(torch.equal(again[k], batch[k]) for k in batch)


def test_vis_workload_constants(smoke):
    """The workload's constants are the JAX module's, and the runner is at
    configs/hotdog.json's model (the bf16 grid, the 4 x 256 visibility
    net)."""
    cfg = smoke[0].cfg
    for name in ("NUM_PIXELS", "NSAMP", "BATCH_SEED", "DATASET", "CAMERA_IDX"):
        assert getattr(tvw, name) == getattr(jvw, name), name
    assert cfg.grid.storage_dtype == "bfloat16"
    assert cfg.visnet.dims == (256, 256, 256, 256)


def _opt_state(opt: torch.optim.Optimizer) -> list:
    """Every entry of an optimizer's state, tensors cloned, in order."""
    sd = opt.state_dict()
    return [(i, k, v.clone() if torch.is_tensor(v) else v)
            for i in sorted(sd["state"]) for k, v in sorted(sd["state"][i].items())]


def _same(a: list, b: list) -> bool:
    return len(a) == len(b) and all(
        (x[0], x[1]) == (y[0], y[1]) and (torch.equal(x[2], y[2]) if torch.is_tensor(x[2])
                                          else x[2] == y[2]) for x, y in zip(a, b))


def test_vis_workload_time_step(smoke):
    """One timed step: one rep's ms a step, and afterwards the runner's
    parameters, every tensor of both optimizers' state (moments and step
    counts, taken after one step so that they are not empty) and its step
    as they were."""
    runner, batch, carry, _ = smoke
    runner.run(1)
    before = flatten_with_paths(to_numpy(runner.params))
    vis, illum = _opt_state(runner.vis_opt), _opt_state(runner.illum_opt)
    assert vis and illum
    groups = (runner.vis_opt.state_dict()["param_groups"],
              runner.illum_opt.state_dict()["param_groups"])
    it = runner.cur_iter
    reps = tvw.time_step(runner, batch, carry, n_steps=1, reps=1)
    assert len(reps) == 1 and reps[0] > 0
    after = flatten_with_paths(to_numpy(runner.params))
    assert all(np.array_equal(before[k], after[k]) for k in before)
    assert runner.cur_iter == it
    assert _same(_opt_state(runner.vis_opt), vis)
    assert _same(_opt_state(runner.illum_opt), illum)
    assert (runner.vis_opt.state_dict()["param_groups"],
            runner.illum_opt.state_dict()["param_groups"]) == groups
