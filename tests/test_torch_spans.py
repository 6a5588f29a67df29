"""The port's spans and counters (``tools/profiler.py``: ``span``, ``count``,
``counts``) on the CPU: nothing recorded without a profiler; nested spans
in the trace; a count on the trace's clock; compaction's row counter; and
the phases a stage-1 step and a compacted PBR step name, once each and
nested as the train loops put them, with the rows whose K3 state each
step kept (``vg.saved_rows``).
"""

import json
import os
import time

import numpy as np
import torch

from robir_tpu_torch.core.compact import compact_apply
from robir_tpu_torch.data.syn_dataset import shadow_scene
from robir_tpu_torch.data.synthetic import make_sphere_scene
from robir_tpu_torch.fields.neus_model import NeuSConfig
from robir_tpu_torch.fields.radiance import RenderingConfig
from robir_tpu_torch.fields.sdf import SDFConfig
from robir_tpu_torch.render.neus import NeusRenderConfig
from robir_tpu_torch.stages import neus_stage as tneus
from robir_tpu_torch.stages import pbr as tpbr
from robir_tpu_torch.stages import stage2_runner as trunner
from robir_tpu_torch.tools import profiler
from test_torch_cesr import TCFG_GRID
from torch_port_helpers import two_sphere_grid


def traced(tmp_path, fn):
    """(the trace's JSON, fn's result) of ``fn()`` under ``profiler.trace``
    on the CPU."""
    with profiler.trace(str(tmp_path), device="cpu"):
        out = fn()
    (name,) = os.listdir(tmp_path)
    with open(tmp_path / name) as fp:
        return json.load(fp), out


def annotations(trace: dict) -> list[tuple[str, float, float]]:
    """(name, start, end) of the trace's ``user_annotation`` events."""
    return sorted(((e["name"], e["ts"], e["ts"] + e["dur"]) for e in trace["traceEvents"]
                   if e.get("ph") == "X" and e.get("cat") == "user_annotation"),
                  key=lambda x: x[1])


def inside(inner, outer) -> bool:
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def test_without_a_profiler_nothing_is_recorded():
    """No profiler: ``span`` is one shared no-op context whatever its name,
    and ``count`` leaves the log as it was."""
    assert not torch._C._autograd._profiler_enabled()
    before = list(profiler._COUNTS)
    with profiler.span("a") as a, profiler.span("b") as b:
        profiler.count("test.rows", 5)
    assert a is None and b is None
    assert profiler.span("a") is profiler.span("b")
    assert list(profiler._COUNTS) == before


def test_nested_spans_are_user_annotations(tmp_path):
    """Under a profiler, spans are ``user_annotation`` events of the trace
    on the calling thread, nested as they were opened."""
    def work():
        with profiler.span("outer"):
            with profiler.span("inner"):
                torch.ones(64).sum()
            with profiler.span("second"):
                torch.ones(64).sum()

    trace, _ = traced(tmp_path, work)
    got = {n: (n, s, e) for n, s, e in annotations(trace)}
    assert set(got) == {"outer", "inner", "second"}
    assert inside(got["inner"], got["outer"]) and inside(got["second"], got["outer"])
    assert got["inner"][2] <= got["second"][1]
    tids = {e["tid"] for e in trace["traceEvents"] if e.get("cat") == "user_annotation"}
    assert len(tids) == 1


def test_a_count_lands_on_the_trace_clock(tmp_path):
    """A count made inside a span falls inside that span's [ts, ts + dur]
    once mapped through the trace's ``baseTimeNanoseconds``, and ``counts``
    over that window in the trace's microseconds sums it."""
    def work():
        with profiler.span("clocked"):
            time.sleep(0.002)
            profiler.count("test.clock", 7)
            time.sleep(0.002)
        return profiler._COUNTS[-1]

    trace, (t_ns, name, n) = traced(tmp_path, work)
    assert (name, n) == ("test.clock", 7)
    base = trace["baseTimeNanoseconds"]
    (_, start, end), = [a for a in annotations(trace) if a[0] == "clocked"]
    assert round(start * 1e3) + base <= t_ns <= round(end * 1e3) + base
    assert profiler.counts(start + base / 1e3, end + base / 1e3) == {"test.clock": 7}
    assert profiler.counts(end + base / 1e3 + 1, end + base / 1e3 + 2) == {}


def test_compaction_counts_its_rows():
    """``compact_apply``'s ``compact.rows`` is the number of needed rows,
    logged while a profiler runs (the last of ``count_log``), and nothing
    while none does."""
    need = torch.rand(200, generator=torch.Generator().manual_seed(3)) > 0.6
    x = torch.randn(200, 3)

    def run():
        t0 = time.time_ns()
        out = compact_apply(lambda a: {"y": a * 2}, need, [x])
        return out, profiler.counts(t0 / 1e3, time.time_ns() / 1e3)

    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        out, got = run()
    assert got == {"compact.rows": int(need.sum())}
    assert profiler.count_log("compact.rows")[-1][1] == int(need.sum())
    torch.testing.assert_close(out["y"], torch.where(need[:, None], x * 2, 0.0))
    assert run()[1] == {}


def assert_once_each(trace: dict, names) -> dict:
    spans = [a for a in annotations(trace) if a[0] in names]
    assert sorted(n for n, _, _ in spans) == sorted(names)
    return {n: (n, s, e) for n, s, e in spans}


def assert_loop_order(got: dict) -> None:
    """batch, forward, backward and update follow one another."""
    order = [got[n] for n in ("batch", "forward", "backward", "update")]
    assert all(a[2] <= b[1] for a, b in zip(order, order[1:]))


def test_a_stage1_step_names_its_phases(tmp_path):
    """One ``NeusTrainer.run(1)``: ``batch``, ``forward`` holding
    ``neus.sample`` then ``neus.shade``, ``backward``, ``update``; K3's
    forward kept its state for K4 at the step's shaded rows (16 rays x 16
    samples), once (``vg.saved_rows``)."""
    cfg = NeuSConfig(sdf=SDFConfig(d_out=33, d_hidden=32, n_layers=3, skip_in=(2,),
                                   multires=3),
                     color=RenderingConfig(d_feature=32, d_hidden=32, n_layers=2))
    trainer = tneus.NeusTrainer(make_sphere_scene("train", n_train=2, h=8, w=8), cfg,
                                NeusRenderConfig(n_samples=8, n_importance=8,
                                                 up_sample_steps=2),
                                tneus.NeusTrainConfig(batch_size=16), seed=1, device="cpu")
    before = len(profiler.count_log("vg.saved_rows"))
    try:
        trace, metrics = traced(tmp_path, lambda: trainer.run(1))
    finally:
        trainer.close()
    assert np.isfinite(metrics["loss"])
    assert [n for _, n in profiler.count_log("vg.saved_rows")[before:]] == [16 * 16]
    got = assert_once_each(trace, ("batch", "forward", "neus.sample", "neus.shade",
                                   "backward", "update"))
    assert_loop_order(got)
    assert inside(got["neus.sample"], got["forward"]) and inside(got["neus.shade"],
                                                                 got["forward"])
    assert got["neus.sample"][2] <= got["neus.shade"][1]


def test_a_compacted_pbr_step_names_its_phases(tmp_path):
    """One ``PBRRunner.run(1)`` at 24 pixels, compacted at 8: ``batch``,
    ``forward`` holding ``compact.wait`` then ``stage2.shade``, which holds
    ``sg.diffuse_sweep``, then ``backward`` and ``update``: once each. The
    frozen NeuS's K3 keeps no state (``vg.saved_rows`` counts nothing)."""
    params = trunner.init_stage2_params(torch.Generator().manual_seed(1), TCFG_GRID)
    runner = tpbr.PBRRunner(TCFG_GRID, params, shadow_scene(n_train=3, h=40, w=40),
                            tpbr.PBRStageConfig(num_pixels=24, compact_chunk=8), seed=2,
                            device="cpu")
    runner.grid_values = two_sphere_grid(TCFG_GRID.grid)[1]
    before = len(profiler.count_log("vg.saved_rows"))
    trace, metrics = traced(tmp_path, lambda: runner.run(1))
    assert np.isfinite(metrics["loss"])
    assert profiler.count_log("vg.saved_rows")[before:] == []
    got = assert_once_each(trace, ("batch", "forward", "compact.wait", "stage2.shade",
                                   "sg.diffuse_sweep", "backward", "update"))
    assert_loop_order(got)
    assert inside(got["compact.wait"], got["forward"])
    assert inside(got["stage2.shade"], got["forward"])
    assert got["compact.wait"][2] <= got["stage2.shade"][1]
    assert inside(got["sg.diffuse_sweep"], got["stage2.shade"])
