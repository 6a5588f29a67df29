"""A cell's traced window by the program's phases, as one JSON line.

    python3 port_bench/phases.py --workload <config>.<mix> --seed N [--out FILE]

Set-up and the traced window as ``run.py --trace 1`` makes them (on a CUDA
card), then, a step of the window, for each span of the program
(``robir_tpu_torch/tools/profiler.py:span``): its host ms, the device ms
launched with it the innermost span open and the idle ms whose gap's middle
it holds innermost (``null`` is outside every span); the per-layer metrics;
the trace's clock against the program's counter (how far each
``compact.rows`` count lies past the end of the ``compact.wait`` span before
it, and the counter's rows a step of the window taken on that clock, beside
``surface_rows_per_step``'s, which pairs counts and spans); and in a PBR
cell the reference's surface rows of the traced steps beside the counter's.
The trace is read as a ``spans.SpanTrace``. Nothing here decides
``correct`` or is a limit.
"""

import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

import argparse  # noqa: E402
import json  # noqa: E402
from unittest import mock  # noqa: E402

import torch  # noqa: E402

from port_bench import manifest, run, spans  # noqa: E402


def by_phase(tr) -> dict:
    """{span: {"host_ms", "device_ms", "idle_ms"}} a step of the window."""
    n = len(tr.steps)
    device, idle = tr.device_us_by_span(), tr.idle_us_by_span()
    names = {name for _, _, name in tr.spans} | set(device) | set(idle)
    out = {str(name): {"host_ms": spans.host_us(tr, name) / n / 1e3 if name else None,
                       "device_ms": device.get(name, 0.0) / n / 1e3,
                       "idle_ms": idle.get(name, 0.0) / n / 1e3}
           for name in names}
    return dict(sorted(out.items(), key=lambda kv: -kv[1]["device_ms"] - kv[1]["idle_ms"]))


def clock_check(tr) -> dict | None:
    """Microseconds from the end of the last ``compact.wait`` span to each
    ``compact.rows`` count made in the window (small and positive where the
    counter and the trace share a clock), and the counter's rows a step of
    the window on the trace's clock (``profiler.counts``)."""
    from robir_tpu_torch.tools import profiler

    waits = sorted(e for _, e in spans.spans(tr, "compact.wait"))
    if not waits or tr.base_ns is None:
        return None
    lo, hi = tr.window
    base_us = tr.base_ns / 1e3
    lags = []
    for t_ns, _ in profiler.count_log("compact.rows"):
        t = t_ns / 1e3 - base_us
        if lo <= t <= hi:
            before = [e for e in waits if e <= t]
            lags.append(t - before[-1] if before else float("-inf"))
    if not lags:
        return None
    rows = profiler.counts(lo + base_us, hi + base_us).get("compact.rows", 0)
    return {"counts": len(lags), "lag_us_min": min(lags), "lag_us_max": max(lags),
            "rows_per_step": rows / len(tr.steps)}


def main(argv=None, device=None, root: str = manifest.ROOT) -> int:
    """Trace a cell and print its phases; returns the exit code. ``device``
    other than None (a test on the CPU) skips the look for a card."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--out", default=None, help="also write the line to this file")
    args = ap.parse_args(argv)
    if device is None:
        if not torch.cuda.is_available():
            print("port_bench/phases.py needs a CUDA card", file=sys.stderr)
            return 2
        device = torch.device("cuda")
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    seed = args.seed % 2 ** 63
    c = manifest.load_cell(args.workload, root)
    traffic = c["traffic"]
    cell = manifest.stage_module(c["stage"]).build(c["config"], traffic, seed, device)
    with mock.patch.object(run, "Trace", spans.SpanTrace):
        tr, untraced, step_s, failed = run.traced(cell, traffic, device)
    cell.release()
    work = cell.work(untraced)
    result = {"workload": args.workload, "seed": args.seed, "failed": failed,
              "card": run.card_power_limit() if device.type == "cuda" else "none",
              "steps": len(tr.steps),
              "window_ms": tr.window_us() / len(tr.steps) / 1e3,
              "busy_ms": tr.busy_us() / len(tr.steps) / 1e3,
              "phases": by_phase(tr), "clock": clock_check(tr),
              "metrics": {k: v["value"] for k, v in
                          run.per_layer(run.Context(tr, work, step_s, root), root).items()}}
    if c["stage"] == "pbr":
        first = untraced.stop + traffic["trace_skip_steps"]
        result["reference_rows_per_step"] = cell.work(
            range(first, first + traffic["trace_steps"]))["rows"]["surface"]
    line = json.dumps(result)
    print(line, flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as fp:
            fp.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
