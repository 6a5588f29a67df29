"""Run one cell of the benchmark once and print its result as one JSON line.

    python3 port_bench/run.py --workload <config>.<mix> --seed N --seconds S --trace 0|1

From the root of a checkout that holds ``robir_tpu_torch``, on a machine
with as many CUDA cards as the cell asks for; it exits with a code other
than 0 and prints no result without them. Set-up (imports, the scene and
weights from the seed, the program's build and first steps, warm-up) runs
before the window; the window drives the stage's public step one call at
a time. ``--trace 0`` prints the end-to-end metrics, ``--trace 1`` the
per-layer ones from a ``torch.profiler`` trace of a few steps. Both then
judge the program's first steps against the plain reference and print
each number compared beside its limit, last on standard error and last
in the result.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from port_bench import imports, manifest  # noqa: E402
from port_bench.trace import STEP, Trace  # noqa: E402

T_IMPORTS = time.perf_counter() - T0


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def window(cell, seconds: float, device) -> tuple[list[float], float, int]:
    """Step until ``seconds`` have passed: each step's seconds, the
    window's seconds (to the last step's end, synchronised) and the steps
    whose loss was not finite."""
    times, failed = [], 0
    start = time.perf_counter()
    while True:
        t = time.perf_counter()
        loss = cell.step()
        end = time.perf_counter()
        times.append(end - t)
        failed += not math.isfinite(loss)
        if end - start >= seconds:
            break
    sync(device)
    return times, time.perf_counter() - start, failed


class Context:
    """What a per-layer reader reads: the parsed ``trace``, the stage's
    ``work`` a step and ``step_s``, the mean seconds a step, both of the
    untraced steps before the trace, and ``kernels(layer)``."""

    def __init__(self, trace: Trace, work: dict, step_s: float, root: str):
        self.trace, self.work, self.step_s, self.root = trace, work, step_s, root

    def kernels(self, layer: str) -> list[str]:
        return manifest.layer_kernels(layer, self.root)


def traced(cell, traffic: dict, device) -> tuple[Trace, range, float, int]:
    """Time ``trace_steps`` steps untraced, then profile
    ``trace_skip_steps`` steps (whose first launches the profiler drops)
    and ``trace_steps`` more in the traced window: the trace, the untraced
    steps' indices and their mean seconds (the profiler slows the host),
    and the steps that failed."""
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                     if torch.device(device).type == "cuda" else [])
    failed = 0
    untraced = range(cell.steps, cell.steps + traffic["trace_steps"])
    t = time.perf_counter()
    for _ in untraced:
        failed += not math.isfinite(cell.step())
    sync(device)
    step_s = (time.perf_counter() - t) / len(untraced)
    with profile(activities=acts) as prof:
        for _ in range(traffic["trace_skip_steps"]):
            cell.step()
        for _ in range(traffic["trace_steps"]):
            with record_function(STEP):
                failed += not math.isfinite(cell.step())
        sync(device)
    path = os.path.join(tempfile.gettempdir(), f"port_bench_{os.getpid()}.trace.json")
    try:
        prof.export_chrome_trace(path)
        tr = Trace.load(path)
    finally:
        if os.path.exists(path):
            os.remove(path)
    return tr, untraced, step_s, failed


def per_layer(ctx: Context, root: str) -> dict:
    """Each reader under ``metrics/`` that finds something to read."""
    metrics = {}
    for name in manifest.metric_names(root):
        m = manifest.metric_module(name, root)
        value = m.read(ctx)
        if value is not None:
            metrics[name] = {"value": float(value), "unit": m.UNIT}
    return metrics


def card_power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def main(argv=None, device=None, root: str = manifest.ROOT) -> int:
    """Run a cell; returns the exit code. ``device`` other than None (a
    test on the CPU) skips the look for a card."""
    args = parse(argv)
    seed = args.seed % 2 ** 63
    cell_def = manifest.load_cell(args.workload, root)
    traffic = cell_def["traffic"]
    chips = traffic.get("chips", 1)
    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            print(f"port_bench: {args.workload} needs {chips} CUDA card(s); "
                  f"torch.cuda.is_available() is {torch.cuda.is_available()}", file=sys.stderr)
            return 2
        device = torch.device("cuda")
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
        torch.cuda.reset_peak_memory_stats()
    cell = manifest.stage_module(cell_def["stage"]).build(cell_def["config"], traffic, seed,
                                                          device)
    sync(device)
    setup_s = time.perf_counter() - T0
    print("setup s: " + ", ".join(f"{k} {v:.3f}" for k, v in
                                   {"imports": T_IMPORTS, **cell.phases}.items()),
          file=sys.stderr)
    rays = cell.rays_per_step
    if args.trace:
        tr, steps, step_s, failed = traced(cell, traffic, device)
        attempted = 2 * len(steps) + traffic["trace_skip_steps"]
        device_info = {"busy_s": tr.busy_us() / 1e6, "window_s": tr.window_us() / 1e6}
        breakdown = {"device_ops": tr.top_device_ops(), "idle_gaps": tr.idle_by_host_op()}
    else:
        times, window_s, failed = window(cell, args.seconds, device)
        attempted = len(times)
        metrics = {"train_rays_per_s": {"value": attempted * rays / window_s, "unit": "rays/s"},
                   "step_ms_p95": {"value": float(np.percentile(times, 95)) * 1e3,
                                   "unit": "ms"},
                   "setup_s": {"value": setup_s, "unit": "s"}}
        device_info, breakdown = {}, None
        print(f"window: {attempted} steps in {window_s:.3f} s; step ms median "
              f"{np.median(times) * 1e3:.3f}, min {min(times) * 1e3:.3f}, "
              f"max {max(times) * 1e3:.3f}", file=sys.stderr)
    cuda = torch.device(device).type == "cuda"
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    cell.release()
    t = time.perf_counter()
    compared = cell.compare()
    limits = cell_def["limits"]
    if args.trace:
        work = cell.work(steps)
        print(f"work a traced step: {work['flops']} FLOPs, rows {work['rows']}", file=sys.stderr)
        metrics = per_layer(Context(tr, work, step_s, root), root)
    print(f"setup {setup_s:.3f} s, reference {time.perf_counter() - t:.3f} s; "
          f"card: {card_power_limit() if cuda else 'none'}", file=sys.stderr)
    bad = imports.forbidden(sys.modules)
    if bad:
        print(f"port_bench: the run loaded {bad}", file=sys.stderr)
        return 3
    for k, (v, where) in compared.items():
        if k not in limits:
            print(f"read, not compared, {k}: {v:.6e} (worst at {where})", file=sys.stderr)
    compared = {k: v for k, v in compared.items() if k in limits}
    correct = failed == 0 and all(v <= limits[k] for k, (v, _) in compared.items())
    for k, (v, where) in compared.items():
        print(f"compared {k}: {v:.6e} (limit {limits[k]:.3e}; worst at {where})",
              file=sys.stderr)
    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": metrics,
              "device": {"platform": "gpu" if cuda else "cpu",
                         "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
                         "count": chips, "memory_peak_bytes": peak, **device_info}}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["compared"] = {k: {"value": v, "limit": limits[k]} for k, (v, _) in compared.items()}
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
