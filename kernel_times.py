#!/usr/bin/env python3
"""Times of the port's trunk kernels (K1-K4) at the shapes ``chip_smoke.py``
checks, on one CUDA card, from CUDA events.

    python3 kernel_times.py [--tree DIR] [--reps 20] [--seed 0]

``--tree`` times the ``robir_tpu_torch`` package of another checkout (for
example an unpacked parent commit) instead of this one's, so that two
versions are compared in one call on one card: run parent, change, change,
parent. The inputs, the timing by CUDA events, K1's weight packing and
the shapes are ``chip_smoke.py``'s, whichever package runs; stage 1's K3
and K4 are timed as that package's main path runs them. Each shape also
gets the device time of each of the port's kernels it launches (K2's rows
kernel and its dW/db reduction apart), from the profiler: below a
millisecond the CUDA events can time the host, which launches a
wrapper's kernels, rather than the device. Prints the card's name and power limit,
then one line per shape, and last a JSON object of all the times.
"""

from __future__ import annotations

import argparse
import functools
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
# the port's kernels (K1-K4), as the profiler names them; the wrappers'
# own PyTorch ops (weight packing, zeroing) are not counted
KERNEL_NAMES = ("fused_mlp_fwd", "mlp_bwd_rows", "wgrad_kernel", "vg_fwd", "vg_bwd")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=str(HERE))
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    # chip_smoke.py of this checkout, importing the package of --tree
    sys.path.insert(0, str(Path(args.tree).resolve()))
    spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    torch, fm, fv = cs.torch, cs.fm, cs.fv
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        sys.exit("kernel_times: torch.cuda.is_available() is False; this script runs only "
                 "on a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True).stdout.strip(), flush=True)
    print(f"tree {args.tree}: build {cs.build.build_all():.2f} s", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    model_cfg, render_cfg, train_cfg, _, cesr_cfg, stage_cfg = cs.load_configs()
    rows = cs.path_rows(render_cfg, train_cfg, cesr_cfg, stage_cfg)
    checked = cs.switch_rows(torch.cuda.get_device_properties(0).multi_processor_count)
    nets = {"sdf": (fm.plan_from_sdf_config(model_cfg.sdf), model_cfg.sdf.pe),
            "normal_net": (fm.plan_from_sdf_config(stage_cfg.normal_cfg), cs.SHADOW_PE)}
    times = {}

    def device_parts(fn, reps):
        """Device time per call of each of the port's kernels that ``fn``
        launches (the wrappers' PyTorch ops left out), from the profiler."""
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        return {e.key.split("(")[0].removeprefix("void "): e.self_device_time_total / 1e3 / reps
                for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA and any(k in e.key for k in KERNEL_NAMES)}

    def record(key, events_ms, fn, reps):
        parts = device_parts(fn, reps)
        times[key] = {"events": events_ms, "device": sum(parts.values()), **parts}
        print(f"{key}: {events_ms:.4f} ms by CUDA events, {sum(parts.values()):.4f} ms on the "
              f"device (" + ", ".join(f"{k} {v:.4f}" for k, v in parts.items()) + ")", flush=True)

    def inputs(net, n):
        plan, pe = nets[net]
        x, ws, bs = cs.trunk_inputs(plan, pe, n, gen)
        return plan, x, ws, bs, 1e-3 * torch.randn(n, plan.out_dim, generator=gen, device="cuda")

    # (net, rows, the tracer's frozen weights packed once) for K1; (net,
    # rows, dx) for K2: the main paths' shapes, then the switch's
    k1 = [("sdf", n, True) for n in (rows["query"], rows["dense"])]
    k1 += [("sdf", n, False) for n in (rows["round"], rows["stage1"])]
    k1 += [("normal_net", rows["query"], False)]
    k1 += [(net, n, False) for net in nets for n in checked if n != rows["query"]]
    k2 = [("normal_net", rows["query"], False), ("sdf", rows["k2_sdf"], True)]
    k2 += [(net, n, True) for net in nets for n in checked]
    with torch.no_grad():
        for net, n, packed_once in k1:
            plan, x, ws, bs, _ = inputs(net, n)
            reps = args.reps if n < 8192 else max(5, args.reps // 2)
            record(f"K1 {net} {n}", cs.k1_ms(plan, x, ws, bs, reps, packed_once),
                   lambda: fm.fused_mlp_cuda(plan, x, ws, bs), reps)
        for net, n, need_dx in k2:
            plan, x, ws, bs, dy = inputs(net, n)
            fn = functools.partial(fm.mlp_backward_cuda, plan, x, ws, bs, dy, need_dx)
            record(f"K2 {net} {n} dx={int(need_dx)}", cs.cuda_ms(fn, args.reps), fn, args.reps)
        plan, x, ws, bs, dy = inputs("sdf", rows["vg"])
        dde = 1e-3 * torch.randn(rows["vg"], plan.dims[0], generator=gen, device="cuda")
        xq = x[:rows["query"]]
        # stage 1's K3 and K4 as the tree's main path runs them
        if hasattr(fv, "vg_forward_saving_cuda"):  # K4 starts from the state K3 kept
            k3 = functools.partial(fv.vg_forward_saving_cuda, plan, x, ws, bs)
            k4 = functools.partial(fv.vg_backward_cuda, plan, x, ws, bs, dy, dde, saved=k3()[2])
        else:  # a tree whose K4 computes the forward again
            k3 = functools.partial(fv.vg_forward_cuda, plan, x, ws, bs)
            k4 = functools.partial(fv.vg_backward_cuda, plan, x, ws, bs, dy, dde)
        for key, fn, reps in (
                (f"K3 sdf {rows['query']}", functools.partial(fv.vg_forward_cuda, plan, xq, ws, bs),
                 args.reps),
                (f"K3 sdf {rows['vg']}", k3, 5), (f"K4 sdf {rows['vg']}", k4, 3)):
            record(key, cs.cuda_ms(fn, reps), fn, reps)
    print(json.dumps({"tree": args.tree, "times_ms": times}), flush=True)


if __name__ == "__main__":
    main()
