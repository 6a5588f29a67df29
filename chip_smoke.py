#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``robir_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py [--steps 20] [--seed 0] [--profile STEPS]

1. Builds the port's CUDA kernels from ``robir_tpu_torch/csrc`` with nvcc
   for sm_90a (into ``robir_tpu_torch/build/``).
2. Holds each kernel to its plain PyTorch version on the same inputs, at the
   shapes of the stage-1 NeuS main path and at a ragged row count, in fp32
   with TF32 off, and times both with CUDA events.
3. Checks one full-width train step's loss and gradients on the card (the
   kernels) against the same step on the CPU (the plain versions), from the
   same weights and rays (64) on the same samples.
4. Drives the main path: ``NeusTrainer`` at the widths of
   ``configs/neus_blender.json`` (batch 512) on an in-memory 64x64 sphere
   scene for ``--steps`` steps, then the chunked eval render of a test view.
   The kernels' launch counts are set to 0 just before and must rise by
   exactly 4 K1 + 1 K3 + 1 K4 per step and 4 K1 + 1 K3 per eval chunk.
5. With ``--profile STEPS``, profiles that many more train steps and prints
   the device time by kernel and the device's busy share.

Prints the card's name and power limit, the build time, each check, the
kernels line (one JSON object) and, last, the result line. Any failure
raises and exits non-zero; so does a machine without a CUDA device.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from robir_tpu_torch.core.config import build_stage1_configs, load_config
from robir_tpu_torch.data.blender import RayBatch
from robir_tpu_torch.data.synthetic import make_sphere_scene
from robir_tpu_torch.fields.encoding import positional_encoding
from robir_tpu_torch.fields.neus_model import NeuS, init_neus
from robir_tpu_torch.render.cuda import build
from robir_tpu_torch.render.cuda import fused_mlp as fm
from robir_tpu_torch.render.cuda import fused_value_grad as fv
from robir_tpu_torch.render.neus import render_samples, sample_z_vals
from robir_tpu_torch.stages.neus_stage import (NeusTrainer, batch_to_rays,
                                               cos_anneal_ratio, neus_loss)

ROOT = Path(__file__).resolve().parent
CONFIG = ROOT / "configs" / "neus_blender.json"

# NVIDIA H100 SXM data sheet: fp32 outside the tensor cores, HBM3 rate.
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12
# |kernel - plain| <= KERNEL_TOL * max|plain|, per output: both fp32, the
# kernel sums in another order (K4 sums dW/db across blocks with atomics).
KERNEL_TOL = 1e-4
# card vs CPU train step, both fp32 on the same samples: the loss to
# LOSS_RTOL; each gradient to GRAD_TOL x the CPU gradient's largest entry.
LOSS_RTOL = 1e-4
GRAD_TOL = 1e-4

K1, K3, K4 = fm.FORWARD, fv.FORWARD, fv.BACKWARD


def cuda_ms(fn, reps: int) -> float:
    """Mean time of ``fn`` on the card over ``reps`` calls after one warm-up,
    from CUDA events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def held_to_plain(name: str, pairs) -> float:
    """Raise unless each (what, kernel, plain) agrees; the largest error."""
    worst = 0.0
    for what, got, want in pairs:
        err = float((got - want).abs().max())
        scale = float(want.abs().max())
        if not err <= KERNEL_TOL * max(scale, 1e-6):
            raise RuntimeError(f"{name}: {what} max |kernel - plain| {err:.3e} "
                               f"> {KERNEL_TOL} x max|plain| {scale:.3e}")
        worst = max(worst, err)
    return worst


def trunk_inputs(plan, pe, n_rows: int, gen: torch.Generator):
    """Weights ~ N(0, 1/in), biases ~ N(0, 0.01), and the positional encoding
    of points uniform in [-1, 1]^3, on the card."""
    dev = torch.device("cuda")
    ws = [torch.randn(plan.layer_in_dim(i), plan.layer_out_dim(i), generator=gen,
                      device=dev) / math.sqrt(plan.layer_in_dim(i))
          for i in range(plan.n_layers)]
    bs = [0.1 * torch.randn(plan.layer_out_dim(i), generator=gen, device=dev)
          for i in range(plan.n_layers)]
    pts = torch.rand(n_rows, 3, generator=gen, device=dev) * 2 - 1
    return positional_encoding(pts, pe), ws, bs


def bound_ms(flops: float, n_bytes: float) -> tuple[float, str]:
    t_ops, t_bytes = flops / PEAK_FP32, n_bytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def check_kernels(model_cfg, rows_k1: int, rows_k1_round: int, rows_k3: int,
                  gen) -> dict:
    """Each kernel against its plain version at the main path's largest
    shape (timed) and at a ragged row count; returns the kernels' entries."""
    plan = fm.plan_from_sdf_config(model_cfg.sdf)
    pe = model_cfg.sdf.pe
    nw = plan.n_weights()
    nb = sum(plan.layer_out_dim(i) for i in range(plan.n_layers))
    d0, dout = plan.dims[0], plan.out_dim
    entries = {}

    with torch.no_grad():
        x, ws, bs = trunk_inputs(plan, pe, rows_k1, gen)
        xr = x[:4099]
        err = held_to_plain("K1", [
            ("y", fm.fused_mlp_cuda(plan, x, ws, bs), fm._forward_rows(plan, x, ws, bs)),
            ("y ragged", fm.fused_mlp_cuda(plan, xr, ws, bs),
             fm._forward_rows(plan, xr, ws, bs))])
        ms = cuda_ms(lambda: fm.fused_mlp_cuda(plan, x, ws, bs), 10)
        plain = cuda_ms(lambda: fm._forward_rows(plan, x, ws, bs), 10)
        xs = x[:rows_k1_round]
        print(f"K1 at {rows_k1_round} rows (an up-sample round): "
              f"{cuda_ms(lambda: fm.fused_mlp_cuda(plan, xs, ws, bs), 10):.3f} ms "
              f"(plain {cuda_ms(lambda: fm._forward_rows(plan, xs, ws, bs), 10):.3f} ms)",
              flush=True)
        bound = bound_ms(2.0 * nw * rows_k1, 4.0 * (rows_k1 * (d0 + dout) + nw + nb))
        entries["K1"] = dict(
            name="K1 fused_mlp trunk forward", route="cuda",
            source="robir_tpu_torch/csrc/fused_mlp.cu",
            replaces="robir_tpu/render/pallas/fused_mlp.py:111",
            max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bound[0],
            bound_by=bound[1], library_ms=None, rows=rows_k1)

        x, ws, bs = trunk_inputs(plan, pe, rows_k3, gen)
        xr = x[:4099]
        y, de = fv.vg_forward_cuda(plan, x, ws, bs)
        yp, dep, *_ = fv._forward_phases(plan, x, ws, bs)
        y_r, de_r = fv.vg_forward_cuda(plan, xr, ws, bs)
        yp_r, dep_r, *_ = fv._forward_phases(plan, xr, ws, bs)
        err = held_to_plain("K3", [("y", y, yp), ("de", de, dep),
                                   ("y ragged", y_r, yp_r), ("de ragged", de_r, dep_r)])
        del y, de, yp, dep, y_r, de_r, yp_r, dep_r
        ms = cuda_ms(lambda: fv.vg_forward_cuda(plan, x, ws, bs), 5)
        plain = cuda_ms(lambda: fv._forward_phases(plan, x, ws, bs), 5)
        bound = bound_ms(4.0 * nw * rows_k3, 4.0 * (rows_k3 * (2 * d0 + dout) + nw + nb))
        entries["K3"] = dict(
            name="K3 fused_value_grad forward (value + d sdf/dx)", route="cuda",
            source="robir_tpu_torch/csrc/fused_value_grad.cu",
            replaces="robir_tpu/render/pallas/fused_value_grad.py:131",
            max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bound[0],
            bound_by=bound[1], library_ms=None, rows=rows_k3)

        for kernel, backward in (("K3", False), ("K4", True)):
            n_bytes = 4 * fv.scratch_floats(plan, rows_k3, backward)
            print(f"{kernel} global scratch at {rows_k3} rows: {n_bytes} bytes "
                  f"({n_bytes // rows_k3} per row)", flush=True)

        dy = 1e-3 * torch.randn(rows_k3, dout, generator=gen, device="cuda")
        dde = 1e-3 * torch.randn(rows_k3, d0, generator=gen, device="cuda")
        pairs = []
        for tag, n in (("", rows_k3), (" ragged", 4099)):
            got = fv.vg_backward_cuda(plan, x[:n], ws, bs, dy[:n], dde[:n])
            want = fv._backward_phases(plan, x[:n], ws, bs, dy[:n], dde[:n])
            pairs.append(("dx" + tag, got[0], want[0]))
            for i in range(plan.n_layers):
                pairs.append((f"dW{i}{tag}", got[1][i], want[1][i]))
                pairs.append((f"db{i}{tag}", got[2][i], want[2][i]))
        err = held_to_plain("K4", pairs)
        del pairs, got, want
        ms = cuda_ms(lambda: fv.vg_backward_cuda(plan, x, ws, bs, dy, dde), 3)
        plain = cuda_ms(lambda: fv._backward_phases(plan, x, ws, bs, dy, dde), 3)
        bound = bound_ms(12.0 * nw * rows_k3,
                         4.0 * (rows_k3 * (3 * d0 + dout) + 2 * (nw + nb)))
        entries["K4"] = dict(
            name="K4 fused_value_grad backward (hand VJP)", route="cuda",
            source="robir_tpu_torch/csrc/fused_value_grad.cu",
            replaces="robir_tpu/render/pallas/fused_value_grad.py:142",
            max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bound[0],
            bound_by=bound[1], library_ms=None, rows=rows_k3)
    for name, e in entries.items():
        print(f"{name} at {e['rows']} rows: max |kernel - plain| {e['max_abs_err']:.3e}, "
              f"{e['ms']:.3f} ms (plain {e['plain_ms']:.3f} ms, bound {e['bound_ms']:.3f} ms "
              f"by {e['bound_by']})", flush=True)
    return entries


def check_step_against_cpu(model_cfg, render_cfg, train_cfg, scene, seed: int) -> None:
    """One full-width train step's loss and parameter gradients on the card
    (fp32, the kernels) against the same step on the CPU (fp32, the plain
    versions), from the same weights and 64 rays.

    Both sides shade the same samples: the CPU's sampling phase places them
    once and each side gets a copy, so a sample that lands elsewhere on one
    side (a near-tie in the inverse-CDF search) cannot move the gradients.
    Each gradient on the card must lie within GRAD_TOL of the CPU
    gradient's largest entry, so a dW that is zero or of the wrong sign
    fails by a factor of 10,000 or more. The same step in fp64 on the CPU
    shows how far fp32 itself is from exact; it is printed, not gated. The
    colour net runs in fp32 here so that bf16 rounding does not mask the
    comparison; the SDF trunk is fp32 always."""
    cfg = dataclasses.replace(model_cfg, color=dataclasses.replace(
        model_cfg.color, storage_dtype=None))
    params = init_neus(torch.Generator().manual_seed(seed), cfg)
    batch = scene.sample(np.random.default_rng(seed), 64)
    t_rand = torch.rand((64, 1), generator=torch.Generator().manual_seed(seed)) - 0.5
    anneal = cos_anneal_ratio(0, train_cfg.anneal_end)
    z_vals = None
    results = {}
    for dev, dtype in (("cpu", torch.float32), ("cuda", torch.float32),
                       ("cpu", torch.float64)):
        model = NeuS(params, cfg, dev).to(dtype)
        rays, pixels = batch_to_rays(RayBatch(*[
            torch.as_tensor(a, device=dev, dtype=dtype) for a in batch]))
        if z_vals is None:
            z_vals = sample_z_vals(rays, model, render_cfg, t_rand=t_rand)
        out = render_samples(rays, z_vals.to(dev, dtype), model, anneal, render_cfg)
        loss, _ = neus_loss(out, rays.lossmult, pixels, train_cfg)
        names, leaves = zip(*model.named_parameters())
        grads = torch.autograd.grad(loss, leaves)
        results[dev, dtype] = (float(loss.detach()),
                               [g.to("cpu", torch.float64) for g in grads])
    loss_cpu, g_cpu = results["cpu", torch.float32]
    loss_gpu, g_gpu = results["cuda", torch.float32]
    loss64, g64 = results["cpu", torch.float64]
    rel = {}
    for name, a, c, ref in zip(names, g_gpu, g_cpu, g64):
        scale = max(float(c.abs().max()), 1e-30)
        rel[name] = (float((a - c).abs().max()) / scale,
                     float((c - ref).abs().max()) / scale,
                     float((a - ref).abs().max()) / scale)
    print("train step gradients, max |difference| / max |CPU fp32| per tensor: "
          "card vs CPU fp32, CPU fp32 vs fp64, card vs fp64", flush=True)
    for name, (e_gc, e_c64, e_g64) in rel.items():
        print(f"  {name:42s} {e_gc:.3e} {e_c64:.3e} {e_g64:.3e}", flush=True)
    worst = max(rel, key=lambda n: rel[n][0])
    print(f"train step on the card vs the CPU in fp32 (64 rays, full width, same "
          f"samples): loss {loss_gpu:.8f} vs {loss_cpu:.8f} (fp64 {loss64:.8f}); "
          f"worst gradient {worst} {rel[worst][0]:.3e} of its largest entry "
          f"(limit {GRAD_TOL}); worst fp32 CPU vs fp64 "
          f"{max(r[1] for r in rel.values()):.3e}", flush=True)
    if not abs(loss_gpu - loss_cpu) <= LOSS_RTOL * abs(loss_cpu):
        raise RuntimeError(f"train step loss on the card {loss_gpu} vs CPU {loss_cpu}")
    if not rel[worst][0] <= GRAD_TOL:
        raise RuntimeError(f"train step gradient {worst}: card vs CPU "
                           f"{rel[worst][0]:.3e} of its largest entry > {GRAD_TOL}")


def counts() -> dict:
    return {"K1": K1.launches, "K3": K3.launches, "K4": K4.launches}


def profile_steps(trainer: NeusTrainer, n_steps: int) -> None:
    """Device time by kernel over ``n_steps`` more train steps, from
    torch.profiler, and the device's busy share of the window's wall time
    (the profiler's own host overhead lengthens the window)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        trainer.run(n_steps)
        torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t0)
    kernels = sorted((e for e in prof.key_averages() if e.device_type == DeviceType.CUDA),
                     key=lambda e: -e.self_device_time_total)
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    print(f"profile of {n_steps} train steps: device busy {busy_ms / n_steps:.3f} ms per "
          f"step of {wall_ms / n_steps:.3f} ms wall ({100 * busy_ms / wall_ms:.1f}%), "
          f"{sum(e.count for e in kernels) / n_steps:.0f} device ops per step", flush=True)
    for e in kernels[:15]:
        print(f"  {e.self_device_time_total / 1e3 / n_steps:9.3f} ms/step "
              f"{e.count / n_steps:6.1f}x  {e.key[:90]}", flush=True)


def drive_main_path(model_cfg, render_cfg, train_cfg, train_scene, test_scene,
                    steps: int, seed: int, profile: int = 0) -> dict:
    """Train ``steps`` steps and render one test view; returns the launch
    counts of that run. Then, if ``profile``, profile that many more steps."""
    trainer = NeusTrainer(train_scene, model_cfg, render_cfg, train_cfg,
                          seed=seed, device="cuda")
    per_step = {"K1": render_cfg.up_sample_steps, "K3": 1, "K4": 1}
    n_chunks = -(-test_scene.h * test_scene.w // train_cfg.eval_chunk)
    per_chunk = {"K1": render_cfg.up_sample_steps, "K3": 1, "K4": 0}
    torch.cuda.reset_peak_memory_stats()
    step_ms, losses = [], []
    try:
        for k in (K1, K3, K4):
            k.launches = 0
        for _ in range(steps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            metrics = trainer.run(1)
            end.record()
            torch.cuda.synchronize()
            step_ms.append(start.elapsed_time(end))
            losses.append(metrics["loss"])
            if not np.isfinite(metrics["loss"]):
                raise RuntimeError(f"loss {metrics['loss']} at step {trainer.step}")
        trained = counts()
        t0 = time.perf_counter()
        img = trainer.render_image(0, scene=test_scene)
        torch.cuda.synchronize()
        render_s = time.perf_counter() - t0
        run = counts()
        if profile:
            profile_steps(trainer, profile)
    finally:
        trainer.close()

    want = {k: v * steps for k, v in per_step.items()}
    if trained != want:
        raise RuntimeError(f"train launches {trained}, expected {want}")
    want = {k: trained[k] + v * n_chunks for k, v in per_chunk.items()}
    if run != want:
        raise RuntimeError(f"launches after the eval render {run}, expected {want}")
    if img["rgb"].shape != (test_scene.h, test_scene.w, 3) or not (
            np.isfinite(img["rgb"]).all() and np.isfinite(img["psnr"])):
        raise RuntimeError("eval render is not finite or has the wrong shape")

    steady = step_ms[2:] or step_ms
    print(f"train: {steps} steps at batch {train_cfg.batch_size}, losses "
          f"{losses[0]:.5f} -> {losses[-1]:.5f}, all finite", flush=True)
    print(f"train step: median {float(np.median(steady)):.3f} ms, mean "
          f"{float(np.mean(steady)):.3f} ms over steps 3-{steps} (CUDA events around "
          f"NeusTrainer.run(1)); first step {step_ms[0]:.3f} ms", flush=True)
    print(f"launches per step: {per_step}; eval render: {n_chunks} chunks of "
          f"{train_cfg.eval_chunk} rays, {per_chunk} per chunk", flush=True)
    print(f"eval render of test view 0 ({test_scene.h}x{test_scene.w}): PSNR "
          f"{img['psnr']:.3f} dB after {steps} steps, {render_s:.3f} s", flush=True)
    print(f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB",
          flush=True)
    return run


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", type=int, default=0, metavar="STEPS",
                    help="after the main path, profile this many more train steps")
    args = ap.parse_args()
    if args.steps < 1:
        ap.error("--steps must be at least 1")
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is False; this script "
                 "runs only on a CUDA device")

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], check=True,
                          capture_output=True, text=True).stdout.strip()
    print(card, flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("TF32 off: torch.backends.cuda.matmul.allow_tf32 = False "
          "(plain versions in full fp32)", flush=True)

    print(f"build: {build.build_all():.2f} s, nvcc {' '.join(build.NVCC_FLAGS)} "
          f"for {', '.join(build.SOURCES)}", flush=True)
    for src in build.SOURCES:
        for line in build.library_path(src).with_suffix(".log").read_text().splitlines():
            if "registers" in line or "Compiling entry" in line:
                print(f"  {src}: {line.strip()}", flush=True)

    model_cfg, render_cfg, train_cfg, dataset_cfg = build_stage1_configs(
        load_config(str(CONFIG)))
    rows_k1 = train_cfg.batch_size * render_cfg.n_samples
    rows_k3 = train_cfg.batch_size * (render_cfg.n_samples + render_cfg.n_importance)
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    rows_k1_round = (train_cfg.batch_size * render_cfg.n_importance
                     // render_cfg.up_sample_steps)
    entries = check_kernels(model_cfg, rows_k1, rows_k1_round, rows_k3, gen)

    train_scene = make_sphere_scene("train", h=64, w=64, seed=args.seed, cfg=dataset_cfg)
    test_scene = make_sphere_scene("test", h=64, w=64, seed=args.seed, cfg=dataset_cfg)
    check_step_against_cpu(model_cfg, render_cfg, train_cfg, train_scene, args.seed)

    launches = drive_main_path(model_cfg, render_cfg, train_cfg, train_scene,
                               test_scene, args.steps, args.seed, args.profile)
    for name, e in entries.items():
        if launches[name] == 0:
            raise RuntimeError(f"{name} was not launched on the main path")
        e["launches"] = launches[name]

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms", "rows")
    print(json.dumps({"kernels": [{k: e[k] for k in keys} for e in entries.values()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
