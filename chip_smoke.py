#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``robir_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py [--steps 20] [--cesr-steps 20] [--seed 0] [--profile STEPS]

1. Builds the port's CUDA kernels from ``robir_tpu_torch/csrc`` with nvcc
   for sm_90a (into ``robir_tpu_torch/build/``), prints each kernel's
   registers, static shared memory and spill bytes from the ptxas report,
   and fails if a K3 or K4 kernel spills.
2. Holds each kernel to its plain PyTorch version on the same inputs, at the
   shapes of the main paths and at ragged row counts, in fp32 with TF32
   off, and times both with CUDA events: K1, K3 and K4 at the SDF trunk's
   plan and stage 1's rows (K3 and K4 also on each side of their switch
   from 16- to 64-row tiles); K1 at the CESR tracer's rows (1,024 per query,
   102,400 in the dense search) and K3 at the CESR step's (1,024); K1 and
   K2 at the CESR normal net's plan (8 x 512, 1,024 rows, and 1,027), K2
   also at the SDF trunk's (8,192 rows).
3. Checks one full-width stage-1 train step's loss and gradients on the
   card (the kernels) against the same step on the CPU (the plain
   versions), from the same weights and rays (64) on the same samples.
4. Drives the stage-1 path: ``NeusTrainer`` at the widths of
   ``configs/neus_blender.json`` (batch 512) on an in-memory 64x64 sphere
   scene for ``--steps`` steps, then the chunked eval render of a test view.
   The launch counts are set to 0 just before and must rise by exactly
   4 K1 + 1 K3 + 1 K4 per step and 4 K1 + 1 K3 per eval chunk.
5. Checks one full-width dense CESR step (64 pixels) on the card against the
   same step on the CPU in fp32 and fp64, from the same weights and batch,
   one trace and every random draw shared: the loss, every trainable
   gradient, and K2 on the step's own operands; then shows that the
   gradient bounds reject a planted K2 fault.
6. Drives the CESR path: ``CESRRunner`` at the widths of
   ``configs/hotdog.json`` (1,024 pixels, 128 SG lights, shadow and normal
   nets 8 x 512, the 256-wide visibility net, indirect 4 x 512;
   ``tracer="sphere"``, dense) on the in-memory two-sphere shadow scene,
   with the NeuS just trained as its frozen geometry, for ``--cesr-steps``
   steps on a shortened schedule that passes through warmup, explore and
   project and the normal switch. The counts are set to 0 just before and
   must rise by exactly 52 K1 (51 sphere-tracer queries, 50 at 1,024 rows
   and 1 at 102,400; the normal net), 1 K2 and 1 K3 per step, each at its
   shape.
7. With ``--profile STEPS``, profiles that many more steps of each path and
   prints the device time by kernel and the device's busy share.

Prints the card's name and power limit, the build time, each check, the
kernels line (one JSON object) and, last, the result line. Any failure
raises and exits non-zero; so does a machine without a CUDA device.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from robir_tpu_torch.core.config import (build_stage1_configs, build_stage2_config,
                                         build_stage_config, load_config)
from robir_tpu_torch.core.draws import Draws
from robir_tpu_torch.core.params import to_numpy
from robir_tpu_torch.data.blender import RayBatch
from robir_tpu_torch.data.syn_dataset import shadow_scene
from robir_tpu_torch.data.synthetic import make_sphere_scene
from robir_tpu_torch.fields.encoding import positional_encoding
from robir_tpu_torch.fields.neus_model import NeuS, init_neus
from robir_tpu_torch.render.cuda import build
from robir_tpu_torch.render.cuda import fused_mlp as fm
from robir_tpu_torch.render.cuda import fused_value_grad as fv
from robir_tpu_torch.render.neus import render_samples, sample_z_vals
from robir_tpu_torch.render.stage2 import Stage2Model
from robir_tpu_torch.stages.cesr import SHADOW_PE, CESRRunner, CESRStageConfig, cesr_loss
from robir_tpu_torch.stages.neus_stage import (NeusTrainer, batch_to_rays,
                                               cos_anneal_ratio, neus_loss)
from robir_tpu_torch.stages.stage2_runner import init_stage2_params

ROOT = Path(__file__).resolve().parent
CONFIG = ROOT / "configs" / "neus_blender.json"
STAGE2_CONFIG = ROOT / "configs" / "hotdog.json"

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
# the CESR step on one batch, trace and draws, on the card (fp32), the CPU
# (fp32) and the CPU in fp64. The loss to LOSS_RTOL of the CPU fp32 loss.
# Each trainable gradient, against the fp64 one: the card's error within
# CESR_GRAD_TOL of its largest entry, or, where fp32 itself does worse, within
# CESR_FP32_FACTOR x the CPU fp32 step's own error. fp32 does worse on the
# normal net: its raw output n is small near its initial sphere, and n / |n|
# divides the rounding error of n by |n|. Measured on an H100 machine over
# two runs: CPU fp32 up to 6.1e-4 of the largest entry from fp64 there, the
# card up to 4.4x the CPU's error on a tensor (K1 sums each dot product in
# one sequential chain, the CPU's GEMM in blocks).
# K2 is held to KERNEL_TOL on the step's own operands besides.
CESR_GRAD_TOL = 1e-4
CESR_FP32_FACTOR = 8.0
# the planted fault: K2 blind to one tile of this many rows
FAULT_ROWS = 16
# K3 and K4 take 64-row tiles from this many rows per SM (fused_value_grad.cu)
VG_TALL_ROWS_PER_SM = 128

K1, K2, K3, K4 = fm.FORWARD, fm.BACKWARD, fv.FORWARD, fv.BACKWARD
KERNELS = {"K1": K1, "K2": K2, "K3": K3, "K4": K4}


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
            name="K1 fused_mlp trunk forward, SDF trunk plan (width 264 build), stage 1",
            route="cuda", source="robir_tpu_torch/csrc/fused_mlp.cu",
            replaces="robir_tpu/render/pallas/fused_mlp.py:111",
            max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bound[0],
            bound_by=bound[1], library_ms=None, rows=rows_k1,
            kernel="K1", path="neus_stage1", shape=None)

        x, ws, bs = trunk_inputs(plan, pe, rows_k3, gen)
        # the main path's rows, a ragged count, and each side of the switch
        # from 16- to 64-row tiles (fused_value_grad.cu: vg_row_tile)
        switch = VG_TALL_ROWS_PER_SM * torch.cuda.get_device_properties(0).multi_processor_count
        k34_rows = ((rows_k3, ""), (4099, " ragged"), (switch - 1, f" at {switch - 1}"),
                    (switch + 1, f" at {switch + 1}"))
        pairs = []
        for n, tag in k34_rows:
            y, de = fv.vg_forward_cuda(plan, x[:n], ws, bs)
            yp, dep, *_ = fv._forward_phases(plan, x[:n], ws, bs)
            pairs += [("y" + tag, y, yp), ("de" + tag, de, dep)]
        err = held_to_plain("K3", pairs)
        del pairs, y, de, yp, dep
        ms = cuda_ms(lambda: fv.vg_forward_cuda(plan, x, ws, bs), 5)
        plain = cuda_ms(lambda: fv._forward_phases(plan, x, ws, bs), 5)
        bound = bound_ms(4.0 * nw * rows_k3, 4.0 * (rows_k3 * (2 * d0 + dout) + nw + nb))
        entries["K3"] = dict(
            name="K3 fused_value_grad forward (value + d sdf/dx), stage 1", route="cuda",
            source="robir_tpu_torch/csrc/fused_value_grad.cu",
            replaces="robir_tpu/render/pallas/fused_value_grad.py:131",
            max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bound[0],
            bound_by=bound[1], library_ms=None, rows=rows_k3,
            kernel="K3", path="neus_stage1", shape=None)

        for kernel, backward in (("K3", False), ("K4", True)):
            n_bytes = 4 * fv.scratch_floats(plan, rows_k3, backward)
            print(f"{kernel} global scratch at {rows_k3} rows: {n_bytes} bytes "
                  f"({n_bytes // rows_k3} per row)", flush=True)

        dy = 1e-3 * torch.randn(rows_k3, dout, generator=gen, device="cuda")
        dde = 1e-3 * torch.randn(rows_k3, d0, generator=gen, device="cuda")
        pairs = []
        for n, tag in k34_rows:
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
            bound_by=bound[1], library_ms=None, rows=rows_k3,
            kernel="K4", path="neus_stage1", shape=None)
    report(entries)
    return entries


def report(entries: dict) -> None:
    for name, e in entries.items():
        print(f"{name} at {e['rows']} rows: max |kernel - plain| {e['max_abs_err']:.3e}, "
              f"{e['ms']:.3f} ms (plain {e['plain_ms']:.3f} ms, bound {e['bound_ms']:.3f} ms "
              f"by {e['bound_by']})", flush=True)


def check_tracer_kernels(model_cfg, rows: int, rows_dense: int, gen) -> dict:
    """K1 and K3 at the SDF trunk's plan and the CESR path's rows, each
    against its plain version and timed: K1 at ``rows`` (a sphere-tracer
    query: one row per pixel) and ``rows_dense`` (the dense search), K3 at
    ``rows`` (the geometry normals). Returns the kernels' entries."""
    plan = fm.plan_from_sdf_config(model_cfg.sdf)
    nw = plan.n_weights()
    nb = sum(plan.layer_out_dim(i) for i in range(plan.n_layers))
    d0, dout = plan.dims[0], plan.out_dim
    entries = {}
    with torch.no_grad():
        x, ws, bs = trunk_inputs(plan, model_cfg.sdf.pe, rows_dense, gen)
        for key, n, what in (("K1t", rows, "a sphere-tracer query"),
                             ("K1d", rows_dense, "the tracer's dense search")):
            xs = x[:n]
            err = held_to_plain(f"K1 at {n} rows", [
                ("y", fm.fused_mlp_cuda(plan, xs, ws, bs), fm._forward_rows(plan, xs, ws, bs))])
            reps = 20 if n < 8192 else 10
            ms = cuda_ms(lambda: fm.fused_mlp_cuda(plan, xs, ws, bs), reps)
            plain = cuda_ms(lambda: fm._forward_rows(plan, xs, ws, bs), reps)
            bound = bound_ms(2.0 * nw * n, 4.0 * (n * (d0 + dout) + nw + nb))
            entries[key] = dict(
                name=f"K1 fused_mlp trunk forward, SDF trunk plan (width 264 build), CESR: {what}",
                route="cuda", source="robir_tpu_torch/csrc/fused_mlp.cu",
                replaces="robir_tpu/render/pallas/fused_mlp.py:111",
                max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bound[0], bound_by=bound[1],
                library_ms=None, rows=n, kernel="K1", path="cesr", shape=(fm.MAX_WIDTH, n))
        xs = x[:rows]
        y, de = fv.vg_forward_cuda(plan, xs, ws, bs)
        yp, dep, *_ = fv._forward_phases(plan, xs, ws, bs)
        err = held_to_plain(f"K3 at {rows} rows", [("y", y, yp), ("de", de, dep)])
        ms = cuda_ms(lambda: fv.vg_forward_cuda(plan, xs, ws, bs), 20)
        plain = cuda_ms(lambda: fv._forward_phases(plan, xs, ws, bs), 20)
        bound = bound_ms(4.0 * nw * rows, 4.0 * (rows * (2 * d0 + dout) + nw + nb))
        entries["K3c"] = dict(
            name="K3 fused_value_grad forward (value + d sdf/dx), CESR: the geometry normals",
            route="cuda", source="robir_tpu_torch/csrc/fused_value_grad.cu",
            replaces="robir_tpu/render/pallas/fused_value_grad.py:131",
            max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bound[0], bound_by=bound[1],
            library_ms=None, rows=rows, kernel="K3", path="cesr", shape=(fm.MAX_WIDTH, rows))
    report(entries)
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


def check_wide_kernels(normal_cfg, sdf_cfg, rows: int, rows_sdf: int, gen) -> dict:
    """K1 and K2 at the CESR normal net's plan (8 x 512, skip at layer 4:
    449 + 63) at the main path's rows and at rows + 3, and K2 at the SDF
    trunk's plan, each against its plain version; times at the main path's
    shape. Returns the kernels' entries."""
    nplan = fm.plan_from_sdf_config(normal_cfg)
    splan = fm.plan_from_sdf_config(sdf_cfg)
    nw = nplan.n_weights()
    nb = sum(nplan.layer_out_dim(i) for i in range(nplan.n_layers))
    d0, dout = nplan.dims[0], nplan.out_dim
    entries = {}
    with torch.no_grad():
        x, ws, bs = trunk_inputs(nplan, SHADOW_PE, rows + 3, gen)
        xm = x[:rows]
        err = held_to_plain("K1 normal_net", [
            ("y", fm.fused_mlp_cuda(nplan, xm, ws, bs), fm._forward_rows(nplan, xm, ws, bs)),
            ("y ragged", fm.fused_mlp_cuda(nplan, x, ws, bs), fm._forward_rows(nplan, x, ws, bs))])
        ms = cuda_ms(lambda: fm.fused_mlp_cuda(nplan, xm, ws, bs), 20)
        plain = cuda_ms(lambda: fm._forward_rows(nplan, xm, ws, bs), 20)
        bound = bound_ms(2.0 * nw * rows, 4.0 * (rows * (d0 + dout) + nw + nb))
        entries["K1w"] = dict(
            name="K1 fused_mlp trunk forward, CESR normal_net plan (width 520 build)",
            route="cuda", source="robir_tpu_torch/csrc/fused_mlp.cu",
            replaces="robir_tpu/render/pallas/fused_mlp.py:111",
            max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bound[0], bound_by=bound[1],
            library_ms=None, rows=rows, kernel="K1", path="cesr",
            shape=(fm.MAX_WIDTH_WIDE, rows))

        pairs = []
        for plan, n, need_dx, tag in ((nplan, rows, False, "normal_net"),
                                      (nplan, rows + 3, True, "normal_net ragged"),
                                      (splan, rows_sdf, True, "sdf trunk")):
            xx, wws, bbs = (x, ws, bs) if plan is nplan else trunk_inputs(
                plan, sdf_cfg.pe, n, gen)
            xx = xx[:n]
            dy = 1e-3 * torch.randn(n, plan.out_dim, generator=gen, device="cuda")
            got = fm.mlp_backward_cuda(plan, xx, wws, bbs, dy, need_dx)
            want = fm._backward_rows(plan, xx, wws, bbs, dy, need_dx)
            if need_dx:
                pairs.append((f"dx {tag}", got[0], want[0]))
            for i in range(plan.n_layers):
                pairs.append((f"dW{i} {tag}", got[1][i], want[1][i]))
                pairs.append((f"db{i} {tag}", got[2][i], want[2][i]))
        err = held_to_plain("K2", pairs)
        del pairs, got, want
        dy = 1e-3 * torch.randn(rows, dout, generator=gen, device="cuda")
        ms = cuda_ms(lambda: fm.mlp_backward_cuda(nplan, xm, ws, bs, dy, False), 20)
        plain = cuda_ms(lambda: fm._backward_rows(nplan, xm, ws, bs, dy, False), 20)
        w0 = nplan.layer_in_dim(0) * nplan.layer_out_dim(0)
        # recompute 2 nw, wgrad 2 nw, dgrad 2 (nw - w0): no dx on the path
        flops = rows * (6.0 * nw - 2.0 * w0)
        bound = bound_ms(flops, 4.0 * (rows * (d0 + dout) + 2 * (nw + nb)))
        n_bytes = 4 * fm.bwd_scratch_floats(nplan, rows)
        print(f"K2 global scratch at {rows} rows: {n_bytes} bytes ({n_bytes // rows} per row)",
              flush=True)
        entries["K2"] = dict(
            name="K2 fused_mlp recompute backward (dx, dW, db)", route="cuda",
            source="robir_tpu_torch/csrc/fused_mlp.cu",
            replaces="robir_tpu/render/pallas/fused_mlp.py:157",
            max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bound[0], bound_by=bound[1],
            library_ms=None, rows=rows, kernel="K2", path="cesr", shape=None)
    report(entries)
    return entries


def cesr_configs(model_cfg):
    """(Stage2Config, CESRStageConfig) at the widths of configs/hotdog.json,
    with the stage-1 NeuS config (the geometry is the NeuS stage 1 trained),
    the sphere tracer, the dense step, and a schedule cut so that 20 steps
    pass through warmup, explore, project, the normal switch and a
    latent-dropout resample."""
    raw = load_config(str(STAGE2_CONFIG))
    cfg = dataclasses.replace(build_stage2_config(raw["model"], tracer="sphere"),
                              neus=model_cfg)
    stage = build_stage_config(CESRStageConfig, raw["cesr"], warmup_iters=5,
                               explore_iter=5, proj_iter=3, normal_switch_iter=10,
                               dropout_iter=7)
    return cfg, stage


def cesr_params(cfg, neus: dict, seed: int) -> dict:
    """Stage-2 parameters from the port's init, with ``neus`` as the frozen
    implicit network."""
    params = init_stage2_params(torch.Generator().manual_seed(seed), cfg)
    params["implicit_network"] = neus
    return params


def check_cesr_step_against_cpu(cfg, stage, dataset, params, seed: int) -> None:
    """One full-width dense CESR explore step with the new normal (the rgb,
    KL, smoothness and supervision terms all on) on the card against the
    same step on the CPU in fp32 and in fp64 (the visibility net without its
    bf16 storage), from the same weights, the same 64 pixels, one trace (the
    CPU's depths and hits, shaded on every side, as the stage-1 check shares
    its samples) and every random draw shared (the CPU's, replayed): the
    loss and each trainable gradient to the bounds above, and K2 at the
    step's own operands to its plain version.

    Then a planted fault: the card's step again with K2 blind to the first
    FAULT_ROWS rows (their cotangent zeroed, as a kernel that skipped a row
    tile would compute), which the gradient bounds must reject."""
    cfg = dataclasses.replace(cfg, visnet=dataclasses.replace(cfg.visnet, storage_dtype=None))
    stage = dataclasses.replace(stage, num_pixels=64)
    # 48 pixels on the object and 16 off it, so that most of the batch shades
    rng = np.random.default_rng(seed)
    mask = dataset.object_masks[0]
    batch = dataset.pixels(0, np.concatenate([
        rng.choice(np.flatnonzero(mask), 48, replace=False),
        rng.choice(np.flatnonzero(~mask), 16, replace=False)]))
    tb = {k: torch.as_tensor(batch[k]) for k in ("points", "dirs", "object_mask", "rgb")}
    runners = {side: CESRRunner(cfg, params, dataset, stage, seed=seed, device=side[0])
               for side in (("cpu", torch.float32), ("cuda", torch.float32),
                            ("cpu", torch.float64))}
    runners["cpu", torch.float64].params.to(torch.float64)
    traces = {}
    for dev in ("cpu", "cuda"):
        with torch.no_grad():
            traces[dev] = [a.cpu() for a in Stage2Model(
                runners[dev, torch.float32].params, cfg, dev).trace(
                tb["points"].to(dev), tb["dirs"].to(dev))[:2]]
    (t_cpu, hit_cpu), (t_gpu, hit_gpu) = traces["cpu"], traces["cuda"]
    shaded = hit_cpu & tb["object_mask"]
    print(f"CESR step check: the card's own trace vs the CPU's: {int((hit_cpu != hit_gpu).sum())} "
          f"of 64 hit flags differ, depths of common hits at most "
          f"{float(torch.where(hit_cpu & hit_gpu, t_gpu - t_cpu, 0.0).abs().max()):.3e} apart; "
          f"every side shades the CPU's ({int(shaded.sum())} pixels on the surface, "
          f"{int(shaded[:FAULT_ROWS].sum())} of them in the first {FAULT_ROWS} rows)", flush=True)
    names = [n for n, p in runners["cpu", torch.float32].params.named_parameters()
             if p.requires_grad]
    taken = None

    def step(dev: str, dtype=torch.float32) -> tuple:
        nonlocal taken
        runner = runners[dev, dtype]
        torch.set_default_dtype(dtype)
        try:
            draws = (Draws(torch.Generator().manual_seed(seed), record=True) if taken is None
                     else Draws(given=taken, device=dev))
            inp = {k: v.to(dev, dtype) if v.is_floating_point() else v.to(dev)
                   for k, v in tb.items()}
            spec_var = (torch.arange(cfg.envmap.latent_dim, device=dev) % 4 == 1).to(dtype)
            t0 = time.perf_counter()
            loss, metrics = cesr_loss(runner.params, cfg, runner.stage_cfg, spec_var, inp,
                                      draws, "explore", True, True,
                                      traced=(t_cpu.to(dev, dtype), hit_cpu.to(dev)))
            # leaves the step does not reach (the legacy diffuse BRDF head, the
            # tone-map scalars other than adapt_illum) get zeros, as in JAX
            grads = torch.autograd.grad(loss, runner.trainable, materialize_grads=True)
            secs = time.perf_counter() - t0
        finally:
            torch.set_default_dtype(torch.float32)
        if taken is None:
            taken = draws.taken
        return (float(loss.detach()), float(metrics["surface_frac"]),
                [g.to("cpu", torch.float64) for g in grads], secs)

    real = fm.mlp_backward_cuda
    k2_calls = []

    def recorded(plan, x, ws, bs, dy, need_dx=True):
        out = real(plan, x, ws, bs, dy, need_dx)
        k2_calls.append(((plan, x, ws, bs, dy, need_dx), out))
        return out

    def blind_to_first_rows(plan, x, ws, bs, dy, need_dx=True):
        dy = dy.clone()
        dy[:FAULT_ROWS] = 0
        return real(plan, x, ws, bs, dy, need_dx)

    loss_cpu, frac_cpu, g_cpu, s_cpu = step("cpu")
    loss64, _, g64, _ = step("cpu", torch.float64)
    try:
        fm.mlp_backward_cuda = recorded
        loss_gpu, frac_gpu, g_gpu, _ = step("cuda")
        fm.mlp_backward_cuda = blind_to_first_rows
        g_fault = step("cuda")[2]
    finally:
        fm.mlp_backward_cuda = real
    if len(k2_calls) != 1:
        raise RuntimeError(f"the card's CESR step ran K2 {len(k2_calls)} times, not once")
    (plan, *operands), (dx, dws, dbs) = k2_calls[0]
    with torch.no_grad():
        _, want_w, want_b = fm._backward_rows(plan, *operands)
    k2_err = held_to_plain("K2 on the CESR step's operands",
                           [(f"dW{i}", a, b) for i, (a, b) in enumerate(zip(dws, want_w))]
                           + [(f"db{i}", a, b) for i, (a, b) in enumerate(zip(dbs, want_b))])

    def rel(a, ref):
        return float((a - ref).abs().max()) / max(float(ref.abs().max()), 1e-30)

    errs = {n: (rel(a, r), rel(c, r), rel(a, c)) for n, a, c, r in zip(names, g_gpu, g_cpu, g64)}
    bound = {n: max(CESR_GRAD_TOL, CESR_FP32_FACTOR * e[1]) for n, e in errs.items()}
    over = {n: errs[n][0] / bound[n] for n in errs}
    by_net = {}
    for n, e in errs.items():
        net = n.split(".")[0]
        by_net[net] = [max(a, b) for a, b in zip(by_net.get(net, (0.0, 0.0, 0.0)), e)]
    print(f"CESR step on the card vs the CPU (64 pixels, full width, shared trace and draws, "
          f"surface fraction {frac_gpu:.4f} vs {frac_cpu:.4f}): loss card {loss_gpu:.8f}, CPU "
          f"fp32 {loss_cpu:.8f}, fp64 {loss64:.8f}; K2 on the step's operands "
          f"{k2_err:.3e} from its plain version; {len(errs)} tensors; CPU fp32 step "
          f"{s_cpu:.1f} s", flush=True)
    print("  worst gradient error by subtree, / max|fp64|: card vs fp64, CPU fp32 vs fp64, "
          "card vs CPU fp32", flush=True)
    for net, e in by_net.items():
        print(f"  {net:50s} {e[0]:.3e} {e[1]:.3e} {e[2]:.3e}", flush=True)
    print("  the tensors nearest their bound (card vs fp64, CPU fp32 vs fp64, bound):", flush=True)
    for n in sorted(over, key=over.get)[-6:]:
        print(f"  {n:50s} {errs[n][0]:.3e} {errs[n][1]:.3e} {bound[n]:.3e}", flush=True)
    fault = {n: rel(a, r) / bound[n] for n, a, r in zip(names, g_fault, g64)
             if n.startswith("normal_net.")}
    caught = max(fault, key=fault.get)
    print(f"planted fault (K2 blind to the first {FAULT_ROWS} rows): worst normal_net gradient "
          f"{caught} {fault[caught]:.1f}x its bound", flush=True)
    if not abs(loss_gpu - loss_cpu) <= LOSS_RTOL * abs(loss_cpu):
        raise RuntimeError(f"CESR loss on the card {loss_gpu} vs CPU {loss_cpu}")
    worst = max(over, key=over.get)
    if not over[worst] <= 1.0:
        raise RuntimeError(f"CESR gradient {worst}: card vs fp64 {errs[worst][0]:.3e} of its "
                           f"largest entry > bound {bound[worst]:.3e}")
    if not fault[caught] > 1.0:
        raise RuntimeError("the CESR gradient bounds passed the planted K2 fault")


# kernels and device functions named in the ptxas report; those of K3 and
# K4 (the first four, rt_mm_body being their product, compiled out of line)
# must not spill
PTXAS_NAMES = ("vg_fwd_kernel", "vg_bwd_rows_kernel", "wgrad_kernel", "rt_mm_body",
               "fused_mlp_fwd_kernel", "mlp_bwd_rows_kernel")


def ptxas_report() -> None:
    """Registers, static shared memory and spill bytes of each kernel (and
    of rt_mm_body) from the build's ptxas log (``-Xptxas -v``); raises if
    one of K3's or K4's spills."""
    for src in build.SOURCES:
        name, seen = None, {}
        for line in build.library_path(src).with_suffix(".log").read_text().splitlines():
            m = re.search(r"(?:Compiling entry function|Function properties for) '?(\w+)", line)
            if m:
                base = next((k for k in PTXAS_NAMES if k in m.group(1)), None)
                # the template arguments, mangled as I L<type><value>E ... E
                targs = base and re.search(base + r"I((?:L\w\d+E)+)E", m.group(1))
                name = base and (f"{base}<{','.join(re.findall(r'L\w(\d+)E', targs.group(1)))}>"
                                 if targs else base)
                if name:
                    seen.setdefault(name, {"registers": "-", "smem": 0, "spill": (0, 0)})
                continue
            if not name:
                continue
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if m:
                seen[name]["spill"] = (int(m.group(1)), int(m.group(2)))
            m = re.search(r"Used (\d+) registers", line)
            if m:
                seen[name]["registers"] = int(m.group(1))
                smem = re.search(r"(\d+) bytes smem", line)
                seen[name]["smem"] = int(smem.group(1)) if smem else 0
        for name, info in seen.items():
            print(f"  {src}: {name}: {info['registers']} registers, {info['smem']} bytes static "
                  f"shared memory, spill stores/loads {info['spill'][0]}/{info['spill'][1]} "
                  f"bytes", flush=True)
            if any(info["spill"]) and name.split("<")[0] in PTXAS_NAMES[:4]:
                raise RuntimeError(f"{src}: {name} spills {info['spill']} bytes (stores, loads)")


def counts() -> dict:
    return {name: k.launches for name, k in KERNELS.items()}


def shapes() -> dict:
    """Launches of each kernel by (build width, rows)."""
    return {name: dict(k.by_shape) for name, k in KERNELS.items()}


def reset_counts() -> None:
    for k in KERNELS.values():
        k.reset()


def profile_steps(run, n_steps: int, what: str = "train") -> None:
    """Device time by kernel over ``n_steps`` more steps (``run(n_steps)``),
    from torch.profiler, and the device's busy share of the window's wall
    time (the profiler's own host overhead lengthens the window)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run(n_steps)
        torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t0)
    kernels = sorted((e for e in prof.key_averages() if e.device_type == DeviceType.CUDA),
                     key=lambda e: -e.self_device_time_total)
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    print(f"profile of {n_steps} {what} steps: device busy {busy_ms / n_steps:.3f} ms per "
          f"step of {wall_ms / n_steps:.3f} ms wall ({100 * busy_ms / wall_ms:.1f}%), "
          f"{sum(e.count for e in kernels) / n_steps:.0f} device ops per step", flush=True)
    for e in kernels[:20]:
        print(f"  {e.self_device_time_total / 1e3 / n_steps:9.3f} ms/step "
              f"{e.count / n_steps:6.1f}x  {e.key[:90]}", flush=True)


def drive_main_path(model_cfg, render_cfg, train_cfg, train_scene, test_scene,
                    steps: int, seed: int, profile: int = 0):
    """Train ``steps`` steps and render one test view; returns that run's
    launches by shape and the trained NeuS (numpy, JAX layout). Then, if
    ``profile``, profile that many more steps."""
    trainer = NeusTrainer(train_scene, model_cfg, render_cfg, train_cfg,
                          seed=seed, device="cuda")
    per_step = {"K1": render_cfg.up_sample_steps, "K2": 0, "K3": 1, "K4": 1}
    n_chunks = -(-test_scene.h * test_scene.w // train_cfg.eval_chunk)
    per_chunk = {"K1": render_cfg.up_sample_steps, "K2": 0, "K3": 1, "K4": 0}
    torch.cuda.reset_peak_memory_stats()
    step_ms, losses = [], []
    try:
        reset_counts()
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
        run, run_shapes = counts(), shapes()
        neus = to_numpy(trainer.model.params)
        if profile:
            profile_steps(trainer.run, profile)
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
    return run_shapes, neus


def drive_cesr(cfg, stage, dataset, params, steps: int, seed: int, profile: int = 0) -> dict:
    """``steps`` CESRRunner steps on the card; returns that run's launches by
    shape. Then, if ``profile``, profile that many more steps."""
    runner = CESRRunner(cfg, params, dataset, stage, seed=seed, device="cuda")
    rows, tracer = stage.num_pixels, cfg.sphere_tracer
    narrow, wide = fm.MAX_WIDTH, fm.MAX_WIDTH_WIDE
    # the tracer's queries at one row per pixel and its dense search; the
    # normal net forward and backward; the geometry normals
    per_step = {"K1": {(narrow, rows): tracer.sdf_calls() - 1,
                       (narrow, rows * tracer.n_steps): 1, (wide, rows): 1},
                "K2": {(wide, rows): 1}, "K3": {(narrow, rows): 1}, "K4": {}}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_ms = []
    reset_counts()
    for _ in range(steps):
        it = runner.cur_iter
        phase = stage.prefit_option(it)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        metrics = runner.run(1)
        end.record()
        torch.cuda.synchronize()
        step_ms.append(start.elapsed_time(end))
        bad = {k: v for k, v in metrics.items() if not np.isfinite(v)}
        if bad:
            raise RuntimeError(f"CESR step {it}: non-finite {bad}")
        print(f"CESR step {it:2d} ({phase}{', new normal' if it > stage.normal_switch_iter else ''}"
              f"): {step_ms[-1]:8.3f} ms, " + ", ".join(f"{k} {v:.5f}" for k, v in metrics.items()),
              flush=True)
    run = shapes()
    peak = torch.cuda.max_memory_allocated() / 2**30
    if profile:
        profile_steps(runner.run, profile, "CESR")
    want = {k: {shape: n * steps for shape, n in v.items()} for k, v in per_step.items()}
    if run != want:
        raise RuntimeError(f"CESR launches {run}, expected {want}")
    steady = step_ms[2:] or step_ms
    print(f"CESR step: median {float(np.median(steady)):.3f} ms, mean {float(np.mean(steady)):.3f} ms "
          f"over steps 3-{steps} (CUDA events around CESRRunner.run(1)); first step "
          f"{step_ms[0]:.3f} ms; {stage.num_pixels} pixels, {cfg.envmap.num_lgt_sgs} SG lights",
          flush=True)
    print(f"CESR launches per step by (build width, rows): {per_step}; peak device memory "
          f"{peak:.2f} GiB", flush=True)
    return run


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--cesr-steps", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", type=int, default=0, metavar="STEPS",
                    help="after each main path, profile this many more of its steps")
    args = ap.parse_args()
    if args.steps < 1 or args.cesr_steps < 1:
        ap.error("--steps and --cesr-steps must be at least 1")
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
    ptxas_report()

    model_cfg, render_cfg, train_cfg, dataset_cfg = build_stage1_configs(
        load_config(str(CONFIG)))
    cesr_cfg, stage_cfg = cesr_configs(model_cfg)
    rows_k1 = train_cfg.batch_size * render_cfg.n_samples
    rows_k3 = train_cfg.batch_size * (render_cfg.n_samples + render_cfg.n_importance)
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    rows_k1_round = (train_cfg.batch_size * render_cfg.n_importance
                     // render_cfg.up_sample_steps)
    entries = check_kernels(model_cfg, rows_k1, rows_k1_round, rows_k3, gen)
    entries.update(check_tracer_kernels(
        model_cfg, stage_cfg.num_pixels,
        stage_cfg.num_pixels * cesr_cfg.sphere_tracer.n_steps, gen))
    entries.update(check_wide_kernels(stage_cfg.normal_cfg, model_cfg.sdf,
                                      stage_cfg.num_pixels, 8192, gen))

    train_scene = make_sphere_scene("train", h=64, w=64, seed=args.seed, cfg=dataset_cfg)
    test_scene = make_sphere_scene("test", h=64, w=64, seed=args.seed, cfg=dataset_cfg)
    check_step_against_cpu(model_cfg, render_cfg, train_cfg, train_scene, args.seed)
    stage1, neus = drive_main_path(model_cfg, render_cfg, train_cfg, train_scene,
                                   test_scene, args.steps, args.seed, args.profile)

    dataset = shadow_scene(n_train=20, h=128, w=128, seed=args.seed)
    params = cesr_params(cesr_cfg, neus, args.seed)
    check_cesr_step_against_cpu(cesr_cfg, stage_cfg, dataset, params, args.seed)
    cesr = drive_cesr(cesr_cfg, stage_cfg, dataset, params, args.cesr_steps, args.seed,
                      args.profile)

    # each entry counts its kernel's launches on its path, at its shape (or
    # at every shape: stage 1's entries, timed at the path's largest rows)
    paths = {"neus_stage1": stage1, "cesr": cesr}
    for name, e in entries.items():
        e["launches"] = sum(n for shape, n in paths[e["path"]][e["kernel"]].items()
                            if e["shape"] is None or shape == e["shape"])
        if e["launches"] == 0:
            raise RuntimeError(f"{name} was not launched on the {e['path']} path")
    for path, run in paths.items():
        for kernel, by_shape in run.items():
            listed = sum(e["launches"] for e in entries.values()
                         if e["path"] == path and e["kernel"] == kernel)
            if listed != sum(by_shape.values()):
                raise RuntimeError(f"{kernel} on the {path} path: {by_shape} launches, "
                                   f"{listed} in the kernels line")

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms", "rows", "path")
    print(json.dumps({"kernels": [{k: e[k] for k in keys} for e in entries.values()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
