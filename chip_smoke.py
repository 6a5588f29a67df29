#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``robir_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py [--steps 20] [--cesr-steps 20] [--seed 0]
                          [--profile STEPS]

1. Builds the port's CUDA kernels from ``robir_tpu_torch/csrc`` with nvcc
   for sm_90a (into ``robir_tpu_torch/build/``), and its host C++ library
   (mesh, texture and EXR code) with g++, each timed; prints each kernel's
   registers, static shared memory and spill bytes from the ptxas report,
   and fails if any kernel spills.
2. Holds each kernel to its plain PyTorch version on the same inputs, at the
   shapes of the main paths and at ragged row counts, in fp32 with TF32
   off, and times both with CUDA events (K1 as its caller pays for it: the
   tracer packs its frozen weights once for all its queries, the other
   callers at every launch): K1, K3 and K4 at the SDF trunk's
   plan and stage 1's rows (K3 and K4 also on each side of their switch
   from 16- to 64-row tiles; K3 as stage 1 runs it, keeping its state for
   K4, and its outputs bit-equal without keeping; K4 from that state, its
   dx bit-equal on a second backward from it); K1 at the CESR tracer's
   rows (1,024 per query, 102,400 in the dense search) and K3 at the CESR
   step's (1,024); K1 and
   K2 at the CESR normal net's plan (8 x 512, 1,024 rows), K2 also at the
   SDF trunk's (8,192 rows); K1 and K2 at both plans at 1,024 and 1,027
   rows and on each side of their switch from clusters of blocks per
   16-row tile to one block (16 rows per SM), with each launch's geometry
   and the clusters the card holds at once.
3. Checks one full-width stage-1 train step's loss and gradients on the
   card (the kernels) against the same step on the CPU (the plain
   versions), from the same weights and rays (64) on the same samples.
4. Drives the stage-1 path: ``NeusTrainer`` at the widths of
   ``configs/neus_blender.json`` (batch 512) on an in-memory 64x64 sphere
   scene for ``--steps`` steps, then the chunked eval render of a test view.
   The step replays CUDA graphs of its loss call and backward
   (``stages/step_graph.py``): the launch counts are set to 0 just before
   and must rise by exactly 2 x (4 K1 + 1 K3 + 1 K4), the capture's
   warm-up and the capture, however many steps, with one capture and one
   replay a step; then by 4 K1 + 1 K3 per eval chunk; the warm-up's and
   the capture's K3, and none of the eval render's, keep their state for
   K4.
5. Checks one full-width CESR step (64 pixels) dense on the sphere tracer on
   the card against the same step on the CPU in fp32 and fp64, from the
   same weights (the frozen NeuS the seeded init, not the NeuS just trained,
   so that the check's inputs are the same in every run), batch, trace and
   random draws: the loss, every trainable gradient, and K2 on the step's
   own operands; then shows that the gradient bounds reject a planted K2
   fault. Then drives the CESR path of the sphere tracer, dense:
   ``CESRRunner`` at the widths of ``configs/hotdog.json`` (1,024 pixels, 128
   SG lights, shadow and normal nets 8 x 512, the 256-wide visibility net,
   indirect 4 x 512; ``tracer="sphere"``, compact_chunk 0) on the in-memory
   two-sphere shadow scene, with the NeuS just trained as its frozen
   geometry, for SPHERE_STEPS (8) steps. The counts are set to 0 just before
   and must rise by exactly 52 K1 (51 sphere-tracer queries, 50 at 1,024
   rows and 1 at 102,400; the normal net), 1 K2 and 1 K3 per step, each at
   its shape.
6. Bakes the cached-SDF grid of ``configs/hotdog.json`` (320^3, bf16) from
   that NeuS through ``CESRRunner.bake_grid`` (500 K1 launches of 65,536
   rows, counted), prints its wall time, and holds K1 to its plain version
   on one of the bake's chunks.
7. Holds the grid-march kernel to its plain version on that grid: the
   1,024 primary rays of a CESR batch and 4,096 secondary rays from their
   surface points in random directions, at over_relax 0 and 1.6; the hit
   masks must be identical and t within 1e-5 where both hit.
8. Checks the CESR step against the CPU again, in row mode on the grid
   tracer (compact_chunk 16), on a grid of the shadow scene's two spheres'
   analytic sdf (the same values on each side and in every run).
9. Drives the CESR path at the JAX package's defaults: the same runner,
   ``tracer="grid"`` and compact_chunk 128, for ``--cesr-steps`` steps on a
   shortened schedule that passes through warmup, explore and project, the
   normal switch and the guard that picks dense or compacted steps. Each
   step's line gives its mode, surface rows and fraction. The counts are set
   to 0 just before and must rise by 1 grid march (1,024 rays) per step, and
   by 1 K1, 1 K2 and 1 K3 at 1,024 rows per dense step; a compacted step
   replays the CUDA graph of its row bucket (its surface rows rounded up to
   whole chunks) and its phase (``stages/material_graph.py``), so K1-K3 pass
   through their wrappers at the bucket only at a capture, and at one chunk
   where a phase is new (the probe that notes its draws). The graph counters (captures, replays, padded rows,
   eager fallbacks) are printed; K1, K2 and K3 are then held to their plain
   versions at the row counts the run launched.
10. The mesh export (path ``mesh``; it runs right after 4, before stage
   1's profile steps, so that it meshes the NeuS stage 2 takes):
   ``NeusTrainer.extract_mesh`` at ``configs/neus_blender.json``'s ``mesh``
   section (256^3 nodes over +-1.2): exactly 256 K1 launches of 65,536
   rows (counted), the grid and the host marching tetrahedra each timed
   inside the call, the vertex and triangle counts, the PLY written
   and read back equal, K1 held to its plain version on a chunk of the
   grid.
11. The texture bake of that mesh at ``configs/hotdog.json``'s
   ``texture_resolution`` (2,048), all on the host: the atlas, the
   rasterised maps, their EXR files written and read, the five erode
   passes, each timed inside ``TexSampler``;
   of 65,536 samples at least 5% masked in, and the frozen NeuS reads a
   median |sdf| at them (stage-2 coordinates) below one mesh-grid cell
   there (1.2/255).
12. Checks one full-width Norm step (``configs/hotdog.json`` widths, 1,024
   seeded points on a sphere, seeded weights, one draw: the same inputs in
   every run) on the card against the CPU in fp32 and fp64, at cur_iter 0
   and past ``smooth_after``: each metric and decoder gradient against
   fp64 within 1e-4 (of the largest entry for a gradient) or 8x the CPU
   fp32 step's own distance. The step runs no kernel of the port, so there
   is no planted fault.
13. The Norm run (path ``norm``, no kernel launch allowed): ``NormRunner``
   at the ``norm`` section (1,024 samples a step) on the TexSampler, 20
   steps timed with CUDA events and the host batch alone, then on to step
   500 (the smoothness term starts after 500); ``normal_loss`` must fall
   from step 1 to 500; the checkpoint saved. The Vis runner's parameters
   take its decoder as ``robir_tpu/cli.py:cmd_vis`` restores it, and the
   PBR runner's through ``load_norm_checkpoint``, each leaf bit-checked.
14. The Vis stage at ``configs/hotdog.json``'s ``vis`` section (256 pixels,
   512 directions, the 4 x 256 bf16 visibility net, indirect 4 x 512 with
   24 SGs, L1, Adam 5e-4, fan_compact_chunk 4,096) through ``VisRunner``
   with the trained NeuS and the Norm decoder: the energy prologue (1,000 Adam steps, timed, no
   kernel of the port), ``bake_grid`` (timed, counted, its grid bit-equal
   to the CESR runner's, K1 held to its plain version on a chunk).
15. Holds the grid march to its plain version on a Vis batch's 256 primary
   rays and their 131,072-ray fan; ``borrow_color`` on 32,768 rays from
   the cameras' surface hits in uniform directions to its plain version
   (K3's plain version), timed with K3 on one full slice (65,536 rows, a
   check off the main path) and the peak memory.
16. Checks one full-width Vis step (24 + 8 pixels x 512 directions) on the
   card against the CPU in fp32 and fp64, on the seeded weights and the
   two-sphere grid, the CPU's primary and fan traces and every draw shared:
   both losses, each trainable gradient; then shows that the bounds reject
   a planted fault (K3 blind to a borrowed-colour launch's first row tile).
17. Drives 20 Vis steps (counts set to 0 just before: per step 2 grid
   marches, at 256 and 131,072 rays, and K3 once per slice of 4,096 rays
   that need colour, 16 rows when none does; no K1, K2 or K4); holds K3 to
   its plain version at each row count the run launched, timed at their
   median; then a checkpoint round trip: ``save``, ``restore_latest`` into a fresh runner
   (every leaf bit-equal), ``restore_surgical`` of the indirect net; the
   saved file is the PBR stage's start.
18. Checks one full-width PBR step (48 + 16 pixels, 128 SG lights x 32
   diffuse samples) on the card against the CPU in fp32 and fp64, on the
   seeded weights and the two-sphere grid, the CPU's trace and every draw
   shared, in row mode (compact_chunk 16) and dense, each shading with the
   AE normal map and with the geometry normals: the metrics, the
   ``normals`` output (K3's) and each trainable gradient; then shows that
   the bounds reject a planted fault (K3 blind to the first row tile of
   the step's launch): the normals always, the gradients too on the
   geometry normals.
19. The PBR stage at ``configs/hotdog.json``'s ``pbr`` section (1,024 pixels,
   the frozen 4 x 256 bf16 visibility net and 4 x 512 indirect net with 24
   SGs, L1, Adam 5e-4, compact_chunk 128 with the guard) through
   ``PBRRunner``: ``load_norm_checkpoint`` of the Norm phase's file and
   ``load_vis_checkpoint`` of the Vis phase's (the normal decoder
   bit-equal to the Norm runner's, the indirect and visibility nets to the
   Vis runner's, every other leaf the PBR runner's own), ``bake_grid``
   (counted, bit-equal to the CESR runner's grid, K1 held on a chunk), and
   PBR_STEPS (20) steps (counts set
   to 0 just before: per step one grid march at 1,024 rays; K3, which keeps
   no state, at the row bucket of a compacted step's graph at its capture,
   as in 9, at the batch's rows a dense step; no K1, K2 or K4; the graph
   counters printed); K3 then held to its plain version at
   every row count the run launched, and the march on a PBR batch's rays;
   the diffuse sweep alone timed at the run's median rows.
20. The eval render: ``PBRRunner.render_view`` of test view 0 of the shadow
   scene (128 x 128 in 3 chunks of 8,000 rays; counted: one march and one
   K3 a chunk), timed, its PSNR against the view's ground truth; the same
   render on recorded draws against the march's and K3's plain versions
   (identical masks, each buffer within KERNEL_TOL); K3 held to its plain
   version on each chunk's operands and the march on a chunk's rays. Then
   the SG envmap image (``compute_envmap``, 128 x 256), finite.
21. The hand-over to CESR: ``save`` the PBR runner;
   ``CESRRunner.load_pbr_checkpoint`` at the ``cesr`` section (shadow_net,
   normal_net and, at dropout_iter 0, the spec-BRDF autoencoder the CESR
   runner's own; every other leaf bit-equal to the PBR runner's), then
   HANDOVER_STEPS (4) CESR steps with the per-step counts of 9.
   The run's wall time, from argument parsing to the kernels line, is
   printed before the kernels line.
22. The command line's chain (``robir_tpu_torch/cli.py``), in process,
   from the checkpoint of 4's NeuS (saved right after 10) and 10's mesh:
   ``neus`` at configs/neus_blender.json on a sphere scene written to disk
   (64 x 64, 20 train and 2 test views) for CLI_NEUS_STEPS steps with an
   in-train eval and a checkpoint every CLI_EVERY and the test pass, then
   ``--is_continue`` for CLI_RESUME_STEPS more (the restored parameters,
   Adam moments and step bit-equal to the file); ``mesh`` (its PLY equal
   to 10's); then at configs/hotdog.json, with its NeuS at stage 1's PE,
   on the shadow scene written to disk (128 x 128, 20 train and 3 test
   views): ``norm`` on 10's mesh (its texture cache there: no atlas runs),
   ``vis`` (the prologue at its 1,000 steps), ``pbr`` and ``cesr``, each
   plotting twice; each grid bit-equal to 6's, Vis's decoder the Norm
   checkpoint's, every plot and envmap from finite buffers. Paths
   ``cli_neus`` ... ``cli_cesr``: the counts set to 0 before each call and
   read after; every (kernel, shape) they launched held to its plain
   version. Prints each subcommand's wall time.
23. The commands after training, each through ``cli.main`` with the counts
   set to 0 just before and read just after: ``sgfit`` (path
   ``cli_sgfit``) on an EXR of a seeded SG envmap at 512 x 1,024,
   SGFIT_STEPS (300) steps at 128 SGs (its files finite, the loss
   falling; no kernel); ``relight`` (``cli_relight``) of 22's CESR
   checkpoint under the shadow pipeline's envmap6 on white over the
   scene's three test views (K1 500 launches at 65,536 rows, its grid
   bit-equal to 6's; one march and one K3 a 8,000-ray chunk; the relit
   PSNRs, PNGs and GIF; view 0 on recorded draws against the march's and
   K3's plain versions; every (kernel, shape) held to its plain version);
   ``textures`` (``cli_textures``) at 1,024^2 on 10's mesh (no atlas, no
   kernel; four maps, the OBJ and MTL); ``import-ref``
   (``cli_import_ref``) of a reference ``.tar`` of 22's NeuS and a
   ``.pth`` of its CESR checkpoint into a fresh log dir (every leaf
   bit-equal to its source; no kernel). Prints each one's wall time.
24. The stage-1 alternates, each ``neus`` through ``cli.main`` with the
   counts set to 0 just before and read just after, on scenes written from
   ``--seed`` by ``tests/torch_port_helpers.py`` and configs written as
   JSON into the run directory; no kernel of the port may launch on these
   paths (their models are plain PyTorch). ``cli_llff_mip``: VNeRF at its
   defaults (8 x 256, skip at 4, PE 10, view PE 4) under
   ``MipRenderConfig``'s (2 levels, 64 samples), batch ALT_BATCH, on a
   forward-facing LLFF capture (24 views, 120 x 160, llffhold 8) for
   LLFF_STEPS steps, one in-train eval, then the test pass;
   ``cli_llff_ipe``: the same as MipNeRF (``use_ipe``, ``ipe_max_deg``
   16). ``cli_multicam``: the same widths on a Multicam scene at two
   resolutions for MULTICAM_STEPS steps and its ragged test pass (frames
   as images). Each prints its step median, loss, PSNR and wall time.
25. ``cli_hash``: ``model.type=hash`` at the ``HashNeuSConfig`` defaults
   with configs/neus_blender.json's colour net, renderer and mesh section,
   batch ALT_BATCH, HASH_STEPS steps on the sphere scene of 22; then
   ``mesh`` of its checkpoint at 256^3 (``cli_hash_mesh``, the PLY read
   back equal). No launch. The hash encoding's own ms per step (CUDA
   events, forward and backward).
26. ``neus_bg``: stage 1 with the NeRF background shell (``NeRFBgConfig``
   defaults, n_outside 32, white_bkgd false) at configs/neus_blender.json
   widths: one step on the card against the CPU in fp32 and fp64 on the
   same samples (a planted K4 fault must fail), then BG_STEPS steps; the
   counts must rise by exactly 4 K1 + 1 K3 + 1 K4 a step (the shell
   queries no SDF); each kernel held to its plain version at the shapes it
   launched.
27. IDR mode (``model.use_neus=false``) at configs/hotdog.json: the CESR
   step against the CPU in row mode on the two-sphere grid (a planted K2
   fault must fail); ``norm`` must raise the JAX package's ValueError;
   ``vis``, ``pbr`` and ``cesr`` (paths ``cli_idr_*``) IDR_STEPS steps each
   on the shadow scene with the grid tracer: each bake 500 K1 launches of
   65,536 rows at the IDR trunk, the Vis path's K3 one row a needed ray;
   K1, K2, K3 and the march held to their plain versions at every shape
   launched.
28. ``mip_sdf``: the mip renderer's ``sdf`` compositor
   (``similarity_process`` through ``NeuSSDF``) on the seeded NeuS at
   configs/neus_blender.json widths, 512 rays, on the card against the CPU
   within KERNEL_TOL of each output's largest entry; its one K3 launch held
   to the plain version. Prints each phase's wall time.
29. ``ddp_stage1`` and ``ddp_stage2`` (``drive_ddp``): DDP_RANKS ranks
   spawned once (``core/mesh.py:spawn_ranks``), gloo on the one card
   (nccl takes one rank a device), each printing its backend. Stage 1 at
   configs/neus_blender.json widths, a global batch of 512, DDP_STAGE1_STEPS
   steps of ``NeusTrainer(mesh=)``: each rank's launches a step must be
   exactly 4 K1 + 1 K3 + 1 K4; the replicas bit-equal; one step's summed
   gradients within GRAD_TOL of the one-process step's on the card on the
   same global batch and jitter; the step times, one gradient all-reduce
   alone and ``throughput``. Stage 2 at configs/hotdog.json's sections
   (CESR 1,024 global pixels, Vis, PBR, Norm) on the trained NeuS,
   DDP_STAGE2_STEPS steps each after each rank's bake (bit-equal across
   the ranks and to the one process's) and a DDP_VIS_PROLOGUE-step energy
   prologue (CESR from its last warmup step but one): each rank's launches
   a step, the replicas bit-equal; against the one-process runners every
   step's metrics within LOSS_RTOL and the weights after the steps as the
   CPU test holds them; one step's summed gradients within DDP_GRAD_TOL,
   in a check run with fp32 storage and CESR past its warmup.
   ``sampling_bf16``: stage 1 with ``sampling_dtype="bfloat16"`` for
   ``--steps`` steps, graphed: exactly 0 K1 + 2 K3 + 2 K4 counted (the
   capture's warm-up and the capture), one replay a step; the bf16 query
   (one ``torch.mm(out_dtype=float32)`` a layer) against the CPU's bf16
   route and K1 (which it must differ from by bf16's rounding), timed
   beside K1; ``throughput`` of both settings. Each path's (kernel, shape)
   held to its plain version.
30. ``neus_bridge``: ``neus_bridge_render`` (its default 64 + 64 samples,
   eval) of the seeded NeuS at configs/hotdog.json's widths on
   BRIDGE_RAYS (4,096) stage-2 rays of the shadow scene, BRIDGE_CALLS
   calls, each's wall time printed; the counts set to 0 just before:
   exactly 4 K1 (262,144 rows once, 65,536 three times) and 1 K3 (524,288
   rows) a call; rgb, acc and dist of every BRIDGE_CPU_STRIDE-th ray
   against the CPU's render of those rays within KERNEL_TOL of each one's
   largest entry; K1 and K3 held to their plain versions at each shape.
31. ``stage2_options``: ``bgr`` in IDR mode, ``borrow_color`` bit-equal to
   the unflipped run's channels reversed, then one Vis step with ``bgr``
   against the CPU as in 16, with the card's unflipped step as the
   planted fault; ``vis_compute_dtype="bfloat16"`` at fp32 visibility
   storage, the PBR diffuse sweep's logits against the CPU's bf16 route
   and against fp32 in bf16 roundoffs (the BF16_* limits), the sweep timed
   in bf16 and in fp32.
32. ``vis_workload``: ``tools/vis_workload.py``'s ``build()`` at its full
   constants (``info`` printed) and ``time_step`` (VW_STEPS x VW_REPS,
   every rep's ms a step), counted from just before the build: 500 K1
   for the bake, 2 marches a step, K3 for the borrowed colour; each
   (kernel, shape) held to its plain version.
33. With ``--profile STEPS``, profiles that many more steps of each path
   through ``tools/profiler.py`` (a trace under ``profile_traces/``,
   read back by ``summarize_trace``) and prints the device time and ops
   a step by category and kernel and the device's busy share; fails if
   the trace holds no device time, lacks the device event of a host
   launch after its first traced one, or a kernel's events there differ
   from its launches counted in the window by more than the launches the
   trace dropped at its start.

Prints the card's name and power limit, the build time, each check, the
kernels line (one JSON object) and, last, the result line. Any failure
raises and exits non-zero; so does a machine without a CUDA device.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from robir_tpu_torch import cli
from robir_tpu_torch.core import checkpoint as ckpt_lib
from robir_tpu_torch.core import mesh as dp
from robir_tpu_torch.core.compact import bucket_rows
from robir_tpu_torch.core.config import (build_mesh_config, build_stage1_configs,
                                         build_stage2_config, build_stage_config, load_config,
                                         stage1_dispatch, texture_resolution)
from robir_tpu_torch.core.draws import Draws
from robir_tpu_torch.core.params import from_jax, to_numpy
from robir_tpu_torch.core.tree import flatten_with_paths
from robir_tpu_torch.data.blender import RayBatch
from robir_tpu_torch.data.syn_dataset import shadow_scene
from robir_tpu_torch.data.synthetic import (make_shadow_dataset, make_sphere_dataset,
                                            make_sphere_scene)
from robir_tpu_torch.fields.encoding import positional_encoding
from robir_tpu_torch.fields.neus_model import NeuS, init_neus
from robir_tpu_torch.fields.radiance import NeRFBgConfig
from robir_tpu_torch.fields.sdf import fold_weight_norm
from robir_tpu_torch.render.cuda import build
from robir_tpu_torch.render.cuda import fused_mlp as fm
from robir_tpu_torch.render.cuda import fused_value_grad as fv
from robir_tpu_torch.render.cuda import grid_march as gm
from robir_tpu_torch.render import sg as sg_lib
from robir_tpu_torch.render import stage2 as stage2_mod
from robir_tpu_torch.render.neus import (NeusRenderConfig, Rays, outside_z_vals, render_samples,
                                         sample_z_vals)
from robir_tpu_torch.render.sg import compute_envmap
from robir_tpu_torch.render.stage2 import (Stage2Model, neus_bridge_render, secondary_fan,
                                           stage2_forward)
from robir_tpu_torch.stages import pbr as pbr_mod
from robir_tpu_torch.stages.cesr import SHADOW_PE, CESRRunner, CESRStageConfig, cesr_loss
from robir_tpu_torch.stages.norm import NormRunner, NormStageConfig, norm_loss
from robir_tpu_torch.stages import neus_stage as neus_stage_mod
from robir_tpu_torch.stages.neus_stage import (NeusTrainer, batch_to_rays,
                                               cos_anneal_ratio, neus_loss)
from robir_tpu_torch.stages.pbr import PBRRunner, PBRStageConfig, pbr_loss, pbr_sg_render
from robir_tpu_torch.stages.stage2_runner import BATCH_KEYS, init_stage2_params, render_view
from robir_tpu_torch.stages.vis import BATCH_KEYS as VIS_BATCH_KEYS
from robir_tpu_torch.stages.vis import VisRunner, VisStageConfig, vis_loss
from robir_tpu_torch.texture import mesh as tmesh
from robir_tpu_torch.texture import native
from robir_tpu_torch.texture.focus_sampler import TexSpaceSampler, focus_sampler_from_dataset
from robir_tpu_torch.texture import pipeline as tpipe
from robir_tpu_torch.tools import plots as tplots
from robir_tpu_torch.tools import dryrun_multichip
from robir_tpu_torch.tools import profiler
from robir_tpu_torch.tools import vis_workload
from robir_tpu_torch.tools import relight as relight_mod
from robir_tpu_torch.tools.shadow_pipeline import make_relight_envmap
from robir_tpu_torch.tracing import grid as tg
from robir_tpu_torch.utils.exr import read_exr, write_exr

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
# K1 and K2 take one block per 16-row tile from this many rows per SM, and
# a cluster of blocks per tile below (render/cuda/fused_mlp.py:launch_geometry)
MLP_ONE_BLOCK_ROWS_PER_SM = 16

# the grid march against its plain version: the same hits; t where both hit
MARCH_T_TOL = 1e-5
# steps of the CESR run on the sphere tracer, dense (the defaults' run has
# --cesr-steps)
SPHERE_STEPS = 8
# fp32 operations of one march lookup (the cell's coordinates and weights,
# the eight-corner blend), for its bound; the bytes it reads bound it
MARCH_LOOKUP_FLOPS = 40
# the shadow scene's two spheres (data/syn_dataset.py:render_two_sphere_gt)
# in stage-2 coordinates: its world coordinates / the pose scale 2. The
# step checks march a grid of their analytic sdf, the same in every run
SHADOW_SPHERES = (((0.0, 0.0, 0.0), 0.25), ((0.185, 0.11, 0.305), 0.09))
# steps of the driven Vis run
VIS_STEPS = 20
# the Vis step check: pixels on and off the object (x 512 directions)
VIS_CHECK_PIXELS = (24, 8)
# borrow_color's check: 25% of the 131,072-ray fan
VIS_BORROW_RAYS = 32768
# steps of the driven PBR run, and of CESR after the hand-over
PBR_STEPS = 20
HANDOVER_STEPS = 4
# the PBR step check: pixels on and off the object; its row mode's chunk
PBR_CHECK_PIXELS = (48, 16)
PBR_CHECK_CHUNK = 16
# a metric that vanishes (the white-light term on gray lights) is held to
# this absolute floor beside LOSS_RTOL
METRIC_FLOOR = 1e-9
# the eval render: rays a chunk (render_view's default) and the envmap image
VIEW_CHUNK = 8000
ENVMAP_HW = (128, 256)
# the texture bake's checks: this many samples, at least TEX_MIN_MASKED of
# them masked in
TEX_CHECK_SAMPLES = 65536
TEX_MIN_MASKED = 0.05
# the Norm run: this many steps timed, then on untimed to NORM_STEPS (the
# norm section's smooth_after is 500, so the run stays in one loss regime)
NORM_TIMED_STEPS = 20
NORM_STEPS = 500
# the CLI chain: stage 1's steps, its resume's, and its eval and checkpoint
# interval; Norm's steps and plot interval; Vis, PBR and CESR's
CLI_NEUS_STEPS, CLI_RESUME_STEPS, CLI_EVERY = 20, 10, 10
CLI_NORM_STEPS, CLI_NORM_PLOT = 100, 50
CLI_STAGE_STEPS, CLI_STAGE_PLOT = 10, 5
# the commands after training: sgfit's steps and its EXR's size; the
# texture maps' resolution
SGFIT_STEPS, SGFIT_HW = 300, (512, 1024)
TEXTURES_RES = 1024
# the stage-1 alternates and IDR mode: steps of each path, and the batch
LLFF_STEPS, MULTICAM_STEPS, HASH_STEPS, BG_STEPS, IDR_STEPS = 20, 10, 20, 20, 10
ALT_BATCH = 512
# the data-parallel phases: ranks sharing the card, stage 1's steps, each
# stage-2 runner's, the Vis energy prologue's (1,000 in the Vis phase), and
# the spawn's time limit
DDP_RANKS, DDP_STAGE1_STEPS, DDP_STAGE2_STEPS, DDP_VIS_PROLOGUE = 2, 20, 4, 200
DDP_TIMEOUT_S = 300.0
# ddp_stage2's weights after its steps against the one process's, the
# criterion of tests/test_torch_dist_stage2.py: each entry within 2 x lr a
# step, and this share of them within this distance (the sums differ only
# in their order; Adam's first steps are sign-like, so an entry whose
# gradient is near zero moves by an amount its rounding decides)
PARAM_AGREE_ATOL, PARAM_AGREE_FRAC = 1e-5, 0.99
# ddp_stage2's gradient check (``check_runners``: the visibility net and
# the NeuS colour net in fp32, whose bf16 outputs round apart where the
# rows split differently; CESR past its warmup): step 1's summed gradients
# against the one process's, to this share of each tensor's largest entry,
# the gradient tolerance of the CPU tests against the JAX package (CESR's
# normal net, whose n/|n| makes fp32 ill-conditioned, read 1.1e-4 to
# 1.2e-4 on an NVIDIA H100 80GB HBM3 at 700 W; the others under 1e-6)
DDP_GRAD_TOL = 5e-4
# the bf16 sampling query, in bf16 unit roundoffs (2^-8) of the largest
# |sdf|: against the CPU's bf16 route within BF16_CPU_ULPS (0.85 read on
# an NVIDIA H100 80GB HBM3 at 700 W: each side rounds its own activations,
# so a near tie rounds apart at some layer); against the fp32 trunk (K1)
# within BF16_ULPS and at least BF16_MIN_GAP_ULPS away (1.29 read there),
# so that a route that stayed in fp32 fails
BF16_CPU_ULPS, BF16_ULPS, BF16_MIN_GAP_ULPS = 2, 8, 0.25

# the NeuS bridge render: rays a call, the calls (counted), and the stride
# of the rays the CPU renders again (512 of them)
BRIDGE_RAYS, BRIDGE_CALLS, BRIDGE_CPU_STRIDE = 4096, 3, 8
# bgr's borrow_color check: seeded points
BGR_CHECK_POINTS = 4096
# the Vis workload's time_step (tools/vis_workload.py): steps a rep, reps
VW_STEPS, VW_REPS = 10, 4

K1, K2, K3, K4 = fm.FORWARD, fm.BACKWARD, fv.FORWARD, fv.BACKWARD
KERNELS = {"K1": K1, "K2": K2, "K3": K3, "K4": K4, "march": gm.MARCH}


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


@contextlib.contextmanager
def timed_calls(module, parts: dict):
    """While open, each call of ``module.<name>``, for each ``name: label``
    of ``parts``, adds its host seconds to the yielded dict under
    ``label``; the module's functions are restored on exit."""
    real = {name: getattr(module, name) for name in parts}
    secs = {label: 0.0 for label in parts.values()}

    def timed(fn, label):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                secs[label] += time.perf_counter() - t0
        return call

    try:
        for name, label in parts.items():
            setattr(module, name, timed(real[name], label))
        yield secs
    finally:
        for name, fn in real.items():
            setattr(module, name, fn)


def k1_ms(plan, x, packed, reps: int, packed_once: bool = False) -> float:
    """K1's time as its caller pays for it: a frozen trunk's queries (the
    tracer, a bake, the mesh export) share one pack (``packed_once``);
    ``fused_mlp`` packs the weights at every call."""
    if packed_once:
        return cuda_ms(lambda: fm.fused_mlp_cuda(plan, x, packed), reps)
    ws, bs = fm.unpack_grads(packed.W, packed.b, plan)
    return cuda_ms(lambda: fm.fused_mlp_cuda(plan, x, fm.pack_weights(plan, ws, bs)), reps)


def k3_ms(plan, x, packed, reps: int, keep: bool = False) -> float:
    """K3's time as ``fused_value_grad`` pays for it: its forward packs the
    weights (W, W^T and b, which K4 reads after it) at every call."""
    launch = fv.vg_forward_saving_cuda if keep else fv.vg_forward_cuda
    ws, bs = fm.unpack_grads(packed.W, packed.b, plan)
    return cuda_ms(lambda: launch(plan, x, fm.pack_weights(plan, ws, bs, reverse=True)), reps)


def plain_k3(plan, x, packed):
    """K3's plain version in ``vg_forward_cuda``'s place."""
    return fv._forward_phases(plan, x, *fm.unpack_grads(packed.W, packed.b, plan))[:2]


def load_configs():
    """(model, render, train, dataset) configs of configs/neus_blender.json,
    then (Stage2Config, CESRStageConfig) at configs/hotdog.json widths."""
    model_cfg, render_cfg, train_cfg, dataset_cfg = build_stage1_configs(
        load_config(str(CONFIG)))
    return (model_cfg, render_cfg, train_cfg, dataset_cfg, *cesr_configs(model_cfg))


def path_rows(render_cfg, train_cfg, cesr_cfg, stage_cfg) -> dict:
    """The rows of the main paths' kernel launches that the checks time."""
    batch = train_cfg.batch_size
    return {"stage1": batch * render_cfg.n_samples,  # K1's coarse samples
            "round": batch * render_cfg.n_importance // render_cfg.up_sample_steps,
            "vg": batch * (render_cfg.n_samples + render_cfg.n_importance),  # K3, K4
            "query": stage_cfg.num_pixels,  # a tracer query, the normal net, K2
            "dense": stage_cfg.num_pixels * cesr_cfg.sphere_tracer.n_steps,
            "k2_sdf": 8192}  # K2 at the SDF trunk (off the paths)


def switch_rows(sms: int) -> tuple[int, ...]:
    """K1/K2's check rows: the CESR step's 1,024, a ragged count near it,
    and each side of their switch from clusters to one block per tile."""
    switch = MLP_ONE_BLOCK_ROWS_PER_SM * sms
    return 1024, 1027, switch - 1, switch + 1


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


def k2_bound(plan, rows: int, need_dx: bool) -> tuple[float, str]:
    """K2's bound: the recompute up to the last layer's input, dW, and the
    backward products down to layer 1 (layer 0 too for dx)."""
    nw = plan.n_weights()
    nb = sum(plan.layer_out_dim(i) for i in range(plan.n_layers))
    w0 = plan.layer_in_dim(0) * plan.layer_out_dim(0)
    wl = plan.layer_in_dim(plan.n_layers - 1) * plan.out_dim
    flops = rows * (2.0 * (nw - wl) + 2.0 * nw + 2.0 * (nw - (0 if need_dx else w0)))
    return bound_ms(flops, 4.0 * (rows * ((2 if need_dx else 1) * plan.dims[0] + plan.out_dim)
                                  + 2 * (nw + nb)))


def geometry_line(kernel: str, net: str, plan, rows: int) -> dict:
    """Print the launch geometry K1 or K2 takes at ``rows``; its cluster
    size and blocks, for the kernels line."""
    geo = fm.launch_geometry(plan, rows, torch.cuda.get_device_properties(0).multi_processor_count)
    form = "rt_mm" if geo.cluster > 1 or kernel == "K2" else "tile_mm (one block per tile)"
    windows = "; ".join(f"rank {r}: {geo.rank_windows(geo.out[0], r)} ... "
                        f"{geo.rank_windows(geo.out[-1], r)}" for r in range(geo.cluster))
    print(f"{kernel} {net} at {rows} rows: {geo.tiles} tiles x cluster {geo.cluster} = "
          f"{geo.ctas} blocks, {form}; output windows, first ... last layer: {windows}",
          flush=True)
    return {"cluster": geo.cluster, "ctas": geo.ctas}


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
        pk = fm.pack_weights(plan, ws, bs, reverse=True)
        xr = x[:4099]
        err = held_to_plain("K1", [
            ("y", fm.fused_mlp_cuda(plan, x, pk), fm._forward_rows(plan, x, ws, bs)),
            ("y ragged", fm.fused_mlp_cuda(plan, xr, pk),
             fm._forward_rows(plan, xr, ws, bs))])
        ms = k1_ms(plan, x, pk, 10)
        plain = cuda_ms(lambda: fm._forward_rows(plan, x, ws, bs), 10)
        xs = x[:rows_k1_round]
        print(f"K1 at {rows_k1_round} rows (an up-sample round): "
              f"{k1_ms(plan, xs, pk, 10):.3f} ms "
              f"(plain {cuda_ms(lambda: fm._forward_rows(plan, xs, ws, bs), 10):.3f} ms)",
              flush=True)
        bound = bound_ms(2.0 * nw * rows_k1, 4.0 * (rows_k1 * (d0 + dout) + nw + nb))
        entries["K1"] = dict(
            name="K1 fused_mlp trunk forward, SDF trunk plan (width 264 build), stage 1",
            route="cuda", source="robir_tpu_torch/csrc/fused_mlp.cu",
            replaces="robir_tpu/render/pallas/fused_mlp.py:111",
            max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bound[0],
            bound_by=bound[1], library_ms=None, rows=rows_k1,
            kernel="K1", path="neus_stage1", shape=None,
            **geometry_line("K1", "sdf", plan, rows_k1))

        x, ws, bs = trunk_inputs(plan, pe, rows_k3, gen)
        pk = fm.pack_weights(plan, ws, bs, reverse=True)
        # the main path's rows, a ragged count, and each side of the switch
        # from 16- to 64-row tiles (fused_value_grad.cu: vg_row_tile); K3
        # both as stage 1 launches it (keeping its state for K4) and as the
        # paths without a backward do, which must give the same outputs
        switch = VG_TALL_ROWS_PER_SM * torch.cuda.get_device_properties(0).multi_processor_count
        k34_rows = ((rows_k3, ""), (4099, " ragged"), (switch - 1, f" at {switch - 1}"),
                    (switch + 1, f" at {switch + 1}"))
        pairs = []
        for n, tag in k34_rows:
            y, de, _ = fv.vg_forward_saving_cuda(plan, x[:n], pk)
            y2, de2 = fv.vg_forward_cuda(plan, x[:n], pk)
            if not (torch.equal(y, y2) and torch.equal(de, de2)):
                raise RuntimeError(f"K3{tag}: outputs differ with and without the kept state")
            yp, dep, *_ = fv._forward_phases(plan, x[:n], ws, bs)
            pairs += [("y" + tag, y, yp), ("de" + tag, de, dep)]
        err = held_to_plain("K3", pairs)
        del pairs, y, de, y2, de2, yp, dep
        ms = k3_ms(plan, x, pk, 5, keep=True)
        plain = cuda_ms(lambda: fv._forward_phases(plan, x, ws, bs), 5)
        state = fv.scratch_floats(plan, rows_k3, "state")
        bound = bound_ms(4.0 * nw * rows_k3,
                         4.0 * (rows_k3 * (2 * d0 + dout) + state + nw + nb))
        entries["K3"] = dict(
            name="K3 fused_value_grad forward (value + d sdf/dx), stage 1: keeps its state "
                 "for K4", route="cuda",
            source="robir_tpu_torch/csrc/fused_value_grad.cu",
            replaces="robir_tpu/render/pallas/fused_value_grad.py:131",
            max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bound[0],
            bound_by=bound[1], library_ms=None, rows=rows_k3,
            kernel="K3", path="neus_stage1", shape=None)

        for buffer in fv.SCRATCH_BUFFERS:
            n_bytes = 4 * fv.scratch_floats(plan, rows_k3, buffer)
            print(f"global scratch {buffer!r} at {rows_k3} rows: {n_bytes} bytes "
                  f"({n_bytes // rows_k3} per row)", flush=True)

        dy = 1e-3 * torch.randn(rows_k3, dout, generator=gen, device="cuda")
        dde = 1e-3 * torch.randn(rows_k3, d0, generator=gen, device="cuda")
        pairs = []
        for n, tag in k34_rows:
            saved = fv.vg_forward_saving_cuda(plan, x[:n], pk)[2]
            got = fv.vg_backward_cuda(plan, x[:n], pk, dy[:n], dde[:n], saved=saved)
            again = fv.vg_backward_cuda(plan, x[:n], pk, dy[:n], dde[:n], saved=saved)
            if not torch.equal(got[0], again[0]):
                raise RuntimeError(f"K4{tag}: dx differs on a second backward from one state")
            want = fv._backward_phases(plan, x[:n], ws, bs, dy[:n], dde[:n])
            pairs.append(("dx" + tag, got[0], want[0]))
            for i in range(plan.n_layers):
                pairs.append((f"dW{i}{tag}", got[1][i], want[1][i]))
                pairs.append((f"db{i}{tag}", got[2][i], want[2][i]))
        err = held_to_plain("K4", pairs)
        del pairs, got, again, want, saved
        saved = fv.vg_forward_saving_cuda(plan, x, pk)[2]
        ms = cuda_ms(lambda: fv.vg_backward_cuda(plan, x, pk, dy, dde, saved=saved), 3)
        del saved
        plain = cuda_ms(lambda: fv._backward_phases(plan, x, ws, bs, dy, dde), 3)
        bound = bound_ms(8.0 * nw * rows_k3,
                         4.0 * (rows_k3 * (2 * d0 + dout) + state + 2 * (nw + nb)))
        entries["K4"] = dict(
            name="K4 fused_value_grad backward (hand VJP), from the state K3 kept", route="cuda",
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
        pk = fm.pack_weights(plan, ws, bs, reverse=True)
        for key, n, what in (("K1t", rows, "a sphere-tracer query"),
                             ("K1d", rows_dense, "the tracer's dense search")):
            xs = x[:n]
            err = held_to_plain(f"K1 at {n} rows", [
                ("y", fm.fused_mlp_cuda(plan, xs, pk), fm._forward_rows(plan, xs, ws, bs))])
            reps = 20 if n < 8192 else 10
            ms = k1_ms(plan, xs, pk, reps, packed_once=True)
            plain = cuda_ms(lambda: fm._forward_rows(plan, xs, ws, bs), reps)
            bound = bound_ms(2.0 * nw * n, 4.0 * (n * (d0 + dout) + nw + nb))
            entries[key] = dict(
                name=f"K1 fused_mlp trunk forward, SDF trunk plan (width 264 build), CESR sphere "
                     f"tracer: {what}",
                route="cuda", source="robir_tpu_torch/csrc/fused_mlp.cu",
                replaces="robir_tpu/render/pallas/fused_mlp.py:111",
                max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bound[0], bound_by=bound[1],
                library_ms=None, rows=n, kernel="K1", path="cesr_sphere", shape=(fm.MAX_WIDTH, n),
                **geometry_line("K1", "sdf", plan, n))
        xs = x[:rows]
        y, de = fv.vg_forward_cuda(plan, xs, pk)
        yp, dep, *_ = fv._forward_phases(plan, xs, ws, bs)
        err = held_to_plain(f"K3 at {rows} rows", [("y", y, yp), ("de", de, dep)])
        ms = k3_ms(plan, xs, pk, 20)
        plain = cuda_ms(lambda: fv._forward_phases(plan, xs, ws, bs), 20)
        bound = bound_ms(4.0 * nw * rows, 4.0 * (rows * (2 * d0 + dout) + nw + nb))
        entries["K3c"] = dict(
            name="K3 fused_value_grad forward (value + d sdf/dx), CESR sphere tracer, dense: "
                 "the geometry normals",
            route="cuda", source="robir_tpu_torch/csrc/fused_value_grad.cu",
            replaces="robir_tpu/render/pallas/fused_value_grad.py:131",
            max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bound[0], bound_by=bound[1],
            library_ms=None, rows=rows, kernel="K3", path="cesr_sphere",
            shape=(fm.MAX_WIDTH, rows))
    report(entries)
    return entries


def check_switch_kernels(sdf_cfg, normal_cfg, gen) -> dict:
    """K1 and K2 (with dx) at both plans at 1,024 and 1,027 rows and on each
    side of their cluster switch, each against its plain version and timed;
    prints each launch's geometry and the clusters the card holds at once.
    The main paths' own shapes have their entries above; these have none
    (path None, no launches on a main path)."""
    rows_checked = switch_rows(torch.cuda.get_device_properties(0).multi_processor_count)
    entries = {}
    nets = {"sdf": (fm.plan_from_sdf_config(sdf_cfg), sdf_cfg.pe),
            "normal_net": (fm.plan_from_sdf_config(normal_cfg), SHADOW_PE)}
    for net, (plan, pe) in nets.items():
        print(f"{net} (width {fm.build_width(plan)} build): clusters of {fm.CLUSTER} blocks "
              f"held at once (cudaOccupancyMaxActiveClusters), K1 / K2 rows kernel: "
              f"{fm.max_active_clusters(plan, False)} / {fm.max_active_clusters(plan, True)}",
              flush=True)
        x, ws, bs = trunk_inputs(plan, pe, max(rows_checked), gen)
        pk = fm.pack_weights(plan, ws, bs, reverse=True)
        dy = 1e-3 * torch.randn(max(rows_checked), plan.out_dim, generator=gen, device="cuda")
        nw = plan.n_weights()
        nb = sum(plan.layer_out_dim(i) for i in range(plan.n_layers))
        width = fm.build_width(plan)
        for rows in rows_checked:
            xs, dys = x[:rows], dy[:rows]
            for kernel in ("K1", "K2"):
                geo = geometry_line(kernel, net, plan, rows)
                if geo["cluster"] != (fm.CLUSTER if rows < rows_checked[-1] else 1):
                    raise RuntimeError(f"{kernel} {net} at {rows} rows: cluster {geo['cluster']} "
                                       f"on the wrong side of the switch")
                if rows == 1024 and (net == "normal_net" or kernel == "K1"):
                    continue  # a main-path shape, in its own entry
                with torch.no_grad():
                    if kernel == "K1":
                        err = held_to_plain(f"K1 {net} at {rows} rows", [
                            ("y", fm.fused_mlp_cuda(plan, xs, pk),
                             fm._forward_rows(plan, xs, ws, bs))])
                        ms = k1_ms(plan, xs, pk, 10)
                        plain = cuda_ms(lambda: fm._forward_rows(plan, xs, ws, bs), 10)
                        bound = bound_ms(2.0 * nw * rows,
                                         4.0 * (rows * (plan.dims[0] + plan.out_dim) + nw + nb))
                        what = "K1 fused_mlp trunk forward"
                    else:
                        got = fm.mlp_backward_cuda(plan, xs, pk, dys, True)
                        want = fm._backward_rows(plan, xs, ws, bs, dys, True)
                        err = held_to_plain(f"K2 {net} at {rows} rows", [
                            ("dx", got[0], want[0]), *[(f"dW{i}", a, b) for i, (a, b) in
                                                      enumerate(zip(got[1], want[1]))],
                            *[(f"db{i}", a, b) for i, (a, b) in enumerate(zip(got[2], want[2]))]])
                        ms = cuda_ms(lambda: fm.mlp_backward_cuda(plan, xs, pk, dys, True), 10)
                        plain = cuda_ms(lambda: fm._backward_rows(plan, xs, ws, bs, dys, True), 10)
                        bound = k2_bound(plan, rows, True)
                        what = "K2 fused_mlp recompute backward (dx, dW, db)"
                entries[f"{kernel} {net} {rows}"] = dict(
                    name=f"{what}, {net} plan (width {width} build), a check shape off the "
                         f"main paths", route="cuda", source="robir_tpu_torch/csrc/fused_mlp.cu",
                    replaces="robir_tpu/render/pallas/fused_mlp.py:"
                             + ("111" if kernel == "K1" else "157"),
                    max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bound[0],
                    bound_by=bound[1], library_ms=None, rows=rows, kernel=kernel, path=None,
                    shape=(width, rows), **geo)
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
        pk = fm.pack_weights(nplan, ws, bs, reverse=True)
        xm = x[:rows]
        err = held_to_plain("K1 normal_net", [
            ("y", fm.fused_mlp_cuda(nplan, xm, pk), fm._forward_rows(nplan, xm, ws, bs)),
            ("y ragged", fm.fused_mlp_cuda(nplan, x, pk), fm._forward_rows(nplan, x, ws, bs))])
        ms = k1_ms(nplan, xm, pk, 20)
        plain = cuda_ms(lambda: fm._forward_rows(nplan, xm, ws, bs), 20)
        bound = bound_ms(2.0 * nw * rows, 4.0 * (rows * (d0 + dout) + nw + nb))
        entries["K1w"] = dict(
            name="K1 fused_mlp trunk forward, CESR normal_net plan (width 520 build), "
                 "sphere tracer, dense",
            route="cuda", source="robir_tpu_torch/csrc/fused_mlp.cu",
            replaces="robir_tpu/render/pallas/fused_mlp.py:111",
            max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bound[0], bound_by=bound[1],
            library_ms=None, rows=rows, kernel="K1", path="cesr_sphere",
            shape=(fm.MAX_WIDTH_WIDE, rows), **geometry_line("K1", "normal_net", nplan, rows))

        pairs = []
        for plan, n, need_dx, tag in ((nplan, rows, False, "normal_net"),
                                      (nplan, rows + 3, True, "normal_net ragged"),
                                      (splan, rows_sdf, True, "sdf trunk")):
            xx, wws, bbs = (x, ws, bs) if plan is nplan else trunk_inputs(
                plan, sdf_cfg.pe, n, gen)
            xx = xx[:n]
            dy = 1e-3 * torch.randn(n, plan.out_dim, generator=gen, device="cuda")
            got = fm.mlp_backward_cuda(plan, xx, fm.pack_weights(plan, wws, bbs, reverse=True),
                                       dy, need_dx)
            want = fm._backward_rows(plan, xx, wws, bbs, dy, need_dx)
            if need_dx:
                pairs.append((f"dx {tag}", got[0], want[0]))
            for i in range(plan.n_layers):
                pairs.append((f"dW{i} {tag}", got[1][i], want[1][i]))
                pairs.append((f"db{i} {tag}", got[2][i], want[2][i]))
        err = held_to_plain("K2", pairs)
        del pairs, got, want
        dy = 1e-3 * torch.randn(rows, dout, generator=gen, device="cuda")
        ms = cuda_ms(lambda: fm.mlp_backward_cuda(nplan, xm, pk, dy, False), 20)
        plain = cuda_ms(lambda: fm._backward_rows(nplan, xm, ws, bs, dy, False), 20)
        bound = k2_bound(nplan, rows, False)  # no dx on the path
        n_bytes = 4 * fm.bwd_scratch_floats(nplan, rows)
        print(f"K2 global scratch at {rows} rows: {n_bytes} bytes ({n_bytes // rows} per row)",
              flush=True)
        entries["K2"] = dict(
            name="K2 fused_mlp recompute backward (dx, dW, db), CESR normal_net, sphere "
                 "tracer, dense", route="cuda",
            source="robir_tpu_torch/csrc/fused_mlp.cu",
            replaces="robir_tpu/render/pallas/fused_mlp.py:157",
            max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bound[0], bound_by=bound[1],
            library_ms=None, rows=rows, kernel="K2", path="cesr_sphere", shape=None,
            **geometry_line("K2", "normal_net", nplan, rows))
    report(entries)
    return entries


def cesr_configs(model_cfg):
    """(Stage2Config, CESRStageConfig) of configs/hotdog.json as it stands
    (the grid tracer, compact_chunk 128), with the stage-1 NeuS config (the
    geometry is the NeuS stage 1 trained) and a schedule cut so that 20
    steps pass through warmup, explore, project, the normal switch and a
    latent-dropout resample."""
    raw = load_config(str(STAGE2_CONFIG))
    cfg = dataclasses.replace(build_stage2_config(raw["model"]), neus=model_cfg)
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


def check_cesr_step_against_cpu(cfg, stage, dataset, params, seed: int, grid=None) -> None:
    """One full-width CESR explore step with the new normal (the rgb, KL,
    smoothness and supervision terms all on), dense or in row mode as
    ``stage.compact_chunk`` says, on ``cfg``'s tracer (the grid tracer
    marches ``grid``, the same values on each side), on the card against
    the same step on the CPU in fp32 and in fp64 (the visibility net without
    its bf16 storage), from the same weights, the same 64 pixels, one trace
    (the CPU's depths and hits, shaded on every side, as the stage-1 check
    shares its samples) and every random draw shared (the CPU's, replayed):
    the loss and each trainable gradient to the bounds above, and K2 at the
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
                runners[dev, torch.float32].params, cfg, dev,
                None if grid is None else grid.to(dev)).trace(
                tb["points"].to(dev), tb["dirs"].to(dev))[:2]]
    (t_cpu, hit_cpu), (t_gpu, hit_gpu) = traces["cpu"], traces["cuda"]
    shaded = hit_cpu & tb["object_mask"]
    row_mode = stage.compact_chunk > 0  # callers pass 0 or a chunk below 64
    print(f"CESR step check, tracer {cfg.tracer!r}, "
          f"{f'row mode (compact_chunk {stage.compact_chunk})' if row_mode else 'dense'}: "
          f"the card's own trace vs the CPU's: {int((hit_cpu != hit_gpu).sum())} "
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

    def recorded(plan, x, packed, dy, need_dx=True):
        out = real(plan, x, packed, dy, need_dx)
        k2_calls.append(((plan, x, packed, dy, need_dx), out))
        return out

    def blind_to_first_rows(plan, x, packed, dy, need_dx=True):
        dy = dy.clone()
        dy[:FAULT_ROWS] = 0
        return real(plan, x, packed, dy, need_dx)

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
    (plan, x, packed, *operands), (dx, dws, dbs) = k2_calls[0]
    with torch.no_grad():
        _, want_w, want_b = fm._backward_rows(
            plan, x, *fm.unpack_grads(packed.W, packed.b, plan), *operands)
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
    print(f"CESR step check worst: gradient {worst} at {over[worst]:.3f} of its bound", flush=True)
    if not over[worst] <= 1.0:
        raise RuntimeError(f"CESR gradient {worst}: card vs fp64 {errs[worst][0]:.3e} of its "
                           f"largest entry > bound {bound[worst]:.3e}")
    if not fault[caught] > 1.0:
        raise RuntimeError("the CESR gradient bounds passed the planted K2 fault")


# kernels and device functions named in the ptxas report (rt_mm_body, the
# product of all four, is compiled out of line); none may spill
PTXAS_NAMES = ("vg_fwd_kernel", "vg_bwd_rows_kernel", "wgrad_kernel", "rt_mm_body",
               "fused_mlp_fwd_tile_kernel", "fused_mlp_fwd_kernel", "mlp_bwd_rows_kernel",
               "grid_march_kernel")


def ptxas_report() -> None:
    """Registers, static shared memory and spill bytes of each kernel (and
    of rt_mm_body) from the build's ptxas log (``-Xptxas -v``); raises if
    one spills."""
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
            if any(info["spill"]):
                raise RuntimeError(f"{src}: {name} spills {info['spill']} bytes (stores, loads)")


def counts() -> dict:
    return {name: k.launches for name, k in KERNELS.items()}


def shapes() -> dict:
    """Launches of each kernel by (build width, rows)."""
    return {name: dict(k.by_shape) for name, k in KERNELS.items()}


def reset_counts() -> None:
    for k in (*KERNELS.values(), fv.KEPT):
        k.reset()


# the device function that each counted entry point runs once a launch
# with rows (K2 and K4 run wgrad_kernel besides, once a layer)
TRACE_NAMES = {"K1": "fused_mlp_fwd", "K2": "mlp_bwd_rows_kernel", "K3": "vg_fwd_kernel",
               "K4": "vg_bwd_rows_kernel", "march": "grid_march_kernel"}


def stage1_step_launches(render_cfg) -> dict:
    """The trunk kernels' launches in one stage-1 train step: K1 once for
    the coarse samples and once a later up-sample round (the last round
    queries nothing), 1 K3, 1 K4."""
    return {"K1": render_cfg.up_sample_steps, "K2": 0, "K3": 1, "K4": 1, "march": 0}


# the times a graphed stage-1 step's launches pass through the kernels'
# wrappers: the capture's warm-up and the capture
GRAPH_CALLS = 2


def graph_snapshot(runner) -> tuple:
    """(captures, replays, draw specs probed) of a PBR or CESR runner's graph
    set (``stages/material_graph.py``)."""
    g = runner.graphs
    return (0, 0, 0) if g is None else (g.captures, g.replays, len(g._specs))


def step_passes(runner, before: tuple):
    """How the step just taken passed its launches through the kernels'
    wrappers on the graph path: (captures at its row bucket, probes at one
    chunk of rows: the eager call that notes a new flag set's draws), (0,
    0) for a replay of a key captured before; None for an eager step (no
    replay)."""
    after = graph_snapshot(runner)
    if after[1] == before[1]:
        return None
    return after[0] - before[0], after[2] - before[2]

def graph_line(what: str, runner) -> str:
    """A stage's graph counters, printed after its steps."""
    g = runner.graphs
    if g is None:
        return f"{what} graphs: none (no compacted step on the graph path)"
    return (f"{what} graphs: {g.captures} captures, {g.replays} replays, {g.padded_rows} padded "
            f"rows, {g.eager_fallbacks} eager fallbacks; keys (rows, flags) "
            f"{sorted(g.entries, key=str)}")


def profile_steps(run, n_steps: int, what: str = "train", graph=None) -> None:
    """Device time and launches by kernel over ``n_steps`` more steps
    (``run(n_steps)``): a ``tools/profiler.py:trace`` written to
    ``profile_traces/<what>`` and read back by ``summarize_trace``, and the
    device's busy share of the window's wall time (the profiler's own host
    overhead lengthens the window). Raises unless the trace holds device
    time and a device event for every launch after its first traced one
    (the profiler drops a few launches at a trace's start), and each
    kernel's events there equal its wrapper's launches with rows in the
    window, less at most those dropped at the start. ``graph``: (a
    ``StepGraph`` or ``MaterialGraphs``, its launches a replay by kernel),
    whose replays in the window launch without the wrappers and are counted
    so, and whose captures there pass through them and launch nothing."""
    log_dir = ROOT / "profile_traces" / what.replace(" ", "_")
    before = shapes()
    replays = graph[0].replays if graph else 0
    captures = graph[0].captures if graph else 0
    torch.cuda.synchronize()
    with profiler.trace(str(log_dir)):
        t0 = time.perf_counter()
        run(n_steps)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    after = shapes()
    replays = graph[0].replays - replays if graph else 0
    # a capture in the window passes through the wrappers but launches
    # nothing; its step's replay launches without them
    captures = graph[0].captures - captures if graph else 0
    summary = profiler.summarize_trace(str(log_dir), top_ops=20)
    busy_ms, ops = summary["total_ms"], summary["counts"]["ops"]
    lost, at_start = summary["counts"]["lost"], summary["counts"]["lost_at_start"]
    if busy_ms <= 0 or lost:
        raise RuntimeError(f"profile of {what}: the trace holds {busy_ms} ms of device time, and "
                           f"{lost} host launches after its first traced one lack a device event")
    held = {}
    for k, fn in TRACE_NAMES.items():
        launched = sum(n - before[k].get(s, 0) for s, n in after[k].items() if s[-1] > 0)
        launched += (replays - captures) * graph[1][k] if graph else 0
        traced = sum(n for name, n in ops.items() if fn in name)
        if not launched - at_start <= traced <= launched:
            raise RuntimeError(f"profile of {what}: {traced} {fn} events in the trace under "
                               f"{log_dir.relative_to(ROOT)}, {launched} {k} launches counted, "
                               f"{at_start} launches lost at its start")
        held[k] = f"{traced}/{launched}"
    print(f"profile of {n_steps} {what} steps ({log_dir.relative_to(ROOT)}): device busy "
          f"{busy_ms / n_steps:.3f} ms per step of {wall_ms / n_steps:.3f} ms wall "
          f"({100 * busy_ms / wall_ms:.1f}%), "
          f"{sum(summary['counts']['categories'].values()) / n_steps:.0f} device ops per step; "
          f"kernel events / counted launches {held} ({replays} steps replayed from CUDA graphs); "
          f"the first {at_start} launches of the "
          f"window without a device event; "
          "by category " + ", ".join(
              f"{k} {v / n_steps:.3f} ms ({summary['counts']['categories'][k] / n_steps:.0f}x)"
              for k, v in summary["categories"].items()), flush=True)
    for name, ms in summary["top_ops"]:
        print(f"  {ms / n_steps:9.3f} ms/step {ops[name] / n_steps:6.1f}x  {name[:90]}",
              flush=True)


def drive_main_path(model_cfg, render_cfg, train_cfg, train_scene, test_scene,
                    steps: int, seed: int):
    """Train ``steps`` steps and render one test view; returns that run's
    launches by shape, the trained NeuS (numpy, JAX layout) and the
    trainer (its prefetch thread stopped). The steps replay CUDA graphs:
    the kernels' wrappers count a step's launches twice (the
    capture's warm-up and the capture), and the graph its replays."""
    trainer = NeusTrainer(train_scene, model_cfg, render_cfg, train_cfg,
                          seed=seed, device="cuda")
    per_step = stage1_step_launches(render_cfg)
    n_chunks = -(-test_scene.h * test_scene.w // train_cfg.eval_chunk)
    per_chunk = {"K1": render_cfg.up_sample_steps, "K2": 0, "K3": 1, "K4": 0, "march": 0}
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
        trained, kept = counts(), fv.KEPT.launches
        t0 = time.perf_counter()
        img = trainer.render_image(0, scene=test_scene)
        torch.cuda.synchronize()
        render_s = time.perf_counter() - t0
        run, run_shapes = counts(), shapes()
        kept = (kept, fv.KEPT.launches)
        neus = to_numpy(trainer.model.params)
    finally:
        trainer.close()

    graph = trainer.step_graph
    if graph is None or (graph.captures, graph.replays) != (1, steps):
        raise RuntimeError(f"stage 1's step graph: {graph and (graph.captures, graph.replays)} "
                           f"(captures, replays), expected {(1, steps)}")
    want = {k: v * GRAPH_CALLS for k, v in per_step.items()}
    if trained != want:
        raise RuntimeError(f"train launches counted {trained}, expected {want}")
    want = {k: trained[k] + v * n_chunks for k, v in per_chunk.items()}
    if run != want:
        raise RuntimeError(f"launches after the eval render {run}, expected {want}")
    # the warm-up's and the capture's K3 keep their state for their K4; the
    # eval render's keep none
    if kept != (GRAPH_CALLS, GRAPH_CALLS):
        raise RuntimeError(f"K3 launches that kept their state, after training and after the "
                           f"eval render: {kept}, expected {(GRAPH_CALLS, GRAPH_CALLS)}")
    if img["rgb"].shape != (test_scene.h, test_scene.w, 3) or not (
            np.isfinite(img["rgb"]).all() and np.isfinite(img["psnr"])):
        raise RuntimeError("eval render is not finite or has the wrong shape")

    steady = step_ms[2:] or step_ms
    print(f"train: {steps} steps at batch {train_cfg.batch_size}, losses "
          f"{losses[0]:.5f} -> {losses[-1]:.5f}, all finite", flush=True)
    print(f"train step: median {float(np.median(steady)):.3f} ms, mean "
          f"{float(np.mean(steady)):.3f} ms over steps 3-{steps} (CUDA events around "
          f"NeusTrainer.run(1)); first step {step_ms[0]:.3f} ms", flush=True)
    print(f"launches per step: {per_step}, counted {GRAPH_CALLS} times (the capture's warm-up "
          f"and the capture, {graph.captures} capture), then replayed from CUDA graphs "
          f"{graph.replays} times; eval render: {n_chunks} chunks of "
          f"{train_cfg.eval_chunk} rays, {per_chunk} per chunk", flush=True)
    print(f"eval render of test view 0 ({test_scene.h}x{test_scene.w}): PSNR "
          f"{img['psnr']:.3f} dB after {steps} steps, {render_s:.3f} s", flush=True)
    print(f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB",
          flush=True)
    return run_shapes, neus, trainer


def drive_cesr_sphere(cfg, stage, dataset, params, steps: int, seed: int,
                      profile: int = 0) -> dict:
    """``steps`` dense CESRRunner steps on the card with the sphere tracer;
    returns that run's launches by shape. Then, if ``profile``, profile that
    many more steps."""
    runner = CESRRunner(cfg, params, dataset, stage, seed=seed, device="cuda")
    rows, tracer = stage.num_pixels, cfg.sphere_tracer
    narrow, wide = fm.MAX_WIDTH, fm.MAX_WIDTH_WIDE
    # the tracer's queries at one row per pixel and its dense search; the
    # normal net forward and backward; the geometry normals
    per_step = {"K1": {(narrow, rows): tracer.sdf_calls() - 1,
                       (narrow, rows * tracer.n_steps): 1, (wide, rows): 1},
                "K2": {(wide, rows): 1}, "K3": {(narrow, rows): 1}, "K4": {}, "march": {}}
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
        print(f"CESR sphere step {it:2d} ({phase}"
              f"{', new normal' if it > stage.normal_switch_iter else ''}): {step_ms[-1]:8.3f} "
              f"ms, " + ", ".join(f"{k} {v:.5f}" for k, v in metrics.items()), flush=True)
    run = shapes()
    peak = torch.cuda.max_memory_allocated() / 2**30
    if profile:
        profile_steps(runner.run, profile, "CESR sphere-tracer")
    want = {k: {shape: n * steps for shape, n in v.items()} for k, v in per_step.items()}
    if run != want:
        raise RuntimeError(f"CESR launches {run}, expected {want}")
    steady = step_ms[2:] or step_ms
    print(f"CESR sphere step: median {float(np.median(steady)):.3f} ms, mean "
          f"{float(np.mean(steady)):.3f} ms over steps 3-{steps} (CUDA events around "
          f"CESRRunner.run(1)); first step {step_ms[0]:.3f} ms; {stage.num_pixels} pixels, "
          f"{cfg.envmap.num_lgt_sgs} SG lights", flush=True)
    print(f"CESR sphere launches per step by (build width, rows): {per_step}; peak device "
          f"memory {peak:.2f} GiB", flush=True)
    return run

def bake_grid(runner) -> dict:
    """``runner.bake_grid()`` on the card with the counts set to 0 just
    before: the grid of ``runner.cfg.grid`` from the frozen NeuS, which must
    take K1 alone, one launch per BAKE_CHUNK nodes. Prints its wall time
    (to a synchronize); returns its launches by shape."""
    cfg = runner.cfg.grid
    nodes, chunk = cfg.resolution ** 3, tg.BAKE_CHUNK
    want = {k: {} for k in KERNELS}
    want["K1"] = {(fm.MAX_WIDTH, chunk): nodes // chunk}
    if nodes % chunk:
        want["K1"][fm.MAX_WIDTH, nodes % chunk] = 1
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    runner.bake_grid()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    run = shapes()
    if run != want:
        raise RuntimeError(f"grid bake launches {run}, expected {want}")
    g = runner.grid_values
    if tuple(g.shape) != (cfg.resolution,) * 3 or g.dtype != cfg.store:
        raise RuntimeError(f"baked grid {tuple(g.shape)} {g.dtype}")
    vals = g.float()
    if not bool(torch.isfinite(vals).all()) or not float(vals.min()) < 0 < float(vals.max()):
        raise RuntimeError("the baked grid is not finite or holds no surface")
    print(f"grid bake: {cfg.resolution}^3 = {nodes} nodes, {g.dtype}, {secs:.3f} s wall "
          f"({type(runner).__name__}.bake_grid to a synchronize), K1 launches by (build width, "
          f"rows) "
          f"{want['K1']}; sdf in [{float(vals.min()):.4f}, {float(vals.max()):.4f}], "
          f"{float((vals < 0).float().mean()):.4f} of the nodes inside", flush=True)
    return run


def check_bake_kernel(runner, path: str = "bake") -> dict:
    """K1 on one chunk of the bake (the nodes from the middle of the grid
    on), with the frozen NeuS's weights, against its plain version, and
    timed as the bake pays for it (weights packed once); returns its
    entry."""
    gcfg = runner.cfg.grid
    start = gcfg.resolution ** 3 // 2
    with torch.no_grad():
        pts = tg.node_points(gcfg, start, start + tg.BAKE_CHUNK, "cuda") * runner.cfg.coord_scale
    return k1_chunk_entry(runner.cfg.neus.sdf, runner.params["implicit_network"]["sdf_network"],
                          pts, "the grid bake", path)


def k1_chunk_entry(sdf_cfg, sdf_params, pts, what: str, path: str) -> dict:
    """K1 on one chunk of ``pts`` (the SDF trunk's input points), with the
    trunk's weights, against its plain version, and timed as a frozen
    trunk's caller pays for it (weights packed once); returns its entry."""
    plan = fm.plan_from_sdf_config(sdf_cfg)
    rows = pts.shape[0]
    with torch.no_grad():
        x = positional_encoding(pts * sdf_cfg.scale, sdf_cfg.pe)
        ws, bs = fold_weight_norm(sdf_params, plan.n_layers)
        pk = fm.pack_weights(plan, ws, bs)
        err = held_to_plain(f"K1 at {what}'s {rows} rows", [
            ("y", fm.fused_mlp_cuda(plan, x, pk), fm._forward_rows(plan, x, ws, bs))])
        ms = k1_ms(plan, x, pk, 10, packed_once=True)
        plain = cuda_ms(lambda: fm._forward_rows(plan, x, ws, bs), 5)
    nw = plan.n_weights()
    nb = sum(plan.layer_out_dim(i) for i in range(plan.n_layers))
    bound = bound_ms(2.0 * nw * rows, 4.0 * (rows * (plan.dims[0] + plan.out_dim) + nw + nb))
    entries = {f"K1 {path}": dict(
        name=f"K1 fused_mlp trunk forward, SDF trunk plan (width 264 build), {what} ({path})",
        route="cuda", source="robir_tpu_torch/csrc/fused_mlp.cu",
        replaces="robir_tpu/render/pallas/fused_mlp.py:111", max_abs_err=err, ms=ms,
        plain_ms=plain, bound_ms=bound[0], bound_by=bound[1], library_ms=None, rows=rows,
        kernel="K1", path=path, shape=(fm.MAX_WIDTH, rows),
        **geometry_line("K1", "sdf", plan, rows))}
    report(entries)
    return entries


def check_march(gcfg, grid, dataset, n_primary: int, n_secondary: int, seed: int,
                gen) -> dict:
    """The grid-march kernel against its plain version on ``grid``: the
    primary rays of a CESR batch of ``n_primary`` pixels, and
    ``n_secondary`` secondary rays from their surface points (pushed off
    the surface along the grid normal by max(0.005, 2 hit eps), as
    trace_radiance does) in uniformly random directions; each at
    over_relax 0 and 1.6. The hit masks must be identical and t within
    MARCH_T_TOL where both hit. Timed; the bound counts the corner bytes of
    the lookups the plain version says these rays need. Returns the
    entries (the primary rays at the config's over_relax are the main
    path's shape)."""
    batch = dataset.sample_pixels(np.random.default_rng(seed), 0, n_primary)
    o1 = torch.as_tensor(batch["points"], device="cuda")
    d1 = torch.as_tensor(batch["dirs"], device="cuda")
    with torch.no_grad():
        _, hit, x, _ = tg.grid_cast_plain(grid, gcfg, o1, d1)
        pts = x[hit]
        if pts.shape[0] == 0:
            raise RuntimeError("no primary ray hit the grid's surface")
        normals = tg.grid_normal(grid, gcfg, pts)
        sel = torch.randint(pts.shape[0], (n_secondary,), generator=gen, device="cuda")
        offset = max(0.005, 2.0 * gcfg.hit_eps_cells * gcfg.cell)
        o2 = pts[sel] + normals[sel] * offset
        d2 = torch.randn(n_secondary, 3, generator=gen, device="cuda")
        d2 = d2 / torch.linalg.norm(d2, dim=-1, keepdim=True)
    R = gcfg.resolution
    entries = {}
    for over in (0.0, 1.6):
        cfg = dataclasses.replace(gcfg, over_relax=over)
        for rays, (o, d) in (("primary", (o1, d1)), ("secondary", (o2, d2))):
            e = hold_march(grid, cfg, o, d, f"{rays} rays")
            main = rays == "primary" and over == gcfg.over_relax
            entries[f"march {rays} {over}"] = dict(
                e, name=f"grid march (march + refine, one thread a ray), {rays} rays, "
                        f"over_relax {over}" + (", the CESR trace" if main else ", a check shape"),
                path="cesr" if main else None, shape=(R, e["rows"]) if main else None)
    return entries


def hold_march(grid, cfg, o, d, what: str) -> dict:
    """The grid-march kernel (through ``grid_cast``) against its plain
    version on rays (o, d): raises unless the hits are identical and t
    within MARCH_T_TOL where both hit. Timed; the bound counts the corner
    bytes of the lookups the plain version says these rays need. Returns
    the kernels-line fields (without name, path and shape)."""
    n = o.shape[0]
    with torch.no_grad():
        t_k, hit_k, x_k = tg.grid_cast(grid, cfg, o, d)
        t_p, hit_p, x_p, lookups = tg.grid_cast_plain(grid, cfg, o, d)
    differ = torch.nonzero(hit_k != hit_p).squeeze(1)
    if differ.numel():
        raise RuntimeError(f"grid march, {what}, over_relax {cfg.over_relax}: the hits of "
                           f"rays {differ[:20].tolist()} differ from the plain version's")
    both = hit_k
    err_t = float((t_k - t_p)[both].abs().max()) if bool(both.any()) else 0.0
    err_x = float((x_k - x_p)[both].abs().max()) if bool(both.any()) else 0.0
    if not err_t <= MARCH_T_TOL:
        raise RuntimeError(f"grid march, {what}, over_relax {cfg.over_relax}: t {err_t:.3e} "
                           f"from the plain version's > {MARCH_T_TOL}")
    ms = cuda_ms(lambda: tg.grid_cast(grid, cfg, o, d), 20)
    plain = cuda_ms(lambda: tg.grid_cast_plain(grid, cfg, o, d), 3)
    looks = int(lookups.sum())
    bound = bound_ms(MARCH_LOOKUP_FLOPS * looks,
                     8 * grid.element_size() * looks + n * (4 * 3 * 3 + 4 + 1))
    print(f"grid march, {what} ({n}), over_relax {cfg.over_relax}: {int(hit_k.sum())} hits, "
          f"identical to the plain version's; t within {err_t:.3e}, x within {err_x:.3e} "
          f"where both hit; {looks} lookups ({looks / n:.1f} a ray, {int(lookups.max())} at "
          f"most); {ms:.4f} ms (plain {plain:.3f} ms, bound {bound[0]:.5f} ms by {bound[1]})",
          flush=True)
    return dict(route="cuda", source="robir_tpu_torch/csrc/grid_march.cu",
                replaces="robir_tpu/tracing/grid.py:473 (grid_cast, XLA, no Pallas kernel)",
                max_abs_err=err_t, ms=ms, plain_ms=plain, bound_ms=bound[0],
                bound_by=bound[1], library_ms=None, rows=n, kernel="march", lookups=looks,
                hits=int(hit_k.sum()))


def drive_cesr_grid(runner, steps: int, profile: int = 0):
    """``steps`` steps of ``runner`` (the grid tracer, compaction) on the
    card, with the counts set to 0 just before. Each step's line gives its
    mode (``runner.step_config()``: compacted or dense), its surface rows
    and fraction; the guard's reading and choice are printed where it
    reads. Each step must launch the grid march once at the batch's rays;
    a dense step K1, K2 and K3 once each at the batch's rows; a compacted
    step (the graph path, ``stages/material_graph.py``) passes K1, K2 and
    K3 through their wrappers once at one chunk of rows where its flags
    are new (the probe that notes their draws), once at its row bucket
    (its surface rows rounded up to whole chunks) for each capture it
    made, and not at all where it replays a key captured before. Returns
    the launches by shape and the rows each step's kernels ran on. Then,
    if ``profile``, profiles that many more steps."""
    stage = runner.stage_cfg
    n, R = stage.num_pixels, runner.cfg.grid.resolution
    narrow, wide = fm.MAX_WIDTH, fm.MAX_WIDTH_WIDE
    want = {k: {} for k in KERNELS}

    def add(kernel, shape):
        want[kernel][shape] = want[kernel].get(shape, 0) + 1

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_ms, shaded = [], []
    reset_counts()
    for _ in range(steps):
        it = runner.cur_iter
        phase = stage.prefit_option(it)
        compacted = runner.step_config().compact_chunk > 0  # below n: row mode
        before = graph_snapshot(runner)
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
        surface = round(metrics["surface_frac"] * n)
        passes = step_passes(runner, before)
        if passes is None:
            rows, how = (max(surface, 1) if compacted else n), "eager"
            launches = [rows]
        else:
            rows = bucket_rows(surface, stage.compact_chunk)
            launches = [rows] * passes[0] + [stage.compact_chunk] * passes[1]
            how = "replayed" if passes == (0, 0) else f"captured {passes}"
        shaded.extend(sorted(set(launches)) or [rows])
        add("march", (R, n))
        for kernel, width in (("K1", wide), ("K2", wide), ("K3", narrow)):
            for r in launches:
                add(kernel, (width, r))
        print(f"CESR step {it:2d} ({phase}{', new normal' if it > stage.normal_switch_iter else ''}"
              f", {'compacted' if compacted else 'dense'}, {how}): {surface} surface rows, "
              f"fraction {metrics['surface_frac']:.4f}, {rows} rows shaded; "
              f"{step_ms[-1]:8.3f} ms, "
              + ", ".join(f"{k} {v:.5f}" for k, v in metrics.items() if k != "surface_frac"),
              flush=True)
        if runner.cur_iter % stage.guard_every == 0:
            dense = runner.step_config().compact_chunk == 0
            print(f"  guard after step {runner.cur_iter}: surface fraction "
                  f"{runner.surface_frac:.4f} {'>' if dense else '<='} "
                  f"{stage.compact_max_surface_frac}: the next steps run "
                  f"{'dense' if dense else 'compacted'}", flush=True)
    run = shapes()
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(graph_line("CESR", runner), flush=True)
    if profile:
        profile_steps(runner.run, profile, "CESR", graph=runner.graphs and (
            runner.graphs, {"K1": 1, "K2": 1, "K3": 1, "K4": 0, "march": 0}))
    if run != want:
        raise RuntimeError(f"CESR launches {run}, expected {want}")
    steady = step_ms[2:] or step_ms
    print(f"CESR step (grid tracer, compact_chunk {stage.compact_chunk}): median "
          f"{float(np.median(steady)):.3f} ms, mean {float(np.mean(steady)):.3f} ms over steps "
          f"3-{steps} (CUDA events around CESRRunner.run(1)); first step {step_ms[0]:.3f} ms; "
          f"{n} pixels, {runner.cfg.envmap.num_lgt_sgs} SG lights; peak device memory "
          f"{peak:.2f} GiB", flush=True)
    print(f"CESR launches per step: the grid march 1 ({n} rays, grid {R}^3), K1 1 (width "
          f"{wide}), K2 1 ({wide}), K3 1 ({narrow}), each at the step's shaded rows, counted "
          f"through the wrappers at a graph's capture (and a new phase's probe) only; over the "
          f"{steps} steps by kernel and (width or grid resolution, rows): {want}", flush=True)
    return run, shaded


def check_grid_path_kernels(sdf_cfg, normal_cfg, shaded: list, gen) -> dict:
    """K1 and K2 at the CESR normal net's plan (K2 without dx, as the step
    needs none) and K3 at the SDF trunk's, against their plain versions at
    every row count the CESR run shaded, timed at its median; returns their
    entries (which count the run's launches at every row count)."""
    nplan, splan = fm.plan_from_sdf_config(normal_cfg), fm.plan_from_sdf_config(sdf_cfg)
    counts_run = sorted(set(shaded))
    median = int(np.median(shaded))
    nx, nws, nbs = trunk_inputs(nplan, SHADOW_PE, max(counts_run), gen)
    sx, sws, sbs = trunk_inputs(splan, sdf_cfg.pe, max(counts_run), gen)
    npk = fm.pack_weights(nplan, nws, nbs, reverse=True)
    spk = fm.pack_weights(splan, sws, sbs, reverse=True)
    dy = 1e-3 * torch.randn(max(counts_run), nplan.out_dim, generator=gen, device="cuda")
    errs = {"K1": [], "K2": [], "K3": []}
    with torch.no_grad():
        for r in counts_run:
            errs["K1"].append((f"y at {r} rows", fm.fused_mlp_cuda(nplan, nx[:r], npk),
                               fm._forward_rows(nplan, nx[:r], nws, nbs)))
            got = fm.mlp_backward_cuda(nplan, nx[:r], npk, dy[:r], False)
            want = fm._backward_rows(nplan, nx[:r], nws, nbs, dy[:r], False)
            errs["K2"] += [(f"dW{i} at {r} rows", a, b) for i, (a, b) in
                           enumerate(zip(got[1], want[1]))]
            errs["K2"] += [(f"db{i} at {r} rows", a, b) for i, (a, b) in
                           enumerate(zip(got[2], want[2]))]
            y, de = fv.vg_forward_cuda(splan, sx[:r], spk)
            yp, dep, *_ = fv._forward_phases(splan, sx[:r], sws, sbs)
            errs["K3"] += [(f"y at {r} rows", y, yp), (f"de at {r} rows", de, dep)]
        xm, sm, dym = nx[:median], sx[:median], dy[:median]
        timed = {
            "K1": (k1_ms(nplan, xm, npk, 20),
                   cuda_ms(lambda: fm._forward_rows(nplan, xm, nws, nbs), 20),
                   bound_ms(2.0 * nplan.n_weights() * median,
                            4.0 * (median * (nplan.dims[0] + nplan.out_dim) + nplan.n_weights()))),
            "K2": (cuda_ms(lambda: fm.mlp_backward_cuda(nplan, xm, npk, dym, False), 20),
                   cuda_ms(lambda: fm._backward_rows(nplan, xm, nws, nbs, dym, False), 20),
                   k2_bound(nplan, median, False)),
            "K3": (k3_ms(splan, sm, spk, 20),
                   cuda_ms(lambda: fv._forward_phases(splan, sm, sws, sbs), 20),
                   bound_ms(4.0 * splan.n_weights() * median,
                            4.0 * (median * (2 * splan.dims[0] + splan.out_dim)
                                   + splan.n_weights())))}
    what = {"K1": ("K1 fused_mlp trunk forward, CESR normal_net plan (width 520 build)",
                   "fused_mlp.cu", "render/pallas/fused_mlp.py:111"),
            "K2": ("K2 fused_mlp recompute backward (dW, db), CESR normal_net",
                   "fused_mlp.cu", "render/pallas/fused_mlp.py:157"),
            "K3": ("K3 fused_value_grad forward (value + d sdf/dx), CESR geometry normals",
                   "fused_value_grad.cu", "render/pallas/fused_value_grad.py:131")}
    entries = {}
    for kernel, (name, src, tpu) in what.items():
        ms, plain, bound = timed[kernel]
        entries[f"{kernel} cesr rows"] = dict(
            name=f"{name}, grid tracer at the shaded rows ({counts_run[0]}-{counts_run[-1]}; "
                 f"timed at the median)",
            route="cuda", source=f"robir_tpu_torch/csrc/{src}", replaces=f"robir_tpu/{tpu}",
            max_abs_err=held_to_plain(f"{kernel} at the CESR run's rows", errs[kernel]),
            ms=ms, plain_ms=plain, bound_ms=bound[0], bound_by=bound[1], library_ms=None,
            rows=median, kernel=kernel, path="cesr", shape=None)
    print(f"CESR run's shaded row counts (K1, K2 and K3 held to their plain versions at "
          f"each): {counts_run}", flush=True)
    report(entries)
    return entries


def drive_mesh(trainer, mesh_cfg, out_dir: str):
    """The mesh export (path ``mesh``): ``NeusTrainer.extract_mesh`` of the
    NeuS stage 1 just trained, at ``mesh_cfg`` (the ``mesh`` section of
    configs/neus_blender.json), with the counts set to 0 just before: one
    K1 launch per MESH_CHUNK grid nodes and nothing else. Times the whole
    call and, inside it, the SDF grid (the card) and the host marching
    tetrahedra (``timed_calls``). Writes the PLY into ``out_dir`` and
    reads it back equal; holds K1 to its plain version on a chunk from the
    grid's middle. Returns (the launches by shape, the PLY's path, the
    kernel entries)."""
    R, bb = mesh_cfg.resolution, trainer.train_cfg.mesh_bbox
    box = (tuple(mesh_cfg.bbox_min), tuple(mesh_cfg.bbox_max))
    if box != ((-bb,) * 3, (bb,) * 3):
        raise RuntimeError(f"the mesh section's box {box} is not the trainer's +-{bb}")
    n, chunk = R ** 3, tmesh.MESH_CHUNK
    want = {k: {} for k in KERNELS}
    want["K1"] = {(fm.MAX_WIDTH, chunk): -(-n // chunk)}
    torch.cuda.synchronize()
    reset_counts()
    with timed_calls(tmesh, {"sdf_grid": "grid", "marching_tetrahedra": "mt"}) as secs:
        t0 = time.perf_counter()
        mesh = trainer.extract_mesh(R)
        total_s = time.perf_counter() - t0
    run = shapes()
    if run != want:
        raise RuntimeError(f"mesh export launches {run}, expected {want}")
    if len(mesh.tris) == 0 or not np.isfinite(mesh.verts).all():
        raise RuntimeError(f"the mesh export gave {len(mesh.tris)} triangles or non-finite "
                           f"vertices")
    path = os.path.join(out_dir, "mesh.ply")
    mesh.export_ply(path)
    back = tmesh.Mesh.load_ply(path)
    if not (np.array_equal(back.verts, mesh.verts) and np.array_equal(back.tris, mesh.tris)):
        raise RuntimeError("the PLY read back differs from the mesh written")
    lo, hi = mesh.bounds()
    print(f"mesh export (NeusTrainer.extract_mesh at the mesh section): {R}^3 = {n} nodes over "
          f"[{box[0][0]}, {box[1][0]}]^3, {total_s:.3f} s wall; in it, the SDF grid "
          f"{secs['grid']:.3f} s (K1 launches by (build width, rows) {want['K1']}, the grid "
          f"copied to the host), marching tetrahedra {secs['mt']:.3f} s on the host; "
          f"{len(mesh.verts)} vertices, "
          f"{len(mesh.tris)} triangles, bounds ({', '.join(f'{v:.4f}' for v in lo)}) .. "
          f"({', '.join(f'{v:.4f}' for v in hi)}); PLY {os.path.getsize(path)} bytes, read back "
          f"equal",
          flush=True)
    axes = [np.linspace(np.float32(box[0][i]), np.float32(box[1][i]), R, dtype=np.float32)
            for i in range(3)]
    start = max(0, min(n // 2, n - chunk))
    idx = np.arange(start, min(start + chunk, n))
    pts = torch.as_tensor(np.stack([axes[0][idx // (R * R)], axes[1][(idx // R) % R],
                                    axes[2][idx % R]], -1), device="cuda")
    entries = k1_chunk_entry(trainer.model_cfg.sdf, trainer.model.params["sdf_network"], pts,
                             "the mesh grid", "mesh")
    return run, path, entries


def bake_texture(mesh_path: str, resolution: int, model, mesh_cfg, seed: int):
    """The texture bake of ``mesh_path`` at ``resolution``: ``TexSampler``,
    with its parts timed inside it (``timed_calls`` on the pipeline's
    calls): the atlas, the vertex, normal and mask maps rasterised, written
    as EXR into the cache beside the mesh and read back, the five erode
    passes. Checks TEX_CHECK_SAMPLES samples: at least TEX_MIN_MASKED of
    them masked in, and ``model`` (the stage-2 model of the frozen NeuS)
    reads a median |sdf| at the masked ones, in stage-2 coordinates, below
    one cell of the mesh grid there (a wrong stage-1 -> stage-2 scale puts
    them off the surface). Returns the TexSampler."""
    parts = {"atlas_parameterize": "atlas", "rasterize_attributes": "rasterise",
             "write_exr": "EXR write", "read_exr": "EXR read", "erode_map": "erode x5"}
    with timed_calls(tpipe, parts) as secs:
        t0 = time.perf_counter()
        ts = tpipe.TexSampler(mesh_path, resolution)
        total_s = time.perf_counter() - t0
    s = ts.sample(np.random.default_rng(seed), TEX_CHECK_SAMPLES)
    masked = s["object_mask"]
    with torch.no_grad():
        sdf = model.frozen_sdf()(torch.as_tensor(s["x"][masked], dtype=torch.float32,
                                                 device="cuda"))
    med = float(sdf.abs().median()) if masked.any() else float("inf")
    span = np.max(np.subtract(mesh_cfg.bbox_max, mesh_cfg.bbox_min))
    cell = float(span / (mesh_cfg.resolution - 1) / model.cfg.coord_scale)
    print(f"texture bake at {resolution}^2 (host): TexSampler {total_s:.3f} s, in it " + ", ".join(
        f"{k} {v:.3f} s" for k, v in secs.items()) + f"; {float(ts.mask.mean()):.4f} of the "
        f"texels masked in", flush=True)
    print(f"texture samples: {int(masked.sum())} of {TEX_CHECK_SAMPLES} masked in "
          f"({float(masked.mean()):.4f}, at least {TEX_MIN_MASKED}); the frozen NeuS at them "
          f"(stage-2 coordinates, x {ts.coord_scale}): median |sdf| {med:.6f}, max "
          f"{float(sdf.abs().max()) if masked.any() else float('inf'):.6f}, bound one mesh-grid "
          f"cell {cell:.6f}", flush=True)
    if not masked.mean() >= TEX_MIN_MASKED:
        raise RuntimeError(f"only {float(masked.mean()):.4f} of the texture samples masked in")
    if not med < cell:
        raise RuntimeError(f"the texture samples lie off the frozen NeuS's surface: median "
                           f"|sdf| {med:.6f} >= {cell:.6f}")
    return ts


def check_norm_step_against_cpu(cfg, stage, params, seed: int) -> None:
    """One full-width Norm step (``norm_loss`` and its gradients) on the
    card (fp32) and the CPU (fp32, fp64) on one batch and one draw, at
    cur_iter 0 and at smooth_after + 1 (the smoothness term on): each
    metric and each gradient of the normal decoder, against fp64, within
    LOSS_RTOL (GRAD_TOL of its largest entry for a gradient) or, where fp32
    itself does worse, CESR_FP32_FACTOR x the CPU fp32 step's own distance.
    The batch is seeded, not sampled from the exported mesh (whose NeuS
    stage 1 trained through K4's atomics, in an order that changes between
    runs): points on the shadow scene's larger sphere with its normals, a
    third of them masked out. The step runs no kernel of the port (it must
    launch none), so there is no planted kernel fault."""
    n = stage.num_pixels
    rng = np.random.default_rng(seed)
    d = rng.standard_normal((n, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    center, radius = SHADOW_SPHERES[0]
    tb = {"points": torch.as_tensor(np.float32(center) + np.float32(radius) * d,
                                    dtype=torch.float32),
          "normals": torch.as_tensor(d, dtype=torch.float32),
          "object_mask": torch.as_tensor(rng.random(n) > 1 / 3)}
    noise = torch.randn(cfg.envmap.normal_ae.noise_shape(n),
                        generator=torch.Generator().manual_seed(seed))
    sides = (("cpu", torch.float32), ("cuda", torch.float32), ("cpu", torch.float64))
    runners = {side: NormRunner(cfg, params, None, stage, seed=seed, device=side[0])
               for side in sides}
    runners["cpu", torch.float64].params.to(torch.float64)
    names = [k for k, p in flatten_with_paths(runners["cpu", torch.float32].params).items()
             if p.requires_grad]

    def step(dev: str, dtype, cur_iter: int) -> tuple:
        runner = runners[dev, dtype]
        torch.set_default_dtype(dtype)
        try:
            inp = {k: v.to(dev, dtype) if v.is_floating_point() else v.to(dev)
                   for k, v in tb.items()}
            loss, metrics = norm_loss(runner.params, cfg, stage, inp, cur_iter,
                                      Draws(given={"normal_ae": noise}, device=dev))
            grads = torch.autograd.grad(loss, runner.trainable)
        finally:
            torch.set_default_dtype(torch.float32)
        return ({k: float(v) for k, v in metrics.items()},
                [g.to("cpu", torch.float64) for g in grads])

    def rel(a, ref):
        return float((a - ref).abs().max()) / max(float(ref.abs().max()), 1e-30)

    for cur_iter in (0, stage.smooth_after + 1):
        m32, g32 = step("cpu", torch.float32, cur_iter)
        m64, g64 = step("cpu", torch.float64, cur_iter)
        torch.cuda.synchronize()
        reset_counts()
        m_gpu, g_gpu = step("cuda", torch.float32, cur_iter)
        if any(counts().values()):
            raise RuntimeError(f"the Norm step launched {counts()}")
        over = {}
        for k in m64:
            err, own = abs(m_gpu[k] - m64[k]), abs(m32[k] - m64[k])
            over[k] = err / max(LOSS_RTOL * abs(m64[k]), CESR_FP32_FACTOR * own, 1e-30)
        errs = {nm: (rel(a, r), rel(c, r)) for nm, a, c, r in zip(names, g_gpu, g32, g64)}
        for nm, (e, own) in errs.items():
            over[nm] = e / max(GRAD_TOL, CESR_FP32_FACTOR * own)
        worst = max(over, key=over.get)
        print(f"Norm step check at cur_iter {cur_iter} ({n} points on a sphere, "
              f"{int(tb['object_mask'].sum())} masked in; no kernel of the port runs in the "
              f"step, so no planted fault): loss card {m_gpu['loss']:.8f}, CPU fp32 "
              f"{m32['loss']:.8f}, fp64 {m64['loss']:.8f}; normal_loss card "
              f"{m_gpu['normal_loss']:.8f}, fp64 {m64['normal_loss']:.8f}; smooth_loss card "
              f"{m_gpu['smooth_loss']:.6e}, CPU fp32 {m32['smooth_loss']:.6e}, fp64 "
              f"{m64['smooth_loss']:.6e}; {len(errs)} gradient tensors", flush=True)
        for nm in sorted(errs, key=over.get)[-3:]:
            print(f"  {nm:60s} card vs fp64 {errs[nm][0]:.3e}, CPU fp32 vs fp64 "
                  f"{errs[nm][1]:.3e}", flush=True)
        print(f"Norm step check worst at cur_iter {cur_iter}: {worst} at {over[worst]:.3f} of "
              f"its bound", flush=True)
        if not over[worst] <= 1.0:
            raise RuntimeError(f"Norm step at cur_iter {cur_iter}: {worst} on the card is "
                               f"{over[worst]:.3f}x its bound")


def drive_norm(runner, profile: int = 0):
    """The Norm run (path ``norm``): NORM_TIMED_STEPS ``NormRunner`` steps
    on the card, each timed with CUDA events around ``run(1)`` (its host
    batch included), the host batch timed alone besides; then on, untimed,
    to NORM_STEPS. The counts are set to 0 just before: the run may launch
    no kernel of the port. ``normal_loss`` must fall from step 1 to the
    last. Returns the launches by shape. Then, if ``profile``, profiles
    that many more steps."""
    stage = runner.stage_cfg
    if NORM_STEPS > stage.smooth_after + 1:
        raise RuntimeError("the Norm run would cross smooth_after")
    losses, step_ms = {}, []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    for _ in range(NORM_TIMED_STEPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        m = runner.run(1)
        end.record()
        torch.cuda.synchronize()
        step_ms.append(start.elapsed_time(end))
        losses[runner.cur_iter] = m
    t0 = time.perf_counter()
    losses[NORM_STEPS] = runner.run(NORM_STEPS - runner.cur_iter)
    torch.cuda.synchronize()
    rest_s = time.perf_counter() - t0
    run = shapes()
    peak = torch.cuda.max_memory_allocated() / 2**30
    if any(n for by in run.values() for n in by.values()):
        raise RuntimeError(f"the Norm run launched {run}")
    batch_ms = []
    for _ in range(NORM_TIMED_STEPS):
        t0 = time.perf_counter()
        runner._batch()
        torch.cuda.synchronize()
        batch_ms.append(1e3 * (time.perf_counter() - t0))
    if profile:
        profile_steps(runner.run, profile, "Norm")
    for it, m in losses.items():
        if not all(np.isfinite(v) for v in m.values()):
            raise RuntimeError(f"Norm step {it}: non-finite {m}")
    first, mid, last = losses[1], losses[NORM_TIMED_STEPS], losses[NORM_STEPS]
    steady = step_ms[2:]
    print(f"Norm run ({stage.num_pixels} texture samples a step, lr {stage.opt.lr}): "
          f"normal_loss at step 1 {first['normal_loss']:.6f}, step {NORM_TIMED_STEPS} "
          f"{mid['normal_loss']:.6f}, step {NORM_STEPS} {last['normal_loss']:.6f} (smooth_loss "
          f"{last['smooth_loss']:.3e}, in the loss from cur_iter {stage.smooth_after + 1} on); no "
          f"kernel of the port launched", flush=True)
    print(f"Norm step: median {float(np.median(steady)):.3f} ms, mean "
          f"{float(np.mean(steady)):.3f} ms over steps 3-{NORM_TIMED_STEPS} (CUDA events around "
          f"NormRunner.run(1), its host batch included); first step {step_ms[0]:.3f} ms; the "
          f"host batch alone (NormRunner._batch: simple_data_batch and the copy to the card) "
          f"median "
          f"{float(np.median(batch_ms)):.3f} ms; steps {NORM_TIMED_STEPS + 1}-{NORM_STEPS} "
          f"{rest_s:.3f} s wall; peak device memory {peak:.3f} GiB", flush=True)
    if not last["normal_loss"] < first["normal_loss"]:
        raise RuntimeError(f"normal_loss did not fall: {first['normal_loss']} -> "
                           f"{last['normal_loss']}")
    return run


def vis_runner_from_norm(cfg, params, dataset, stage, seed: int, norm_runner, norm_path: str):
    """``VisRunner`` on ``params`` with the Norm checkpoint's normal decoder
    restored into them before the runner is built, as
    ``robir_tpu/cli.py:cmd_vis`` does: every leaf must be the Norm
    runner's, bit for bit (it trained the decoder alone), and the decoder
    must differ from the init's."""
    keep = lambda p: "normal_decoder_layer" in p  # noqa: E731
    vis_params, _ = ckpt_lib.restore_into(params, norm_path, keep=keep)
    runner = VisRunner(cfg, vis_params, dataset, stage, seed=seed, device="cuda")
    got, want = flat_leaves(runner), flat_leaves(norm_runner)
    init = flatten_with_paths(params)
    wrong = [k for k in got if not torch.equal(got[k], want[k])]
    same = [k for k in got if keep(k) and np.array_equal(got[k].cpu().numpy(),
                                                           np.asarray(init[k]))]
    if wrong or got.keys() != want.keys() or same:
        raise RuntimeError(f"the Vis parameters from the Norm checkpoint: leaves {wrong[:5]} "
                           f"differ from the Norm runner's, {same[:5]} are the init's")
    print(f"VisRunner from the Norm checkpoint {os.path.basename(norm_path)} (cmd_vis's restore "
          f"before the runner): {sum(keep(k) for k in got)} normal_decoder_layer leaves and the "
          f"other {sum(not keep(k) for k in got)} bit-equal to the Norm runner's", flush=True)
    return runner


def seeded_neus(model_cfg, seed: int) -> dict:
    """A NeuS that no kernel with a run-dependent summation order produced:
    the seeded init, carried through the weights bridge (numpy, JAX
    layout). The step checks trace and shade it, so that their inputs are
    the same in every run."""
    return to_numpy(init_neus(torch.Generator().manual_seed(seed), model_cfg))


def two_sphere_sdf(x: torch.Tensor) -> torch.Tensor:
    """The analytic sdf of the shadow scene's two spheres in stage-2
    coordinates."""
    return torch.stack([torch.linalg.norm(x - torch.tensor(c, device=x.device), dim=-1) - r
                        for c, r in SHADOW_SPHERES]).amin(0)


def vis_fan_k3_launches(need: int, chunk: int) -> dict:
    """K3's launches by (build width, rows) of one Vis step whose fan needed
    colour on ``need`` rays: one per slice of ``chunk`` rays, 16 sample rows
    a ray; one at 16 rows where none is needed (compaction runs row 0)."""
    out = {}
    for i in range(0, max(need, 1), chunk):
        shape = (fm.MAX_WIDTH, 16 * min(chunk, max(need, 1) - i))
        out[shape] = out.get(shape, 0) + 1
    return out


def check_vis_march(runner, seed: int) -> dict:
    """The grid-march kernel against its plain version on the Vis stage's
    own rays: the 256 primary rays of a batch on the baked grid, then the
    fan of 131,072 secondary rays from their offset origins
    (``secondary_fan``, which the step traces). Returns their entries."""
    stage, R = runner.stage_cfg, runner.cfg.grid.resolution
    rng = np.random.default_rng(seed + 1)
    b = runner.dataset.sample_pixels(rng, int(rng.integers(runner.dataset.n_cameras)),
                                     stage.num_pixels)
    b["hdr_shift"] = rng.random((stage.num_pixels, 1)).astype(np.float32)
    inp = {k: torch.as_tensor(b[k], device="cuda") for k in VIS_BATCH_KEYS}
    model = Stage2Model(runner.params, runner.cfg, "cuda", runner.grid_values)
    draws = Draws(torch.Generator(device="cuda").manual_seed(seed), device="cuda")
    with torch.no_grad():
        fwd = stage2_forward(model, draws, inp, trainstage="Illum")
        fan = secondary_fan(model, draws, fwd, stage.nsamp)
    entries = {}
    for what, (o, d) in (("primary", (inp["points"], inp["dirs"])),
                         ("fan", (fan["origins"], fan["dirs"]))):
        e = hold_march(runner.grid_values, runner.cfg.grid, o, d, f"the Vis {what} rays")
        entries[f"march vis {what}"] = dict(
            e, name=f"grid march (march + refine, one thread a ray), the Vis {what} rays",
            path="vis", shape=(R, e["rows"]))
    print(f"Vis fan of that batch: {int(fwd['network_object_mask'].sum())} surface pixels, "
          f"{int((~fan['back_cull']).sum())} rays front facing of {fan['dirs'].shape[0]}",
          flush=True)
    return entries


def check_borrow_color(runner, gen) -> dict:
    """``borrow_color`` on a realistic fan: VIS_BORROW_RAYS rays from points
    where the scene's cameras' object pixels hit the baked grid, in uniform
    directions, in slices of ``fan_compact_chunk`` rays as the step runs it.
    The card's colour (K3) against the same call with K3's plain version,
    within KERNEL_TOL of its largest entry; the whole call and K3 on one
    full slice timed, the peak memory of the call. A check off the main
    path: the driven Vis steps need far fewer rays (``check_vis_path_kernels``
    holds K3 at their shapes). Returns K3's entry at that slice."""
    ds, chunk = runner.dataset, runner.stage_cfg.fan_compact_chunk
    model = Stage2Model(runner.params, runner.cfg, "cuda", runner.grid_values)
    hits = []
    with torch.no_grad():
        for cam in range(ds.n_cameras):
            b = ds.pixels(cam, np.flatnonzero(ds.object_masks[cam]))
            _, hit, x = model.trace(torch.as_tensor(b["points"], device="cuda"),
                                    torch.as_tensor(b["dirs"], device="cuda"))
            hits.append(x[hit])
    pts = torch.cat(hits)
    x = pts[torch.randint(pts.shape[0], (VIS_BORROW_RAYS,), generator=gen, device="cuda")]
    d = torch.randn(VIS_BORROW_RAYS, 3, generator=gen, device="cuda")
    d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    real = fv.vg_forward_cuda
    slices = []

    def recorded(plan, xs, packed):
        slices.append((plan, xs, packed))
        return real(plan, xs, packed)

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    try:
        fv.vg_forward_cuda = recorded
        with torch.no_grad():
            got = model.borrow_color(x, -d, chunk)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        fv.vg_forward_cuda = plain_k3
        with torch.no_grad():
            want = model.borrow_color(x, -d, chunk)
            plain_call = cuda_ms(lambda: model.borrow_color(x, -d, chunk), 1)
    finally:
        fv.vg_forward_cuda = real
    with torch.no_grad():
        call = cuda_ms(lambda: model.borrow_color(x, -d, chunk), 3)
    err_call = held_to_plain(f"borrow_color at {VIS_BORROW_RAYS} rays", [("colour", got, want)])
    plan, xs, packed = slices[0]
    ws, bs = fm.unpack_grads(packed.W, packed.b, plan)
    rows = xs.shape[0]
    with torch.no_grad():
        y, de = fv.vg_forward_cuda(plan, xs, packed)
        yp, dep, *_ = fv._forward_phases(plan, xs, ws, bs)
        err = held_to_plain(f"K3 on a borrowed-colour slice ({rows} rows)",
                            [("y", y, yp), ("de", de, dep)])
        del y, de, yp, dep
        ms = k3_ms(plan, xs, packed, 10)
        plain = cuda_ms(lambda: fv._forward_phases(plan, xs, ws, bs), 3)
    nw = plan.n_weights()
    nb = sum(plan.layer_out_dim(i) for i in range(plan.n_layers))
    bound = bound_ms(4.0 * nw * rows,
                     4.0 * (rows * (2 * plan.dims[0] + plan.out_dim) + nw + nb))
    print(f"borrow_color at {VIS_BORROW_RAYS} rays from {pts.shape[0]} surface points of "
          f"{ds.n_cameras} cameras, slices of {chunk}: {len(slices)} K3 launches of "
          f"{rows} rows; colour within {err_call:.3e} of the plain version's (largest entry "
          f"{float(want.abs().max()):.4f}); the call {call:.3f} ms (with K3's plain version "
          f"{plain_call:.3f} ms); K3 on one slice {ms:.3f} ms (plain {plain:.3f} ms, bound "
          f"{bound[0]:.3f} ms by {bound[1]}); peak device memory {peak / 2**30:.2f} GiB, "
          f"{(peak - base) / 2**30:.2f} GiB above what was held before the call", flush=True)
    if len(slices) != -(-VIS_BORROW_RAYS // chunk):
        raise RuntimeError(f"borrow_color launched K3 {len(slices)} times")
    return {"K3 vis borrow check": dict(
        name=f"K3 fused_value_grad forward (value + d sdf/dx), borrow_color on a full slice "
             f"of {chunk} rays, no graph (a check off the main path)",
        route="cuda", source="robir_tpu_torch/csrc/fused_value_grad.cu",
        replaces="robir_tpu/render/pallas/fused_value_grad.py:131", max_abs_err=err, ms=ms,
        plain_ms=plain, bound_ms=bound[0], bound_by=bound[1], library_ms=None, rows=rows,
        kernel="K3", path=None, shape=None)}


def check_vis_path_kernels(runner, run: dict, gen) -> dict:
    """K3 at the SDF trunk's plan against its plain version at every row
    count the driven Vis run launched it at (``run``: its launches by
    shape), timed at the launches' median (the lower one, a row count the
    run launched); returns its entry, which counts the run's K3 launches
    at every row count."""
    plan = fm.plan_from_sdf_config(runner.cfg.neus.sdf)
    launched = sorted(r for (_, r), k in run["K3"].items() for _ in range(k))
    counts_run = sorted(set(launched))
    median = launched[(len(launched) - 1) // 2]
    x, ws, bs = trunk_inputs(plan, runner.cfg.neus.sdf.pe, counts_run[-1], gen)
    pk = fm.pack_weights(plan, ws, bs, reverse=True)
    slices = [(plan, x[:r], pk) for r in counts_run]
    entries = {"K3 vis rows": k3_entry(
        f"the Vis borrowed colour at the run's rows ({counts_run[0]}-{counts_run[-1]}; timed "
        f"at the median)", slices, "vis", counts_run.index(median))}
    print(f"Vis run's K3 row counts (16 a needed ray; held to its plain version at each): "
          f"{counts_run}", flush=True)
    report(entries)
    return entries


def check_vis_step_against_cpu(cfg, stage, dataset, params, seed: int, grid,
                               planted=None) -> None:
    """One full-width Vis step (VIS_CHECK_PIXELS on and off the object x 512
    directions) on the card against the same step on the CPU in fp32 and in
    fp64 (the visibility and colour nets without their bf16 storage), from
    the same weights and batch, the CPU's primary and secondary traces of
    ``grid`` (the same values on each side) and every draw shared (the
    CPU's, replayed): both losses to LOSS_RTOL of the CPU fp32 step's, and
    each trainable gradient to fp64 within CESR_GRAD_TOL of its largest
    entry or CESR_FP32_FACTOR x the CPU fp32 step's own distance.

    Then a planted fault: the card's step again with K3 blind to the first
    row tile of each launch of the borrowed colour (its outputs zeroed
    there, as a kernel that skipped the tile would leave them), or, with
    ``planted`` = (what, change), on the config ``change(cfg)``; the loss
    or gradient bounds must reject it."""
    cfg = dataclasses.replace(
        cfg, visnet=dataclasses.replace(cfg.visnet, storage_dtype=None),
        neus=dataclasses.replace(cfg.neus, color=dataclasses.replace(cfg.neus.color,
                                                                     storage_dtype=None)))
    on, off = VIS_CHECK_PIXELS
    stage = dataclasses.replace(stage, num_pixels=on + off)
    rng = np.random.default_rng(seed)
    mask = dataset.object_masks[0]
    b = dataset.pixels(0, np.concatenate([rng.choice(np.flatnonzero(mask), on, replace=False),
                                          rng.choice(np.flatnonzero(~mask), off, replace=False)]))
    b["hdr_shift"] = rng.random((on + off, 1)).astype(np.float32)
    tb = {k: torch.as_tensor(b[k]) for k in VIS_BATCH_KEYS}
    sides = (("cpu", torch.float32), ("cuda", torch.float32), ("cpu", torch.float64))
    runners = {side: VisRunner(cfg, params, dataset, stage, seed=seed, device=side[0])
               for side in sides}
    runners["cpu", torch.float64].params.to(torch.float64)
    grids = {"cpu": grid.cpu(), "cuda": grid}
    cpu = Stage2Model(runners["cpu", torch.float32].params, cfg, "cpu", grids["cpu"])
    card = Stage2Model(runners["cuda", torch.float32].params, cfg, "cuda", grid)
    draws = Draws(torch.Generator().manual_seed(seed), record=True)
    with torch.no_grad():
        traced = cpu.trace(tb["points"], tb["dirs"])[:2]
        own = card.trace(tb["points"].cuda(), tb["dirs"].cuda())[1].cpu()
        fwd = stage2_forward(cpu, draws, tb, trainstage="Illum", traced=traced)
        fan = secondary_fan(cpu, draws, fwd, stage.nsamp)
        fan_traced = cpu.trace(fan["origins"], fan["dirs"])
        own_fan = card.trace(fan["origins"].cuda(), fan["dirs"].cuda())[1].cpu()
    taken = draws.taken
    print(f"Vis step check ({on} + {off} pixels x {stage.nsamp} directions, the two-sphere "
          f"grid): the card's own traces vs the CPU's: {int((own != traced[1]).sum())} of "
          f"{on + off} primary and {int((own_fan != fan_traced[1]).sum())} of "
          f"{fan_traced[1].numel()} fan hit flags differ; every side shades the CPU's "
          f"({int((traced[1] & tb['object_mask']).sum())} surface pixels, "
          f"{int(fan_traced[1].sum())} fan hits)", flush=True)
    names = [n for n, p in runners["cpu", torch.float32].params.named_parameters()
             if p.requires_grad]

    def step(dev: str, dtype=torch.float32, run_cfg=cfg) -> tuple:
        runner = runners[dev, dtype]
        torch.set_default_dtype(dtype)
        try:
            inp = {k: v.to(dev, dtype) if v.is_floating_point() else v.to(dev)
                   for k, v in tb.items()}
            t0 = time.perf_counter()
            k3 = K3.launches
            loss, metrics = vis_loss(
                runner.params, run_cfg, stage, inp, Draws(given=taken, device=dev), grids[dev],
                traced=(traced[0].to(dev, dtype), traced[1].to(dev)),
                fan_traced=(fan_traced[0].to(dev, dtype), fan_traced[1].to(dev),
                            fan_traced[2].to(dev, dtype)))
            grads = torch.autograd.grad(loss, runner.trainable, materialize_grads=True)
            secs = time.perf_counter() - t0
        finally:
            torch.set_default_dtype(torch.float32)
        return ({k: float(v) for k, v in metrics.items()},
                [g.to("cpu", torch.float64) for g in grads], secs, K3.launches - k3)

    real = fv.vg_forward_cuda
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    def blind_to_first_tile(plan, x, packed):
        y, de = real(plan, x, packed)
        tile = 64 if x.shape[0] >= VG_TALL_ROWS_PER_SM * sms else 16
        y[:tile] = 0
        de[:tile] = 0
        return y, de

    m_cpu, g_cpu, s_cpu, _ = step("cpu")
    m64, g64, _, _ = step("cpu", torch.float64)
    m_gpu, g_gpu, _, k3_launches = step("cuda")
    if planted is None:
        fault_what = "K3 blind to the first row tile of each borrowed-colour launch"
        try:
            fv.vg_forward_cuda = blind_to_first_tile
            m_fault, g_fault, _, _ = step("cuda")
        finally:
            fv.vg_forward_cuda = real
    else:
        fault_what, change = planted
        m_fault, g_fault, _, _ = step("cuda", run_cfg=change(cfg))

    def rel(a, ref):
        return float((a - ref).abs().max()) / max(float(ref.abs().max()), 1e-30)

    losses = ("radiance_loss", "visibility_loss")
    loss_over = {k: abs(m_gpu[k] - m_cpu[k]) / (LOSS_RTOL * abs(m_cpu[k])) for k in losses}
    errs = {n: (rel(a, r), rel(c, r), rel(a, c)) for n, a, c, r in zip(names, g_gpu, g_cpu, g64)}
    bound = {n: max(CESR_GRAD_TOL, CESR_FP32_FACTOR * e[1]) for n, e in errs.items()}
    over = {n: errs[n][0] / bound[n] for n in errs}
    need = int(m_gpu["fan_need"])
    print(f"Vis step on the card vs the CPU: radiance loss card {m_gpu['radiance_loss']:.8f}, "
          f"CPU fp32 {m_cpu['radiance_loss']:.8f}, fp64 {m64['radiance_loss']:.8f}; visibility "
          f"loss {m_gpu['visibility_loss']:.8f}, {m_cpu['visibility_loss']:.8f}, "
          f"{m64['visibility_loss']:.8f}; confidences lit/occluded card "
          f"{m_gpu['vis_conf_lit']:.5f}/{m_gpu['vis_conf_occ']:.5f}; needed rays card "
          f"{need}, CPU {int(m_cpu['fan_need'])}, fp64 {int(m64['fan_need'])} ({k3_launches} K3 "
          f"launches); {len(errs)} tensors; CPU fp32 step {s_cpu:.1f} s", flush=True)
    for n in sorted(over, key=over.get)[-6:]:
        print(f"  {n:50s} card vs fp64 {errs[n][0]:.3e}, CPU fp32 vs fp64 {errs[n][1]:.3e}, "
              f"bound {bound[n]:.3e}", flush=True)
    worst = max(over, key=over.get)
    print(f"Vis step check worst: gradient {worst} at {over[worst]:.3f} of its bound; losses "
          + ", ".join(f"{k} at {v:.3f} of LOSS_RTOL" for k, v in loss_over.items()), flush=True)
    fault = {k: abs(m_fault[k] - m_cpu[k]) / (LOSS_RTOL * abs(m_cpu[k])) for k in losses}
    fault.update({n: rel(a, r) / bound[n] for n, a, r in zip(names, g_fault, g64)})
    caught = max(fault, key=fault.get)
    print(f"planted fault ({fault_what}): worst {caught} {fault[caught]:.1f}x its bound",
          flush=True)
    if need == 0:
        raise RuntimeError("the Vis step check needed no borrowed colour")
    if not max(loss_over.values()) <= 1.0:
        raise RuntimeError(f"Vis losses on the card {m_gpu} vs CPU {m_cpu}")
    if not over[worst] <= 1.0:
        raise RuntimeError(f"Vis gradient {worst}: card vs fp64 {errs[worst][0]:.3e} of its "
                           f"largest entry > bound {bound[worst]:.3e}")
    if not fault[caught] > 1.0:
        raise RuntimeError(f"the Vis step's bounds passed the planted fault ({fault_what})")


def drive_vis(runner, steps: int, profile: int = 0):
    """``steps`` VisRunner steps on the card with the counts set to 0 just
    before. Each step's line gives its time, both losses and confidences,
    the surface pixels and the fan's rays that face the front, that hit and
    whose colour was borrowed. Each step must launch the grid march twice
    (the batch's rays and the fan's) and K3 once per slice of needed rays
    (``vis_fan_k3_launches``); K1, K2 and K4 never. Returns the launches by
    shape. Then, if ``profile``, profiles that many more steps."""
    stage, R = runner.stage_cfg, runner.cfg.grid.resolution
    n, fan = stage.num_pixels, stage.num_pixels * stage.nsamp
    want = {k: {} for k in KERNELS}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_ms = []
    reset_counts()
    for _ in range(steps):
        it = runner.cur_iter
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        m = runner.run(1)
        end.record()
        torch.cuda.synchronize()
        step_ms.append(start.elapsed_time(end))
        bad = {k: v for k, v in m.items() if not np.isfinite(v)}
        if bad:
            raise RuntimeError(f"Vis step {it}: non-finite {bad}")
        for shape in ((R, n), (R, fan)):
            want["march"][shape] = want["march"].get(shape, 0) + 1
        for shape, k in vis_fan_k3_launches(int(m["fan_need"]),
                                            stage.fan_compact_chunk).items():
            want["K3"][shape] = want["K3"].get(shape, 0) + k
        print(f"Vis step {it:2d}: {step_ms[-1]:8.3f} ms, radiance loss "
              f"{m['radiance_loss']:.5f}, visibility loss {m['visibility_loss']:.5f}, confidence "
              f"lit {m['vis_conf_lit']:.4f} occluded {m['vis_conf_occ']:.4f}; "
              f"{int(m['surface_pixels'])} surface pixels; fan of {fan}: "
              f"{int(m['fan_front'])} front facing, {int(m['fan_hits'])} hit, "
              f"{int(m['fan_need'])} needed colour", flush=True)
    run = shapes()
    peak = torch.cuda.max_memory_allocated() / 2**30
    if profile:
        profile_steps(runner.run, profile, "Vis")
    if run != want:
        raise RuntimeError(f"Vis launches {run}, expected {want}")
    steady = step_ms[2:] or step_ms
    print(f"Vis step ({n} pixels x {stage.nsamp} directions, grid {R}^3, fan_compact_chunk "
          f"{stage.fan_compact_chunk}): median {float(np.median(steady)):.3f} ms, mean "
          f"{float(np.mean(steady)):.3f} ms over steps 3-{steps} (CUDA events around "
          f"VisRunner.run(1)); first step {step_ms[0]:.3f} ms; peak device memory {peak:.2f} "
          f"GiB", flush=True)
    print(f"Vis launches over the {steps} steps by kernel and (width or grid resolution, rows): "
          f"{want}", flush=True)
    return run


def flat_leaves(runner) -> dict:
    """A copy of every leaf of ``runner``'s parameters, by path."""
    return {k: v.detach().clone() for k, v in flatten_with_paths(runner.params).items()}


def check_surgery(what: str, before: dict, after: dict, saved: dict, keep) -> int:
    """Raise unless every leaf of ``after`` is bit-equal to the file's
    (``saved``) where ``keep`` holds and to the receiver's own (``before``)
    elsewhere; returns the number of leaves kept."""
    wrong = [k for k in after if not torch.equal(after[k], saved[k] if keep(k) else before[k])]
    if wrong or after.keys() != before.keys():
        raise RuntimeError(f"{what}: leaves {wrong[:5]} are not as kept")
    return sum(keep(k) for k in after)


def check_vis_checkpoint(runner, cfg, params, stage, seed: int, log_dir: str) -> str:
    """``save`` after the steps (into ``log_dir``, where the PBR stage reads
    it); ``restore_latest`` into a fresh runner must give every leaf
    bit-equal; ``restore_surgical`` of the indirect net into another must
    change those leaves only. Returns the saved file."""
    runner.log_dir = log_dir
    path = runner.save()
    fresh = VisRunner(cfg, params, runner.dataset, stage, seed=seed, device="cuda",
                      log_dir=log_dir)
    if not fresh.restore_latest() or fresh.cur_iter != runner.cur_iter:
        raise RuntimeError("restore_latest found no checkpoint or another step")
    saved, restored = flat_leaves(runner), flat_leaves(fresh)
    differ = [k for k in saved if not torch.equal(saved[k], restored[k])]
    if differ or saved.keys() != restored.keys():
        raise RuntimeError(f"restore_latest: leaves differ: {differ[:5]}")
    surgical = VisRunner(cfg, params, runner.dataset, stage, seed=seed, device="cuda")
    before = flat_leaves(surgical)
    keep = lambda p: p.startswith("indirect_illum_network/")  # noqa: E731
    surgical.restore_surgical(path, keep)
    after = flat_leaves(surgical)
    check_surgery("restore_surgical", before, after, saved, keep)
    changed = sum(not torch.equal(after[k], before[k]) for k in after)
    print(f"checkpoint round trip: {os.path.basename(path)} and latest.npz, {len(saved)} leaves; "
          f"restore_latest bit-equal at step {fresh.cur_iter}; restore_surgical of "
          f"indirect_illum_network: {changed} leaves changed, "
          f"{sum(keep(k) for k in after)} kept, the rest as they were", flush=True)
    return path


def pbr_check_setting(cfg, stage, dataset, params, seed: int, tb: dict, traced, grids) -> dict:
    """One PBR step (``pbr_loss`` and its gradients) at ``stage``'s setting on
    the card (fp32) and the CPU (fp32, fp64) on one batch, trace and draws;
    then on the card with K3 blind to the first row tile of its launch (its
    outputs zeroed there). Returns the readings over their bounds: the
    metrics, the ``normals`` output, the worst gradient, and the planted
    fault's on the normals and the gradients."""
    sides = (("cpu", torch.float32), ("cuda", torch.float32), ("cpu", torch.float64))
    runners = {side: PBRRunner(cfg, params, dataset, stage, seed=seed, device=side[0])
               for side in sides}
    runners["cpu", torch.float64].params.to(torch.float64)
    names = [n for n, p in runners["cpu", torch.float32].params.named_parameters()
             if p.requires_grad]
    taken = None
    forward = pbr_mod.stage2_forward

    def step(dev: str, dtype=torch.float32) -> tuple:
        nonlocal taken
        runner, outs = runners[dev, dtype], []

        def recorded(*a, **kw):
            outs.append(forward(*a, **kw))
            return outs[-1]

        torch.set_default_dtype(dtype)
        try:
            pbr_mod.stage2_forward = recorded
            draws = (Draws(torch.Generator().manual_seed(seed), record=True) if taken is None
                     else Draws(given=taken, device=dev))
            inp = {k: v.to(dev, dtype) if v.is_floating_point() else v.to(dev)
                   for k, v in tb.items()}
            k3, t0 = K3.launches, time.perf_counter()
            loss, metrics = pbr_loss(runner.params, cfg, stage, inp, draws,
                                     traced=(traced[0].to(dev, dtype), traced[1].to(dev)),
                                     grid_values=grids[dev])
            grads = torch.autograd.grad(loss, runner.trainable, materialize_grads=True)
            secs = time.perf_counter() - t0
        finally:
            pbr_mod.stage2_forward = forward
            torch.set_default_dtype(torch.float32)
        if taken is None:
            taken = draws.taken
        return ({k: float(v) for k, v in metrics.items()},
                outs[0]["normals"].detach().to("cpu", torch.float64),
                [g.to("cpu", torch.float64) for g in grads], secs, K3.launches - k3)

    real = fv.vg_forward_cuda

    def blind_to_first_tile(plan, x, packed):
        y, de = real(plan, x, packed)
        y[:16] = 0  # below VG_TALL_ROWS_PER_SM rows a SM: 16-row tiles
        de[:16] = 0
        return y, de

    m_cpu, n_cpu, g_cpu, s_cpu, _ = step("cpu")
    m64, n64, g64, _, _ = step("cpu", torch.float64)
    m_gpu, n_gpu, g_gpu, _, k3_launches = step("cuda")
    try:
        fv.vg_forward_cuda = blind_to_first_tile
        _, n_fault, g_fault, _, _ = step("cuda")
    finally:
        fv.vg_forward_cuda = real

    def rel(a, ref):
        return float((a - ref).abs().max()) / max(float(ref.abs().max()), 1e-30)

    metric_over = {k: abs(m_gpu[k] - m_cpu[k]) / (LOSS_RTOL * abs(m_cpu[k]) + METRIC_FLOOR)
                   for k in m_cpu}
    n_bound = max(CESR_GRAD_TOL, CESR_FP32_FACTOR * rel(n_cpu, n64))
    errs = {n: (rel(a, r), rel(c, r)) for n, a, c, r in zip(names, g_gpu, g_cpu, g64)}
    bound = {n: max(CESR_GRAD_TOL, CESR_FP32_FACTOR * e[1]) for n, e in errs.items()}
    over = {n: errs[n][0] / bound[n] for n in errs}
    worst = max(over, key=over.get)
    fault_g = {n: rel(a, r) / bound[n] for n, a, r in zip(names, g_fault, g64)}
    caught = max(fault_g, key=fault_g.get)
    readings = {"metrics": max(metric_over.values()), "normals": rel(n_gpu, n64) / n_bound,
                "gradients": over[worst], "fault normals": rel(n_fault, n64) / n_bound,
                "fault gradients": fault_g[caught]}
    mode = (f"row mode (compact_chunk {stage.compact_chunk})" if stage.compact_chunk
            else "dense")
    print(f"PBR step check, {mode}, shading with the "
          f"{'AE normal map' if stage.use_normal_map else 'geometry normals'}: loss card "
          f"{m_gpu['loss']:.8f}, CPU fp32 {m_cpu['loss']:.8f}, fp64 {m64['loss']:.8f}; rgb_loss "
          f"{m_gpu['rgb_loss']:.8f}, PSNR {m_gpu['psnr']:.4f} dB; worst metric "
          f"{max(metric_over, key=metric_over.get)} at {readings['metrics']:.3f} of its bound; "
          f"normals card vs fp64 {rel(n_gpu, n64):.3e} (bound {n_bound:.3e}); worst gradient "
          f"{worst} at {over[worst]:.3f} of its bound; {k3_launches} K3 launch; CPU fp32 step "
          f"{s_cpu:.1f} s", flush=True)
    print(f"  planted fault (K3 blind to the first 16 rows of its launch): normals "
          f"{readings['fault normals']:.1f}x their bound, worst gradient {caught} "
          f"{fault_g[caught]:.1f}x its bound", flush=True)
    if k3_launches != 1:
        raise RuntimeError(f"the card's PBR step launched K3 {k3_launches} times, not once")
    if not readings["metrics"] <= 1.0:
        raise RuntimeError(f"PBR metrics on the card {m_gpu} vs CPU {m_cpu}")
    if not readings["normals"] <= 1.0:
        raise RuntimeError(f"PBR normals: card vs fp64 {rel(n_gpu, n64):.3e} > {n_bound:.3e}")
    if not readings["gradients"] <= 1.0:
        raise RuntimeError(f"PBR gradient {worst}: card vs fp64 {errs[worst][0]:.3e} of its "
                           f"largest entry > bound {bound[worst]:.3e}")
    if not readings["fault normals"] > 1.0:
        raise RuntimeError("the PBR normals bound passed the planted K3 fault")
    if not stage.use_normal_map and not readings["fault gradients"] > 1.0:
        raise RuntimeError("the PBR gradient bounds passed the planted K3 fault on the "
                           "geometry normals")
    return readings


def check_pbr_step_against_cpu(cfg, stage, dataset, params, seed: int, grid) -> None:
    """One full-width PBR step (PBR_CHECK_PIXELS on and off the object; 128
    SG lights x 32 diffuse samples) on the card against the same step on
    the CPU in fp32 and fp64 (the visibility net without its bf16 storage),
    from the same weights (the seeded NeuS, the same in every run), batch,
    the CPU's trace of ``grid`` (the shadow scene's two analytic spheres)
    and every draw shared (the CPU's, replayed): in row mode (compact_chunk
    PBR_CHECK_CHUNK) and dense, each shading with the AE normal map and with
    the geometry normals. The metrics to LOSS_RTOL of the CPU fp32 step's;
    the ``normals`` output (K3's) and each trainable gradient to fp64
    within CESR_GRAD_TOL of its largest entry or CESR_FP32_FACTOR x the
    CPU fp32 step's own distance. Then a planted fault, K3 blind to the
    first row tile of the step's launch, which the normals bound must
    reject, and on the geometry normals the gradient bounds too."""
    cfg = dataclasses.replace(cfg, visnet=dataclasses.replace(cfg.visnet, storage_dtype=None))
    on, off = PBR_CHECK_PIXELS
    rng = np.random.default_rng(seed)
    mask = dataset.object_masks[0]
    b = dataset.pixels(0, np.concatenate([rng.choice(np.flatnonzero(mask), on, replace=False),
                                          rng.choice(np.flatnonzero(~mask), off, replace=False)]))
    tb = {k: torch.as_tensor(b[k]) for k in BATCH_KEYS}
    grids = {"cpu": grid.cpu(), "cuda": grid}
    with torch.no_grad():
        traced = Stage2Model(params, cfg, "cpu", grids["cpu"]).trace(tb["points"], tb["dirs"])[:2]
        own = Stage2Model(params, cfg, "cuda", grid).trace(tb["points"].cuda(),
                                                           tb["dirs"].cuda())[1].cpu()
    surface = traced[1] & tb["object_mask"]
    print(f"PBR step check ({on} + {off} pixels x {cfg.envmap.num_lgt_sgs} lights x 32 "
          f"samples, the two-sphere grid): the card's own trace vs the CPU's: "
          f"{int((own != traced[1]).sum())} of {on + off} hit flags differ; every side shades "
          f"the CPU's ({int(surface.sum())} surface pixels, {int(surface[:16].sum())} of them in "
          f"the first 16 rows)", flush=True)
    readings = {}
    for chunk in (PBR_CHECK_CHUNK, 0):
        for use_normal_map in (True, False):
            setting = dataclasses.replace(stage, num_pixels=on + off, compact_chunk=chunk,
                                          use_normal_map=use_normal_map)
            readings[chunk, use_normal_map] = pbr_check_setting(cfg, setting, dataset, params,
                                                                seed, tb, traced, grids)
    worst = max(((s, k) for s in readings for k in ("metrics", "normals", "gradients")),
                key=lambda sk: readings[sk[0]][sk[1]])
    faults = {k: min(r[k] for s, r in readings.items() if k == "fault normals" or not s[1])
              for k in ("fault normals", "fault gradients")}
    print(f"PBR step check worst: {worst[1]} at {readings[worst[0]][worst[1]]:.3f} of the bound "
          f"({'row mode' if worst[0][0] else 'dense'}, use_normal_map {worst[0][1]}); planted "
          f"fault caught at least {faults['fault normals']:.1f}x by the normals, "
          f"{faults['fault gradients']:.1f}x by the gradients on the geometry normals",
          flush=True)


def load_pbr_runner(cfg, params, dataset, stage, seed: int, vis_runner, vis_path: str,
                    norm_runner, norm_path: str, log_dir: str):
    """``PBRRunner`` at ``stage`` from the Norm and Vis stages' checkpoints,
    in ``robir_tpu/cli.py:cmd_pbr``'s order: ``load_norm_checkpoint`` (the
    normal decoder must be the Norm runner's, bit for bit, every other leaf
    the PBR runner's own), then ``load_vis_checkpoint`` (the indirect and
    visibility nets the Vis runner's, every other leaf as it was)."""
    runner = PBRRunner(cfg, params, dataset, stage, seed=seed, device="cuda", log_dir=log_dir)
    before = flat_leaves(runner)
    runner.load_norm_checkpoint(norm_path)
    kept = check_surgery("load_norm_checkpoint", before, flat_leaves(runner),
                         flat_leaves(norm_runner), lambda p: "normal_decoder_layer" in p)
    print(f"PBRRunner.load_norm_checkpoint {os.path.basename(norm_path)}: {kept} "
          f"normal_decoder_layer leaves bit-equal to the Norm runner's, the other "
          f"{len(before) - kept} the PBR runner's own", flush=True)
    before = flat_leaves(runner)
    runner.load_vis_checkpoint(vis_path)
    kept = check_surgery("load_vis_checkpoint", before, flat_leaves(runner),
                         flat_leaves(vis_runner),
                         lambda p: p.startswith(("indirect_illum_network", "visibility_network")))
    changed = sum(not torch.equal(v, before[k]) for k, v in flat_leaves(runner).items())
    print(f"PBRRunner from the Vis checkpoint {os.path.basename(vis_path)}: {kept} leaves of the "
          f"indirect and visibility nets kept ({changed} changed), bit-equal to the Vis runner's; "
          f"the other {len(before) - kept} the PBR runner's own; {stage.num_pixels} pixels, "
          f"compact_chunk {stage.compact_chunk}, use_normal_map {stage.use_normal_map}",
          flush=True)
    return runner


def drive_pbr(runner, steps: int, profile: int = 0):
    """``steps`` PBRRunner steps on the card with the counts set to 0 just
    before. Each step's line gives its time, its mode (``step_config``:
    compacted or dense), surface rows, loss, rgb_loss and PSNR; the guard's
    choice is printed where it reads. Each step must launch the grid march
    once at the batch's rays and K3, keeping no state, as ``drive_cesr_grid``
    K1-K3: once at the batch's rows if dense; if compacted (the graph path)
    once at one chunk at a new flag set's probe, once at its row bucket a
    capture, not at all on a replay; K1, K2 and K4 never. Returns the launches by
    shape and the rows each step's K3 ran on. Then, if ``profile``,
    profiles that many more steps."""
    stage = runner.stage_cfg
    n, R = stage.num_pixels, runner.cfg.grid.resolution
    want = {k: {} for k in KERNELS}

    def add(kernel, shape):
        want[kernel][shape] = want[kernel].get(shape, 0) + 1

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_ms, shaded = [], []
    reset_counts()
    for _ in range(steps):
        it = runner.cur_iter
        compacted = runner.step_config().compact_chunk > 0  # below n: row mode
        before = graph_snapshot(runner)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        m = runner.run(1)
        end.record()
        torch.cuda.synchronize()
        step_ms.append(start.elapsed_time(end))
        bad = {k: v for k, v in m.items() if not np.isfinite(v)}
        if bad:
            raise RuntimeError(f"PBR step {it}: non-finite {bad}")
        surface = round(m["surface_frac"] * n)
        passes = step_passes(runner, before)
        if passes is None:
            rows, how = (max(surface, 1) if compacted else n), "eager"
            launches = [rows]
        else:
            rows = bucket_rows(surface, stage.compact_chunk)
            launches = [rows] * passes[0] + [stage.compact_chunk] * passes[1]
            how = "replayed" if passes == (0, 0) else f"captured {passes}"
        shaded.extend(sorted(set(launches)) or [rows])
        add("march", (R, n))
        for r in launches:
            add("K3", (fm.MAX_WIDTH, r))
        print(f"PBR step {it:2d} ({'compacted' if compacted else 'dense'}, {how}): "
              f"{step_ms[-1]:8.3f} ms, "
              f"{surface} surface rows (fraction {m['surface_frac']:.4f}), {rows} rows shaded; "
              f"loss {m['loss']:.5f}, rgb_loss {m['rgb_loss']:.5f}, PSNR {m['psnr']:.3f} dB, kl "
              f"{m['kl']:.5f}, smooth {m['smooth']:.6f}, white {m['white']:.3e}", flush=True)
        if runner.cur_iter % stage.guard_every == 0:
            dense = runner.step_config().compact_chunk == 0
            print(f"  guard after step {runner.cur_iter}: surface fraction "
                  f"{runner.surface_frac:.4f} {'>' if dense else '<='} "
                  f"{stage.compact_max_surface_frac}: the next steps run "
                  f"{'dense' if dense else 'compacted'}", flush=True)
    run, kept = shapes(), fv.KEPT.launches
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(graph_line("PBR", runner), flush=True)
    if profile:
        profile_steps(runner.run, profile, "PBR", graph=runner.graphs and (
            runner.graphs, {"K1": 0, "K2": 0, "K3": 1, "K4": 0, "march": 0}))
    if run != want:
        raise RuntimeError(f"PBR launches {run}, expected {want}")
    if kept:  # the frozen NeuS's K3 has no backward to keep its state for
        raise RuntimeError(f"PBR steps: {kept} K3 launches kept their state, expected 0")
    steady = step_ms[2:] or step_ms
    print(f"PBR step ({n} pixels, {runner.cfg.envmap.num_lgt_sgs} SG lights x 32 diffuse "
          f"samples, grid {R}^3, compact_chunk {stage.compact_chunk}): median "
          f"{float(np.median(steady)):.3f} ms, mean {float(np.mean(steady)):.3f} ms over steps "
          f"3-{steps} (CUDA events around PBRRunner.run(1)); first step {step_ms[0]:.3f} ms; "
          f"peak device memory {peak:.2f} GiB", flush=True)
    print(f"PBR launches per step: the grid march 1 ({n} rays), K3 1 ({fm.MAX_WIDTH}) at the "
          f"step's shaded rows (through the wrapper at a graph's capture and a new flag "
          f"set's probe only), no K1, K2 or K4; over the {steps} steps by kernel and (width or grid "
          f"resolution, rows): {want}", flush=True)
    return run, shaded


def diffuse_sweep(model, lgt, rows: int, gen):
    """(the PBR step's diffuse sweep as ``render_with_sg`` calls it, forward
    and the backward to ``lgt``; its points, lobe directions and draws):
    ``rows`` points on the shadow scene's larger sphere x ``lgt``'s SG
    lights x 32 samples through ``model``'s visibility net."""
    m = lgt.shape[0]
    p = torch.randn(rows, 3, generator=gen, device="cuda")
    normals = p / torch.linalg.norm(p, dim=-1, keepdim=True)
    theta, phi = (torch.rand(m, 32, generator=gen, device="cuda") for _ in range(2))

    def sweep():
        vis = sg_lib.get_diffuse_visibility(
            0.25 * normals, normals, model.vis_logits, sg_lib._unit_lobes(lgt[:, :3]),
            torch.abs(lgt[:, 3]), theta, phi, chunk_lights=model.cfg.sweep_light_chunk,
            vis_outer_fn=model.vis_logits_outer)
        torch.autograd.grad(vis.sum(), lgt)

    return sweep, (0.25 * normals, theta, phi)


def time_pbr_sweep(runner, rows: int, gen) -> None:
    """The PBR step's diffuse sweep alone (``diffuse_sweep``) at ``rows``
    points through the runner's frozen visibility net, timed by CUDA
    events, with the peak memory it adds. No kernel of the port runs in
    it."""
    lgt = runner.params["envmap_material_network"]["lgtSGs"]
    m = lgt.shape[0]
    sweep, _ = diffuse_sweep(runner.model(), lgt, rows, gen)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ms = cuda_ms(sweep, 10)
    peak = torch.cuda.max_memory_allocated() - base
    print(f"the PBR diffuse sweep alone at {rows} rows x {m} lights x 32 samples "
          f"({rows * m * 32} rows of the visibility net), forward and backward to lgtSGs: "
          f"{ms:.3f} ms (CUDA events), {peak / 2**30:.2f} GiB above what was held", flush=True)


def k3_entry(name: str, slices, path: str, timed: int, reps: int = 20) -> dict:
    """K3 against its plain version on each (plan, x, packed weights) of
    ``slices``, timed on ``slices[timed]``; its kernels-line entry (shape
    None: it counts the path's launches at every row count)."""
    pairs = []
    with torch.no_grad():
        for plan, x, packed in slices:
            y, de = fv.vg_forward_cuda(plan, x, packed)
            yp, dep, *_ = fv._forward_phases(plan, x, *fm.unpack_grads(packed.W, packed.b, plan))
            pairs += [(f"y at {x.shape[0]} rows", y, yp), (f"de at {x.shape[0]} rows", de, dep)]
        err = held_to_plain(f"K3, {name}", pairs)
        plan, x, packed = slices[timed]
        ws, bs = fm.unpack_grads(packed.W, packed.b, plan)
        ms = k3_ms(plan, x, packed, reps)
        plain = cuda_ms(lambda: fv._forward_phases(plan, x, ws, bs), reps)
    rows, nw = x.shape[0], plan.n_weights()
    nb = sum(plan.layer_out_dim(i) for i in range(plan.n_layers))
    bound = bound_ms(4.0 * nw * rows, 4.0 * (rows * (2 * plan.dims[0] + plan.out_dim) + nw + nb))
    return dict(name=f"K3 fused_value_grad forward (value + d sdf/dx), {name}", route="cuda",
                source="robir_tpu_torch/csrc/fused_value_grad.cu",
                replaces="robir_tpu/render/pallas/fused_value_grad.py:131", max_abs_err=err,
                ms=ms, plain_ms=plain, bound_ms=bound[0], bound_by=bound[1], library_ms=None,
                rows=rows, kernel="K3", path=path, shape=None)


def check_pbr_path_kernels(runner, shaded: list, seed: int, gen) -> dict:
    """K3 at the SDF trunk's plan against its plain version at every row
    count the PBR run shaded (timed at the median), and the grid march on
    the 1,024 primary rays of a PBR batch; returns their entries."""
    plan = fm.plan_from_sdf_config(runner.cfg.neus.sdf)
    counts_run = sorted(set(shaded))
    x, ws, bs = trunk_inputs(plan, runner.cfg.neus.sdf.pe, max(counts_run), gen)
    pk = fm.pack_weights(plan, ws, bs, reverse=True)
    slices = [(plan, x[:r], pk) for r in counts_run]
    median = int(np.median(shaded))
    entries = {"K3 pbr rows": k3_entry(
        f"the PBR geometry normals at the shaded rows ({counts_run[0]}-{counts_run[-1]}; timed "
        f"at the median)", slices + [(plan, x[:median], pk)], "pbr", -1)}
    print(f"PBR run's shaded row counts (K3 held to its plain version at each): {counts_run}",
          flush=True)
    stage, R = runner.stage_cfg, runner.cfg.grid.resolution
    b = runner.dataset.sample_pixels(np.random.default_rng(seed + 2), 0, stage.num_pixels)
    e = hold_march(runner.grid_values, runner.cfg.grid, torch.as_tensor(b["points"], device="cuda"),
                   torch.as_tensor(b["dirs"], device="cuda"), "a PBR batch's primary rays")
    entries["march pbr"] = dict(e, name="grid march (march + refine, one thread a ray), the PBR "
                                        "primary trace", path="pbr", shape=(R, e["rows"]))
    report({k: v for k, v in entries.items() if v["kernel"] == "K3"})
    return entries


def check_pbr_view(runner, view) -> tuple:
    """The eval render of test view 0 of ``view`` through
    ``PBRRunner.render_view`` (chunks of VIEW_CHUNK rays), timed, with the
    counts set to 0 just before: per chunk one grid march at VIEW_CHUNK rays
    and one K3, nothing else. Its PSNR against the view's ground truth.
    Then the same render on recorded draws against the same call with the
    march's and K3's plain versions: identical masks, each buffer within
    KERNEL_TOL of its largest entry; K3 held to its plain version on each
    chunk's operands and the march on chunk 0's rays. Then the SG envmap
    image (``compute_envmap``, ENVMAP_HW), finite. Returns the entries and
    the launches by shape."""
    h, w = view.img_res
    n_chunks, R = -(-h * w // VIEW_CHUNK), runner.cfg.grid.resolution
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    out = runner.render_view(0, view, chunk=VIEW_CHUNK)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    run, peak = shapes(), torch.cuda.max_memory_allocated() / 2**30
    k3_rows = sorted(r for (_, r), k in run["K3"].items() for _ in range(k))
    if (run["march"] != {(R, VIEW_CHUNK): n_chunks} or len(k3_rows) != n_chunks
            or any(run[k] for k in ("K1", "K2", "K4"))):
        raise RuntimeError(f"render_view launches {run}, expected {n_chunks} marches of "
                           f"{VIEW_CHUNK} rays and {n_chunks} K3")
    gt = view.rgb_images[0]
    psnr = -10 * np.log10(float(np.mean((out["pred_rgb"] - gt) ** 2)) + 1e-12)
    if out["pred_rgb"].shape != (h * w, 3) or not all(np.isfinite(v).all() for v in out.values()):
        raise RuntimeError("render_view's buffers are not finite or have the wrong shape")
    print(f"render_view of test view 0 ({h}x{w}, {n_chunks} chunks of {VIEW_CHUNK} rays, the last "
          f"padded): {secs:.3f} s wall (PBRRunner.render_view to a synchronize), "
          f"{int(out['mask'].sum())} surface pixels, K3 at {k3_rows} rows, PSNR {psnr:.3f} dB "
          f"against the view's ground truth; peak device memory {peak:.2f} GiB", flush=True)

    taken, slices = [], []
    real_k3, real_cast = fv.vg_forward_cuda, stage2_mod.grid_cast

    def recorded(plan, x, packed):
        slices.append((plan, x, packed))
        return real_k3(plan, x, packed)

    def drawn(_):
        taken.append(Draws(runner.generator, device="cuda", record=True))
        return taken[-1]

    kw = dict(sg_render_fn=functools.partial(pbr_sg_render,
                                             use_normal_map=runner.stage_cfg.use_normal_map),
              chunk=VIEW_CHUNK)
    try:
        fv.vg_forward_cuda = recorded
        got = render_view(runner.model(), view, 0, draws=drawn, **kw)
        fv.vg_forward_cuda = plain_k3
        stage2_mod.grid_cast = lambda g, c, o, d: tg.grid_cast_plain(g, c, o, d)[:3]
        want = render_view(runner.model(), view, 0,
                           draws=lambda c: Draws(given=taken[c].taken, device="cuda"), **kw)
    finally:
        fv.vg_forward_cuda, stage2_mod.grid_cast = real_k3, real_cast
    if not np.array_equal(got["mask"], want["mask"]):
        raise RuntimeError("render_view: the traced mask differs from the plain march's")
    err = held_to_plain("render_view against the plain versions", [
        (k, torch.as_tensor(got[k]), torch.as_tensor(want[k])) for k in want if k != "mask"])
    print(f"render_view on the kernels vs on their plain versions (the same draws): masks "
          f"identical, every buffer within {err:.3e} of the plain render's", flush=True)
    entries = {"K3 pbr_view": k3_entry(
        f"the PBR eval render, no graph (one launch a {VIEW_CHUNK}-ray chunk at its surface "
        f"rows; timed on the largest)", slices, "pbr_view",
        max(range(len(slices)), key=lambda i: slices[i][1].shape[0]))}
    dirs, cam_loc = view.camera_rays(0)
    d = torch.as_tensor(dirs[:VIEW_CHUNK], device="cuda")
    e = hold_march(runner.grid_values, runner.cfg.grid,
                   torch.as_tensor(cam_loc, device="cuda").expand(VIEW_CHUNK, 3).contiguous(), d,
                   "an eval-render chunk's rays")
    entries["march pbr_view"] = dict(e, name="grid march (march + refine, one thread a ray), the "
                                             "PBR eval render's chunks", path="pbr_view",
                                     shape=(R, VIEW_CHUNK))
    report({"K3 pbr_view": entries["K3 pbr_view"]})

    with torch.no_grad():
        lgt = runner.model().material(torch.zeros((1, 3), device="cuda")).lgt_sgs
        t0 = time.perf_counter()
        env = compute_envmap(lgt, *ENVMAP_HW)
        torch.cuda.synchronize()
    env_ms = 1e3 * (time.perf_counter() - t0)
    if env.shape != (*ENVMAP_HW, 3) or not bool(torch.isfinite(env).all()):
        raise RuntimeError("the SG envmap image is not finite or has the wrong shape")
    print(f"SG envmap image (compute_envmap of the {lgt.shape[0]} trained lights, "
          f"{ENVMAP_HW[0]}x{ENVMAP_HW[1]}): finite, in [{float(env.min()):.4f}, "
          f"{float(env.max()):.4f}], mean {float(env.mean()):.4f}; {env_ms:.3f} ms", flush=True)
    return entries, run


def check_pbr_handover(pbr_runner, cfg, params, dataset, stage, seed: int, log_dir: str):
    """``save`` the PBR runner into ``log_dir``; ``CESRRunner.load_pbr_checkpoint``
    of that file: shadow_net and normal_net stay the CESR runner's own, the
    spec-BRDF autoencoder too unless ``stage.dropout_iter`` is -1, and every
    other leaf must be the PBR runner's, bit for bit. Then HANDOVER_STEPS
    CESR steps on the PBR runner's grid with the per-step counts of
    ``drive_cesr_grid``."""
    pbr_runner.log_dir = log_dir
    path = pbr_runner.save()
    cesr = CESRRunner(cfg, params, dataset, stage, seed=seed, device="cuda")
    before = flat_leaves(cesr)

    def keep(p: str) -> bool:
        return (not p.startswith(("shadow_net", "normal_net"))
                and ("spec_brdf" not in p or stage.dropout_iter == -1))

    cesr.load_pbr_checkpoint(path)
    kept = check_surgery("load_pbr_checkpoint", before, flat_leaves(cesr),
                         flat_leaves(pbr_runner), keep)
    spec = sum("spec_brdf" in k for k in before)
    print(f"CESRRunner from the PBR checkpoint {os.path.basename(path)} (step "
          f"{pbr_runner.cur_iter}): {kept} leaves bit-equal to the PBR runner's; shadow_net, "
          f"normal_net and the {spec} spec_brdf leaves (dropout_iter {stage.dropout_iter}) the "
          f"CESR runner's own; then {HANDOVER_STEPS} CESR steps", flush=True)
    cesr.grid_values = pbr_runner.grid_values
    drive_cesr_grid(cesr, HANDOVER_STEPS)


@contextlib.contextmanager
def observed(owner, name: str, seen: list, record):
    """While open, each call of ``owner.<name>`` appends
    ``record(args, kwargs, result)`` to ``seen``; the attribute is restored
    on exit."""
    real = getattr(owner, name)

    @functools.wraps(real)
    def call(*args, **kwargs):
        out = real(*args, **kwargs)
        seen.append(record(args, kwargs, out))
        return out

    setattr(owner, name, call)
    try:
        yield seen
    finally:
        setattr(owner, name, real)


def march_rays(grid, gcfg, dataset, n: int, gen):
    """``n`` rays on ``grid`` for holding the march: the first half camera
    rays evenly spaced over all the dataset's views and pixels; the rest
    from their surface hits (pushed off along the grid normal as
    trace_radiance does) in uniformly random directions, as the Vis fan's
    are."""
    n_sec = n // 2
    rays = [dataset.camera_rays(v) for v in range(dataset.n_cameras)]
    d = np.concatenate([dirs for dirs, _ in rays])
    o = np.concatenate([np.broadcast_to(loc, dirs.shape) for dirs, loc in rays])
    pick = np.linspace(0, len(d) - 1, n - n_sec).astype(np.int64)
    o1 = torch.as_tensor(o[pick], device="cuda")
    d1 = torch.as_tensor(d[pick], device="cuda")
    if n_sec == 0:
        return o1, d1
    with torch.no_grad():
        _, hit, x, _ = tg.grid_cast_plain(grid, gcfg, o1, d1)
        pts = x[hit]
        if pts.shape[0] == 0:
            raise RuntimeError("no camera ray hit the grid's surface")
        normals = tg.grid_normal(grid, gcfg, pts)
        sel = torch.randint(pts.shape[0], (n_sec,), generator=gen, device="cuda")
        o2 = pts[sel] + normals[sel] * max(0.005, 2.0 * gcfg.hit_eps_cells * gcfg.cell)
        d2 = torch.randn(n_sec, 3, generator=gen, device="cuda")
        d2 = d2 / torch.linalg.norm(d2, dim=-1, keepdim=True)
    return torch.cat([o1, o2]), torch.cat([d1, d2])


TRUNK_KERNELS = {
    "K1": ("fused_mlp trunk forward", "fused_mlp.cu", "render/pallas/fused_mlp.py:111"),
    "K2": ("fused_mlp recompute backward (dW, db)", "fused_mlp.cu",
           "render/pallas/fused_mlp.py:157"),
    "K3": ("fused_value_grad forward (value + d sdf/dx)", "fused_value_grad.cu",
           "render/pallas/fused_value_grad.py:131"),
    "K4": ("fused_value_grad backward (hand VJP)", "fused_value_grad.cu",
           "render/pallas/fused_value_grad.py:142")}


def trunk_calls(kernel: str, plan, x, packed, gen):
    """(kernel call, plain call) of a trunk kernel on x and the packed
    weights: K2 without dx, as the CESR normal net needs none; K2 and K4 on
    seeded cotangents, K4 from the state K3 kept, as the paths run it."""
    n, d0, dout = x.shape[0], plan.dims[0], plan.out_dim
    ws, bs = fm.unpack_grads(packed.W, packed.b, plan)
    if kernel == "K1":
        return (lambda: fm.fused_mlp_cuda(plan, x, packed),
                lambda: fm._forward_rows(plan, x, ws, bs))
    if kernel == "K3":
        return (lambda: fv.vg_forward_cuda(plan, x, packed),
                lambda: fv._forward_phases(plan, x, ws, bs)[:2])
    dy = 1e-3 * torch.randn(n, dout, generator=gen, device="cuda")
    if kernel == "K2":
        return (lambda: fm.mlp_backward_cuda(plan, x, packed, dy, False)[1:],
                lambda: fm._backward_rows(plan, x, ws, bs, dy, False)[1:])
    dde = 1e-3 * torch.randn(n, d0, generator=gen, device="cuda")
    saved = fv.vg_forward_saving_cuda(plan, x, packed)[2]  # K4 starts from K3's state
    return (lambda: fv.vg_backward_cuda(plan, x, packed, dy, dde, saved),
            lambda: fv._backward_phases(plan, x, ws, bs, dy, dde))


def trunk_bound(kernel: str, plan, rows: int) -> tuple[float, str]:
    nw = plan.n_weights()
    nb = sum(plan.layer_out_dim(i) for i in range(plan.n_layers))
    d0, dout = plan.dims[0], plan.out_dim
    if kernel == "K1":
        return bound_ms(2.0 * nw * rows, 4.0 * (rows * (d0 + dout) + nw + nb))
    if kernel == "K2":
        return k2_bound(plan, rows, False)
    if kernel == "K3":
        return bound_ms(4.0 * nw * rows, 4.0 * (rows * (2 * d0 + dout) + nw + nb))
    state = fv.scratch_floats(plan, rows, "state")
    return bound_ms(8.0 * nw * rows, 4.0 * (rows * (2 * d0 + dout) + state + 2 * (nw + nb)))


def flat_outputs(out) -> list:
    return [t for x in (out if isinstance(out, (tuple, list)) else [out])
            for t in (x if isinstance(x, (tuple, list)) else [x])]


def hold_path_kernels(path: str, run: dict, plans: dict, march_on, frozen: bool, gen) -> dict:
    """The kernels line's entries of a CLI path from its launches by shape
    (``run``): one per trunk kernel and build width (shape (width, None):
    it counts the path's launches at every row count of that build) and one
    for the march (shape (grid resolution, None)). Each is held to its
    plain version at every row count the path launched it at, on seeded
    inputs (``trunk_inputs`` of ``plans[width]``, a (plan, PE config); the
    march on ``march_rays`` of ``march_on`` = (grid, GridConfig,
    dataset)), and timed at the row count it was launched at most (K1
    with its weights packed once where ``frozen``)."""
    entries = {}
    for kernel, by_shape in run.items():
        for width in sorted({w for w, _ in by_shape}):
            launched = {r: k for (w, r), k in by_shape.items() if w == width}
            top = max(launched, key=lambda r: (launched[r], r))
            rows = sorted(launched)
            what = f"the {path} path ({rows[0]}-{rows[-1]} rows; timed at {top}, its most " \
                   f"launched)"
            if kernel == "march":
                grid, gcfg, dataset = march_on
                held = {r: hold_march(grid, gcfg, *march_rays(grid, gcfg, dataset, r, gen),
                                      f"{path} at {r} rays") for r in rows}
                entries[f"march {path}"] = dict(
                    held[top], max_abs_err=max(e["max_abs_err"] for e in held.values()),
                    name=f"grid march (march + refine, one thread a ray), {what}", path=path,
                    shape=(width, None))
                continue
            plan, pe = plans[width]
            x, ws, bs = trunk_inputs(plan, pe, rows[-1], gen)
            pk = fm.pack_weights(plan, ws, bs, reverse=True)
            err = 0.0
            with torch.no_grad():
                for r in rows:
                    got, want = trunk_calls(kernel, plan, x[:r], pk, gen)
                    err = max(err, held_to_plain(f"{kernel} on the {path} path at {r} rows", [
                        (f"output {i}", a, b) for i, (a, b) in
                        enumerate(zip(flat_outputs(got()), flat_outputs(want())))]))
                    del got, want
                xt = x[:top]
                call, plain = trunk_calls(kernel, plan, xt, pk, gen)
                ms = (k1_ms(plan, xt, pk, 5, packed_once=frozen) if kernel == "K1"
                      else k3_ms(plan, xt, pk, 5) if kernel == "K3" else cuda_ms(call, 5))
                plain_ms = cuda_ms(plain, 3)
            bound = trunk_bound(kernel, plan, top)
            name, src, tpu = TRUNK_KERNELS[kernel]
            entries[f"{kernel} {path} {width}"] = dict(
                name=f"{kernel} {name}, width {width} build, {what}", route="cuda",
                source=f"robir_tpu_torch/csrc/{src}", replaces=f"robir_tpu/{tpu}",
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound[0],
                bound_by=bound[1], library_ms=None, rows=top, kernel=kernel, path=path,
                shape=(width, None))
            del x, ws, bs, pk
    report({k: v for k, v in entries.items() if v["kernel"] != "march"})
    return entries


def check_images(paths: list) -> None:
    """Each PNG exists and is not one flat colour."""
    from PIL import Image
    for p in paths:
        if not os.path.exists(p):
            raise RuntimeError(f"{p} was not written")
        img = np.asarray(Image.open(p), np.float32)
        if not img.reshape(-1, img.shape[-1]).std(0).max() > 0:
            raise RuntimeError(f"{p} is one flat colour")


def cli_caller(runs: dict, walls: dict):
    """``call(path, argv)``: ``cli.main(argv)`` to a synchronize, with the
    counts set to 0 just before and read just after, added to
    ``runs[path]`` by kernel and shape and the wall seconds to
    ``walls[path]``; returns what ``cli.main`` returns."""
    def call(path, argv):
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        out = cli.main(argv)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        walls[path] = walls.get(path, 0.0) + secs
        for kernel, by_shape in shapes().items():
            acc = runs.setdefault(path, {}).setdefault(kernel, {})
            for shape, k in by_shape.items():
                acc[shape] = acc.get(shape, 0) + k
        print(f"cli {' '.join(argv[:1] + argv[-4:])}: {secs:.1f} s wall (cli.main to a "
              f"synchronize)", flush=True)
        return out
    return call


def drive_cli_chain(root: str, seed: int, ckpt: str, mesh_path: str, grid, plans1: dict,
                    plans2: dict, neus_sets: list, gen):
    """The command line's chain on the card, in process (``cli.main``), into
    one log dir under ``root``: stage 1 at configs/neus_blender.json on a
    sphere scene written by ``make_sphere_dataset`` (64 x 64, 20 train and
    2 test views), stage 2 at configs/hotdog.json on the shadow scene
    written by ``make_shadow_dataset`` (128 x 128, 20 train and 3 test
    views), each from ``seed``. Paths ``cli_neus`` (CLI_NEUS_STEPS steps
    with an eval and a checkpoint every CLI_EVERY and the test pass, then
    ``--is_continue`` for CLI_RESUME_STEPS more, its restored state held
    bit-equal to the file), ``cli_mesh`` (``ckpt``, the main path's stage
    1, whose PLY must equal ``mesh_path``'s), ``cli_norm`` (on
    ``mesh_path``, whose texture cache is there already: no atlas may
    run), ``cli_vis``, ``cli_pbr`` and ``cli_cesr`` (each from ``ckpt``'s
    NeuS, its grid bit-equal to ``grid``; ``neus_sets``, the ``--set``
    overrides that give configs/hotdog.json's ``model.neus`` stage 1's
    widths); the counts set to 0 just before each call and read just
    after. Checks the files each stage writes and
    that Vis kept Norm's decoder; prints each subcommand's wall time.
    Returns (the launches by path and shape, their kernels-line entries,
    the stage-2 commands' common arguments, the march's check inputs
    (grid, GridConfig, dataset))."""
    sphere = make_sphere_dataset(os.path.join(root, "sphere"), n_train=20, n_test=2, h=64, w=64,
                                 seed=seed)
    shadow = make_shadow_dataset(os.path.join(root, "shadow"), n_train=20, n_test=3, h=128,
                                 w=128, seed=seed)
    L = os.path.join(root, "logs")
    runs, walls = {}, {}
    call = cli_caller(runs, walls)

    # stage 1, and its resume from the step-20 file
    s1 = ["--conf", str(CONFIG), "--data", sphere, "--log_dir", L, "--seed", str(seed),
          "--set", f"train.eval_every={CLI_EVERY}", "--set", f"train.ckpt_every={CLI_EVERY}"]
    finals, restored = [], []
    with observed(NeusTrainer, "run", finals, lambda a, k, out: out), \
            observed(NeusTrainer, "restore", restored, lambda a, k, out: a[0].state()):
        call("cli_neus", ["neus", *s1, "--n_iters", str(CLI_NEUS_STEPS)])
        run_dir = os.path.join(L, "NeuS", "neus")
        with open(os.path.join(run_dir, "description.json")) as f:
            first = json.load(f)
        trainer = call("cli_neus", ["neus", *s1, "--is_continue", "--n_iters",
                                    str(CLI_RESUME_STEPS)])
    file = ckpt_lib.step_path(os.path.join(L, "NeuS"), CLI_NEUS_STEPS)
    saved = flatten_with_paths(ckpt_lib.load(file)[0])
    got = restored[0]
    if sorted(got) != sorted(saved) or not all(np.array_equal(got[k], saved[k]) for k in saved):
        raise RuntimeError(f"the resumed trainer differs from {os.path.basename(file)}")
    last = CLI_NEUS_STEPS + CLI_RESUME_STEPS
    evals = range(CLI_EVERY, last + 1, CLI_EVERY)
    if trainer.step != last:
        raise RuntimeError(f"the resumed run ended at step {trainer.step}, not {last}")
    with open(os.path.join(run_dir, "description.json")) as f:
        desc = json.load(f)
    check_images([os.path.join(run_dir, "plots", f"test_rgb_{s}.png") for s in evals])
    for p in ([ckpt_lib.step_path(os.path.join(L, "NeuS"), s) for s in evals]
              + [os.path.join(run_dir, "meshes", f"mesh_{s:06d}.ply") for s in evals]):
        if not os.path.exists(p):
            raise RuntimeError(f"{p} was not written")
    if not (np.isfinite(desc["mean_psnr"]) and desc["rays_per_sec"] > 0
            and all(np.isfinite(m["loss"]) for m in finals)):
        raise RuntimeError(f"stage 1 from the command line: {finals}, {desc}")
    print(f"cli neus: {CLI_NEUS_STEPS} steps, loss {finals[0]['loss']:.5f}, test PSNR "
          f"{first['mean_psnr']:.3f} dB, rays_per_sec {first['rays_per_sec']:.1f}; resumed at "
          f"step {CLI_NEUS_STEPS} ({len(saved)} leaves: parameters, Adam moments and counts "
          f"bit-equal to {os.path.basename(file)}), {CLI_RESUME_STEPS} more steps, loss "
          f"{finals[1]['loss']:.5f}, test PSNR {desc['mean_psnr']:.3f} dB, rays_per_sec "
          f"{desc['rays_per_sec']:.1f} (description.json); evals, meshes and checkpoints at "
          f"steps {list(evals)}", flush=True)

    cli_mesh = os.path.join(L, "mesh.ply")
    call("cli_mesh", ["mesh", "--conf", str(CONFIG), "--log_dir", L, "--ckpt", ckpt,
                      "--out", cli_mesh])
    got, want = tmesh.Mesh.load_ply(cli_mesh), tmesh.Mesh.load_ply(mesh_path)
    if not (np.array_equal(got.tris, want.tris) and np.array_equal(got.verts, want.verts)):
        raise RuntimeError("cli mesh differs from the driven mesh export")
    print(f"cli mesh of {os.path.basename(ckpt)}: {len(got.verts)} vertices, {len(got.tris)} "
          f"triangles, bit-equal to the driven mesh export's PLY", flush=True)

    s2 = ["--conf", str(STAGE2_CONFIG), "--data", shadow, "--log_dir", L, "--seed", str(seed),
          "--set", f"neus_checkpoint={ckpt}", *neus_sets]
    bad = []

    def finite_plot(args, kwargs, out):
        if not all(np.isfinite(np.asarray(v)).all() for v in args[0].values()):
            bad.append(out)
        return out

    plot_names = ("plot_norm", "plot_illum", "plot_mat", "plot_cesr")
    with contextlib.ExitStack() as stack:
        atlas = stack.enter_context(timed_calls(tpipe, {"atlas_parameterize": "atlas"}))
        for name in plot_names:
            stack.enter_context(observed(tplots, name, [], finite_plot))
        stack.enter_context(observed(sg_lib, "compute_envmap", [], lambda a, k, out: bad.append(
            "envmap") if not bool(torch.isfinite(out).all()) else None))
        runners = {"cli_norm": call("cli_norm", ["norm", *s2, "--mesh", mesh_path, "--plot_freq",
                                                 str(CLI_NORM_PLOT), "--n_iters",
                                                 str(CLI_NORM_STEPS)])}
        for stage in ("vis", "pbr", "cesr"):
            runners[f"cli_{stage}"] = call(f"cli_{stage}", [
                stage, *s2, "--plot_freq", str(CLI_STAGE_PLOT), "--n_iters",
                str(CLI_STAGE_STEPS)])
    if atlas["atlas"] or bad:
        raise RuntimeError(f"the chain ran the atlas ({atlas['atlas']:.1f} s) or plotted "
                           f"non-finite buffers {bad}")
    for path, r in runners.items():
        if not torch.equal(r.grid_values, grid):
            raise RuntimeError(f"{path}: the grid differs from the main path's of that NeuS")
    plot_files = {"Norm": [f"norm_{s}.png" for s in (CLI_NORM_PLOT, CLI_NORM_STEPS)]}
    stage_plots = (CLI_STAGE_PLOT, CLI_STAGE_STEPS)
    plot_files["Vis"] = [f"illum_{s}.png" for s in stage_plots]
    for stage, tag in (("PBR", "mat"), ("CESR", "cesr")):
        plot_files[stage] = [f"{tag}_{s}_0.png" for s in stage_plots] + [
            f"envmap_{s}.png" for s in stage_plots]
    check_images([os.path.join(L, st, "plots", f) for st, fs in plot_files.items() for f in fs])
    norm_ck, vis_ck = (flatten_with_paths(ckpt_lib.load(os.path.join(
        L, stage, "checkpoints", "latest.npz"))[0]) for stage in ("Norm", "Vis"))
    decoder = [k for k in norm_ck if "normal_decoder_layer" in k]
    if not decoder or not all(np.array_equal(vis_ck[k], norm_ck[k]) for k in decoder):
        raise RuntimeError("the Vis checkpoint's normal decoder is not the Norm checkpoint's")
    print(f"cli norm, vis, pbr, cesr: grids bit-equal to the main path's; no atlas ran (the "
          f"texture cache beside the mesh); the Vis checkpoint's {len(decoder)} "
          f"normal_decoder_layer leaves bit-equal to the Norm checkpoint's; plots and envmaps "
          f"written from finite buffers, none flat: "
          f"{sum(len(v) for v in plot_files.values())} PNGs", flush=True)
    print("cli wall time by subcommand: " + ", ".join(f"{p[4:]} {s:.1f} s"
                                                      for p, s in walls.items())
          + f"; the chain {sum(walls.values()):.1f} s", flush=True)

    march_on = (grid, runners["cli_vis"].cfg.grid, runners["cli_vis"].dataset)
    entries = {}
    for path, run in runs.items():
        stage1 = path in ("cli_neus", "cli_mesh")
        entries.update(hold_path_kernels(path, run, plans1 if stage1 else plans2, march_on,
                                         frozen=path != "cli_neus", gen=gen))
    return runs, entries, s2, march_on


def launched(run: dict) -> dict:
    """The kernels a path launched: {kernel: {shape: launches}}."""
    return {k: v for k, v in run.items() if v}


def drive_cli_sgfit(root: str, seed: int, call) -> None:
    """Path ``cli_sgfit``: an EXR of a seeded SG envmap at SGFIT_HW, then
    ``sgfit`` for SGFIT_STEPS steps at 128 SGs; its files written and
    finite, the loss at the last step below the first's; no kernel."""
    rng = np.random.default_rng(seed)
    sgs = rng.standard_normal((16, 7)).astype(np.float32)
    sgs[:, 3] = np.abs(sgs[:, 3]) * 20 + 5
    sgs[:, 4:] = np.abs(sgs[:, 4:]) * 0.5
    env = os.path.join(root, "envmaps", "studio.exr")
    os.makedirs(os.path.dirname(env), exist_ok=True)
    with torch.no_grad():
        write_exr(env, compute_envmap(torch.as_tensor(sgs, device="cuda"), *SGFIT_HW)
                  .cpu().numpy())
    fitted, logged = call("cli_sgfit", ["sgfit", "--envmap_path", env, "--n_iters",
                                        str(SGFIT_STEPS), "--num_sg", "128"])
    out = os.path.join(root, "envmaps", "studio")
    npy, fit = np.load(os.path.join(out, "sg_128.npy")), read_exr(os.path.join(out, "fit_128.exr"))
    if not (npy.shape == (128, 7) and np.array_equal(npy, fitted) and np.isfinite(npy).all()
            and fit.shape[:2] == (256, 512) and np.isfinite(fit).all()):
        raise RuntimeError(f"sgfit wrote {npy.shape} SGs and a {fit.shape} image, or non-finite")
    (first, l0), (last, l1) = logged[0], logged[-1]
    if not l1 < l0:
        raise RuntimeError(f"sgfit: the loss at step {last} ({l1}) is not below step {first}'s "
                           f"({l0})")
    print(f"cli sgfit: {SGFIT_STEPS} Adam steps at 128 SGs on a {SGFIT_HW[0]}x{SGFIT_HW[1]} EXR "
          f"(area-resized to 256x512): loss {l0:.6f} at step {first}, {l1:.6f} at step {last}; "
          f"sg_128.npy and fit_128.exr written, finite", flush=True)


def drive_cli_relight(root: str, s2: list, grid, plans2: dict, march_on, call, runs: dict,
                      gen) -> dict:
    """Path ``cli_relight``: ``relight`` of the chain's CESR checkpoint under
    the shadow pipeline's envmap6 on white, over the shadow scene's three
    test views: K1 exactly 500 launches at 65,536 rows (its bake, the grid
    bit-equal to ``grid``), per VIEW_CHUNK-ray chunk one march and one K3,
    nothing else; ``metrics.json``'s relit PSNRs finite, the buffers
    finite, the PNGs not flat, the GIF written. Then view 0 again on
    recorded draws against the same call with the march's and K3's plain
    versions (masks identical, each buffer within KERNEL_TOL of its largest
    entry), and every (kernel, shape) of the path held to its plain
    version. Returns the path's kernels-line entries."""
    env6 = make_relight_envmap(os.path.join(root, "envmaps"))
    out_dir = os.path.join(root, "relight")
    seen = []
    with observed(relight_mod, "relight_views", seen, lambda a, k, out: (a, k)):
        views, metrics, baked = call("cli_relight", [
            "relight", *s2, "--envmap", env6, "--background", "white", "--n_views", "3",
            "--out", out_dir])
    (params, cfg, _, dataset, *_), kwargs = seen[0]
    h, w = dataset.img_res
    n_chunks = len(views) * -(-h * w // VIEW_CHUNK)
    R = cfg.grid.resolution
    run = launched(runs["cli_relight"])
    k3 = sum(run.get("K3", {}).values())
    if (run.get("K1") != {(fm.MAX_WIDTH, 65536): R ** 3 // 65536}
            or run.get("march") != {(R, VIEW_CHUNK): n_chunks} or k3 != n_chunks
            or set(run) - {"K1", "K3", "march"}):
        raise RuntimeError(f"cli relight launched {run}; expected {R ** 3 // 65536} K1 at 65,536 "
                           f"rows and {n_chunks} marches of {VIEW_CHUNK} rays and K3")
    if not torch.equal(baked, grid):
        raise RuntimeError("cli relight: the grid differs from the chain's of that NeuS")
    with open(os.path.join(out_dir, "metrics.json")) as f:
        saved = json.load(f)
    psnrs = [saved[k] for k in ("mean_relit_psnr", "mean_relit_psnr_masked")]
    if not (all(np.isfinite(p) for p in psnrs) and saved == {
            k: v for k, v in metrics.items() if k in saved}
            and all(np.isfinite(v).all() for view in views for v in view.values())):
        raise RuntimeError(f"cli relight: metrics {saved}, or non-finite buffers")
    check_images([os.path.join(out_dir, f"{kind}_{v:03d}.png") for v in range(len(views))
                  for kind in ("rgb", "albedo", "roughness", "normal")])
    if not (metrics["video"].endswith((".gif", ".mp4")) and os.path.exists(metrics["video"])):
        raise RuntimeError(f"cli relight: no video at {metrics['video']}")
    print(f"cli relight of the CESR checkpoint under envmap6 (2 SGs) on white: {len(views)} "
          f"test views {h}x{w}, {n_chunks} chunks of {VIEW_CHUNK} rays; K1 {R ** 3 // 65536} at "
          f"65,536 rows (the bake, grid bit-equal to the chain's), {n_chunks} marches, K3 at "
          f"{sorted(r for (_, r), k in run['K3'].items() for _ in range(k))} rows; relit PSNR "
          f"{psnrs[0]:.3f} dB, masked {psnrs[1]:.3f} dB (views {saved['relit_psnr']}); "
          f"{4 * len(views)} PNGs, none flat; {os.path.basename(metrics['video'])}", flush=True)

    # view 0 on recorded draws, on the kernels and on their plain versions
    taken, slices = [], []
    real_k3, real_cast = fv.vg_forward_cuda, stage2_mod.grid_cast

    def recorded(plan, x, packed):
        slices.append((plan, x, packed))
        return real_k3(plan, x, packed)

    def drawn(_):
        taken.append(Draws(gen, device="cuda", record=True))
        return taken[-1]

    kw = dict(view_indices=[0], write_video=False, background="white", device="cuda")
    check_dir = os.path.join(root, "relight_check")
    try:
        fv.vg_forward_cuda = recorded
        got = relight_mod.relight_views(params, cfg, baked, dataset, env6, check_dir,
                                        draws=drawn, **kw)[0][0]
        fv.vg_forward_cuda = plain_k3
        stage2_mod.grid_cast = lambda g, c, o, d: tg.grid_cast_plain(g, c, o, d)[:3]
        want = relight_mod.relight_views(params, cfg, baked, dataset, env6, check_dir,
                                         draws=lambda c: Draws(given=taken[c].taken,
                                                               device="cuda"), **kw)[0][0]
    finally:
        fv.vg_forward_cuda, stage2_mod.grid_cast = real_k3, real_cast
    if not np.array_equal(got["mask"], want["mask"]):
        raise RuntimeError("cli relight: the traced mask differs from the plain march's")
    err = held_to_plain("relight_views against the plain versions", [
        (k, torch.as_tensor(got[k]), torch.as_tensor(want[k])) for k in want if k != "mask"])
    if not slices:
        raise RuntimeError("relight_views of view 0 recorded no K3 launch")
    with torch.no_grad():
        k3_err = max(held_to_plain(f"K3 on a relit chunk's {x.shape[0]} surface rows", [
            (f"output {i}", a, b) for i, (a, b) in enumerate(zip(
                real_k3(plan, x, packed), plain_k3(plan, x, packed)))])
            for plan, x, packed in slices)
    print(f"relight_views of view 0 on the kernels vs on their plain versions (the same draws): "
          f"masks identical, every buffer within {err:.3e} of the plain render's (the march is "
          f"its plain version bit for bit, and the relit buffers read no K3 output: the AE "
          f"normal map shades); K3 within {k3_err:.3e} on the view's {len(slices)} recorded "
          f"launches (rows {[x.shape[0] for _, x, _ in slices]})", flush=True)
    return hold_path_kernels("cli_relight", run, plans2, march_on, frozen=True, gen=gen)


def drive_cli_textures(root: str, s2: list, mesh_path: str, call, runs: dict) -> None:
    """Path ``cli_textures``: ``textures`` of the chain's CESR checkpoint at
    TEXTURES_RES on the driven mesh, whose texture cache holds its atlas
    (no atlas may run); no kernel; the four maps finite and not flat; the
    OBJ and MTL written."""
    out_dir = os.path.join(root, "textures")
    with timed_calls(tpipe, {"atlas_parameterize": "atlas"}) as atlas:
        maps = call("cli_textures", ["textures", *s2, "--mesh", mesh_path, "--resolution",
                                     str(TEXTURES_RES), "--out", out_dir])
    run = launched(runs["cli_textures"])
    if atlas["atlas"] or run:
        raise RuntimeError(f"cli textures ran the atlas ({atlas['atlas']:.1f} s) or launched "
                           f"{run}")
    if not all(m.shape == (TEXTURES_RES, TEXTURES_RES, 3) and np.isfinite(m).all()
               for m in maps.values()):
        raise RuntimeError("cli textures: a map is not finite or has the wrong shape")
    check_images([os.path.join(out_dir, f"{k}.png") for k in maps])
    for name in ("mesh.obj", "mesh.mtl"):
        if not os.path.getsize(os.path.join(out_dir, name)):
            raise RuntimeError(f"cli textures: {name} is empty")
    texels = float((maps["normal"].sum(-1) > 0).mean())
    print(f"cli textures at {TEXTURES_RES}^2 on the driven mesh: no atlas ran (its uv in the "
          f"texture cache), no kernel launched; albedo, roughness, metallic and normal maps "
          f"finite, none flat, {100 * texels:.1f}% of the texels on the mesh; mesh.obj "
          f"({os.path.getsize(os.path.join(out_dir, 'mesh.obj')) / 2**20:.1f} MiB) and mesh.mtl",
          flush=True)


def drive_cli_import_ref(root: str, log_dir: str, shadow: str, neus_sets: list, call,
                         runs: dict) -> None:
    """Path ``cli_import_ref``: a reference ``.tar`` of the chain's NeuS
    checkpoint and a ``.pth`` of its CESR checkpoint, both in the
    reference's key layout (``torch_port_helpers.reference_state_dict``),
    imported with ``--filter all`` into a fresh log dir; every imported
    leaf bit-equal to its source (CESR's own nets, which the stage-2 tree
    lacks, dropped by ``--ignore_unknown``); no kernel."""
    sys.path.insert(0, str(ROOT / "tests"))
    from torch_port_helpers import reference_state_dict

    neus, meta = ckpt_lib.load(ckpt_lib.latest_path(os.path.join(log_dir, "NeuS")))
    cesr, cesr_meta = ckpt_lib.load(os.path.join(log_dir, "CESR", "checkpoints", "latest.npz"))
    tar = os.path.join(root, "reference", f"{meta['step']:06d}.tar")
    pth = os.path.join(root, "reference", "latest.pth")
    os.makedirs(os.path.dirname(tar), exist_ok=True)
    torch.save({"global_step": meta["step"], "model": reference_state_dict(neus["params"])}, tar)
    torch.save({"model_state_dict": reference_state_dict(cesr), "epoch": cesr_meta["step"]}, pth)
    fresh = os.path.join(root, "imported")
    paths = call("cli_import_ref", [
        "import-ref", "--conf", str(STAGE2_CONFIG), "--data", shadow, "--log_dir", fresh,
        *neus_sets, "--stage1_tar", tar, "--stage2_pth", pth, "--filter", "all",
        "--ignore_unknown"])
    if launched(runs["cli_import_ref"]):
        raise RuntimeError(f"cli import-ref launched {launched(runs['cli_import_ref'])}")
    s1, s2 = (flatten_with_paths(ckpt_lib.load(p)[0]) for p in paths)
    src1 = flatten_with_paths({"params": neus["params"]})
    src2 = flatten_with_paths(cesr)
    dropped = sorted(set(src2) - set(s2))
    if (s1.keys() != src1.keys() or not all(np.array_equal(s1[k], src1[k]) for k in src1)
            or not all(np.array_equal(s2[k], src2[k]) for k in set(src2) & set(s2))
            or any(not k.startswith(("shadow_net", "normal_net")) for k in dropped)):
        raise RuntimeError("cli import-ref: an imported leaf differs from its source")
    print(f"cli import-ref: {os.path.basename(tar)} -> {len(s1)} NeuS leaves, "
          f"latest.pth -> {len(set(src2) & set(s2))} stage-2 leaves, each bit-equal to the "
          f"chain's checkpoint; {len(dropped)} leaves of CESR's own nets dropped "
          f"(--ignore_unknown)", flush=True)


# -- the stage-1 alternates and IDR mode ------------------------------------


@contextlib.contextmanager
def stage1_step_ms(ms: list):
    """While open, each stage-1 ``train_step`` (the one ``NeusTrainer.run``
    calls) is timed with CUDA events to a synchronize, into ``ms``."""
    real = neus_stage_mod.train_step

    def timed(*args, **kwargs):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        out = real(*args, **kwargs)
        end.record()
        torch.cuda.synchronize()
        ms.append(start.elapsed_time(end))
        return out

    neus_stage_mod.train_step = timed
    try:
        yield ms
    finally:
        neus_stage_mod.train_step = real


def write_conf(path: str, conf: dict) -> str:
    with open(path, "w") as f:
        json.dump(conf, f, indent=1)
    return path


def steady_median(ms: list) -> float:
    return float(np.median(ms[2:] or ms))


def drive_cli_stage1_alt(path: str, root: str, conf: dict, data: str, steps: int, call,
                         runs: dict, walls: dict, frames: int) -> float:
    """``neus`` of ``conf`` on ``data`` from the command line into
    ``root/<path>`` for ``steps`` steps, its in-train evals and its test
    pass: no kernel of the port may launch (the VNeRF, MipNeRF and hash
    paths are plain PyTorch); the checkpoint, ``description.json`` and the
    test frames (``frames`` of them; ragged scenes as images, the others
    as one video) written, the losses and PSNR finite. Prints the phase's
    line; returns its step median, ms."""
    log_dir = os.path.join(root, path)
    conf_path = write_conf(os.path.join(root, f"{path}.json"), conf)
    ms, finals = [], []
    with stage1_step_ms(ms), observed(NeusTrainer, "run", finals, lambda a, k, out: out):
        trainer = call(path, ["neus", "--conf", conf_path, "--data", data, "--log_dir",
                              log_dir, "--n_iters", str(steps)])
    if launched(runs[path]):
        raise RuntimeError(f"{path} launched {launched(runs[path])}; its models run no kernel")
    run_dir = os.path.join(log_dir, "NeuS", "neus")
    with open(os.path.join(run_dir, "description.json")) as f:
        desc = json.load(f)
    plots = set(os.listdir(os.path.join(run_dir, "plots")))
    ragged = len({trainer.scene.image_shape(i) for i in range(trainer.scene.n_images)}) > 1 \
        if hasattr(trainer.scene, "image_shape") else False
    framed = ({f"test_frame_{i}_{steps}.png" for i in range(frames)} <= plots if ragged
              else any(p.startswith("test_frames.") for p in plots))
    if not (framed and os.path.exists(ckpt_lib.step_path(os.path.join(log_dir, "NeuS"),
                                                                 steps))
            and trainer.step == steps and np.isfinite(desc["mean_psnr"])
            and all(np.isfinite(m["loss"]) for m in finals)):
        raise RuntimeError(f"{path}: step {trainer.step}, {desc}, plots {sorted(plots)}")
    print(f"{path}: {steps} steps of {type(trainer.model).__name__} at batch "
          f"{trainer.train_cfg.batch_size}, {trainer.scene.n_images} train views; step median "
          f"{steady_median(ms):.3f} ms (steps 3-{steps}, CUDA events around train_step), first "
          f"{ms[0]:.1f} ms; loss {finals[-1]['loss']:.5f}; test pass {frames} views "
          f"{'ragged, as images' if ragged else 'as a video'}: PSNR {desc['mean_psnr']:.3f} dB, "
          f"{desc['rays_per_sec']:.0f} rays/s; {walls[path]:.1f} s wall; no kernel launched",
          flush=True)
    return steady_median(ms)


def time_hash_encoding(cfg, params, rows: tuple[int, int], gen) -> float:
    """The hash encoding's own work in one stage-1 step, timed with CUDA
    events: its forward at the sampling phase's rows (no graph), then at
    the shaded pass's rows its forward, the spatial gradient with a graph
    and the backward of a loss on both to the tables (the eikonal term's
    second order). ms."""
    from robir_tpu_torch.fields.hashgrid import hashgrid_encode
    grid = cfg.hash_sdf.grid
    hash_params = params["sdf_network"]["hash"]
    n_samp, n_shade = rows
    xs = torch.rand(n_samp, 3, generator=gen, device="cuda") * 2 - 1
    xt = torch.rand(n_shade, 3, generator=gen, device="cuda") * 2 - 1
    w = torch.randn(grid.out_dim, generator=gen, device="cuda")

    def step():
        with torch.no_grad():
            hashgrid_encode(hash_params, grid, xs)
        x = xt.clone().requires_grad_(True)
        f = hashgrid_encode(hash_params, grid, x) @ w
        g, = torch.autograd.grad(f.sum(), x, create_graph=True)
        (f.sum() + (g * g).sum()).backward()

    return cuda_ms(step, 5)


def drive_cli_hash(root: str, sphere: str, seed: int, call, runs: dict, walls: dict,
                   gen) -> None:
    """Path ``cli_hash``: ``neus`` with ``model.type=hash`` at the
    ``HashNeuSConfig`` defaults, configs/neus_blender.json's colour net,
    renderer, train and mesh sections, batch 512, HASH_STEPS steps on the
    sphere scene; then ``mesh`` of its checkpoint at 256^3 (path
    ``cli_hash_mesh``). No kernel; the hash encoding's own ms per step."""
    base = load_config(str(CONFIG))
    conf = {**base, "model": {"type": "hash", "color": base["model"]["color"]},
            "train": {**base["train"], "batch_size": ALT_BATCH, "eval_every": HASH_STEPS,
                      "ckpt_every": HASH_STEPS}}
    step_ms = drive_cli_stage1_alt("cli_hash", root, conf, sphere, HASH_STEPS, call, runs,
                                   walls, frames=2)
    ckpt = ckpt_lib.step_path(os.path.join(root, "cli_hash", "NeuS"), HASH_STEPS)
    ply = os.path.join(root, "cli_hash_mesh.ply")
    mesh = call("cli_hash_mesh", ["mesh", "--conf", os.path.join(root, "cli_hash.json"),
                                  "--ckpt", ckpt, "--out", ply])
    if launched(runs["cli_hash_mesh"]):
        raise RuntimeError(f"cli_hash_mesh launched {launched(runs['cli_hash_mesh'])}")
    got = tmesh.Mesh.load_ply(ply)
    if not (np.array_equal(got.tris, mesh.tris) and np.array_equal(got.verts, mesh.verts)):
        raise RuntimeError("cli_hash_mesh: the PLY read back differs")
    _, _, model_cfg, render_cfg = stage1_dispatch(conf)
    params = from_jax(ckpt_lib.load(ckpt)[0]["params"], "cuda")
    batch = conf["train"]["batch_size"]
    samp = batch * (render_cfg.n_samples + render_cfg.n_importance * (
        render_cfg.up_sample_steps - 1) // render_cfg.up_sample_steps)
    shade = batch * (render_cfg.n_samples + render_cfg.n_importance)
    enc_ms = time_hash_encoding(model_cfg, params, (samp, shade), gen)
    g = model_cfg.hash_sdf.grid
    print(f"cli_hash_mesh: {build_mesh_config(conf).resolution}^3 from {os.path.basename(ckpt)}: "
          f"{len(mesh.verts)} vertices, {len(mesh.tris)} triangles, {walls['cli_hash_mesh']:.1f} "
          f"s wall, no kernel launched; the hash encoding ({g.n_levels} levels x "
          f"{g.n_features} features, 2^{g.log2_hashmap_size} entries a level, plain PyTorch "
          f"gathers): {enc_ms:.3f} ms a step (forward at the sampling phase's {samp} points, "
          f"forward, spatial gradient and second-order backward at the shaded pass's {shade}; "
          f"CUDA events) of the step's {step_ms:.3f} ms median", flush=True)


def check_bg_step_against_cpu(model_cfg, render_cfg, train_cfg, scene, seed: int) -> None:
    """One full-width stage-1 step with the background shell on the card
    against the same step on the CPU in fp32 and fp64, as
    ``check_step_against_cpu`` does: the same weights (seeded), 64 rays of
    ``scene`` (every pixel in the loss's mask, so that the rays that pass
    the object train the shell) and the same samples (the CPU's sampling
    phase, the shell's from one seeded draw). Each parameter gradient on
    the card against fp64 within GRAD_TOL of its largest entry, or, where
    fp32 itself does worse (the shell's density head, whose gradient
    cancels over the samples), within CESR_FP32_FACTOR x the CPU fp32
    step's own error. Then a planted fault, K4 blind to the first
    FAULT_ROWS rows (their cotangents zeroed), which those bounds must
    reject on the SDF trunk's gradients."""
    cfg = dataclasses.replace(model_cfg, color=dataclasses.replace(
        model_cfg.color, storage_dtype=None))
    params = init_neus(torch.Generator().manual_seed(seed), cfg)
    batch = scene.sample(np.random.default_rng(seed), 64)
    gen = torch.Generator().manual_seed(seed)
    t_rand = torch.rand((64, 1), generator=gen) - 0.5
    t_out = torch.rand((64, render_cfg.n_outside), generator=gen)
    anneal = cos_anneal_ratio(0, train_cfg.anneal_end)
    z_vals = z_out = None

    def step(dev, dtype):
        nonlocal z_vals, z_out
        model = NeuS(params, cfg, dev).to(dtype)
        rays, pixels = batch_to_rays(RayBatch(*[
            torch.as_tensor(a, device=dev, dtype=dtype) for a in batch]))
        if z_vals is None:
            z_vals = sample_z_vals(rays, model, render_cfg, t_rand=t_rand)
            z_out = outside_z_vals(rays, render_cfg, t_rand_outside=t_out)
        out = render_samples(rays, z_vals.to(dev, dtype), model, anneal, render_cfg,
                             z_out.to(dev, dtype))
        loss, _ = neus_loss(out, rays.lossmult, pixels, train_cfg)
        names, leaves = zip(*model.named_parameters())
        grads = torch.autograd.grad(loss, leaves)
        return float(loss.detach()), names, [g.to("cpu", torch.float64) for g in grads]

    loss_cpu, names, g_cpu = step("cpu", torch.float32)
    loss64, _, g64 = step("cpu", torch.float64)
    loss_gpu, _, g_gpu = step("cuda", torch.float32)
    real = fv.vg_backward_cuda

    def blind_to_first_rows(plan, x, packed, dy, dde, saved):
        dy, dde = dy.clone(), dde.clone()
        dy[:FAULT_ROWS] = 0
        dde[:FAULT_ROWS] = 0
        return real(plan, x, packed, dy, dde, saved)

    try:
        fv.vg_backward_cuda = blind_to_first_rows
        g_fault = step("cuda", torch.float32)[2]
    finally:
        fv.vg_backward_cuda = real

    def rel(a, ref):
        return float((a - ref).abs().max()) / max(float(ref.abs().max()), 1e-30)

    errs = {n: (rel(a, r), rel(c, r)) for n, a, c, r in zip(names, g_gpu, g_cpu, g64)}
    bound = {n: max(GRAD_TOL, CESR_FP32_FACTOR * e[1]) for n, e in errs.items()}
    over = {n: errs[n][0] / bound[n] for n in errs}
    worst = max(over, key=over.get)
    shell = max((n for n in errs if n.startswith("params.nerf_outside")), key=over.get)
    fault = {n: rel(a, r) / bound[n] for n, a, r in zip(names, g_fault, g64)
             if n.startswith("params.sdf_network")}
    caught = max(fault, key=fault.get)
    print(f"stage-1 step with the background shell on the card vs the CPU (64 rays, "
          f"neus_blender.json widths, the shell at NeRFBgConfig's, n_outside "
          f"{render_cfg.n_outside}, same samples): loss card {loss_gpu:.8f}, CPU fp32 "
          f"{loss_cpu:.8f}, fp64 {loss64:.8f}; {len(errs)} tensors; worst {worst}: card vs "
          f"fp64 {errs[worst][0]:.3e}, CPU fp32 vs fp64 {errs[worst][1]:.3e}, bound "
          f"{bound[worst]:.3e}; the shell's worst {shell}: {errs[shell][0]:.3e} "
          f"(CPU fp32 {errs[shell][1]:.3e}, bound {bound[shell]:.3e}); planted fault (K4 "
          f"blind to the first {FAULT_ROWS} rows): {caught} {fault[caught]:.1f}x its bound",
          flush=True)
    print(f"shell step check worst: gradient {worst} at {over[worst]:.3f} of its bound",
          flush=True)
    if not abs(loss_gpu - loss_cpu) <= LOSS_RTOL * abs(loss_cpu):
        raise RuntimeError(f"shell step loss on the card {loss_gpu} vs CPU {loss_cpu}")
    if not over[worst] <= 1.0:
        raise RuntimeError(f"shell step gradient {worst}: card vs fp64 {errs[worst][0]:.3e} "
                           f"> bound {bound[worst]:.3e}")
    if not fault[caught] > 1.0:
        raise RuntimeError("the shell step's gradient bounds passed the planted K4 fault")


def drive_neus_bg(model_cfg, render_cfg, train_cfg, scene, steps: int, seed: int, plans1: dict,
                  gen) -> tuple[dict, dict]:
    """Path ``neus_bg``: ``NeusTrainer`` with the shell for ``steps`` steps;
    the counts set to 0 just before must rise by exactly
    ``up_sample_steps`` K1 + 1 K3 + 1 K4 a step (the shell queries no SDF);
    each kernel then held to its plain version at the shapes it launched.
    Returns (the launches by shape, the kernels-line entries)."""
    trainer = NeusTrainer(scene, model_cfg, render_cfg, train_cfg, seed=seed, device="cuda")
    ms, losses = [], []
    t0 = time.perf_counter()
    try:
        torch.cuda.synchronize()
        reset_counts()
        with stage1_step_ms(ms):
            for _ in range(steps):
                losses.append(trainer.run(1)["loss"])
        run, by_shape = counts(), shapes()
    finally:
        trainer.close()
    wall = time.perf_counter() - t0
    want = {"K1": render_cfg.up_sample_steps * steps, "K2": 0, "K3": steps, "K4": steps,
            "march": 0}
    if run != want or not all(np.isfinite(losses)):
        raise RuntimeError(f"neus_bg launches {run}, expected {want}; losses {losses}")
    print(f"neus_bg: {steps} steps with the background shell (n_outside "
          f"{render_cfg.n_outside}, white_bkgd {render_cfg.white_bkgd}) at batch "
          f"{train_cfg.batch_size}: step median {steady_median(ms):.3f} ms (steps 3-{steps}), "
          f"first {ms[0]:.1f} ms; losses {losses[0]:.5f} -> {losses[-1]:.5f}; launches {run} "
          f"({render_cfg.up_sample_steps} K1 + 1 K3 + 1 K4 a step, as without the shell); "
          f"{wall:.1f} s wall", flush=True)
    return by_shape, hold_path_kernels("neus_bg", by_shape, plans1, None, frozen=False,
                                       gen=gen)


def drive_cli_idr(root: str, shadow: str, seed: int, stage_cfg, call, runs: dict,
                  walls: dict, gen) -> dict:
    """Paths ``cli_idr_vis``, ``cli_idr_pbr``, ``cli_idr_cesr``: ``vis``,
    ``pbr`` and ``cesr`` at configs/hotdog.json with ``--set
    model.use_neus=false`` (IDR mode: a fresh IDR pair, no stage-1 graft)
    on the shadow scene, IDR_STEPS steps each, the grid tracer. Each bake
    is 500 K1 launches of 65,536 rows at the IDR trunk; the Vis path's K3
    rows are one a needed ray (no mini render). ``norm`` with the same
    setting must raise the JAX package's error. Every (kernel, shape)
    launched held to its plain version. Returns the kernels-line entries."""
    from robir_tpu_torch.stages.norm import IDR_REFUSAL
    L = os.path.join(root, "idr_logs")
    s2 = ["--conf", str(STAGE2_CONFIG), "--data", shadow, "--log_dir", L, "--seed", str(seed),
          "--set", "model.use_neus=false"]
    try:
        cli.main(["norm", *s2, "--mesh", os.path.join(root, "none.ply")])
    except ValueError as e:
        if str(e) != IDR_REFUSAL:
            raise
        print(f"cli norm with model.use_neus=false: ValueError, the JAX package's: {e}",
              flush=True)
    else:
        raise RuntimeError("cli norm ran in IDR mode")
    cfg = build_stage2_config(load_config(str(STAGE2_CONFIG))["model"], use_neus=False)
    vis_chunk = build_stage_config(VisStageConfig,
                                   load_config(str(STAGE2_CONFIG))["vis"]).fan_compact_chunk
    print(f"IDR prediction: the Vis path's K3 launches at one row a needed ray, at most "
          f"{vis_chunk} rows each (the NeuS bridge's mini render takes 16 a ray); 500 K1 "
          f"launches of 65,536 rows a bake", flush=True)
    runners, grids = {}, []
    for stage in ("vis", "pbr", "cesr"):
        path = f"cli_idr_{stage}"
        runners[path] = call(path, [stage, *s2, "--n_iters", str(IDR_STEPS), "--no_plot"])
        grids.append(runners[path].grid_values)
        bake = runs[path]["K1"].get((fm.MAX_WIDTH, 65536), 0)
        if bake != 500:
            raise RuntimeError(f"{path}: {bake} K1 launches of 65,536 rows, not 500")
    if not all(torch.equal(g, grids[0]) for g in grids):
        raise RuntimeError("the IDR stages baked different grids of one seeded IDR pair")
    k3_vis = sorted({r for (w, r) in runs["cli_idr_vis"]["K3"]})
    if not k3_vis or max(k3_vis) > vis_chunk:
        raise RuntimeError(f"cli_idr_vis K3 rows {k3_vis}: the prediction was at most "
                           f"{vis_chunk}")
    for path, r in runners.items():
        leaves = flatten_with_paths(to_numpy(r.params))
        if "rendering_network/lin0/v" not in leaves or "implicit_network/lin0/v" not in leaves:
            raise RuntimeError(f"{path}: not the IDR tree")
    vis_ck, pbr_ck, cesr_ck = (flatten_with_paths(ckpt_lib.load(os.path.join(
        L, st, "checkpoints", "latest.npz"))[0]) for st in ("Vis", "PBR", "CESR"))
    idr = [k for k in vis_ck if k.startswith(("implicit_network", "rendering_network"))]
    kept = [k for k in vis_ck if k.startswith(("indirect_illum_network", "visibility_network"))]
    if not (all(np.array_equal(cesr_ck[k], vis_ck[k]) and np.array_equal(pbr_ck[k], vis_ck[k])
                for k in idr) and all(np.array_equal(pbr_ck[k], vis_ck[k]) for k in kept)):
        raise RuntimeError("the IDR hand-over changed a kept leaf")
    print(f"cli vis, pbr, cesr in IDR mode ({IDR_STEPS} steps each): each bake 500 K1 launches "
          f"of 65,536 rows at the IDR trunk ({cfg.neus.sdf.n_layers} x {cfg.neus.sdf.d_hidden}, "
          f"PE {cfg.neus.sdf.multires}, bias {cfg.neus.sdf.bias}), the three grids bit-equal; "
          f"the Vis path's K3 rows {k3_vis[0]}-{k3_vis[-1]}; the IDR pair ({len(idr)} leaves) "
          f"and the Vis nets PBR keeps bit-equal through the hand-over; wall "
          + ", ".join(f"{p[8:]} {walls[p]:.1f} s" for p in runners), flush=True)
    plans = {fm.MAX_WIDTH: (fm.plan_from_sdf_config(cfg.neus.sdf), cfg.neus.sdf.pe),
             fm.MAX_WIDTH_WIDE: (fm.plan_from_sdf_config(stage_cfg.normal_cfg), SHADOW_PE)}
    march_on = (grids[0], cfg.grid, runners["cli_idr_vis"].dataset)
    entries = {}
    for path in runners:
        entries.update(hold_path_kernels(path, runs[path], plans, march_on, frozen=True,
                                         gen=gen))
    return entries


def check_mip_sdf_mode(model_cfg, scene, seed: int, gen) -> tuple[dict, dict]:
    """Path ``mip_sdf``: ``similarity_process`` in its ``sdf`` sub-mode on
    the seeded NeuS at configs/neus_blender.json widths, 512 rays of
    MipRenderConfig's 64 samples (their sdf from K1, their gradient from
    K3, through ``NeuSSDF``), on the card against the same call on the CPU:
    every output within KERNEL_TOL of its largest entry. Returns (the
    launches by shape, the kernels-line entries of K1 and K3)."""
    from robir_tpu_torch.render import mip as mip_mod
    params = init_neus(torch.Generator().manual_seed(seed), model_cfg)
    batch = scene.sample(np.random.default_rng(seed), 512)
    mcfg = mip_mod.MipRenderConfig(mode="sdf")
    rgb = torch.randn((512, mcfg.num_samples, 3), generator=torch.Generator().manual_seed(seed))
    outs = {}
    for dev in ("cpu", "cuda"):
        neus = NeuS(params, model_cfg, dev)
        rays, _ = batch_to_rays(RayBatch(*[torch.as_tensor(a, device=dev) for a in batch]))
        with torch.no_grad():
            t, (means, _) = mip_mod.sample_along_rays(None, rays.origins, rays.directions,
                                                      rays.radii, mcfg.num_samples, rays.near,
                                                      rays.far)
            means = means / 2.0  # inside the NeuS's sphere of radius 2
            sdf = neus.sdf(means.reshape(-1, 3)).reshape(512, -1)
            if dev == "cuda":
                torch.cuda.synchronize()
                reset_counts()
            out = mip_mod.similarity_process(rgb.to(dev), sdf, means, t, rays.directions, mcfg,
                                             mode="sdf", model=mip_mod.NeuSSDF(neus),
                                             cos_anneal_ratio=0.5)
            if dev == "cuda":
                torch.cuda.synchronize()
                run = shapes()
        outs[dev] = {k: v.cpu() for k, v in out.items()}
    err = held_to_plain("similarity_process sdf mode, card vs CPU",
                        [(k, outs["cuda"][k], outs["cpu"][k]) for k in outs["cpu"]])
    if sum(run["K3"].values()) != 1 or any(sum(run[k].values()) for k in ("K1", "K2", "K4")):
        raise RuntimeError(f"mip_sdf launches {run}: one K3 expected")
    print(f"mip_sdf: similarity_process 'sdf' on the seeded NeuS, 512 rays x "
          f"{mcfg.num_samples} samples, card vs CPU: every output within {err:.3e} (limit "
          f"{KERNEL_TOL} of its largest entry); eikonal {float(outs['cuda']['sim_or_grad']):.6f}; "
          f"one K3 launch at {list(run['K3'])}", flush=True)
    plans = {fm.MAX_WIDTH: (fm.plan_from_sdf_config(model_cfg.sdf), model_cfg.sdf.pe)}
    return run, hold_path_kernels("mip_sdf", run, plans, None, frozen=False, gen=gen)


def drive_alternates(root: str, seed: int, sphere: str, shadow: str, model_cfg, render_cfg,
                     train_cfg, train_scene, dataset, stage_cfg, plans1: dict,
                     gen) -> tuple[dict, dict]:
    """The six phases of the stage-1 alternates and IDR mode; returns (their
    launches by path and shape, their kernels-line entries)."""
    runs, walls, entries, phase_s = {}, {}, {}, {}
    call = cli_caller(runs, walls)
    t0 = time.perf_counter()
    llff = str(Path(root) / "llff")
    sys.path.insert(0, str(ROOT / "tests"))
    from torch_port_helpers import write_llff_scene, write_multicam_scene
    write_llff_scene(llff, n=24, h=120, w=160, seed=seed)
    train = {"batch_size": ALT_BATCH, "eval_every": LLFF_STEPS, "ckpt_every": LLFF_STEPS}
    llff_conf = {"model": {"type": "vnerf"}, "render": {"type": "mip"}, "train": train,
                 "dataset": {"type": "llff", "llffhold": 8}}
    drive_cli_stage1_alt("cli_llff_mip", root, llff_conf, llff, LLFF_STEPS, call, runs, walls,
                         frames=3)
    ipe = {**llff_conf, "model": {"type": "vnerf", "use_ipe": True, "ipe_max_deg": 16}}
    drive_cli_stage1_alt("cli_llff_ipe", root, ipe, llff, LLFF_STEPS, call, runs, walls,
                         frames=3)
    phase_s["llff"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    mc = write_multicam_scene(str(Path(root) / "multicam"), sizes=((120, 160), (96, 128)),
                              n_train=8, n_test=2, seed=seed)
    mc_conf = {**llff_conf, "train": {**train, "eval_every": MULTICAM_STEPS,
                                      "ckpt_every": MULTICAM_STEPS},
               "dataset": {"type": "multicam"}}
    drive_cli_stage1_alt("cli_multicam", root, mc_conf, mc, MULTICAM_STEPS, call, runs, walls,
                         frames=2)
    phase_s["multicam"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    drive_cli_hash(root, sphere, seed, call, runs, walls, gen)
    phase_s["hash"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    bg_model = dataclasses.replace(model_cfg, background=NeRFBgConfig())
    bg_render = dataclasses.replace(render_cfg, n_outside=32, white_bkgd=False)
    check_bg_step_against_cpu(bg_model, bg_render, train_cfg, make_sphere_scene(
        "train", h=64, w=64, seed=seed, cfg=dataclasses.replace(train_scene.cfg,
                                                                 alpha_as_mask=False)), seed)
    runs["neus_bg"], bg_entries = drive_neus_bg(bg_model, bg_render, train_cfg, train_scene,
                                                BG_STEPS, seed, plans1, gen)
    entries.update(bg_entries)
    phase_s["neus_bg"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    idr_cfg = build_stage2_config(load_config(str(STAGE2_CONFIG))["model"], use_neus=False)
    idr_params = init_stage2_params(torch.Generator().manual_seed(seed), idr_cfg)
    two_spheres = tg.build_sdf_grid(two_sphere_sdf, idr_cfg.grid, device="cuda")
    check_cesr_step_against_cpu(idr_cfg, dataclasses.replace(stage_cfg, compact_chunk=16),
                                dataset, idr_params, seed, grid=two_spheres)
    entries.update(drive_cli_idr(root, shadow, seed, stage_cfg, call, runs, walls, gen))
    phase_s["idr"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    runs["mip_sdf"], sdf_entries = check_mip_sdf_mode(model_cfg, train_scene, seed, gen)
    entries.update(sdf_entries)
    phase_s["mip_sdf"] = time.perf_counter() - t0
    print("stage-1 alternates and IDR wall time by phase: " + ", ".join(
        f"{k} {v:.1f} s" for k, v in phase_s.items()) + f"; {sum(phase_s.values()):.1f} s in "
        "all", flush=True)
    return runs, entries


# -- the data-parallel phases and bf16 sampling ----------------------------


def _rank_setup(mesh) -> None:
    """A spawned rank's set-up: TF32 off as in the parent, the counts at 0."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(mesh.device)
    reset_counts()


def _timed_run(runner, steps: int) -> tuple[list, list]:
    """``steps`` calls of ``runner.run(1)``, each timed with CUDA events:
    (their ms, their metrics)."""
    ms, metrics = [], []
    for _ in range(steps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        metrics.append(runner.run(1))
        end.record()
        torch.cuda.synchronize()
        ms.append(start.elapsed_time(end))
    bad = [m for m in metrics if not all(np.isfinite(v) for v in m.values())]
    if bad:
        raise RuntimeError(f"non-finite metrics {bad[0]}")
    return ms, metrics


def _progress(mesh, what: str) -> None:
    """Rank 0's line of where the ranks are (a hang shows where it hung)."""
    if mesh.rank == 0:
        print(f"  rank 0: {what}", flush=True)


def _checksums(tree) -> list:
    return [dp.bit_checksum(v) for v in flatten_with_paths(tree).values()]


def _all_reduce_ms(mesh, params, reps: int = 10) -> float:
    """The median wall ms of one gradient all-reduce of ``params``'s flat
    buffer (zero gradients) to a synchronize."""
    params = list(params)
    for p in params:
        p.grad = torch.zeros_like(p)
    ms = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dp.all_reduce_grads(mesh, params)
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0))
    return float(np.median(ms))


def step_grads(mesh, params, model_cfg, render_cfg, train_cfg, batch, t_rand) -> tuple:
    """One stage-1 ``train_step`` on the card on this rank's rows of
    ``batch`` (numpy, global; all of it without a mesh) with the global
    jitter ``t_rand``: (metrics, the summed gradients on the CPU)."""
    device = mesh.device if mesh is not None else torch.device("cuda")
    model = NeuS(params, model_cfg, device)
    opt, lr_fn = neus_stage_mod.make_optimizer(model.parameters(), train_cfg)
    rows = mesh.local_slice(len(batch[0])) if mesh is not None else slice(None)
    local = RayBatch(*[torch.as_tensor(np.asarray(x)[rows], device=device) for x in batch])
    n = local.origins.shape[0]
    draws = Draws(given={"t_rand": torch.as_tensor(t_rand)}, device=device,
                  split=dp.batch_split(mesh, n))
    metrics = neus_stage_mod.train_step(model, opt, lr_fn, local, 0, train_cfg, render_cfg,
                                        draws, mesh=mesh)
    return ({k: float(v) for k, v in metrics.items()},
            {k: p.grad.detach().cpu().numpy() for k, p in model.named_parameters()})


def ddp_stage1_rank(mesh, model_cfg, render_cfg, train_cfg, scene_kw, seed: int, steps: int,
                    check) -> dict:
    """A rank of ``ddp_stage1``: the step check's summed gradients, then
    ``NeusTrainer(mesh=)`` for ``steps`` steps (the counts set to 0 just
    before and read just after, each step timed), the replicas checked
    bit-equal, ``throughput`` and one gradient all-reduce timed alone."""
    metrics, grads = step_grads(mesh, *check)
    _progress(mesh, "the stage-1 step check's step done")
    scene = make_sphere_scene("train", **scene_kw)
    trainer = NeusTrainer(scene, model_cfg, render_cfg, train_cfg, seed=seed, mesh=mesh)
    try:
        reset_counts()
        step_ms, step_metrics = _timed_run(trainer, steps)
        run = shapes()
        dp.check_replicas(mesh, "the stage-1 parameters", trainer.model.parameters())
        _progress(mesh, f"{steps} stage-1 steps done")
        rays_s = trainer.throughput(n_steps=5, warmup=2, reps=3)
    finally:
        trainer.close()
    return {"backend": mesh.backend, "device": str(mesh.device), "check": (metrics, grads),
            "run": run, "ms": step_ms, "metrics": step_metrics,
            "checksums": _checksums(trainer.model.params), "rays_per_s": rays_s,
            "all_reduce_ms": _all_reduce_ms(mesh, trainer.model.parameters())}


def stage2_runners(cfg, stages: dict, params, dataset, seed: int, mesh, tex_sampler):
    """The four stage-2 runners at ``stages`` (their sections of
    configs/hotdog.json) on ``params`` (the Norm decoder for Vis and PBR as
    it is: the runs hold ranks to one process, not stages to stages). CESR
    starts at its last warmup step but one, so that of DDP_STAGE2_STEPS
    steps the third on runs the rgb, latent KL and smoothness terms."""
    dev = "cuda"
    cesr = CESRRunner(cfg, params, dataset, stages["cesr"], seed=seed, device=dev, mesh=mesh)
    cesr.cur_iter = stages["cesr"].warmup_iters - 1
    return {"cesr": cesr,
            "vis": VisRunner(cfg, params, dataset, stages["vis"], seed=seed, device=dev,
                             mesh=mesh),
            "pbr": PBRRunner(cfg, params, dataset, stages["pbr"], seed=seed, device=dev,
                             mesh=mesh),
            "norm": NormRunner(cfg, params, TexSpaceSampler(tex_sampler, None, None),
                               stages["norm"], seed=seed, device=dev, mesh=mesh)}


def check_runners(cfg, stages: dict, params, dataset, seed: int, mesh, grid) -> dict:
    """CESR, Vis and PBR for the gradient check of ``ddp_stage2``: fresh,
    with the visibility net and the NeuS colour net in fp32, on ``grid``,
    CESR one step past its warmup (its rgb, latent KL and smoothness terms
    on)."""
    check = dataclasses.replace(
        cfg, visnet=dataclasses.replace(cfg.visnet, storage_dtype=None),
        neus=dataclasses.replace(cfg.neus, color=dataclasses.replace(cfg.neus.color,
                                                                     storage_dtype=None)))
    runners = {"cesr": CESRRunner(check, params, dataset, stages["cesr"], seed=seed,
                                  device="cuda", mesh=mesh),
               "vis": VisRunner(check, params, dataset, stages["vis"], seed=seed, device="cuda",
                                mesh=mesh),
               "pbr": PBRRunner(check, params, dataset, stages["pbr"], seed=seed, device="cuda",
                                mesh=mesh)}
    runners["cesr"].cur_iter = stages["cesr"].warmup_iters + 1
    for r in runners.values():
        r.grid_values = grid
    return runners


def _grads(tree) -> dict:
    """The gradient of each leaf of ``tree`` that has one, on the host."""
    return {k: v.grad.detach().cpu().numpy() for k, v in flatten_with_paths(tree).items()
            if v.grad is not None}


def _stage2_steps(runner, steps: int) -> dict:
    """``steps`` timed steps of a stage-2 runner: their ms and metrics, the
    first step's gradients (summed over the ranks) and the parameters
    after the last step, on the host."""
    ms, metrics = _timed_run(runner, 1)
    grads = _grads(runner.params)
    more_ms, more = _timed_run(runner, steps - 1)
    return {"ms": ms + more_ms, "metrics": metrics + more, "grads": grads,
            "params": flatten_with_paths(to_numpy(runner.params))}


def ddp_stage2_rank(mesh, cfg, stages: dict, params, dataset_kw, mesh_path: str, tex_res: int,
                    seed: int, steps: int, prologue: int) -> dict:
    """A rank of ``ddp_stage2``: the CESR runner's bake (checked bit-equal
    across the ranks by ``bake_grid``), shared by the four runners; Vis's
    energy prologue (``prologue`` steps); then ``steps`` steps of CESR,
    Vis, PBR and Norm, the counts set to 0 before each and read after, the
    replicas checked bit-equal after each. Rank 0 alone returns the first
    step's gradients and the parameters after the steps."""
    dataset = shadow_scene(**dataset_kw)
    runners = stage2_runners(cfg, stages, params, dataset, seed, mesh,
                             tpipe.TexSampler(mesh_path, tex_res))
    reset_counts()
    t0 = time.perf_counter()
    runners["cesr"].bake_grid()
    torch.cuda.synchronize()
    out = {"bake": {"run": shapes(), "s": time.perf_counter() - t0,
                    "checksum": dp.bit_checksum(runners["cesr"].grid_values)}}
    _progress(mesh, "the grid baked")
    for r in runners.values():
        r.grid_values = runners["cesr"].grid_values
    runners["vis"].fit_energy_prologue(prologue)
    out["energy"] = to_numpy(runners["vis"].params["gamma"]["energy"])
    for name, r in runners.items():
        torch.cuda.synchronize()
        reset_counts()
        res = _stage2_steps(r, steps)
        out[name] = {"run": shapes(), "checksums": _checksums(r.params), **res}
        if mesh.rank:
            del out[name]["grads"], out[name]["params"]
        _progress(mesh, f"{steps} {name} steps done")
        dp.check_replicas(mesh, f"the {name} parameters", r.params.parameters())
    out["check"] = {}
    for name, r in check_runners(cfg, stages, params, dataset, seed, mesh,
                                 runners["cesr"].grid_values).items():
        r.run(1)
        out["check"][name] = _grads(r.params)
    _progress(mesh, "the gradient check's steps done")
    if mesh.rank:
        del out["check"]
    return out


def rank_ddp(mesh, stage1: dict, stage2: dict) -> dict:
    """One rank of the data-parallel phases on the card: ``ddp_stage1``,
    then ``ddp_stage2``."""
    _rank_setup(mesh)
    return {"stage1": ddp_stage1_rank(mesh, **stage1), "stage2": ddp_stage2_rank(mesh, **stage2)}


def _per_step(run: dict, steps: int) -> dict:
    """Launches a step by kernel (all shapes) of a rank's run."""
    return {k: sum(v.values()) / steps for k, v in run.items() if v}


def _sum_runs(runs: list) -> dict:
    """The ranks' launches by kernel and shape, summed."""
    total = {k: {} for k in KERNELS}
    for run in runs:
        for k, by in run.items():
            for shape, n in by.items():
                total[k][shape] = total[k].get(shape, 0) + n
    return total


def _worst_grad(got: dict, want: dict) -> tuple[str, float]:
    """The leaf whose gradient in ``got`` is furthest from ``want``'s, as a
    share of ``want``'s largest entry; raises if the leaves differ."""
    if got.keys() != want.keys():
        raise RuntimeError(f"gradients of {sorted(got.keys() ^ want.keys())} on one side only")
    errs = {k: float(np.abs(g - want[k]).max()) / max(float(np.abs(want[k]).max()), 1e-30)
            for k, g in got.items()}
    name = max(errs, key=errs.get)
    return name, errs[name]


def _params_agree(got: dict, want: dict) -> tuple[float, float]:
    """The largest difference between two flat parameter sets, and the
    share of entries within PARAM_AGREE_ATOL."""
    diffs = np.concatenate([np.abs(got[k] - want[k]).ravel() for k in want])
    return float(diffs.max()), float(np.mean(diffs <= PARAM_AGREE_ATOL))


def _worst_metric(got: list, want: list) -> tuple[float, str]:
    """The worst relative difference (METRIC_FLOOR beside) between two
    runs' metrics, step by step, and where it was."""
    worst, where = 0.0, ""
    for step, (g, w) in enumerate(zip(got, want), 1):
        for k, v in w.items():
            err = abs(g[k] - v) - METRIC_FLOOR
            err = err / abs(v) if v else (math.inf if err > 0 else 0.0)
            if err > worst:
                worst, where = err, f"step {step} {k}"
    return max(worst, 0.0), where


def drive_ddp(model_cfg, render_cfg, train_cfg, dataset_cfg, cfg, stages: dict, params,
              seed: int, mesh_path: str, tex_res: int, tex_sampler, grid, plans1, plans2, gen):
    """The data-parallel phases: DDP_RANKS gloo ranks sharing the one card
    (nccl refuses two ranks on one device), spawned once.

    ``ddp_stage1``: configs/neus_blender.json widths, a global batch of
    512 (256 a rank), DDP_STAGE1_STEPS steps of ``NeusTrainer(mesh=)``;
    each rank must launch exactly 4 K1 + 1 K3 + 1 K4 a step; the replicas
    bit-equal; one step's summed gradients within GRAD_TOL (of each
    tensor's largest entry) of the one-process step's on the card on the
    same global batch and jitter (the colour net in fp32 there), its loss
    within LOSS_RTOL.

    ``ddp_stage2``: configs/hotdog.json's sections (CESR at 1,024 global
    pixels, Vis 256 x 512, PBR 1,024, Norm 1,024) on the trained NeuS and
    the grid each rank bakes (bit-equal across the ranks and to
    ``grid``, the one process's bake), DDP_STAGE2_STEPS steps each; the
    replicas bit-equal; against the one-process runners on the same
    batches and draws (Vis on rank 0's energy net): every step's metrics
    within LOSS_RTOL and the weights after the steps as PARAM_AGREE_*
    says, CESR from its last warmup step but one, so that its rgb, latent
    KL and smoothness terms run over the ranks; and one step of
    ``check_runners`` (fp32 storage, CESR past its warmup; Norm's own first
    step) whose summed gradients are within DDP_GRAD_TOL of each tensor's
    largest entry of the one process's. Then the dry run at one rank on the card, which must take
    nccl (the one-rank-a-GPU layout; its kernel launches count on no
    path). Returns the paths' launches by shape (the ranks' summed)
    and their kernels-line entries, each launched shape held to its plain
    version."""
    n1 = train_cfg.batch_size
    scene_kw = dict(h=64, w=64, seed=seed, cfg=dataset_cfg)
    # the check's colour net in fp32, as check_step_against_cpu's: its bf16
    # storage rounds GEMM outputs whose sums cuBLAS orders by the rows
    check_cfg = dataclasses.replace(model_cfg, color=dataclasses.replace(
        model_cfg.color, storage_dtype=None))
    check_params = seeded_neus(check_cfg, seed)
    batch = tuple(np.asarray(x) for x in make_sphere_scene("train", **scene_kw).sample(
        np.random.default_rng(seed + 1), n1))
    t_rand = torch.rand((n1, 1), generator=torch.Generator().manual_seed(seed + 1)).numpy()
    check = (check_params, check_cfg, render_cfg, train_cfg, batch, t_rand)
    dataset_kw = dict(n_train=20, h=128, w=128, seed=seed)
    t0 = time.perf_counter()
    ranks = dp.spawn_ranks(
        rank_ddp, DDP_RANKS,
        dict(model_cfg=model_cfg, render_cfg=render_cfg, train_cfg=train_cfg, scene_kw=scene_kw,
             seed=seed, steps=DDP_STAGE1_STEPS, check=check),
        dict(cfg=cfg, stages=stages, params=params, dataset_kw=dataset_kw, mesh_path=mesh_path,
             tex_res=tex_res, seed=seed, steps=DDP_STAGE2_STEPS, prologue=DDP_VIS_PROLOGUE),
        device="cuda", timeout_s=DDP_TIMEOUT_S)
    spawn_s = time.perf_counter() - t0
    s1 = [r["stage1"] for r in ranks]
    s2 = [r["stage2"] for r in ranks]

    # ddp_stage1
    print(f"ddp_stage1: {DDP_RANKS} ranks, backend {s1[0]['backend']} on {s1[0]['device']} "
          f"(shared: nccl takes one rank a device); spawn and both phases {spawn_s:.1f} s wall",
          flush=True)
    want = {"K1": render_cfg.up_sample_steps, "K3": 1, "K4": 1}
    for r, res in enumerate(s1):
        per = _per_step(res["run"], DDP_STAGE1_STEPS)
        print(f"  rank {r}: launches a step {per}; steps 3-{DDP_STAGE1_STEPS} median "
              f"{float(np.median(res['ms'][2:])):.3f} ms (CUDA events around run(1)); first "
              f"{res['ms'][0]:.3f} ms; loss {res['metrics'][0]['loss']:.5f} -> "
              f"{res['metrics'][-1]['loss']:.5f}; throughput {res['rays_per_s']:.0f} rays/s "
              f"(global batch {n1}); one gradient all-reduce alone {res['all_reduce_ms']:.3f} ms",
              flush=True)
        if per != want:
            raise RuntimeError(f"ddp_stage1 rank {r}: launches a step {per}, expected {want}")
    if any(res["checksums"] != s1[0]["checksums"] for res in s1):
        raise RuntimeError("ddp_stage1: the replicas differ")
    one_m, one_g = step_grads(None, *check)
    worst = {}
    for r, res in enumerate(s1):
        m, g = res["check"]
        if not abs(m["loss"] - one_m["loss"]) <= LOSS_RTOL * abs(one_m["loss"]):
            raise RuntimeError(f"ddp_stage1 rank {r}: loss {m['loss']} vs {one_m['loss']}")
        for k, ref in one_g.items():
            rel = float(np.abs(g[k] - ref).max()) / max(float(np.abs(ref).max()), 1e-30)
            worst[k] = max(worst.get(k, 0.0), rel)
    name = max(worst, key=worst.get)
    print(f"ddp_stage1: replicas bit-equal ({len(s1[0]['checksums'])} leaves); the {DDP_RANKS}-"
          f"rank step vs the one-process step on the card (global batch {n1}, one jitter): loss "
          f"{s1[0]['check'][0]['loss']:.8f} vs {one_m['loss']:.8f}; worst gradient {name} "
          f"{worst[name]:.3e} of its largest entry (limit {GRAD_TOL})", flush=True)
    if not worst[name] <= GRAD_TOL:
        raise RuntimeError(f"ddp_stage1: gradient {name} {worst[name]:.3e} > {GRAD_TOL}")
    run1 = _sum_runs([res["run"] for res in s1])

    # ddp_stage2
    bake = [res["bake"] for res in s2]
    if any(b["checksum"] != dp.bit_checksum(grid) for b in bake):
        raise RuntimeError("ddp_stage2: a rank's grid differs from the one process's bake")
    print(f"ddp_stage2: each rank baked the grid ({cfg.grid.resolution}^3, "
          f"{_per_step(bake[0]['run'], 1)} launches, {bake[0]['s']:.2f} s), bit-equal across "
          f"the ranks and to the one process's bake", flush=True)
    one = stage2_runners(cfg, stages, params, shadow_scene(**dataset_kw), seed, None,
                         tex_sampler)
    for r in one.values():
        r.grid_values = grid
    # the ranks' generators passed through the prologue's draws: so does
    # this one's; the fit itself is rank 0's
    one["vis"].fit_energy_prologue(DDP_VIS_PROLOGUE)
    with torch.no_grad():
        for path, p in flatten_with_paths(one["vis"].params["gamma"]["energy"]).items():
            p.copy_(torch.as_tensor(flatten_with_paths(s2[0]["energy"])[path]))
    one_check = {}
    for name, r in check_runners(cfg, stages, params, one["vis"].dataset, seed, None,
                                 grid).items():
        r.run(1)
        one_check[name] = _grads(r.params)
    failed = []
    for name in ("cesr", "vis", "pbr", "norm"):
        res = [r[name] for r in s2]
        if any(x["checksums"] != res[0]["checksums"] for x in res):
            raise RuntimeError(f"ddp_stage2 {name}: the replicas differ")
        ref = _stage2_steps(one[name], DDP_STAGE2_STEPS)
        worst, where = max(_worst_metric(x["metrics"], ref["metrics"]) for x in res)
        grad_name, grad_err = _worst_grad(res[0]["grads"], ref["grads"])
        # the gradient check's run: Norm's own (nothing on its path stores
        # bf16), the others' in ``check_runners``
        if name == "norm":
            check_name, check_err = grad_name, grad_err
        else:
            check_name, check_err = _worst_grad(s2[0]["check"][name], one_check[name])
        moved, within = _params_agree(res[0]["params"], ref["params"])
        lr = stages[name].opt.lr
        for r, x in enumerate(res):
            print(f"  {name} rank {r}: launches a step {_per_step(x['run'], DDP_STAGE2_STEPS)} "
                  f"(by shape {launched(x['run'])}); steps "
                  + ", ".join(f"{t:.3f}" for t in x["ms"]) + " ms; loss "
                  + ", ".join(f"{m.get('loss', m.get('radiance_loss')):.5f}"
                              for m in x["metrics"]), flush=True)
        print(f"  {name}: replicas bit-equal ({len(res[0]['checksums'])} leaves); against the "
              f"one process: every step's metrics within {worst:.2e} (relative, worst {where}; "
              f"limit {LOSS_RTOL}); the weights after {DDP_STAGE2_STEPS} steps within "
              f"{moved:.3e} (limit 2 x lr x steps = {2 * lr * DDP_STAGE2_STEPS:.1e}), "
              f"{within:.5f} of the entries within {PARAM_AGREE_ATOL} (limit "
              f"{PARAM_AGREE_FRAC}); step 1's summed gradients within {grad_err:.3e} of the "
              f"largest entry (worst {grad_name}) at hotdog.json's storage, "
              f"{check_err:.3e} (worst {check_name}; limit {DDP_GRAD_TOL}) in the check's run",
              flush=True)
        if not worst <= LOSS_RTOL:
            failed.append(f"{name}: {where} {worst:.3e} from the one process's > {LOSS_RTOL}")
        if not check_err <= DDP_GRAD_TOL:
            failed.append(f"{name}: step 1's gradient {check_name} {check_err:.3e} > "
                          f"{DDP_GRAD_TOL}")
        if not (moved <= 2 * lr * DDP_STAGE2_STEPS and within >= PARAM_AGREE_FRAC):
            failed.append(f"{name}: the weights after {DDP_STAGE2_STEPS} steps differ from the "
                          f"one process's: max {moved}, {within} within {PARAM_AGREE_ATOL}")
    if failed:
        raise RuntimeError("ddp_stage2 against the one process: " + "; ".join(failed))
    if any(n for by in _sum_runs([r["norm"]["run"] for r in s2]).values() for n in by.values()):
        raise RuntimeError("ddp_stage2: the Norm steps launched a kernel")
    run2 = _sum_runs([r[k]["run"] for r in s2 for k in ("cesr", "vis", "pbr", "norm")]
                     + [b["run"] for b in bake])
    # the one-rank-a-GPU layout, which this machine holds at a world of one
    one_rank = dryrun_multichip.dryrun(1, "cuda")
    print(f"the dry run at one rank on the card: backend {one_rank['backend']} on "
          f"{one_rank['device']}, loss {one_rank['metrics']['loss']:.6f}", flush=True)
    if one_rank["backend"] != "nccl":
        raise RuntimeError(f"one rank on its own GPU took {one_rank['backend']}, not nccl")
    entries = hold_path_kernels("ddp_stage1", run1, plans1, None, frozen=False, gen=gen)
    entries.update(hold_path_kernels("ddp_stage2", launched(run2), plans2,
                                     (grid, cfg.grid, one["vis"].dataset), frozen=True, gen=gen))
    return {"ddp_stage1": run1, "ddp_stage2": run2}, entries


def drive_sampling_bf16(model_cfg, render_cfg, train_cfg, scene, steps: int, seed: int, plans1,
                        gen):
    """``sampling_bf16``: stage 1 with ``sampling_dtype="bfloat16"`` for
    ``steps`` steps (the counts set to 0 just before: 0 K1, 1 K3 and 1 K4 a
    step); the sampling phase's bf16 query (one bf16 GEMM a layer) on
    seeded weights held to the CPU's bf16 route and to the fp32 trunk (K1)
    as BF16_*_ULPS say (in bf16 roundoffs of the largest |sdf|; it must
    differ from K1 by bf16's rounding), and timed against K1 at the first
    query's rows; ``throughput`` of both settings."""
    bf16 = dataclasses.replace(render_cfg, sampling_dtype="bfloat16")
    trainer = NeusTrainer(scene, model_cfg, bf16, train_cfg, seed=seed, device="cuda")
    try:
        torch.cuda.synchronize()
        reset_counts()
        ms, metrics = _timed_run(trainer, steps)
        run = shapes()
        replays = trainer.step_graph.replays
        rays_s = trainer.throughput(n_steps=5, warmup=2, reps=3)
    finally:
        trainer.close()
    per, want = _per_step(run, 1), {"K3": GRAPH_CALLS, "K4": GRAPH_CALLS}
    if per != want or (trainer.step_graph.captures, replays) != (1, steps):
        raise RuntimeError(f"sampling_bf16: launches counted {per}, expected {want}; "
                           f"{trainer.step_graph.captures} captures and {replays} replays, "
                           f"expected 1 and {steps}")
    fp32 = NeusTrainer(scene, model_cfg, render_cfg, train_cfg, seed=seed, device="cuda")
    try:
        rays_s32 = fp32.throughput(n_steps=5, warmup=2, reps=3)
    finally:
        fp32.close()
    rows = train_cfg.batch_size * render_cfg.n_samples
    params = seeded_neus(model_cfg, seed)
    x = torch.rand(rows, 3, generator=gen, device="cuda") * 2.4 - 1.2
    model, cpu = NeuS(params, model_cfg, "cuda"), NeuS(params, model_cfg, "cpu")
    with torch.no_grad():
        got = model.sdf(x, torch.bfloat16)
        want_bf = cpu.sdf(x.cpu(), torch.bfloat16).cuda()
        k1 = model.sdf(x)
        scale = float(k1.abs().max())
        err = float((got - want_bf).abs().max())
        gap = float((got - k1).abs().max())
        bf_ms = cuda_ms(lambda: model.sdf(x, torch.bfloat16), 10)
        k1_ms_ = cuda_ms(lambda: model.sdf(x), 10)
    print(f"sampling_bf16: {steps} steps replayed from CUDA graphs, launches counted {per} (the "
          f"capture's warm-up and the capture; no K1: the sampling phase's "
          f"4 queries run one torch.mm(bf16, bf16, out_dtype=float32) a layer); steps 3-{steps} "
          f"median {float(np.median(ms[2:])):.3f} ms; loss {metrics[0]['loss']:.5f} -> "
          f"{metrics[-1]['loss']:.5f}; throughput {rays_s:.0f} rays/s, fp32 sampling (K1) "
          f"{rays_s32:.0f} rays/s", flush=True)
    ulp = scale / 256
    print(f"sampling_bf16 query at {rows} rows (the first query of a step), in bf16 roundoffs "
          f"of the largest |sdf| (2^-8 x {scale:.3f} = {ulp:.3e}): card vs CPU bf16 route max "
          f"{err:.3e} = {err / ulp:.3f} (limit {BF16_CPU_ULPS}), vs the fp32 trunk (K1) "
          f"{gap:.3e} = {gap / ulp:.3f} (limits {BF16_MIN_GAP_ULPS} to {BF16_ULPS}); "
          f"{bf_ms:.3f} ms (bf16 GEMMs), K1 {k1_ms_:.3f} ms", flush=True)
    if not (err <= BF16_CPU_ULPS * ulp and BF16_MIN_GAP_ULPS * ulp <= gap <= BF16_ULPS * ulp):
        raise RuntimeError(f"sampling_bf16: the card's bf16 query is {err / ulp:.3f} roundoffs "
                           f"from the CPU's, {gap / ulp:.3f} from the fp32 trunk")
    return run, hold_path_kernels("sampling_bf16", launched(run), plans1, None, frozen=False,
                                  gen=gen)


# -- the NeuS bridge render, the stage-2 options, the Vis workload ---------


def bridge_rays(dataset, n: int, seed: int) -> Rays:
    """``n`` stage-2 camera rays of the shadow scene's view 0, on the CPU:
    unit directions, near and far where each ray meets the unit sphere's
    shell around the origin (the stage-1 NeuS's radius 2 in stage-1
    coordinates), near at least 0.05."""
    b = dataset.sample_pixels(np.random.default_rng(seed), 0, n)
    o = torch.as_tensor(b["points"])
    d = torch.as_tensor(b["dirs"])
    d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    dist = torch.linalg.norm(o, dim=-1, keepdim=True)
    ones = torch.ones_like(dist)
    return Rays(o, d, d, 0 * ones, ones, torch.clamp(dist - 1.0, min=0.05), dist + 1.0)


def drive_neus_bridge(dataset, seed: int, gen) -> tuple[dict, dict]:
    """Path ``neus_bridge``: ``neus_bridge_render`` (eval, its default 64 +
    64 samples) of the seeded stage-2 NeuS at configs/hotdog.json's widths
    (the 9 x 256 trunk; the colour net in fp32, so that bf16 rounding does
    not mask the comparison) on BRIDGE_RAYS rays of the shadow scene,
    BRIDGE_CALLS times, each timed to a synchronize. The counts are set to 0
    just before: each call must launch exactly 4 K1 (the 64 coarse samples
    and three up-sample rounds of 16 a ray; the fourth round adds samples
    without a query) and 1 K3 (render_core's 128 a ray), nothing else. The
    last call's rgb, acc and dist on every BRIDGE_CPU_STRIDE-th ray are held
    to the same render of those rays on the CPU within KERNEL_TOL of each
    one's largest entry; K1 and K3 to their plain
    versions at every shape launched. Returns (the launches by shape, the
    kernels-line entries)."""
    cfg = build_stage2_config(load_config(str(STAGE2_CONFIG))["model"])
    cfg = dataclasses.replace(cfg, neus=dataclasses.replace(
        cfg.neus, color=dataclasses.replace(cfg.neus.color, storage_dtype=None)))
    params = to_numpy(init_stage2_params(torch.Generator().manual_seed(seed), cfg))
    rays = bridge_rays(dataset, BRIDGE_RAYS, seed)
    model = Stage2Model(params, cfg, "cuda")
    card_rays = Rays(*[t.cuda() for t in rays])
    walls = []
    torch.cuda.synchronize()
    reset_counts()
    with torch.no_grad():
        for _ in range(BRIDGE_CALLS):
            t0 = time.perf_counter()
            out = neus_bridge_render(model, card_rays)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
    run = launched(shapes())
    n, r = BRIDGE_RAYS, NeusRenderConfig()
    want = {"K1": {(fm.MAX_WIDTH, n * r.n_samples): BRIDGE_CALLS,
                   (fm.MAX_WIDTH, n * r.n_importance // r.up_sample_steps):
                       BRIDGE_CALLS * (r.up_sample_steps - 1)},
            "K3": {(fm.MAX_WIDTH, n * (r.n_samples + r.n_importance)): BRIDGE_CALLS}}
    if run != want:
        raise RuntimeError(f"neus_bridge launches {run}, expected {want}")
    # each ray's render reads its own samples only, so the CPU renders every
    # BRIDGE_CPU_STRIDE-th ray of the call
    held = slice(None, None, BRIDGE_CPU_STRIDE)
    t0 = time.perf_counter()
    with torch.no_grad():
        cpu = neus_bridge_render(Stage2Model(params, cfg, "cpu"),
                                 Rays(*[t[held] for t in rays]))
    cpu_s = time.perf_counter() - t0
    err = held_to_plain("neus_bridge_render, card vs CPU", [
        (k, out[k][held].cpu(), cpu[k]) for k in ("idr_rgb", "acc", "dist")])
    hits = int(out["network_object_mask"].sum())
    if not 0 < hits < n:
        raise RuntimeError(f"neus_bridge: {hits} of {n} rays have acc > 0.5")
    print(f"neus_bridge: neus_bridge_render of the seeded NeuS ({cfg.neus.sdf.n_layers} x "
          f"{cfg.neus.sdf.d_hidden}, PE {cfg.neus.sdf.multires}) on {n} stage-2 rays, "
          f"{BRIDGE_CALLS} calls: wall " + ", ".join(f"{1e3 * w:.1f}" for w in walls)
          + f" ms; launches a call {_per_step(run, BRIDGE_CALLS)} at {sorted(run['K1'])} (K1) "
          f"and {sorted(run['K3'])} (K3); {hits} rays with acc > 0.5; rgb, acc, dist of every "
          f"{BRIDGE_CPU_STRIDE}th ray vs the CPU's call on them ({cpu_s:.1f} s) within "
          f"{err:.3e} (limit {KERNEL_TOL} of each one's largest entry)", flush=True)
    plans = {fm.MAX_WIDTH: (fm.plan_from_sdf_config(cfg.neus.sdf), cfg.neus.sdf.pe)}
    return run, hold_path_kernels("neus_bridge", run, plans, None, frozen=False, gen=gen)


def check_bgr_vis_step(dataset, vis_stage, seed: int) -> None:
    """``bgr``: in IDR mode (configs/hotdog.json with ``use_neus=false`` and
    ``bgr=true``) ``borrow_color`` on the card comes out as the channels of
    the run without ``bgr`` reversed, on BGR_CHECK_POINTS seeded points;
    then one Vis step with ``bgr`` held to the CPU's as
    ``check_vis_step_against_cpu`` holds it, and a planted fault, the card's
    step without the flip, must fail its bounds."""
    cfg = build_stage2_config(load_config(str(STAGE2_CONFIG))["model"], use_neus=False,
                              bgr=True)
    params = to_numpy(init_stage2_params(torch.Generator().manual_seed(seed), cfg))
    g = torch.Generator().manual_seed(seed)
    x = (0.3 * torch.randn(BGR_CHECK_POINTS, 3, generator=g)).cuda()
    d = torch.randn(BGR_CHECK_POINTS, 3, generator=g).cuda()
    with torch.no_grad():
        flipped = Stage2Model(params, cfg, "cuda").borrow_color(x, d)
        plain = Stage2Model(params, dataclasses.replace(cfg, bgr=False), "cuda").borrow_color(x, d)
    if not torch.equal(flipped, torch.flip(plain, (-1,))) or torch.equal(flipped, plain):
        raise RuntimeError("bgr: IDR mode's borrow_color is not the unflipped run's channels "
                           "reversed")
    print(f"stage2_options bgr: IDR mode's borrow_color on {BGR_CHECK_POINTS} points is the "
          f"run without bgr with its channels reversed, bit for bit", flush=True)
    grid = tg.build_sdf_grid(two_sphere_sdf, cfg.grid, device="cuda")
    check_vis_step_against_cpu(cfg, vis_stage, dataset, params, seed, grid, planted=(
        "the card's step with bgr off: borrow_color unflipped",
        lambda c: dataclasses.replace(c, bgr=False)))


def check_vis_compute_dtype(rows: int, seed: int, gen) -> None:
    """``vis_compute_dtype="bfloat16"`` at fp32 visibility storage: the PBR
    diffuse sweep's visibility-net logits (``vis_logits_outer`` over its
    lobe directions, ``rows`` points x the 128 lights x 32 samples) on the
    card held to the CPU's bf16 route within BF16_CPU_ULPS bf16 roundoffs
    (2^-8) of the largest fp32 logit, and at least BF16_MIN_GAP_ULPS from
    the fp32 logits (at most BF16_ULPS), so that a route left in fp32
    fails; then the whole sweep, forward and backward to lgtSGs, timed in
    bf16 and in fp32 with CUDA events. Seeded weights; no kernel of the
    port runs in it."""
    raw = load_config(str(STAGE2_CONFIG))["model"]
    fp32 = build_stage2_config(raw)
    fp32 = dataclasses.replace(fp32, visnet=dataclasses.replace(fp32.visnet,
                                                                storage_dtype=None))
    bf16 = dataclasses.replace(fp32, vis_compute_dtype="bfloat16")
    params = to_numpy(init_stage2_params(torch.Generator().manual_seed(seed), fp32))
    models = {k: Stage2Model(params, c, "cuda") for k, c in (("fp32", fp32), ("bf16", bf16))}
    lgt = models["bf16"].params["envmap_material_network"]["lgtSGs"]
    sweeps = {}
    for k, model in models.items():
        sweeps[k], (pts, theta, phi) = diffuse_sweep(
            model, model.params["envmap_material_network"]["lgtSGs"], rows,
            torch.Generator(device="cuda").manual_seed(seed))
    with torch.no_grad():
        dirs = sg_lib.sample_lobe_dirs(sg_lib._unit_lobes(lgt[:, :3]), torch.abs(lgt[:, 3]),
                                       theta, phi).reshape(-1, 3)
        got = models["bf16"].vis_logits_outer(pts, dirs)
        ref32 = models["fp32"].vis_logits_outer(pts, dirs)
        cpu = Stage2Model(params, bf16, "cpu").vis_logits_outer(pts.cpu(), dirs.cpu())
    ulp = float(ref32.abs().max()) / 256
    err = float((got.cpu() - cpu).abs().max())
    gap = float((got - ref32).abs().max())
    times = {k: cuda_ms(f, 10) for k, f in sweeps.items()}
    print(f"stage2_options vis_compute_dtype: the diffuse sweep's logits at {rows} rows x "
          f"{dirs.shape[0]} directions, in bf16 roundoffs of the largest fp32 logit (2^-8 x "
          f"{256 * ulp:.3f} = {ulp:.3e}): card bf16 vs CPU bf16 route {err / ulp:.3f} (limit "
          f"{BF16_CPU_ULPS}), vs fp32 {gap / ulp:.3f} (limits {BF16_MIN_GAP_ULPS} to "
          f"{BF16_ULPS}); the sweep forward and backward to lgtSGs {times['bf16']:.3f} ms in "
          f"bf16, {times['fp32']:.3f} ms in fp32 (CUDA events)", flush=True)
    if not (err <= BF16_CPU_ULPS * ulp and BF16_MIN_GAP_ULPS * ulp <= gap <= BF16_ULPS * ulp):
        raise RuntimeError(f"vis_compute_dtype: the card's bf16 logits are {err / ulp:.3f} "
                           f"roundoffs from the CPU's, {gap / ulp:.3f} from fp32")


def drive_vis_workload(gen) -> tuple[dict, dict]:
    """Path ``vis_workload``: ``tools/vis_workload.py``'s ``build()`` at its
    full constants on the card (``info`` printed; its bake counted here)
    and ``time_step`` with n_steps 10 and reps 4 (every rep's ms a step,
    and the step's launches: per step 2 marches and K3 once per slice of
    needed rays). Every (kernel, shape) launched held to its plain version.
    Returns (the launches by shape, the kernels-line entries)."""
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    runner, batch, carry, info = vis_workload.build()
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    reps = vis_workload.time_step(runner, batch, carry, n_steps=VW_STEPS, reps=VW_REPS)
    run = launched(shapes())
    marches = sum(run.get("march", {}).values())
    steps = VW_STEPS * (VW_REPS + 1)
    if marches != 2 * steps or any(k in run for k in ("K2", "K4")) or sum(
            run["K1"].values()) != 500:
        raise RuntimeError(f"vis_workload launches {run}: expected 500 K1 for the bake and 2 "
                           f"marches a step over {steps} steps")
    print(f"vis_workload: info {json.dumps(info)}; build {build_s:.1f} s (the 320^3 bake "
          f"included); time_step ({VW_STEPS} steps x {VW_REPS} reps after a warmup chain, CUDA "
          f"events): " + ", ".join(f"{t:.3f}" for t in reps) + " ms a step; launches "
          f"{ {k: sum(v.values()) for k, v in run.items()} } over the build and {steps} steps",
          flush=True)
    cfg = runner.cfg
    plans = {fm.MAX_WIDTH: (fm.plan_from_sdf_config(cfg.neus.sdf), cfg.neus.sdf.pe)}
    return run, hold_path_kernels("vis_workload", run, plans,
                                  (runner.grid_values, cfg.grid, runner.dataset), frozen=True,
                                  gen=gen)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--cesr-steps", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", type=int, default=0, metavar="STEPS",
                    help="after each main path, profile this many more of its steps")
    args = ap.parse_args()
    t_start = time.perf_counter()
    if min(args.steps, args.cesr_steps) < 1:
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

    print(f"build: {build.build_all():.2f} s, nvcc {' '.join(build.NVCC_FLAGS)} for "
          f"{', '.join(build.SOURCES)} (and {build.SOURCE_FLAGS} for those sources)", flush=True)
    t0 = time.perf_counter()
    lib = native.build()
    print(f"build: {time.perf_counter() - t0:.2f} s, g++ {' '.join(native.CXX_FLAGS)} for the host "
          f"library {native.SOURCE.name} (marching tetrahedra, rasteriser, atlas, EXR PIZ) into "
          f"{lib.relative_to(ROOT)}", flush=True)
    ptxas_report()

    model_cfg, render_cfg, train_cfg, dataset_cfg, cesr_cfg, stage_cfg = load_configs()
    rows = path_rows(render_cfg, train_cfg, cesr_cfg, stage_cfg)
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    entries = check_kernels(model_cfg, rows["stage1"], rows["round"], rows["vg"], gen)
    entries.update(check_tracer_kernels(model_cfg, rows["query"], rows["dense"], gen))
    entries.update(check_wide_kernels(stage_cfg.normal_cfg, model_cfg.sdf,
                                      rows["query"], rows["k2_sdf"], gen))
    entries.update(check_switch_kernels(model_cfg.sdf, stage_cfg.normal_cfg, gen))

    train_scene = make_sphere_scene("train", h=64, w=64, seed=args.seed, cfg=dataset_cfg)
    test_scene = make_sphere_scene("test", h=64, w=64, seed=args.seed, cfg=dataset_cfg)
    check_step_against_cpu(model_cfg, render_cfg, train_cfg, train_scene, args.seed)
    stage1, neus, trainer = drive_main_path(model_cfg, render_cfg, train_cfg, train_scene,
                                            test_scene, args.steps, args.seed)
    raw = load_config(str(STAGE2_CONFIG))
    with tempfile.TemporaryDirectory() as log_dir:
        # the mesh export of the NeuS stage 1 just trained, before its
        # profile steps move the trainer's NeuS off the one stage 2 takes
        mesh_cfg = build_mesh_config(load_config(str(CONFIG)))
        mesh, mesh_path, mesh_entries = drive_mesh(trainer, mesh_cfg, log_dir)
        entries.update(mesh_entries)
        # the checkpoint of that NeuS, the CLI chain's stage 1
        trainer.log_dir = os.path.join(log_dir, "stage1")
        cli_ckpt = trainer.save()
        if args.profile:
            try:
                profile_steps(trainer.run, args.profile,
                              graph=(trainer.step_graph, stage1_step_launches(render_cfg)))
            finally:
                trainer.close()

        dataset = shadow_scene(n_train=20, h=128, w=128, seed=args.seed)
        params = cesr_params(cesr_cfg, neus, args.seed)
        # the step checks: the seeded NeuS, not the one stage 1 just trained
        # (its K4 sums dW with atomics in an order that changes between runs)
        check_params = cesr_params(cesr_cfg, seeded_neus(model_cfg, args.seed), args.seed)
        sphere_cfg = dataclasses.replace(cesr_cfg, tracer="sphere")
        sphere_stage = dataclasses.replace(stage_cfg, compact_chunk=0)
        check_cesr_step_against_cpu(sphere_cfg, sphere_stage, dataset, check_params, args.seed)
        cesr_sphere = drive_cesr_sphere(sphere_cfg, sphere_stage, dataset, params,
                                        SPHERE_STEPS, args.seed, args.profile)

        # the CESR path at the JAX package's defaults: grid tracer, compaction
        runner = CESRRunner(cesr_cfg, params, dataset, stage_cfg, seed=args.seed, device="cuda")
        bake = bake_grid(runner)
        entries.update(check_bake_kernel(runner))
        entries.update(check_march(cesr_cfg.grid, runner.grid_values, dataset,
                                   stage_cfg.num_pixels, 4096, args.seed, gen))
        two_spheres = tg.build_sdf_grid(two_sphere_sdf, cesr_cfg.grid, device="cuda")
        check_cesr_step_against_cpu(cesr_cfg, dataclasses.replace(stage_cfg, compact_chunk=16),
                                    dataset, check_params, args.seed, grid=two_spheres)
        cesr, shaded = drive_cesr_grid(runner, args.cesr_steps, args.profile)
        entries.update(check_grid_path_kernels(model_cfg.sdf, stage_cfg.normal_cfg, shaded, gen))

        # the texture bake at configs/hotdog.json's texture_resolution and
        # the Norm stage at its norm section, on the exported mesh; Vis and
        # PBR then start from the trained decoder
        tex = bake_texture(mesh_path, texture_resolution(raw),
                           Stage2Model(params, cesr_cfg, "cuda"), mesh_cfg, args.seed)
        norm_stage = build_stage_config(NormStageConfig, raw["norm"])
        check_norm_step_against_cpu(cesr_cfg, norm_stage, check_params, args.seed)
        grid_values = runner.grid_values
        sampler = TexSpaceSampler(
            tex, focus_sampler_from_dataset(dataset),
            lambda o, d: tg.grid_cast(grid_values, cesr_cfg.grid, o, d),
            offset=TexSpaceSampler.offset_for_grid(cesr_cfg.grid), device="cuda")
        norm_runner = NormRunner(cesr_cfg, params, sampler, norm_stage, seed=args.seed,
                                 device="cuda", log_dir=log_dir)
        norm = drive_norm(norm_runner, args.profile)
        norm_runner.save()
        norm_path = os.path.join(norm_runner.ckpt_dir(), "latest.npz")

        # the Vis stage at configs/hotdog.json's vis section, its params
        # with the Norm decoder: the energy prologue, the bake, then the steps
        vis_stage = build_stage_config(VisStageConfig, raw["vis"])
        vis_runner = vis_runner_from_norm(cesr_cfg, params, dataset, vis_stage, args.seed,
                                          norm_runner, norm_path)
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        vis_runner.fit_energy_prologue()
        torch.cuda.synchronize()
        prologue_s = time.perf_counter() - t0
        if any(counts().values()):
            raise RuntimeError(f"the energy prologue launched {counts()}")
        energy = to_numpy(vis_runner.params["gamma"]["energy"])
        if not all(np.isfinite(v).all() for v in flatten_with_paths(energy).values()):
            raise RuntimeError("the fitted energy net is not finite")
        print(f"Vis energy prologue: 1000 Adam steps (8,192 pixels x 512 shifts each) on "
              f"{len(dataset.masked_pixels())} masked pixels, {prologue_s:.3f} s wall to a "
              f"synchronize; no kernel of the port launched", flush=True)
        vis_bake = bake_grid(vis_runner)
        if not torch.equal(vis_runner.grid_values, runner.grid_values):
            raise RuntimeError("the Vis runner's grid differs from the CESR runner's of that "
                               "NeuS")
        print("Vis grid bit-equal to the CESR runner's grid of the same NeuS", flush=True)
        entries.update(check_bake_kernel(vis_runner, "vis_bake"))
        entries.update(check_vis_march(vis_runner, args.seed))
        entries.update(check_borrow_color(vis_runner, gen))
        check_vis_step_against_cpu(cesr_cfg, vis_stage, dataset, check_params, args.seed,
                                   two_spheres)
        vis = drive_vis(vis_runner, VIS_STEPS, args.profile)
        entries.update(check_vis_path_kernels(vis_runner, vis, gen))
        vis_path = check_vis_checkpoint(vis_runner, cesr_cfg, params, vis_stage, args.seed,
                                        log_dir)

        # the PBR stage at configs/hotdog.json's pbr section, from the Norm
        # and Vis checkpoints: the step check, the bake, the steps, the eval
        # render and the envmap; then the hand-over to CESR at its cesr
        # section
        pbr_stage = build_stage_config(PBRStageConfig, raw["pbr"])
        check_pbr_step_against_cpu(cesr_cfg, pbr_stage, dataset, check_params, args.seed,
                                   two_spheres)
        pbr_runner = load_pbr_runner(cesr_cfg, params, dataset, pbr_stage, args.seed,
                                     vis_runner, vis_path, norm_runner, norm_path, log_dir)
        pbr_bake = bake_grid(pbr_runner)
        if not torch.equal(pbr_runner.grid_values, runner.grid_values):
            raise RuntimeError("the PBR runner's grid differs from the CESR runner's of that "
                               "NeuS")
        entries.update(check_bake_kernel(pbr_runner, "pbr_bake"))
        pbr, pbr_shaded = drive_pbr(pbr_runner, PBR_STEPS, args.profile)
        time_pbr_sweep(pbr_runner, int(np.median(pbr_shaded)), gen)
        entries.update(check_pbr_path_kernels(pbr_runner, pbr_shaded, args.seed, gen))
        view_entries, pbr_view = check_pbr_view(
            pbr_runner, shadow_scene(n_train=20, h=128, w=128, seed=args.seed, split="test"))
        entries.update(view_entries)
        check_pbr_handover(pbr_runner, cesr_cfg, params, dataset,
                           build_stage_config(CESRStageConfig, raw["cesr"]), args.seed, log_dir)

        # the command line's chain from that checkpoint and mesh; stage 2 at
        # configs/hotdog.json with its NeuS at stage 1's PE (multires)
        plan1 = {fm.MAX_WIDTH: (fm.plan_from_sdf_config(model_cfg.sdf), model_cfg.sdf.pe)}
        plan2 = {fm.MAX_WIDTH: (fm.plan_from_sdf_config(cesr_cfg.neus.sdf), cesr_cfg.neus.sdf.pe),
                 fm.MAX_WIDTH_WIDE: (fm.plan_from_sdf_config(stage_cfg.normal_cfg), SHADOW_PE)}
        cli_root = os.path.join(log_dir, "cli")
        neus_sets = ["--set", f"model.neus.sdf.multires={model_cfg.sdf.multires}"]
        cli_runs, cli_entries, s2, march_on = drive_cli_chain(
            cli_root, args.seed, cli_ckpt, mesh_path, runner.grid_values, plan1, plan2,
            neus_sets, gen)
        entries.update(cli_entries)

        # the commands after training: sgfit, relight, textures, import-ref
        post_runs, post_walls = {}, {}
        call = cli_caller(post_runs, post_walls)
        drive_cli_sgfit(cli_root, args.seed, call)
        entries.update(drive_cli_relight(cli_root, s2, runner.grid_values, plan2, march_on,
                                         call, post_runs, gen))
        drive_cli_textures(cli_root, s2, mesh_path, call, post_runs)
        drive_cli_import_ref(cli_root, os.path.join(cli_root, "logs"),
                             os.path.join(cli_root, "shadow"), neus_sets, call, post_runs)
        print("cli wall time after training: " + ", ".join(
            f"{p[4:]} {t:.1f} s" for p, t in post_walls.items()), flush=True)
        cli_runs.update(post_runs)

        # the stage-1 alternates (LLFF and Multicam scenes, VNeRF/MipNeRF
        # under mip, the hash-grid NeuS, the background shell), IDR mode
        # and the mip renderer's sdf compositor
        alt_runs, alt_entries = drive_alternates(
            os.path.join(log_dir, "alt"), args.seed, os.path.join(cli_root, "sphere"),
            os.path.join(cli_root, "shadow"), model_cfg, render_cfg, train_cfg, train_scene,
            dataset, stage_cfg, plan1, gen)
        entries.update(alt_entries)
        cli_runs.update(alt_runs)

        # data parallelism over two ranks on the card, and bf16 sampling
        t0 = time.perf_counter()
        ddp_stages = {"cesr": build_stage_config(CESRStageConfig, raw["cesr"]),
                      "vis": vis_stage, "pbr": pbr_stage, "norm": norm_stage}
        ddp_runs, ddp_entries = drive_ddp(
            model_cfg, render_cfg, train_cfg, dataset_cfg, cesr_cfg, ddp_stages, params,
            args.seed, mesh_path, texture_resolution(raw), tex, runner.grid_values, plan1,
            plan2, gen)
        entries.update(ddp_entries)
        cli_runs.update(ddp_runs)
        bf16_run, bf16_entries = drive_sampling_bf16(model_cfg, render_cfg, train_cfg,
                                                     train_scene, args.steps, args.seed, plan1,
                                                     gen)
        entries.update(bf16_entries)
        cli_runs["sampling_bf16"] = bf16_run
        print(f"ddp_stage1, ddp_stage2 and sampling_bf16: {time.perf_counter() - t0:.1f} s wall",
              flush=True)

        # the NeuS bridge render, the stage-2 options bgr and
        # vis_compute_dtype, and the canonical Vis workload
        phase_s = {}
        t0 = time.perf_counter()
        cli_runs["neus_bridge"], bridge_entries = drive_neus_bridge(dataset, args.seed, gen)
        entries.update(bridge_entries)
        phase_s["neus_bridge"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        check_bgr_vis_step(dataset, vis_stage, args.seed)
        check_vis_compute_dtype(int(np.median(pbr_shaded)), args.seed, gen)
        phase_s["stage2_options"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        cli_runs["vis_workload"], vw_entries = drive_vis_workload(gen)
        entries.update(vw_entries)
        phase_s["vis_workload"] = time.perf_counter() - t0
        print("neus_bridge, stage2_options and vis_workload wall time: " + ", ".join(
            f"{k} {v:.1f} s" for k, v in phase_s.items()) + f"; {sum(phase_s.values()):.1f} s "
            "in all", flush=True)

    # each entry counts its kernel's launches on its path, at its shape (or
    # at every shape: stage 1's entries, timed at the path's largest rows;
    # the CESR and PBR runs' trunk kernels at their shaded rows); the check
    # shapes off the main paths count none
    paths = {"neus_stage1": stage1, "cesr_sphere": cesr_sphere, "bake": bake, "cesr": cesr,
             "mesh": mesh, "norm": norm, "vis_bake": vis_bake, "vis": vis,
             "pbr_bake": pbr_bake, "pbr": pbr, "pbr_view": pbr_view, **cli_runs}
    for name, e in entries.items():
        if e["path"] is None:
            e["launches"] = 0
            continue
        # an entry's shape: None (every shape), or a (width, rows) pattern
        # whose None matches any value
        e["launches"] = sum(n for shape, n in paths[e["path"]].get(e["kernel"], {}).items()
                            if e["shape"] is None or all(
                                p is None or p == v for p, v in zip(e["shape"], shape)))
        if e["launches"] == 0:
            raise RuntimeError(f"{name} was not launched on the {e['path']} path")
    for path, run in paths.items():
        for kernel, by_shape in run.items():
            listed = sum(e["launches"] for e in entries.values()
                         if e["path"] == path and e["kernel"] == kernel)
            if listed != sum(by_shape.values()):
                raise RuntimeError(f"{kernel} on the {path} path: {by_shape} launches, "
                                   f"{listed} in the kernels line")

    print(f"chip_smoke wall time: {time.perf_counter() - t_start:.1f} s (from argument parsing "
          f"to the kernels line, the build included)", flush=True)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms", "rows", "path", "cluster", "ctas")
    print(json.dumps({"kernels": [{k: e.get(k) for k in keys} for e in entries.values()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
