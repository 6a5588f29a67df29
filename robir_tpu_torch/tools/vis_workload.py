"""The canonical Vis-step workload (counterpart of
``robir_tpu/tools/vis_workload.py``): the camera batch a ``VisRunner``
step sees on the procedural sphere dataset, from a fixed seed, at the
reference constants (256 pixels x 512 directions, ``configs/hotdog.json``'s
model: the 320^3 bf16 grid, the 4 x 256 bf16 visibility net). The batch's
surface fraction is part of the record, since the secondary fan's cost
follows the batch's surface pixels.

    python -m robir_tpu_torch.tools.vis_workload [--smoke] [--n_steps 10]
                                                 [--reps 4] [--device cuda|cpu]

prints ``info`` and every run's ms a step as one JSON line.

``build`` has none of the JAX function's grid knobs: the workload is
``configs/hotdog.json``'s grid as written, and its TPU layouts have no
counterpart in the port's march (``tracing/grid.py``). ``time_step`` times
chained steps with ``tools/profiler.py:time_scanned_reps`` and then puts the
runner's trainable parameters, optimizer state and step back as they were.
Both run on ``cuda`` unless ``device="cpu"`` is passed.
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import json
import tempfile
from pathlib import Path

import numpy as np
import torch

from ..core.config import build_stage2_config, load_config
from ..core.draws import Draws
from ..data.syn_dataset import SynDataset, SynDatasetConfig
from ..data.synthetic import make_sphere_dataset
from ..stages.stage2_runner import init_stage2_params
from ..stages.vis import VisRunner, VisStageConfig
from .profiler import time_scanned_reps

# the canonical workload's constants, the JAX module's
NUM_PIXELS = 256
NSAMP = 512
BATCH_SEED = 7
DATASET = dict(n_train=4, n_test=1, h=200, w=200, radius=0.5)
CAMERA_IDX = 0
CONFIG = Path(__file__).resolve().parents[2] / "configs" / "hotdog.json"


def build(smoke: bool = False, device="cuda"):
    """The canonical Vis-step workload: ``(runner, batch, carry, info)``.
    ``runner`` is a ``VisRunner`` at ``configs/hotdog.json``'s model on the
    sphere dataset (``DATASET``), params from seed 0, its grid baked;
    ``batch`` the ``NUM_PIXELS`` pixels of camera ``CAMERA_IDX`` drawn from
    ``BATCH_SEED`` with ``hdr_shift`` 0.5; ``carry`` the generator of the
    timed steps' draws (seed 1); ``info`` the workload's record (pixels,
    directions, surface fraction, provenance). ``smoke``: a 48^3 grid,
    64 x 64 images, 64 pixels x 32 directions."""
    cfg = build_stage2_config(load_config(str(CONFIG))["model"])
    if smoke:
        cfg = dataclasses.replace(cfg, grid=dataclasses.replace(cfg.grid, resolution=48))
    npx, nsamp = (64, 32) if smoke else (NUM_PIXELS, NSAMP)
    with tempfile.TemporaryDirectory() as d:
        ds_args = dict(DATASET, **(dict(h=64, w=64) if smoke else {}))
        make_sphere_dataset(d, **ds_args)
        dataset = SynDataset(SynDatasetConfig(instance_dir=d))
    params = init_stage2_params(torch.Generator().manual_seed(0), cfg)
    runner = VisRunner(cfg, params, dataset, VisStageConfig(num_pixels=npx, nsamp=nsamp),
                       device=device)
    runner.bake_grid()
    # a fixed-seed batch: the same pixels in every process
    runner.rng = np.random.default_rng(BATCH_SEED)
    b = dataset.sample_pixels(runner.rng, CAMERA_IDX, npx)
    batch = runner._local({"points": b["points"], "dirs": b["dirs"],
                           "object_mask": b["object_mask"],
                           "hdr_shift": np.full((npx, 1), 0.5, np.float32)})
    carry = torch.Generator(device=runner.device).manual_seed(1)
    info = {
        "vis_step_px": npx,
        "vis_step_nsamp": nsamp,
        "vis_step_object_frac": round(float(np.asarray(b["object_mask"], np.float32).mean()), 4),
        "vis_step_workload": "hotdog.json model constants, procedural sphere dataset camera "
                             f"batch, seed {BATCH_SEED}",
    }
    return runner, batch, carry, info


def time_step(runner: VisRunner, batch: dict, carry: torch.Generator, n_steps: int = 10,
              reps: int = 4) -> list[float]:
    """Every run's ms a step of ``reps`` runs of ``n_steps`` chained
    ``runner.step`` on ``batch`` (after one warmup chain), their draws from
    ``carry``; timed on the runner's device. Afterwards the trainable
    parameters, both optimizers' state and the step are as they were."""
    saved = ([p.detach().clone() for p in runner.trainable],
             copy.deepcopy(runner.vis_opt.state_dict()),
             copy.deepcopy(runner.illum_opt.state_dict()), runner.cur_iter)

    def one(gen: torch.Generator) -> torch.Generator:
        runner.step(batch, Draws(gen, device=runner.device))
        return gen

    try:
        secs = time_scanned_reps(one, carry, n_steps=n_steps, reps=reps, device=runner.device)
    finally:
        with torch.no_grad():
            for p, v in zip(runner.trainable, saved[0]):
                p.copy_(v)
        runner.vis_opt.load_state_dict(saved[1])
        runner.illum_opt.load_state_dict(saved[2])
        runner.cur_iter = saved[3]
    return [t * 1e3 for t in secs]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--n_steps", type=int, default=10)
    ap.add_argument("--reps", type=int, default=4)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    runner, batch, carry, info = build(smoke=args.smoke, device=args.device)
    out = dict(info, vis_step_ms=time_step(runner, batch, carry, args.n_steps, args.reps))
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
