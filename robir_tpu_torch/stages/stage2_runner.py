"""Shared stage-2 runner pieces (counterpart of
``robir_tpu/stages/stage2_runner.py``): the Adam optimizer with the
MultiStep schedule, the stage-2 parameter init, and the runner base that
holds the parameter tree on its device with the frozen subtrees frozen,
bakes the grid tracer's grid from the frozen NeuS, and reads and writes
checkpoints in the JAX package's format: the runner's own (``save``,
``restore_latest``), a path-filtered partial restore across stages
(``restore_surgical``, the reference's checkpoint surgery,
``training/train_pbr.py:122-203``), and stage 1's NeuS as the frozen
``implicit_network`` (``load_neus_checkpoint``). Not ported yet: the
chunked ``render_view``.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable, Iterable, Sequence

import numpy as np
import torch

from .. import resolve_device
from ..core import checkpoint as ckpt_lib
from ..core.params import freeze, from_jax
from ..fields.envmap_material import init_envmap_material
from ..fields.neus_model import init_neus
from ..fields.visibility import init_indirect, init_visnet
from ..render.color import init_tonemap
from ..render.stage2 import Stage2Config, Stage2Model
from ..tracing.grid import build_sdf_grid


@dataclasses.dataclass(frozen=True)
class StageOptConfig:
    lr: float = 5e-4
    sched_milestones: tuple[int, ...] = ()
    sched_factor: float = 0.5


def multistep_lr(cfg: StageOptConfig) -> Callable[[int], float]:
    """The learning rate of update ``step`` (counted from 0): ``lr`` times
    ``sched_factor`` for each milestone at or below ``step``, as the JAX
    package's piecewise-constant optax schedule (torch MultiStepLR)."""
    def lr(step: int) -> float:
        return cfg.lr * cfg.sched_factor ** sum(int(m) <= step for m in cfg.sched_milestones)
    return lr


def make_adam(params: Iterable[torch.nn.Parameter], cfg: StageOptConfig):
    """(Adam, lr schedule); the step sets the group's lr to
    ``schedule(step)`` before each update. Adam's defaults are optax's."""
    lr = multistep_lr(cfg)
    return torch.optim.Adam(list(params), lr=lr(0), betas=(0.9, 0.999), eps=1e-8), lr


def init_stage2_params(gen: torch.Generator, cfg: Stage2Config) -> dict:
    """A fresh stage-2 tree (CPU tensors) from a CPU generator: the same
    tree, shapes and distributions as the JAX package's init."""
    return {
        "envmap_material_network": init_envmap_material(gen, cfg.envmap),
        "indirect_illum_network": init_indirect(gen, cfg.indirect),
        "visibility_network": init_visnet(gen, cfg.visnet),
        "gamma": init_tonemap(cfg.tonemap, gen),
        "implicit_network": init_neus(gen, cfg.neus),
    }


def load_neus_checkpoint(path: str) -> dict:
    """The stage-1 NeuS of a checkpoint written by either package's
    ``NeusTrainer.save`` (a file, or the newest ``ckpt_*.npz`` of a
    directory): its ``params`` subtree, numpy leaves in the JAX layout,
    ready to be the stage-2 ``implicit_network`` (``robir_tpu/cli.py``'s
    stage-2 set-up). Raises FileNotFoundError where there is none."""
    found = path if os.path.isfile(path) else ckpt_lib.latest_path(path)
    if found is None:
        raise FileNotFoundError(f"no NeuS checkpoint at {path}")
    return ckpt_lib.load(found)[0]["params"]


class Stage2RunnerBase:
    """The parameter tree on its device (``cuda`` unless ``device="cpu"``),
    the trainable subtrees named by ``TRAINABLE`` and every other subtree
    frozen, the host RNG for batches, the device generator for the step's
    draws, the grid tracer's baked grid (``bake_grid``), and checkpoints
    under ``log_dir/<stage_name>/checkpoints``."""

    stage_name = "Base"
    TRAINABLE: Sequence[str] = ()

    def __init__(self, cfg: Stage2Config, params: dict, seed: int = 0, device="cuda",
                 log_dir: str | None = None):
        self.cfg = cfg
        self.log_dir = log_dir
        self.device = resolve_device(device)
        self.params = from_jax(params, self.device)
        self.trainable = freeze(self.params, self.TRAINABLE)
        self.rng = np.random.default_rng(seed)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.cur_iter = 0
        self.grid_values = None

    def bake_grid(self) -> None:
        """Bake the cached-SDF grid from the frozen NeuS (the reference's
        ``ray_tracer.generate``): ``cfg.grid.resolution``^3 nodes through
        the NeuS bridge's sdf, its weights folded and packed once for all
        the chunks (on the card, K1 launches of 65,536 rows). Stores the
        base [R, R, R] grid as ``grid_values``."""
        model = Stage2Model(self.params, self.cfg, self.device)
        self.grid_values = build_sdf_grid(model.frozen_sdf(), self.cfg.grid,
                                          device=self.device)

    # -- checkpoints ------------------------------------------------------

    def ckpt_dir(self) -> str:
        if not self.log_dir:
            raise ValueError(f"{type(self).__name__} has no log_dir for checkpoints")
        return os.path.join(self.log_dir, self.stage_name, "checkpoints")

    def save(self, extra: dict | None = None) -> str:
        """Write the parameters and ``cur_iter`` to ``ckpt_<step>.npz`` and
        ``latest.npz`` of ``ckpt_dir()`` (the JAX runner's two files);
        returns the step file's path. Optimizer moments are not written, as
        in the JAX package."""
        path = ckpt_lib.step_path(self.ckpt_dir(), self.cur_iter)
        for p in (path, os.path.join(self.ckpt_dir(), "latest.npz")):
            ckpt_lib.save(p, self.params, step=self.cur_iter, extra=extra)
        return path

    def restore_surgical(self, path: str, keep: Callable[[str], bool]) -> None:
        """The leaves of ``path`` that pass ``keep`` into the parameters, in
        place (the reference's cross-stage checkpoint surgery); then
        ``_refresh_after_restore``."""
        ckpt_lib.restore_into(self.params, path, keep=keep)
        self._refresh_after_restore()

    def restore_latest(self) -> bool:
        """Restore ``latest.npz`` of ``ckpt_dir()`` and its step, if there is
        one; returns whether there was."""
        path = os.path.join(self.ckpt_dir(), "latest.npz")
        if not os.path.exists(path):
            return False
        _, meta = ckpt_lib.restore_into(self.params, path)
        self.cur_iter = meta.get("step", 0)
        self._refresh_after_restore()
        return True

    def _refresh_after_restore(self) -> None:
        """Freeze the tree again; subclasses also rebuild their optimizers
        over the restored parameters with fresh moments, as the JAX runners
        do (stage-2 checkpoints carry parameters only)."""
        self.trainable = freeze(self.params, self.TRAINABLE)
