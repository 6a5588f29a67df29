"""Shared stage-2 runner pieces (counterpart of
``robir_tpu/stages/stage2_runner.py``): the Adam optimizer with the
MultiStep schedule, the stage-2 parameter init, and the runner base that
holds the parameter tree on its device with the frozen subtrees frozen.

Params live in memory: no grid bake, no checkpoints, no chunked
``render_view`` yet.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Iterable, Sequence

import numpy as np
import torch

from .. import resolve_device
from ..core.params import freeze, from_jax
from ..fields.envmap_material import init_envmap_material
from ..fields.neus_model import init_neus
from ..fields.visibility import init_indirect, init_visnet
from ..render.color import init_tonemap
from ..render.stage2 import Stage2Config


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


class Stage2RunnerBase:
    """The parameter tree on its device (``cuda`` unless ``device="cpu"``),
    the trainable subtrees named by ``TRAINABLE`` and every other subtree
    frozen, the host RNG for batches and the device generator for the
    step's draws."""

    TRAINABLE: Sequence[str] = ()

    def __init__(self, cfg: Stage2Config, params: dict, seed: int = 0, device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.params = from_jax(params, self.device)
        self.trainable = freeze(self.params, self.TRAINABLE)
        self.rng = np.random.default_rng(seed)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.cur_iter = 0
