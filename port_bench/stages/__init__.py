"""One driver a stage, found by a traffic mix's ``stage``.

A driver module defines ``build(config, traffic, seed, device)``, which
does the cell's set-up and returns a ``TrainingCell``:
- ``rays_per_step``: the camera rays (pixels) one step trains on;
- ``step()``: one timed call of the program's public entry; ``steps``
  counts them, set-up's included;
- ``work(steps)``: the work a step of the steps with these indices, from
  the benchmark's own arithmetic and, where it depends on the data, its
  own reference (``flops`` by precision, ``trunk_flops``, ``rows``);
- ``release()``: frees the program's state, keeping what ``compare`` needs;
- ``compare(judged="program")``: the numbers that decide ``correct``,
  from the reference run after the window; ``judged="control"`` puts the
  reference in the precision below the configuration's in the program's
  place, and a fault's name the reference with that fault planted.
"""

from __future__ import annotations

import gc
import time

import torch

from .. import compare as cmp
from .. import scenes


class TrainingCell:
    """Set-up shared by the training stages: the scene (of the mix's
    ``scene.seed`` where it names one, else of the run's seed), the
    program's trainer from ``build_program``, its first ``compared_steps``
    steps through the timed call, keeping each step's loss, the first
    gradients (from Adam's state after step 1) and the trained parameters
    after them, then ``warmup_steps`` more; ``phases`` holds the seconds of
    each part. Subclasses set ``reference``
    (a module whose ``train`` follows the program from the same seed) and
    define ``build_program``, ``work`` and, where the step's metrics have
    no ``loss``, ``loss``."""

    reference = None

    def __init__(self, config: dict, traffic: dict, seed: int, device):
        self.config, self.traffic, self.seed, self.device = config, traffic, seed, device
        self.rays_per_step = traffic["batch"]
        sc = traffic["scene"]
        t = time.perf_counter()
        # a mix that names a scene seed keeps one scene for every run: the
        # run's seed then orders the views and draws, not the work
        self.scene = scenes.make_scene(sc["kind"], sc.get("seed", seed), sc["views"],
                                       sc["size"], sc["camera_angle_x"])
        self.phases = {"scene": time.perf_counter() - t}
        self.program, optimizers, params = self.build_program()
        self.phases["program"] = time.perf_counter() - t - self.phases["scene"]
        names = {p: k for k, p in params.items()}
        self.losses, self.first_grads, self.steps = [], None, 0
        for _ in range(traffic["compared_steps"]):
            self.losses.append(self.step())
            if self.first_grads is None:
                self.first_grads = cmp.first_grads_from_adam(optimizers, names)
        self.params = {k: p.detach().clone() for k, p in params.items()}
        for _ in range(traffic["warmup_steps"]):
            self.step()
        self.phases["steps"] = time.perf_counter() - t - sum(self.phases.values())

    def build_program(self):
        """(the program's trainer, its optimizers, {path: trained
        parameter})."""
        raise NotImplementedError

    def loss(self, metrics: dict) -> float:
        return metrics["loss"]

    def step(self) -> float:
        """One train step through ``run(1)``; its loss (a float: the step
        has finished)."""
        self.steps += 1
        return self.loss(self.program.run(1))

    def release(self) -> None:
        close = getattr(self.program, "close", None)
        if close is not None:
            close()
        self.program = None
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()

    def compare(self, judged: str = "program") -> dict:
        def ref(variant=None):
            return self.reference.train(self.config, self.traffic, self.scene, self.seed,
                                        len(self.losses), self.device, variant)

        base = ref()
        subject = ({"losses": self.losses, "first_grads": self.first_grads,
                    "params": self.params} if judged == "program" else ref(judged))
        return cmp.training(subject, base, base["initial"])
