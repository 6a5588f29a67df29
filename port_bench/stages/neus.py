"""Stage 1: ``NeusTrainer.run(1)`` on the benchmark's sphere scene.

One trainer at the configuration's widths and the mix's batch, the seeded
weights copied into it (``TrainingCell`` runs its compared and warm-up
steps); after the window ``reference/neus.py`` trains from the same
weights on the same draws.
"""

from __future__ import annotations

import torch

from .. import flops
from ..reference import neus as reference
from ..weights import neus_weights
from . import TrainingCell


class NeusCell(TrainingCell):
    reference = reference

    def build_program(self):
        from robir_tpu_torch.core.config import build_stage1_configs
        from robir_tpu_torch.data.blender import BlenderScene
        from robir_tpu_torch.stages.neus_stage import NeusTrainer

        batch, c = self.traffic["batch"], self.config
        model_cfg, render_cfg, train_cfg, data_cfg = build_stage1_configs(
            {"model": c["model"], "render": c["render"],
             "train": {**c["train"], "batch_size": batch},
             "dataset": {**c["dataset"], "batch_size": batch}})
        trainer = NeusTrainer(
            BlenderScene.from_arrays(data_cfg, self.scene.images, self.scene.camtoworlds,
                                     self.scene.camera_angle_x),
            model_cfg, render_cfg, train_cfg, seed=self.seed, device=self.device)
        params = dict(trainer.model.params.named_parameters())
        weights = neus_weights(c["model"], self.seed, self.device)
        if sorted(params) != sorted(weights):
            raise KeyError(f"the program's parameters {sorted(params)} are not the "
                           f"benchmark's {sorted(weights)}")
        with torch.no_grad():
            for k, w in weights.items():
                params[k].copy_(w)
        return trainer, trainer.optimizer, params

    def work(self, steps=None) -> dict:
        """The step's matrix work (the same in every step)."""
        return flops.neus_step_work(self.config["model"], self.config["render"],
                                    self.traffic["batch"])


def build(config: dict, traffic: dict, seed: int, device) -> NeusCell:
    return NeusCell(config, traffic, seed, device)
