"""Stage 1 with the hash-grid NeuS: ``NeusTrainer.run(1)`` on the
benchmark's sphere scene.

The trainer is built as the command line's ``neus`` builds it for
``model.type`` "hash": ``stage1_dispatch`` gives the model and render
configs, ``make_stage1_bindings`` the bindings; it runs the eager step
(``stage1_step_path``, checked), and the seeded weights
(``reference/neus_hash.py:weights``) are copied into it (``TrainingCell``
runs its compared and warm-up steps). After the window
``reference/neus_hash.py`` trains from the same weights on the same draws.
"""

from __future__ import annotations

import torch

from .. import flops_hash
from ..reference import neus_hash as reference
from . import TrainingCell


class NeusHashCell(TrainingCell):
    reference = reference

    def build_program(self):
        from robir_tpu_torch.core.config import build_stage1_configs, stage1_dispatch
        from robir_tpu_torch.data.blender import BlenderScene
        from robir_tpu_torch.stages.neus_stage import (NeusTrainer, make_stage1_bindings,
                                                       stage1_step_path)

        batch, c = self.traffic["batch"], self.config
        cfg = {"model": c["model"], "render": c["render"],
               "train": {**c["train"], "batch_size": batch},
               "dataset": {**c["dataset"], "batch_size": batch}}
        model_type, render_type, model_cfg, render_cfg = stage1_dispatch(cfg)
        _, _, train_cfg, data_cfg = build_stage1_configs(cfg)
        if (model_type, render_type) != ("hash", "neus"):
            raise ValueError(f"the configuration is ({model_type}, {render_type}), "
                             "not the hash-grid NeuS under the NeuS renderer")
        bindings = make_stage1_bindings(model_type, render_type, model_cfg, render_cfg)
        trainer = NeusTrainer(
            BlenderScene.from_arrays(data_cfg, self.scene.images, self.scene.camtoworlds,
                                     self.scene.camera_angle_x),
            model_cfg, render_cfg, train_cfg, seed=self.seed, device=self.device,
            bindings=bindings)
        path = stage1_step_path(trainer.device, None, bindings, render_cfg)
        if path != "eager":
            raise RuntimeError(f"the hash-grid NeuS step runs on the {path!r} path, not the "
                               "eager one this cell measures")
        params = dict(trainer.model.params.named_parameters())
        weights = reference.weights(c["model"], self.seed, self.device)
        if sorted(params) != sorted(weights):
            raise KeyError(f"the program's parameters {sorted(params)} are not the "
                           f"benchmark's {sorted(weights)}")
        with torch.no_grad():
            for k, w in weights.items():
                params[k].copy_(w)
        return trainer, trainer.optimizer, params

    def work(self, steps=None) -> dict:
        """The step's matrix work and the encoding's least bytes (the same
        in every step)."""
        return flops_hash.hash_step_work(self.config["model"], self.config["render"],
                                         self.traffic["batch"])


def build(config: dict, traffic: dict, seed: int, device) -> NeusHashCell:
    return NeusHashCell(config, traffic, seed, device)
