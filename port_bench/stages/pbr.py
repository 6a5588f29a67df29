"""Stage PBR: ``PBRRunner.run(1)`` on the benchmark's two-sphere scene.

One runner at the configuration's widths and the mix's pixel batch from
the seeded stage-2 tree (``weights.stage2_weights``), its grid baked from
the frozen NeuS (``TrainingCell`` runs its compared and warm-up steps);
after the window ``reference/pbr.py`` bakes its own grid, traces and
trains from the same weights on the same draws.
"""

from __future__ import annotations

import numpy as np

from .. import flops, scenes
from ..reference import pbr as reference
from ..weights import nest, stage2_weights
from . import TrainingCell


def dataset(config: dict, scene: scenes.Scene):
    """The program's stage-2 dataset of a scene: linear radiance (8-bit
    sRGB decoded with gamma 2.2), masks (alpha above one half), poses."""
    from robir_tpu_torch.data.syn_dataset import SynDataset

    return SynDataset.from_arrays(
        [np.power(im[..., :3], 2.2).astype(np.float32) for im in scene.images],
        [im[..., 3] > 0.5 for im in scene.images], scene.camtoworlds, scene.focal,
        scene.images.shape[1:3], config["dataset"]["pose_scale"])


def trained(runner, optimizers) -> dict:
    """{path: parameter} of what ``optimizers`` train."""
    train = {p for opt in optimizers for g in opt.param_groups for p in g["params"]}
    return {k: p for k, p in runner.params.named_parameters() if p in train}


class PBRCell(TrainingCell):
    reference = reference

    def build_program(self):
        from robir_tpu_torch.core.config import build_stage2_config, build_stage_config
        from robir_tpu_torch.stages.pbr import PBRRunner, PBRStageConfig

        c = self.config
        runner = PBRRunner(build_stage2_config(c["model"]),
                           nest(stage2_weights(c["model"], self.seed, self.device,
                                               self.traffic.get("neus_seed"))),
                           dataset(c, self.scene),
                           build_stage_config(PBRStageConfig, {
                               **c["pbr"], "num_pixels": self.traffic["batch"]}),
                           seed=self.seed, device=self.device)
        runner.bake_grid()
        return runner, runner.optimizer, trained(runner, [runner.optimizer])

    def work(self, steps) -> dict:
        """The matrix work a step, mean over ``steps`` (indices from 0), at
        the surface rows the reference's own bake and trace find in those
        steps' batches."""
        rows = reference.surface_rows(self.config, self.traffic, self.scene, self.seed,
                                      list(steps), self.device)
        return flops.pbr_step_work(self.config["model"], self.traffic["batch"],
                                   float(np.mean(rows)))


def build(config: dict, traffic: dict, seed: int, device) -> PBRCell:
    return PBRCell(config, traffic, seed, device)
