"""Stage CESR: ``CESRRunner.run(1)`` on the benchmark's two-sphere scene.

One runner at the configuration's widths and the mix's pixel batch from
the seeded stage-2 tree (``weights.stage2_weights``) and its own shadow
and normal nets (``reference/cesr.py:net_weights`` makes the same from
the seed and hands them to it), its grid baked from the frozen NeuS,
started at the mix's ``start_iter`` as from a checkpoint of that step
(``TrainingCell`` runs its compared and warm-up steps); every step of the
run is checked to be compacted (row mode) before it starts, as the mix
intends. After the window ``reference/cesr.py`` bakes its own grid,
traces and trains from the same weights on the same draws.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import flops_cesr
from ..reference import cesr as reference
from ..reference import pbr as pbr_reference
from ..weights import nest, stage2_weights
from . import TrainingCell
from .pbr import dataset, trained


class CESRCell(TrainingCell):
    reference = reference

    def build_program(self):
        from robir_tpu_torch.core.config import build_stage2_config, build_stage_config
        from robir_tpu_torch.stages.cesr import CESRRunner, CESRStageConfig

        c = self.config
        runner = CESRRunner(build_stage2_config(c["model"]),
                            nest(stage2_weights(c["model"], self.seed, self.device,
                                                self.traffic.get("neus_seed"))),
                            dataset(c, self.scene),
                            build_stage_config(CESRStageConfig, {
                                **c["cesr"], "num_pixels": self.traffic["batch"]}),
                            seed=self.seed, device=self.device)
        for name, cfg in (("shadow_net", runner.stage_cfg.shadow_cfg),
                          ("normal_net", runner.stage_cfg.normal_cfg)):
            net = c["cesr_nets"][name]
            if (cfg.d_hidden, cfg.n_layers, list(cfg.skip_in)) != (
                    net["d_hidden"], net["n_layers"], net["skip_in"]):
                raise ValueError(f"the program's {name} is not the configuration's {net}")
        leaves = dict(runner.params.named_parameters())
        with torch.no_grad():
            for k, v in reference.net_weights(c, self.seed, self.device).items():
                leaves[k].copy_(v)
        runner.cur_iter = self.traffic.get("start_iter", 0)
        runner.bake_grid()
        return runner, runner.optimizer, trained(runner, [runner.optimizer])

    def step(self) -> float:
        """One ``run(1)``; raises where the runner's guard would take the
        step dense while the configuration compacts."""
        if self.config["cesr"]["compact_chunk"] > 0 and not self.program.step_config(
                ).compact_chunk:
            raise RuntimeError(f"CESR step at iteration {self.program.cur_iter} went dense "
                               f"(surface fraction {self.program.surface_frac})")
        return super().step()

    def work(self, steps) -> dict:
        """The matrix work a step, mean over ``steps`` (indices from 0), at
        the surface rows the reference's own bake and trace find in those
        steps' batches (``flops_cesr.py``)."""
        rows = pbr_reference.surface_rows(self.config, self.traffic, self.scene, self.seed,
                                          list(steps), self.device)
        return flops_cesr.cesr_step_work(self.config, self.traffic["batch"],
                                         float(np.mean(rows)))


def build(config: dict, traffic: dict, seed: int, device) -> CESRCell:
    return CESRCell(config, traffic, seed, device)
