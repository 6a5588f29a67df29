"""The port's CESR stage in IDR mode (``model.use_neus=false``) against the
JAX package, at ``test_torch_idr.py``'s setting: one dense CESR step (the
loss, the metrics and the gradient of every trainable leaf, on JAX's
draws), and the Vis -> PBR -> CESR hand-over through checkpoints on the
CPU (every leaf the surgery keeps, the frozen IDR pair's included,
bit-equal to the file's).

Tolerances: the CESR step as ``test_torch_cesr.py``; none for the
checkpoints (exact equality).
"""

import jax
import numpy as np
import pytest
import torch

from robir_tpu_torch.core import tree as ttree
from robir_tpu_torch.stages import cesr as tcesr
from robir_tpu_torch.stages import pbr as tpbr
from robir_tpu_torch.stages import stage2_runner as trunner
from robir_tpu_torch.stages import vis as tvis
from test_torch_cesr import (N_LIGHTS, STAGE_KW, JSmallCESR, TSmallCESR, assert_step_matches,
                             jax_step, port_step)
from test_torch_idr import JIDR, TIDR, case, idr_params  # noqa: F401  (the fixture)
from torch_port_helpers import jax_stage2_draws


@pytest.mark.parametrize("prefit,use_new_normal,use_rgb_loss", [("explore", True, True)])
def test_idr_cesr_step_matches_jax(case, prefit, use_new_normal, use_rgb_loss):
    params, _, batch = case
    key = jax.random.PRNGKey(10)
    jgrads, metrics = jax_step(params, JIDR, JSmallCESR(compact_chunk=0, **STAGE_KW), batch,
                               key, prefit, use_new_normal, use_rgb_loss)
    _, tmetrics, tparams = port_step(params, TIDR, TSmallCESR(compact_chunk=0, **STAGE_KW),
                                     batch, jax_stage2_draws(key, 48, JIDR, N_LIGHTS),
                                     prefit, use_new_normal, use_rgb_loss)
    assert_step_matches(tmetrics, tparams, metrics, jgrads)


def _leaves(path: str) -> dict:
    from robir_tpu_torch.core import checkpoint as ckpt_lib
    return ttree.flatten_with_paths(ckpt_lib.load(path)[0])


def test_idr_handover_vis_pbr_cesr(case, tmp_path):
    """Vis -> PBR -> CESR in IDR mode on the CPU: each runner takes its
    predecessor's file; the IDR pair, frozen in every stage, and every
    leaf the surgery keeps, bit-equal to the file's."""
    params, ds, _ = case
    log = str(tmp_path)
    vis = tvis.VisRunner(TIDR, params, ds, tvis.VisStageConfig(num_pixels=16, nsamp=8),
                         device="cpu", log_dir=log)
    vis.run(1)
    vis_file = vis.save()
    pbr = tpbr.PBRRunner(TIDR, trunner.init_stage2_params(torch.Generator().manual_seed(5),
                                                          TIDR),
                         ds, tpbr.PBRStageConfig(num_pixels=16), device="cpu", log_dir=log)
    pbr.load_vis_checkpoint(vis_file)
    pbr_file = pbr.save()
    stage = TSmallCESR(**STAGE_KW)
    cesr = tcesr.CESRRunner(TIDR, idr_params(6), ds, stage, device="cpu", log_dir=log)
    cesr.load_pbr_checkpoint(pbr_file)
    v, p = _leaves(vis_file), _leaves(pbr_file)
    c = {k: t.detach().numpy() for k, t in ttree.flatten_with_paths(cesr.params).items()}
    kept_by_pbr = [k for k in v if k.startswith(("indirect_illum_network",
                                                 "visibility_network"))]
    assert kept_by_pbr and all(np.array_equal(p[k], v[k]) for k in kept_by_pbr)
    kept_by_cesr = [k for k in p if not k.startswith(("shadow_net", "normal_net"))
                    and not (stage.dropout_iter > 0 and "spec_brdf" in k)]
    assert any(k.startswith("rendering_network") for k in kept_by_cesr)
    assert all(np.array_equal(c[k], p[k]) for k in kept_by_cesr)


