"""The port's CESR step in row mode (surface-pixel compaction) on the grid
tracer, against the JAX package's compacted step: warmup and explore
steps at the small widths of ``test_torch_cesr.py`` (48 pixels, compact
chunk 16, 8 lights), on bridged weights, one grid that JAX bakes and both
packages march, and the draws of JAX's compacted render replayed
(``torch_port_helpers.jax_stage2_draws``); and row mode against the dense
step. The JAX compacted step compiles for 7-17 s a phase on the CPU, so
the project step (``test_torch_cesr_project.py``) and the
``ambient_anchor`` knob, which only row mode applies
(``test_torch_cesr_anchor.py``), have files of their own, with these
inputs and tolerances.

Tolerances as in ``test_torch_cesr.py``: loss and metrics to 1e-5
relative, gradients to rtol 5e-4 and GRAD_ATOL of each tensor's largest
entry. Row mode against dense: sv_loss to 1e-4 relative (the JAX
package's own bound for it, ``tests/test_compact.py``), bit-identical
where a knob must not reach the dense step.
"""

import jax
import numpy as np
import pytest
import torch

from robir_tpu.render.stage2 import Stage2Model as JStage2Model
from robir_tpu_torch.core.draws import Draws
from robir_tpu_torch.render.stage2 import Stage2Model, stage2_forward
from test_torch_cesr import case  # noqa: F401  (the shared fixture)
from test_torch_cesr import (JCFG_GRID, N_LIGHTS, STAGE_KW, TCFG_GRID, JSmallCESR,
                             TSmallCESR, assert_step_matches, jax_step, port_step,
                             shared_grid)
from torch_port_helpers import jax_stage2_draws

CHUNK = 16
KEY = 10


@pytest.fixture(scope="module")
def grid_case(case):
    """The shared weights, a batch, JAX's grid and its copy, the batch's
    surface pixels (JAX's trace), and a cache of JAX steps by (prefit,
    ambient_anchor), each compiled once for the file. The batch takes 36
    pixels on the object and 12 off it, in random order, so that the
    surface rows fill two chunks."""
    params, _, ds, _ = case
    rng = np.random.default_rng(5)
    mask = ds.object_masks[0].reshape(-1)
    batch = ds.pixels(0, rng.permutation(np.concatenate([
        rng.choice(np.flatnonzero(mask), 36, replace=False),
        rng.choice(np.flatnonzero(~mask), 12, replace=False)])))
    jgrid, tgrid = shared_grid(params)
    _, hit, _ = jax.jit(JStage2Model(params, JCFG_GRID, jgrid).trace)(batch["points"],
                                                                     batch["dirs"])
    surface = np.asarray(hit) & batch["object_mask"]
    assert CHUNK < surface.sum() < 48
    return params, batch, jgrid, tgrid, surface, {}


def jax_rows(grid_case, prefit, use_new_normal, use_rgb_loss, ambient_anchor=0.0):
    params, batch, jgrid, _, _, cache = grid_case
    k = (prefit, use_new_normal, use_rgb_loss, ambient_anchor)
    if k not in cache:
        jstage = JSmallCESR(compact_chunk=CHUNK, ambient_anchor=ambient_anchor, **STAGE_KW)
        cache[k] = jax_step(params, JCFG_GRID, jstage, batch, jax.random.PRNGKey(KEY),
                            prefit, use_new_normal, use_rgb_loss, grid=jgrid)
    return cache[k]


def port_rows(grid_case, prefit, use_new_normal, use_rgb_loss, chunk=CHUNK,
              ambient_anchor=0.0):
    params, batch, _, tgrid, surface, _ = grid_case
    draws = jax_stage2_draws(jax.random.PRNGKey(KEY), 48, JCFG_GRID, N_LIGHTS,
                             surface=surface, chunk=chunk)
    return port_step(params, TCFG_GRID,
                     TSmallCESR(compact_chunk=chunk, ambient_anchor=ambient_anchor, **STAGE_KW),
                     batch, draws, prefit, use_new_normal, use_rgb_loss, grid=tgrid)


@pytest.mark.parametrize("prefit,use_new_normal,use_rgb_loss", [
    ("warmup", False, False), ("explore", True, True)])
def test_row_mode_step_matches_jax(grid_case, prefit, use_new_normal, use_rgb_loss):
    """The compacted step (grid tracer, row mode): loss, metrics and every
    trainable gradient."""
    jgrads, metrics = jax_rows(grid_case, prefit, use_new_normal, use_rgb_loss)
    _, tmetrics, tparams = port_rows(grid_case, prefit, use_new_normal, use_rgb_loss)
    assert_step_matches(tmetrics, tparams, metrics, jgrads)


@pytest.mark.parametrize("prefit", ["warmup", "explore", "project"])
def test_row_mode_sv_loss_matches_dense(grid_case, prefit):
    """At ambient_anchor=0 the row-mode sv_loss equals the dense step's
    (the port's copy of tests/test_compact.py's check): every ingredient
    is per-light or per-row, and miss rows weigh 0."""
    args = (prefit, prefit != "warmup", prefit != "warmup")
    _, rows, _ = port_rows(grid_case, *args)
    _, dense, _ = port_rows(grid_case, *args, chunk=0)
    np.testing.assert_allclose(rows["sv_loss"].item(), dense["sv_loss"].item(), rtol=1e-4)


def test_row_mode_rejects_batch_statistics(grid_case):
    """A render that returns a batch statistic cannot be compacted."""
    params, batch, _, tgrid, _, _ = grid_case
    model = Stage2Model(params, TCFG_GRID, "cpu", tgrid)
    inp = {k: torch.as_tensor(batch[k]) for k in ("points", "dirs")}
    with pytest.raises(ValueError, match="batch statistics"):
        stage2_forward(model, Draws(torch.Generator().manual_seed(0)), inp,
                       sg_render_fn=lambda m, d, pts, *a, **k: {"sg_rgb": pts,
                                                               "loss": pts.sum()},
                       compact_chunk=CHUNK)
