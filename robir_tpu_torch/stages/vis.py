"""Stage Vis: the visibility net and the indirect-illumination SG field
(counterpart of ``robir_tpu/stages/vis.py``, the reference's
``training/train_visibility.py``).

The energy net is fitted once at start-up (``fit_energy_prologue``,
train_visibility.py:274). Each step draws a pixel batch and a per-pixel
``hdr_shift`` (:297), runs the Illum forward and the 512-direction
secondary trace through the frozen NeuS (:298-299), and the IllumLoss: a
radiance loss that reaches only the indirect net and a cross-entropy
visibility loss that reaches only the visibility net (its labels are the
trace's hits). So one backward of their sum gives each net the gradient of
its own loss: the cross-gradients are structurally zero, as in the JAX
step. Two ``torch.optim.Adam`` instances (:99-112, :306-313) update the two
nets; every other subtree is frozen.

On the card the step runs the grid march twice (the 256 primary rays and
the 131,072-ray fan) and K3 in the borrowed colour (one launch per slice
of ``fan_compact_chunk`` needed rays); K1, K2 and K4 not at all.
``vis_plot_to_disk`` writes the stage's diagnostic grid of one view.

Data parallelism (``VisRunner(mesh=)``): each rank holds its pixels and so
traces, and borrows the colour of, its own pixels' fan. ``shard_fan``, the
JAX package's spreading of the fan's own axis over the chips
(``robir_tpu/render/stage2.py:485-535``), is therefore what one process per
rank does already: ``shard_fan=True`` computes what ``False`` computes, as
in the JAX package without a mesh (``robir_tpu/stages/vis.py:133-135``).
Every rank fits the energy prologue from the same draws; rank 0's fit is
then broadcast, so the replicas hold one energy net whatever order the
device summed in.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from ..core.draws import Draws
from ..core.mesh import DataMesh, all_reduce_grads, global_sum, replicate
from ..core.params import ParamTree
from ..core.tree import flatten_with_paths
from ..data.syn_dataset import SynDataset
from ..render.color import fit_energy, init_energy, ldr2hdr
from ..render.stage2 import Stage2Config, Stage2Model, stage2_forward, trace_radiance
from ..tools import plots
from ..tools.profiler import span
from .losses import IllumLossConfig, illum_loss
from .stage2_runner import Stage2RunnerBase, StageOptConfig, make_adam, map_view


@dataclasses.dataclass(frozen=True)
class VisStageConfig:
    num_pixels: int = 256
    nsamp: int = 512
    max_iters: int = 200_001
    opt: StageOptConfig = StageOptConfig(lr=5e-4)
    loss: IllumLossConfig = IllumLossConfig(loss_type="L1")
    anneal_t: float = 0.0
    # the fan over the ranks: each rank's fan is its own pixels' already
    # (one process a rank), so True and False compute the same
    shard_fan: bool = False
    # the borrowed colour runs on the needed rays in slices of this many
    # (0: dense, on the whole fan in one call)
    fan_compact_chunk: int = 4096


BATCH_KEYS = ("points", "dirs", "object_mask", "hdr_shift")


def vis_loss(params: ParamTree, cfg: Stage2Config, stage_cfg: VisStageConfig, batch: dict,
             draws: Draws, grid_values=None, traced=None, fan_traced=None,
             mesh: DataMesh | None = None):
    """(radiance + visibility loss, metrics) of one Vis step on ``batch``
    (``BATCH_KEYS``, [N, ...] on the parameters' device). ``traced`` is the
    primary trace's (t, hit) and ``fan_traced`` the fan's (t, hit, x), each
    made beforehand (so that two devices can share one trace); None traces
    here. The metrics are the JAX step's (``radiance_loss``,
    ``visibility_loss``, and the mean P(visible) over the labelled
    front-facing lit directions and the occluded ones, ``vis_conf_lit`` and
    ``vis_conf_occ``) and four counts: ``surface_pixels``, and the fan's
    rays that face the front (``fan_front``), that hit (``fan_hits``) and
    whose colour was borrowed (``fan_need``). Under a ``mesh``, ``batch``
    is this rank's rows and the losses and metrics this rank's shares of
    the global ones (global counts)."""
    model = Stage2Model(params, cfg, batch["dirs"].device, grid_values, mesh)
    fwd = stage2_forward(model, draws, {k: batch[k] for k in BATCH_KEYS},
                         trainstage="Illum", traced=traced)
    tr = trace_radiance(model, draws, fwd, nsamp=stage_cfg.nsamp,
                        compact_chunk=stage_cfg.fan_compact_chunk, traced=fan_traced)
    rad, vis = illum_loss(
        stage_cfg.loss, indirect_sgs=fwd["indirect_sgs"], indir_integral=fwd["indir_integral"],
        network_object_mask=fwd["network_object_mask"], trace_radiance=tr["trace_radiance"],
        sample_dirs=tr["sample_dirs"], gt_vis=tr["gt_vis"], pred_vis=tr["pred_vis"],
        indir_mask=tr["indir_mask"], gt_integral=tr["gt_integral"], anneal_t=stage_cfg.anneal_t,
        mesh=mesh)
    with torch.no_grad():
        p_vis = torch.softmax(tr["pred_vis"], -1)[..., 1]
        nrm = fwd["normals"]
        nrm = nrm / torch.clamp(torch.linalg.norm(nrm, dim=-1, keepdim=True), min=1e-4)
        front = torch.sum(nrm[:, None, :] * tr["sample_dirs"], -1) > 0
        surf = fwd["network_object_mask"][:, None]
        lit = (surf & front & ~tr["gt_vis"]).to(p_vis.dtype)
        occ = (surf & tr["gt_vis"]).to(p_vis.dtype)
        n_lit, n_occ = global_sum(mesh, torch.sum(lit), torch.sum(occ))
        metrics = {
            "radiance_loss": rad.detach(), "visibility_loss": vis.detach(),
            "vis_conf_lit": torch.sum(p_vis * lit) / torch.clamp(n_lit, min=1.0),
            "vis_conf_occ": torch.sum(p_vis * occ) / torch.clamp(n_occ, min=1.0),
            "surface_pixels": torch.sum(surf), "fan_front": torch.sum(front),
            "fan_hits": torch.sum(tr["hit"]), "fan_need": torch.sum(tr["need"])}
    return rad + vis, metrics


def make_vis_step(cfg: Stage2Config, stage_cfg: VisStageConfig,
                  vis_opt: torch.optim.Optimizer, illum_opt: torch.optim.Optimizer,
                  mesh: DataMesh | None = None):
    """``step(params, batch, draws, grid_values=None) -> metrics``: one
    forward and one backward of radiance + visibility loss, then an update
    of each optimizer (the visibility net's and the indirect net's). Under
    a ``mesh`` both nets' gradients and the metrics are summed over the
    ranks in one all-reduce first."""
    trainable = [p for opt in (vis_opt, illum_opt) for g in opt.param_groups
                 for p in g["params"]]

    def step(params: ParamTree, batch: dict, draws: Draws, grid_values=None) -> dict:
        with span("forward"):
            loss, metrics = vis_loss(params, cfg, stage_cfg, batch, draws, grid_values,
                                     mesh=mesh)
        vis_opt.zero_grad(set_to_none=True)
        illum_opt.zero_grad(set_to_none=True)
        with span("backward"):
            loss.backward()
        with span("update"):
            metrics = all_reduce_grads(mesh, trainable, metrics)
            vis_opt.step()
            illum_opt.step()
        return metrics

    return step


class VisRunner(Stage2RunnerBase):
    """The Vis loop on a dataset: ``fit_energy_prologue()`` once, then
    ``run(n)``. With ``tracer="grid"`` call ``bake_grid()`` first.

    Runs on ``cuda`` unless ``device="cpu"`` is passed; with a ``mesh``,
    one rank of a data-parallel run (``Stage2RunnerBase``)."""

    stage_name = "Vis"
    VIS_PREFIX = ("visibility_network",)
    ILLUM_PREFIX = ("indirect_illum_network",)
    TRAINABLE = VIS_PREFIX + ILLUM_PREFIX

    def __init__(self, cfg: Stage2Config, params: dict, dataset: SynDataset,
                 stage_cfg: VisStageConfig = VisStageConfig(), seed: int = 0, device="cuda",
                 log_dir: str | None = None, mesh: DataMesh | None = None):
        super().__init__(cfg, params, seed, device, log_dir, mesh)
        self.stage_cfg = stage_cfg
        self.dataset = dataset
        self._make_optimizers()

    def _make_optimizers(self) -> None:
        """Both nets' Adam, with fresh moments."""
        opt = self.stage_cfg.opt
        self.vis_opt, self.lr_fn = make_adam(
            [p for k in self.VIS_PREFIX for p in self.params[k].parameters()], opt)
        self.illum_opt, _ = make_adam(
            [p for k in self.ILLUM_PREFIX for p in self.params[k].parameters()], opt)
        self._step = make_vis_step(self.cfg, self.stage_cfg, self.vis_opt, self.illum_opt,
                                   self.mesh)

    def _refresh_after_restore(self) -> None:
        super()._refresh_after_restore()
        self._make_optimizers()

    def fit_energy_prologue(self, n_steps: int = 1000) -> None:
        """Fit the energy net on the dataset's masked pixels
        (train_visibility.py:274 -> energy_integral.py:51-77) from a fresh
        init, as the JAX runner does, whose weights a CPU generator seeded
        from the runner's generator makes; the fitted weights replace
        ``params["gamma"]["energy"]`` in place."""
        px = torch.as_tensor(np.clip(self.dataset.masked_pixels(), 1e-4, 1.0),
                             device=self.device)
        gamma = self.params["gamma"]
        seed = int(torch.randint(2 ** 62, (1,), generator=self.generator, device=self.device))
        fitted = fit_energy(
            init_energy(torch.Generator().manual_seed(seed)), px,
            lambda x, shift: ldr2hdr(gamma, self.cfg.tonemap, x, shift),
            lambda _: Draws(self.generator, device=self.device), n_steps=n_steps)
        new = flatten_with_paths(fitted)
        with torch.no_grad():
            for path, p in flatten_with_paths(gamma["energy"]).items():
                p.copy_(new[path])
        replicate(self.mesh, gamma["energy"].parameters())

    def _batch(self) -> dict:
        """A pixel batch of a random camera and its per-pixel ``hdr_shift``,
        drawn from the numpy RNG in the JAX runner's order; this rank's
        rows of them under a mesh."""
        idx = int(self.rng.integers(self.dataset.n_cameras))
        b = self.dataset.sample_pixels(self.rng, idx, self.stage_cfg.num_pixels)
        b["hdr_shift"] = self.rng.random((b["dirs"].shape[0], 1)).astype(np.float32)
        return self._local({k: b[k] for k in BATCH_KEYS})

    def step(self, batch: dict, draws: Draws) -> dict:
        """One update at ``cur_iter``; returns the metrics (detached)."""
        for opt in (self.vis_opt, self.illum_opt):
            for group in opt.param_groups:
                group["lr"] = self.lr_fn(self.cur_iter)
        metrics = self._step(self.params, batch, draws, self.grid_values)
        self.cur_iter += 1
        return metrics


def vis_plot_to_disk(runner: VisRunner, dataset, idx: int = 0, plots_dir: str | None = None,
                     chunk: int = 2048, nsamp: int = 8) -> str:
    """The predicted against the traced visibility and the image of view
    ``idx`` (train_visibility.py plot_to_disk -> utils/plots.py
    plot_illum), into ``plots_dir`` (default ``<log_dir>/Vis/plots``) as
    ``illum_<cur_iter>.png``; returns its path. Per chunk of ``chunk`` rays
    without a graph, with draws from the runner's generator: the Illum
    forward at ``hdr_shift`` 0.5 and ``trace_radiance`` with ``nsamp``
    directions a pixel (on the card two grid marches, and K3 in the
    borrowed colour); the mean P(visible) and the mean traced visibility
    of each pixel, ones off the surface."""
    model = runner.model()

    def chunk_fn(_, o, d):
        draws = Draws(runner.generator, device=runner.device)
        inp = {"points": o, "dirs": d, "hdr_shift": torch.full_like(d[:, :1], 0.5)}
        fwd = stage2_forward(model, draws, inp, trainstage="Illum")
        tr = trace_radiance(model, draws, fwd, nsamp=nsamp)
        pred = torch.softmax(tr["pred_vis"], -1)[..., 1].mean(-1)
        gt = 1.0 - tr["gt_vis"].to(pred.dtype).mean(-1)
        m = fwd["network_object_mask"]
        return {"pred_vis": torch.where(m, pred, 1.0), "gt_vis": torch.where(m, gt, 1.0)}

    out = map_view(dataset, idx, chunk, runner.device, chunk_fn)
    plots_dir = plots_dir or os.path.join(runner.log_dir or ".", runner.stage_name, "plots")
    return plots.plot_illum(out, dataset.rgb_images[idx], plots_dir, runner.cur_iter,
                            dataset.img_res)
