"""Shared stage-2 runner pieces (counterpart of
``robir_tpu/stages/stage2_runner.py``): the Adam optimizer with the
MultiStep schedule, the stage-2 parameter init, and the runner base that
holds the parameter tree on its device with the frozen subtrees frozen,
bakes the grid tracer's grid from the frozen NeuS, and reads and writes
checkpoints in the JAX package's format: the runner's own (``save``,
``restore_latest``), a path-filtered partial restore across stages
(``restore_surgical``, the reference's checkpoint surgery,
``training/train_pbr.py:122-203``), and stage 1's NeuS as the frozen
``implicit_network`` (``load_neus_checkpoint``); the PBR and CESR runners'
common loop (``MaterialRunner``); ``render_view``, the chunked eval
render of a whole view, and ``map_view``, the chunking under it that the
stages' plots share.

Data parallelism (``mesh=``, ``core/mesh.py``; the JAX runners'
``mesh=``/``shard_batch``): the parameters are rank 0's; every rank draws
the global pixel batch and the global draws from the shared seed and
keeps its rows; the losses take global counts; the gradients and metrics
are summed in one all-reduce; every rank applies the same update. Each
rank bakes the grid itself (K1 forward, no atomics: the same bits on
every rank, which ``bake_grid`` checks with one all-gather of a checksum)
rather than receive rank 0's, which would move the whole grid. Rank 0
alone writes checkpoints (and, by the callers, plots).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable, Iterable, Sequence

import numpy as np
import torch

from .. import resolve_device
from ..core import checkpoint as ckpt_lib
from ..core.compact import effective_chunk, needed_rows
from ..core.params import freeze, from_jax
from ..fields.envmap_material import init_envmap_material
from ..fields.neus_model import init_neus
from ..fields.radiance import init_rendering
from ..fields.sdf import init_sdf
from ..core.draws import Draws
from ..core.mesh import (DataMesh, all_reduce_grads, batch_split, check_replicas, is_writer,
                         replicate)
from ..fields.visibility import init_indirect, init_visnet
from ..render.color import as_input, hdr2ldr, init_tonemap
from ..render.stage2 import Stage2Config, Stage2Model, stage2_forward
from ..tools.profiler import span
from ..tracing.grid import build_sdf_grid
from .material_graph import MaterialGraphs, graphable


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
    tree, shapes and distributions as the JAX package's init. In IDR mode
    (``use_neus=False``) ``implicit_network`` is the SDF tree and
    ``rendering_network`` the colour net (implicit_differentiable_renderer.py
    :280-282), drawn last, in that order, as the JAX keys 1 and 5 are."""
    params = {
        "envmap_material_network": init_envmap_material(gen, cfg.envmap),
        "indirect_illum_network": init_indirect(gen, cfg.indirect),
        "visibility_network": init_visnet(gen, cfg.visnet),
        "gamma": init_tonemap(cfg.tonemap, gen),
    }
    if cfg.use_neus:
        params["implicit_network"] = init_neus(gen, cfg.neus)
    else:
        params["implicit_network"] = init_sdf(gen, cfg.neus.sdf)
        params["rendering_network"] = init_rendering(gen, cfg.neus.color)
    return params


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


BATCH_KEYS = ("points", "dirs", "object_mask", "rgb")


class Stage2RunnerBase:
    """The parameter tree on its device (``cuda`` unless ``device="cpu"``),
    the trainable subtrees named by ``TRAINABLE`` and every other subtree
    frozen, the host RNG for batches, the device generator for the step's
    draws, the grid tracer's baked grid (``bake_grid``), checkpoints
    under ``log_dir/<stage_name>/checkpoints``, and ``run(n)`` over the
    subclass's ``step`` and ``_batch``.

    With a ``mesh`` the runner is one rank of a data-parallel run on
    ``mesh.device``; the stage's ``num_pixels`` is the global batch, which
    must split evenly over the ranks; every rank calls the same methods."""

    stage_name = "Base"
    TRAINABLE: Sequence[str] = ()

    def __init__(self, cfg: Stage2Config, params: dict, seed: int = 0, device="cuda",
                 log_dir: str | None = None, mesh: DataMesh | None = None):
        self.cfg = cfg
        self.log_dir = log_dir
        self.mesh = mesh
        self.device = mesh.device if mesh is not None else resolve_device(device)
        self.params = from_jax(params, self.device)
        replicate(mesh, self.params.parameters())
        self.trainable = freeze(self.params, self.TRAINABLE)
        self.rng = np.random.default_rng(seed)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.cur_iter = 0
        self.grid_values = None

    def model(self) -> Stage2Model:
        """The stage-2 model of the runner's parameters and grid."""
        return Stage2Model(self.params, self.cfg, self.device, self.grid_values)

    def bake_grid(self) -> None:
        """Bake the cached-SDF grid from the frozen NeuS (the reference's
        ``ray_tracer.generate``): ``cfg.grid.resolution``^3 nodes through
        the NeuS bridge's sdf, its weights folded and packed once for all
        the chunks (on the card, K1 launches of 65,536 rows). Stores the
        base [R, R, R] grid as ``grid_values``."""
        model = Stage2Model(self.params, self.cfg, self.device)
        self.grid_values = build_sdf_grid(model.frozen_sdf(), self.cfg.grid,
                                          device=self.device)
        check_replicas(self.mesh, "the baked grid", [self.grid_values])

    def _local(self, batch: dict) -> dict:
        """This rank's rows of a global batch of numpy arrays, on its
        device."""
        rows = (slice(None) if self.mesh is None
                else self.mesh.local_slice(self.stage_cfg.num_pixels))
        return {k: torch.as_tensor(np.asarray(v)[rows], device=self.device)
                for k, v in batch.items()}

    def _draws(self) -> Draws:
        """A step's draws from the runner's generator; per-row draws of the
        global batch cut to this rank's rows."""
        local = self.stage_cfg.num_pixels // (self.mesh.world if self.mesh is not None else 1)
        return Draws(self.generator, device=self.device, split=batch_split(self.mesh, local))

    def _reduce(self, metrics: dict) -> dict:
        """Sum the trainable gradients and the metrics (detached; ``psnr``
        is global already) over the ranks in one all-reduce; returns the
        metrics, global."""
        metrics = {k: v.detach() for k, v in metrics.items()}
        return all_reduce_grads(self.mesh, self.trainable, metrics, shared=("psnr",))

    # -- checkpoints ------------------------------------------------------

    def ckpt_dir(self) -> str:
        if not self.log_dir:
            raise ValueError(f"{type(self).__name__} has no log_dir for checkpoints")
        return os.path.join(self.log_dir, self.stage_name, "checkpoints")

    def save(self, extra: dict | None = None) -> str:
        """Write the parameters and ``cur_iter`` to ``ckpt_<step>.npz`` and
        ``latest.npz`` of ``ckpt_dir()`` (the JAX runner's two files);
        returns the step file's path. Optimizer moments are not written, as
        in the JAX package. Under a mesh rank 0 alone writes."""
        path = ckpt_lib.step_path(self.ckpt_dir(), self.cur_iter)
        if is_writer(self.mesh):
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

    def run(self, n_iters: int, log_every: int = 0, log_fn=None) -> dict:
        """Take ``n_iters`` steps (``step`` on ``_batch``, with draws from the
        runner's generator). Every ``log_every`` steps (0: never) the
        metrics, as floats, go to ``log_fn(cur_iter, metrics)``. Returns
        the metrics last logged, or the last step's where none was (as the
        JAX runners do)."""
        last, metrics = {}, {}
        for _ in range(n_iters):
            with span("batch"):
                batch, draws = self._batch(), self._draws()
            metrics = self.step(batch, draws)
            if log_every and self.cur_iter % log_every == 0:
                last = {k: float(v) for k, v in metrics.items()}
                if log_fn:
                    log_fn(self.cur_iter, last)
        return last or {k: float(v) for k, v in metrics.items()}


class MaterialRunner(Stage2RunnerBase):
    """The PBR and CESR runners' common loop: one Adam over the trainable
    subtrees (rebuilt with fresh moments after a restore), pixel batches
    drawn in the JAX runners' order, and their switch between compacted and
    dense steps (``step_config``) on the surface fraction read every
    ``guard_every`` steps. Subclasses define ``step``.

    A compacted step on a CUDA device without a mesh takes the graph path
    (``stages/material_graph.py``): its batch goes into the fixed buffers
    of ``graphs`` (a ``MaterialGraphs``, made at the first such step), and
    ``_graph_step`` replays the padded step's CUDA graph of its row bucket
    and flags. Every other step, and every step after a capture failed,
    runs eagerly. A restore drops the graphs (``close``)."""

    def __init__(self, cfg: Stage2Config, params: dict, dataset, stage_cfg, seed: int = 0,
                 device="cuda", log_dir: str | None = None, mesh: DataMesh | None = None):
        super().__init__(cfg, params, seed, device, log_dir, mesh)
        self.stage_cfg = stage_cfg
        self.dataset = dataset
        self.optimizer, self.lr_fn = make_adam(self.trainable, stage_cfg.opt)
        self.surface_frac = None  # read from the device every guard_every steps
        self._graph_on = graphable(self.device, mesh)
        self.graphs: MaterialGraphs | None = None

    def _refresh_after_restore(self) -> None:
        super()._refresh_after_restore()
        self.optimizer, self.lr_fn = make_adam(self.trainable, self.stage_cfg.opt)
        self.close()

    def close(self) -> None:
        """Drop the graphs, their memory pool and the gradients in it."""
        if self.graphs is not None:
            for p in self.trainable:
                p.grad = None
            self.graphs.close()
            self.graphs = None

    def step_config(self):
        """The stage config the next step runs with (the JAX runners'
        ``_pick_step``): the dense step (compact_chunk 0) once the surface
        fraction last read is above ``compact_max_surface_frac``, since
        compaction pays only when there are miss rows to skip."""
        sc = self.stage_cfg
        if (sc.compact_chunk > 0 and self.surface_frac is not None
                and self.surface_frac > sc.compact_max_surface_frac):
            return dataclasses.replace(sc, compact_chunk=0)
        return sc

    def _batch(self) -> dict:
        """``num_pixels`` pixels of a random camera (``BATCH_KEYS``, on the
        runner's device), drawn from the numpy RNG in the JAX runners'
        order; this rank's rows of them under a mesh."""
        idx = int(self.rng.integers(self.dataset.n_cameras))
        b = self.dataset.sample_pixels(self.rng, idx, self.stage_cfg.num_pixels)
        b = {k: b[k] for k in BATCH_KEYS}
        if self._graphed(self.step_config()):
            return self._graph_set().put(b)
        return self._local(b)

    def _graphed(self, step_cfg) -> bool:
        """Whether a step at ``step_cfg`` takes the graph path: compacted,
        on a CUDA device without a mesh."""
        return self._graph_on and bool(effective_chunk(self.stage_cfg.num_pixels,
                                                       step_cfg.compact_chunk))

    def _graph_set(self) -> MaterialGraphs:
        if self.graphs is None:
            self.graphs = MaterialGraphs(self.trainable, self.stage_cfg.compact_chunk,
                                         self.device)
        return self.graphs

    def _graph_step(self, batch: dict, key: tuple, loss_fn) -> dict | None:
        """The step on the graph path, on ``batch`` in the buffers of
        ``graphs.put``: the march and the wait for the surface rows eager,
        then the replay of the graph of the rows' bucket and ``key`` (the
        loss call's host-side flags; ``loss_fn(batch, draws, traced,
        padded)`` is captured at its first step), the gradients handed to
        ``.grad`` and the update. None where the path is off (a capture
        failed): the caller steps eagerly on ``batch``."""
        graphs = self._graph_set()
        if graphs.failed:
            graphs.eager_fallbacks += 1
            return None
        with span("forward"):
            dists, hit = self.model().trace(batch["points"], batch["dirs"])[:2]
            idx = needed_rows(hit & batch["object_mask"])
            out = graphs.run(key, idx, (dists, hit), loss_fn, self.generator)
        if out is None:
            return None
        metrics, grads = out
        with span("backward"):
            for p, g in zip(self.trainable, grads):
                p.grad = g
        return self._apply(metrics)

    def _update(self, loss: torch.Tensor, metrics: dict) -> dict:
        """The Adam update of ``loss`` (``_apply`` after its backward)."""
        self.optimizer.zero_grad(set_to_none=True)
        with span("backward"):
            loss.backward()
        return self._apply(metrics)

    def _apply(self, metrics: dict) -> dict:
        """The Adam update of the gradients in ``.grad`` at ``cur_iter``'s
        learning rate (the gradients and metrics summed over a mesh's ranks
        first); then ``cur_iter`` + 1, and every ``guard_every`` steps the
        surface fraction read (a wait for the device; global, so every rank
        picks the same step). Returns the metrics detached."""
        with span("update"):
            metrics = self._reduce(metrics)
            for group in self.optimizer.param_groups:
                group["lr"] = self.lr_fn(self.cur_iter)
            self.optimizer.step()
            self.cur_iter += 1
            if self.cur_iter % self.stage_cfg.guard_every == 0:
                self.surface_frac = float(metrics["surface_frac"])
        return metrics


def render_view(model: Stage2Model, dataset, idx: int, sg_render_fn=None,
                draws: Callable[[int], Draws] | None = None, chunk: int = 8000,
                train_spec: bool = False, lin_diff: bool = False,
                compact_chunk: int = 512, **sg_kwargs) -> dict:
    """The chunked eval render of view ``idx`` of ``dataset``
    (``robir_tpu/stages/stage2_runner.py:render_view``, the reference's
    ``split_input`` loop, utils/general.py:27-69 and train_pbr.py:240-276).

    The view's rays in chunks of ``chunk``, the last one padded by
    repeating its last ray (the padding is cut from the output); each
    chunk one ``stage2_forward(trainstage="Material")`` without a graph,
    under the learnt shift, compacted at ``compact_chunk`` (on the card:
    one grid march and, through ``sg_render_fn``'s geometry normals, one
    K3 launch a chunk). ``draws(c)`` gives chunk c's draws (default: one
    ``Draws`` a chunk from a generator seeded 0 on the model's device).
    ``sg_kwargs`` go to the render.

    Returns flat [H * W, .] numpy buffers: ``pred_rgb`` (the tone-mapped
    sg + indirect colour, ones off the surface), ``sg_rgb``,
    ``indir_rgb``, ``sg_specular_rgb``, ``diffuse_albedo``, ``roughness``
    (widened to 3), ``normal_map``, ``normals``, ``vis_shadow`` and
    ``mask`` (the traced hits)."""
    params = model.params
    device = params["gamma"]["adapt_illum"].device
    if draws is None:
        gen = torch.Generator(device=device).manual_seed(0)
        draws = lambda _: Draws(gen, device=device)  # noqa: E731

    def render(c, origins, dirs):
        n = dirs.shape[0]
        inp = {"points": origins, "dirs": dirs,
               "hdr_shift": as_input(params["gamma"]).expand(n, 1)}
        out = stage2_forward(model, draws(c), inp, trainstage="Material",
                             sg_render_fn=sg_render_fn, train_spec=train_spec,
                             lin_diff=lin_diff, compact_chunk=compact_chunk, **sg_kwargs)
        pred = hdr2ldr(params["gamma"], model.cfg.tonemap, out["sg_rgb"] + out["indir_rgb"])
        mask = out["network_object_mask"]
        return {"pred_rgb": torch.where(mask[:, None], pred, 1.0),
                "sg_rgb": out["sg_rgb"], "indir_rgb": out["indir_rgb"],
                "sg_specular_rgb": out["sg_specular_rgb"],
                "diffuse_albedo": out["diffuse_albedo"],
                "roughness": out["roughness"].expand(pred.shape),
                "normal_map": out["normal_map"], "normals": out["normals"],
                "vis_shadow": out["vis_shadow"], "mask": mask}

    return map_view(dataset, idx, chunk, device, render)


def map_view(dataset, idx: int, chunk: int, device, fn) -> dict:
    """``fn(c, origins, dirs)`` -> a dict of [chunk, ...] tensors, on each
    chunk c of ``chunk`` rays of view ``idx`` of ``dataset`` (on
    ``device``; the last chunk padded by repeating its last ray), without
    a graph; returns the outputs with the padding cut, concatenated as
    numpy [H * W, ...] buffers."""
    dirs, cam_loc = dataset.camera_rays(idx)
    outs = []
    with torch.no_grad():
        for c, start in enumerate(range(0, dirs.shape[0], chunk)):
            d = dirs[start:start + chunk]
            cut = d.shape[0]
            if cut < chunk:
                d = np.concatenate([d, np.repeat(d[-1:], chunk - cut, 0)])
            o = torch.as_tensor(cam_loc, device=device).expand(chunk, 3)
            out = fn(c, o, torch.as_tensor(d, device=device))
            outs.append({k: v[:cut].cpu().numpy() for k, v in out.items()})
    return {k: np.concatenate([o[k] for o in outs], 0) for k in outs[0]}
