"""Stage 1: NeuS SDF + radiance training (counterpart of
``robir_tpu/stages/neus_stage.py``).

One train step: render a ray batch (sampling through K1, the shaded pass
through K3), the masked MSE + eikonal + silhouette loss (+ the sparsity
and similarity terms), backward (K4 for the SDF trunk), optional
global-norm clipping, then ``torch.optim.Adam`` with
``lr = log_lerp_lr(step)`` set before the update. The model and its
renderer come from ``make_stage1_bindings`` (the JAX package's stage-1
dispatch): NeuS or the hash-grid NeuS under the NeuS renderer (with the
background shell where the config has one), or VNeRF/MipNeRF under the
mip renderer (plain PyTorch: no kernel of the port runs there). Each draw
of a step is asked of a ``Draws`` by name (``t_rand``,
``t_rand_outside``, ``mip_u<level>``). The step counter
starts at 0, as optax counts the first update. ``NeusTrainer`` runs the
loop on a scene, with a checkpoint every ``ckpt_every`` steps and an
in-train eval every ``eval_every`` (a test view and a mesh into a
``tools/logger.py`` run directory), renders test views in chunks, and runs
the test pass (mean PSNR and MSE, render time, rays/s, a video and
``description.json``).

``NeusTrainer.extract_mesh`` meshes the current SDF (``texture/mesh.py``:
on the card, K1 launches of 65,536 grid points, then the host marching
tetrahedra; the hash-grid SDF in plain PyTorch) and refuses a density
model. Ragged scenes (Multicam) render each view at its own
``image_shape`` and log their test frames as images, not a video.

Checkpoints hold the parameters, the step and the Adam moments in the JAX
trainer's layout (``NeusTrainer.state``), so that either package resumes
from the other's file with its moments. ``NeusTrainer.throughput`` gives
the rays/s of chained steps on one batch and leaves the trainer as it was.

On a CUDA device without a mesh, NeuS under the NeuS renderer without the
background shell (``stage1_step_path``), the trainer runs the step as
``graphed_train_step``: the batch, the draws and the cos-anneal ratio are
put in the buffers of a ``step_graph.py:StepGraph``, the loss call and its
backward replay from CUDA graphs captured at the first step (the span
``neus.graph`` around each forward replay), and the update runs eagerly
on the same ``torch.optim.Adam``. The kernels, their precision and the
draws are the eager step's; every other trainer keeps the eager step.

Data parallelism (``NeusTrainer(mesh=)``, ``core/mesh.py``; the JAX
package's ``make_train_step(mesh=)``): every rank draws the global ray
batch and the global draws from the shared seed and keeps its rows; the
parameters start as rank 0's; each mean of the loss is this rank's sum over
the global count (``neus_loss``), so the summed gradients, reduced in one
all-reduce, are the global batch's; every rank applies the same Adam
update. Rank 0 alone writes checkpoints, logs and meshes; the eval render
splits each chunk's rays over the ranks and gathers them.
"""

from __future__ import annotations

import copy
import dataclasses
import time
from typing import Callable, Iterable, NamedTuple, Optional

import numpy as np
import torch

from .. import resolve_device
from ..core import checkpoint as ckpt_lib
from ..core.draws import Draws
from ..core.mesh import (DataMesh, all_reduce_grads, batch_split, gather_rows, global_max,
                         global_sum, is_writer, pad_to_multiple, replicate)
from ..core.schedule import log_lerp_lr
from ..core.tree import flatten_with_paths
from ..data.blender import BlenderScene, Prefetcher, RayBatch
from ..fields.neus_model import HashNeuS, NeuS, NeuSConfig, init_hash_neus, init_neus
from ..fields.sdf import frozen_sdf
from ..fields.vnerf import VNeRF, init_vnerf
from ..render.mip import render_mip
from ..render.neus import NeusRenderConfig, Rays, render_neus
from ..texture.mesh import Mesh, extract_mesh
from ..tools.profiler import span, time_scanned_reps
from .step_graph import StepGraph


@dataclasses.dataclass(frozen=True)
class NeusTrainConfig:
    lr_init: float = 5e-4
    lr_final: float = 5e-6
    lr_delay_steps: int = 2500
    lr_delay_mult: float = 0.01
    max_steps: int = 200_000
    anneal_end: int = 50_000
    batch_size: int = 512
    eikonal_weight: float = 0.1
    silhouette_weight: float = 1.0
    sparsity_weight: float = 0.0
    similarity_weight: float = 0.0
    eval_chunk: int = 1024
    ckpt_every: int = 50_000
    grad_max_norm: float = 0.0
    eval_every: int = 50_000
    mesh_resolution: int = 128
    mesh_bbox: float = 1.2


def mse_to_psnr(mse):
    return -10.0 / np.log(10.0) * torch.log(mse)


def make_optimizer(params: Iterable[torch.nn.Parameter], cfg: NeusTrainConfig):
    """(Adam, lr schedule). The schedule is applied by the train step, which
    sets the group's lr to ``schedule(step)`` before each update."""
    lr = log_lerp_lr(cfg.lr_init, cfg.lr_final, cfg.max_steps,
                     cfg.lr_delay_steps, cfg.lr_delay_mult)
    opt = torch.optim.Adam(list(params), lr=lr(0), betas=(0.9, 0.999), eps=1e-8)
    return opt, lr


def clip_by_global_norm_(params: list[torch.nn.Parameter], max_norm: float) -> None:
    """optax.clip_by_global_norm: scale all grads by max_norm / norm when
    the global norm reaches max_norm."""
    grads = [p.grad for p in params if p.grad is not None]
    norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
    scale = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    for g in grads:
        g.mul_(scale)


def batch_to_rays(batch: RayBatch) -> tuple[Rays, torch.Tensor]:
    """RayBatch of tensors -> (Rays, pixels)."""
    return Rays(batch.origins, batch.directions, batch.viewdirs, batch.radii,
                batch.lossmult, batch.near, batch.far), batch.pixels


def neus_loss(out: dict, mask: torch.Tensor, pixels: torch.Tensor,
              cfg: NeusTrainConfig, mesh: DataMesh | None = None) -> tuple[torch.Tensor, dict]:
    """Masked MSE + eikonal + silhouette (+ the optional Cauchy-log weight
    sparsity and the (sim - 1)^2 similarity terms, regular.py:18-29).
    Density renderers (mip) have no SDF gradient, so no eikonal term.

    Each mean over the batch is a sum over the batch's count. Under a
    ``mesh`` the sums are this rank's and the counts global (the mask's by
    one all-reduce, the batch's the rank's rows times the world size; the
    eikonal term's comes so from the renderer), so the ranks' losses and
    metrics add up to the global batch's; ``psnr`` is then of this rank's
    share of the mse (``train_step`` puts the global one in its place)."""
    n = mask.shape[0] * (mesh.world if mesh is not None else 1)
    mask_sum = global_sum(mesh, torch.sum(mask)) + 1e-5
    mse = torch.sum(mask * (out["rgb"] - pixels) ** 2) / mask_sum
    eikonal = (out["gradient_error"] * cfg.eikonal_weight if "gradient_error" in out
               else torch.zeros((), device=mse.device))
    silhouette = torch.sum((out["acc"] - mask[..., 0]) ** 2) / n * cfg.silhouette_weight
    loss = mse + eikonal + silhouette
    metrics = {"mse": mse, "psnr": mse_to_psnr(mse),
               "eikonal": eikonal, "silhouette": silhouette}
    if cfg.sparsity_weight > 0:
        sparsity = torch.sum(torch.log(1 + 2 * out["weights"] ** 2)) / n
        loss = loss + sparsity * cfg.sparsity_weight
        metrics["sparsity"] = sparsity
    if cfg.similarity_weight > 0 and "similarity" in out:
        sim = torch.sum((out["similarity"] - 1) ** 2) / n
        loss = loss + sim * cfg.similarity_weight
        metrics["similarity"] = sim
    metrics["loss"] = loss
    return loss, metrics


def cos_anneal_ratio(step: int, anneal_end: int) -> float:
    return float(min(np.float32(1.0), np.float32(step) / np.float32(anneal_end)))


class Stage1Bindings(NamedTuple):
    """A stage-1 (model, renderer) pair: ``init(gen)`` the fresh tree (CPU
    tensors), ``model(tree, device)`` the module a trainer holds,
    ``render(draws, rays, model, cos_anneal, is_eval)`` the render,
    ``sdf(model)`` the SDF query for the mesh export (None: a density
    model, which has no mesh), ``pair`` the (model.type, render.type) it
    binds."""

    init: Callable
    model: Callable
    render: Callable
    sdf: Optional[Callable]
    pair: tuple = ()


def neus_render_binding(render_cfg: NeusRenderConfig):
    """render="neus" (volume_render/interface.py:20-34), for NeuS and the
    hash-grid NeuS: the stratified jitter ``t_rand`` ([B, 1] in [0, 1),
    less 0.5) and the shell's ``t_rand_outside`` ([B, n_outside]) asked of
    ``draws`` in training. ``mesh``: the eikonal term's count is global."""
    def render_fn(draws, rays, model, cos_anneal, is_eval=False, mesh=None):
        t_rand = t_out = None
        if not is_eval and render_cfg.perturb > 0:
            b = rays.origins.shape[0]
            t_rand = draws.uniform("t_rand", (b, 1), rows=True) - 0.5
            if render_cfg.n_outside > 0:
                t_out = draws.uniform("t_rand_outside", (b, render_cfg.n_outside), rows=True)
        return render_neus(rays, model, cos_anneal, render_cfg, is_eval, t_rand=t_rand,
                           t_rand_outside=t_out, mesh=mesh)
    return render_fn


def mip_render_binding(render_cfg):
    """render="mip" over VNeRF/MipNeRF fields, trained and evaluated on the
    finest level (the reference's ``mip_render_fn``, interface.py:8-17);
    the 'sim' and 'raw' compositors feed ``similarity`` to the loss
    (trainer.py:129). 'sdf' needs an SDF model, which a density field is
    not: refused with the JAX package's ValueError. Its outputs are per
    ray, so a ``mesh`` changes nothing here."""
    mode = render_cfg.mode
    if mode == "sdf":
        raise ValueError(
            "render.mode='sdf' requires an SDF model; vnerf/mipnerf fields "
            "are density-only. Use model.type=neus with render.type=neus, "
            "or call render.mip.similarity_process directly with an SDF "
            "model adapter.")

    def render_fn(draws, rays, model, cos_anneal, is_eval=False, mesh=None):
        out = render_mip(draws, rays, model, render_cfg, is_eval=is_eval,
                         cos_anneal_ratio=cos_anneal)[-1]
        if mode != "mip":
            out["similarity"] = out["sim_or_grad"]
        return out
    return render_fn


def _neus_mesh_sdf(model: NeuS):
    return frozen_sdf(model.params["sdf_network"], model.cfg.sdf, out_cols=1)


def _hash_mesh_sdf(model: HashNeuS):
    return torch.no_grad()(model.sdf)


def make_stage1_bindings(model_type: str, render: str, model_cfg,
                         render_cfg) -> Stage1Bindings:
    """The bindings of a stage-1 (model.type, render.type) pair, as the JAX
    package's dispatch (trainer.py:39-48, interface.py:37-40): ("neus",
    "neus"), ("hash", "neus"), ("vnerf", "mip"); any other raises KeyError."""
    table = {
        ("neus", "neus"): (init_neus, NeuS, neus_render_binding, _neus_mesh_sdf),
        ("hash", "neus"): (init_hash_neus, HashNeuS, neus_render_binding, _hash_mesh_sdf),
        ("vnerf", "mip"): (init_vnerf, VNeRF, mip_render_binding, None),
    }
    if (model_type, render) not in table:
        raise KeyError(f"unsupported stage-1 combo model={model_type!r} render={render!r}; "
                       f"supported: {sorted(table)}")
    init_fn, module, binder, sdf = table[(model_type, render)]
    return Stage1Bindings(lambda gen: init_fn(gen, model_cfg),
                          lambda tree, device: module(tree, model_cfg, device),
                          binder(render_cfg), sdf, (model_type, render))


def stage1_step_path(device, mesh: DataMesh | None, bindings: Stage1Bindings,
                     render_cfg) -> str:
    """How ``NeusTrainer`` runs its train step: "graph" (``graphed_train_step``:
    the loss call and its backward replayed from CUDA graphs) on a CUDA
    device without a mesh (collectives are not captured) for NeuS under the
    NeuS renderer without the background shell, the step whose shapes are
    fixed and which reads nothing back to the host; "eager" (``train_step``)
    for every other trainer."""
    if (torch.device(device).type == "cuda" and mesh is None
            and bindings.pair == ("neus", "neus")
            and render_cfg.n_outside == 0):
        return "graph"
    return "eager"


def step_loss(model, batch: RayBatch, cos_anneal, draws: Draws, train_cfg: NeusTrainConfig,
              render_fn: Callable, mesh: DataMesh | None = None) -> tuple[torch.Tensor, dict]:
    """The loss call of a train step: the render of ``batch`` (its draws
    asked of ``draws``; ``cos_anneal`` a float or a 0-d tensor) and
    ``neus_loss``."""
    rays, pixels = batch_to_rays(batch)
    out = render_fn(draws, rays, model, cos_anneal, mesh=mesh)
    return neus_loss(out, rays.lossmult, pixels, train_cfg, mesh)


def _update(optimizer: torch.optim.Optimizer, lr_fn: Callable[[int], float], step: int,
            train_cfg: NeusTrainConfig, metrics: dict, mesh: DataMesh | None) -> dict:
    """The all-reduce, the clip and Adam at ``lr_fn(step)`` on the
    gradients in ``.grad``; returns the metrics (the global batch's)."""
    with span("update"):
        params = [p for g in optimizer.param_groups for p in g["params"]]
        metrics = all_reduce_grads(mesh, params, {k: v.detach() for k, v in metrics.items()},
                                   shared=("psnr",))
        metrics["psnr"] = mse_to_psnr(metrics["mse"])
        if train_cfg.grad_max_norm > 1e-10:
            clip_by_global_norm_(params, train_cfg.grad_max_norm)
        for group in optimizer.param_groups:
            group["lr"] = lr_fn(step)
        optimizer.step()
    return metrics


def train_step(model, optimizer: torch.optim.Optimizer,
               lr_fn: Callable[[int], float], batch: RayBatch, step: int,
               train_cfg: NeusTrainConfig, render_cfg, draws: Draws,
               render_fn: Optional[Callable] = None,
               mesh: DataMesh | None = None) -> dict:
    """One update of ``model``'s parameters in place; returns the metrics
    (detached tensors). ``render_fn`` (a ``Stage1Bindings.render``;
    default: the NeuS renderer's) asks ``draws`` for the step's draws.
    Under a ``mesh``, ``batch`` is this rank's rows of the global batch;
    the gradients and metrics are summed over the ranks in one all-reduce
    before the clip and the update, and the metrics returned are the
    global batch's."""
    if render_fn is None:
        render_fn = neus_render_binding(render_cfg)
    with span("forward"):
        loss, metrics = step_loss(model, batch, cos_anneal_ratio(step, train_cfg.anneal_end),
                                  draws, train_cfg, render_fn, mesh)
    optimizer.zero_grad(set_to_none=True)
    with span("backward"):
        loss.backward()
    return _update(optimizer, lr_fn, step, train_cfg, metrics, mesh)


def graphed_train_step(graph: StepGraph, optimizer: torch.optim.Optimizer,
                       lr_fn: Callable[[int], float], step: int,
                       train_cfg: NeusTrainConfig) -> dict:
    """``train_step`` on the inputs ``graph.fill`` put in its buffers: the
    loss call replayed from its CUDA graph (captured at the first call),
    its backward replayed through ``loss.backward()``, the update eager;
    the same spans around each."""
    with span("forward"):
        loss, metrics = graph.loss()
    optimizer.zero_grad(set_to_none=True)
    with span("backward"):
        loss.backward()
    return _update(optimizer, lr_fn, step, train_cfg, metrics, None)


def eval_render(model, render_cfg, batch: RayBatch,
                render_fn: Optional[Callable] = None) -> dict:
    """Forward-only render of a ray batch (no draws, no gradients; NeuS:
    K1 and K3)."""
    rays, _ = batch_to_rays(batch)
    if render_fn is None:
        render_fn = neus_render_binding(render_cfg)
    with torch.no_grad():
        out = render_fn(Draws(), rays, model, 1.0, is_eval=True)
    return {"rgb": out["rgb"], "acc": out["acc"], "dist": out["dist"]}


def _floats(metrics: dict) -> dict:
    """The metrics (0-d tensors) as floats, read back in one copy."""
    return dict(zip(metrics, torch.stack(list(metrics.values())).tolist()))


class NeusTrainer:
    """Host-side loop over a scene: sampling, train steps, checkpoints,
    in-train evals, test renders.

    Runs on ``cuda`` unless ``device="cpu"`` is passed; raises if CUDA is
    asked for and absent. ``save`` and ``restore`` use ``log_dir``.
    ``bindings`` (``make_stage1_bindings``; default: NeuS under the NeuS
    renderer) give the model, its init and its render.

    With a ``mesh`` (``core/mesh.py:create_mesh``) the trainer is one rank
    of a data-parallel run on ``mesh.device``: ``batch_size`` is the global
    batch, which must split evenly over the ranks. Every rank calls ``run``
    and the eval methods alike (they hold collectives); rank 0 alone
    writes checkpoints, logs and meshes, so each rank may pass a
    ``logger``.

    The train step runs as ``stage1_step_path`` says: on the graph
    path ``step_graph`` (a ``StepGraph``, made at the first step) holds
    the step's inputs, and ``run`` and ``throughput`` fill it and replay
    it; its ``captures`` counts one capture, its ``replays`` the steps.
    """

    def __init__(self, scene: BlenderScene, model_cfg: NeuSConfig,
                 render_cfg: NeusRenderConfig, train_cfg: NeusTrainConfig,
                 seed: int = 0, device="cuda", log_dir: str | None = None,
                 bindings: Stage1Bindings | None = None, mesh: DataMesh | None = None):
        self.scene = scene
        self.log_dir = log_dir
        self.model_cfg = model_cfg
        self.render_cfg = render_cfg
        self.train_cfg = train_cfg
        self.mesh = mesh
        self.device = mesh.device if mesh is not None else resolve_device(device)
        self._rows = (mesh.local_slice(train_cfg.batch_size) if mesh is not None
                      else slice(None))
        self.bindings = bindings or make_stage1_bindings("neus", "neus", model_cfg, render_cfg)
        self.model = self.bindings.model(self.bindings.init(torch.Generator().manual_seed(seed)),
                                         self.device)
        replicate(mesh, self.model.parameters())
        self.optimizer, self.lr_fn = make_optimizer(self.model.parameters(),
                                                    train_cfg)
        self.step = 0
        self._rng = np.random.default_rng(seed)
        self._noise = torch.Generator(device=self.device).manual_seed(seed)
        self._prefetch: Prefetcher | None = None
        # the next step's batch, taken while the device runs the step before
        self._ahead: RayBatch | None = None
        self._path = stage1_step_path(self.device, mesh, self.bindings, render_cfg)
        self.step_graph: StepGraph | None = None

    def _sample(self) -> RayBatch:
        return self.scene.sample(self._rng, self.train_cfg.batch_size)

    def _put(self, batch: RayBatch) -> RayBatch:
        """This rank's rows of a global batch, on its device."""
        return RayBatch(*[torch.as_tensor(np.asarray(x)[self._rows], device=self.device)
                          for x in batch])

    def _draws(self) -> Draws:
        """A step's draws: from the trainer's generator, per-ray draws of
        the global batch cut to this rank's rows."""
        local = self._rows.stop - self._rows.start if self.mesh is not None else 0
        return Draws(self._noise, device=self.device, split=batch_split(self.mesh, local))

    def _inputs(self, batch: RayBatch, step: int):
        """Step ``step``'s inputs from ``batch`` (the global batch, numpy, or
        this rank's rows on the device): on the graph path put in
        ``step_graph``'s buffers with the step's draws and cos-anneal ratio
        (None returned); else (this rank's batch on the device, the step's
        draws)."""
        if self._path == "eager":
            return (batch if torch.is_tensor(batch.origins) else self._put(batch)), self._draws()
        if self.step_graph is None:
            def loss_fn(batch, draws, cos_anneal):
                return step_loss(self.model, batch, cos_anneal, draws, self.train_cfg,
                                 self.bindings.render)

            params = [p for g in self.optimizer.param_groups for p in g["params"]]
            # the draws neus_render_binding asks for without the shell
            draws = ({"t_rand": (self.train_cfg.batch_size, 1)} if self.render_cfg.perturb > 0
                     else {})
            self.step_graph = StepGraph(loss_fn, params, batch, draws, self.device)
        self.step_graph.fill(batch, cos_anneal_ratio(step, self.train_cfg.anneal_end),
                             self._noise)
        return None

    def _train_step(self, inputs, step: int) -> dict:
        """One step on ``_inputs``' result."""
        if self._path == "graph":
            return graphed_train_step(self.step_graph, self.optimizer, self.lr_fn, step,
                                      self.train_cfg)
        batch, draws = inputs
        return train_step(self.model, self.optimizer, self.lr_fn, batch, step,
                          self.train_cfg, self.render_cfg, draws, self.bindings.render,
                          self.mesh)

    def run(self, n_steps: int, log_every: int = 0,
            metrics_cb: Callable[[int, dict], None] | None = None,
            test_scene: BlenderScene | None = None, logger=None) -> dict:
        """Train ``n_steps`` steps. Every ``log_every`` steps (0: never) the
        metrics, as floats, go to ``metrics_cb(step, metrics)``; every
        ``eval_every`` steps ``in_train_eval(test_scene, logger)``; every
        ``ckpt_every`` steps, given a ``log_dir``, ``save``. Returns the
        metrics last logged, or the last step's where none was (as the JAX
        trainer does)."""
        if self._prefetch is None:
            self._prefetch = Prefetcher(self._sample)
        cfg = self.train_cfg
        last, metrics = {}, {}
        for _ in range(n_steps):
            with span("batch"):
                batch = self._ahead if self._ahead is not None else next(self._prefetch)
                inputs = self._inputs(batch, self.step)
            metrics = self._train_step(inputs, self.step)
            # the prefetch thread samples the batch after it while this step
            # waits for the device, not at the next step's start
            self._ahead = next(self._prefetch)
            self.step += 1
            if log_every and self.step % log_every == 0:
                last = _floats(metrics)
                if metrics_cb:
                    metrics_cb(self.step, last)
            if cfg.eval_every and self.step % cfg.eval_every == 0:
                self.in_train_eval(test_scene, logger)
            if self.log_dir and self.step % cfg.ckpt_every == 0:
                self.save()
        return last or _floats(metrics)

    def in_train_eval(self, test_scene: BlenderScene | None, logger) -> None:
        """The periodic test render and mesh (trainer.py:75-81): with a
        ``logger``, test view ``step % n_images`` as ``test_rgb_<step>.png``
        with its PSNR and MSE, and the mesh at ``mesh_resolution`` as
        ``meshes/mesh_<step>.ply`` (none for a density model). Under a mesh
        every rank renders its share; rank 0 writes."""
        if logger is None:
            return
        writer = is_writer(self.mesh)
        if test_scene is not None:
            out = self.render_image(self.step % test_scene.n_images, scene=test_scene)
            if writer:
                logger.log_image(self.step, "test_rgb", np.clip(out["rgb"], 0, 1))
                logger.log_scalars(self.step, "test", psnr=out["psnr"], mse=out["mse"])
        if self.bindings.sdf is not None and writer:
            logger.log_mesh(self.step, self.extract_mesh())

    def test(self, test_scene: BlenderScene, n_frames: int | None = None,
             logger=None) -> dict:
        """The test pass (neus/optimization/trainer.py:86-108): render the
        first ``n_frames`` (default: every) test view; returns mean PSNR and
        MSE, the wall time of the renders and rays/s. With a ``logger``: the
        frames as the ``test_frames`` video, the metrics into
        ``description.json`` and rays/s as a scalar."""
        n_frames = min(n_frames or test_scene.n_images, test_scene.n_images)
        frames, psnrs, mses = [], [], []
        t0 = time.perf_counter()
        for i in range(n_frames):
            out = self.render_image(i, scene=test_scene)
            frames.append(out["rgb"])
            psnrs.append(out["psnr"])
            mses.append(out["mse"])
        render_time = time.perf_counter() - t0
        rays_per_sec = sum(f.shape[0] * f.shape[1] for f in frames) / render_time
        metrics = {"mean_psnr": float(np.mean(psnrs)), "mean_mse": float(np.mean(mses)),
                   "render_time": render_time, "rays_per_sec": rays_per_sec}
        if logger is not None and is_writer(self.mesh):
            if len({f.shape for f in frames}) == 1:
                logger.log_video("test_frames", frames)
            else:  # ragged (Multicam): a video needs frames of one size
                for i, f in enumerate(frames):
                    logger.log_image(self.step, f"test_frame_{i}", f)
            logger.log_json(**metrics)
            logger.log_rays_per_sec(self.step, rays_per_sec)
        return metrics

    def _opt_prefixes(self) -> tuple[str, str]:
        """The JAX layout's paths of optax's Adam state and of its schedule's
        count: ``opt_state/0`` and ``opt_state/1``, or, behind
        ``clip_by_global_norm`` (a state without leaves), ``opt_state/1/0``
        and ``opt_state/1/1``."""
        if self.train_cfg.grad_max_norm > 1e-10:
            return "opt_state/1/0", "opt_state/1/1"
        return "opt_state/0", "opt_state/1"

    def state(self) -> dict:
        """``{path: numpy array}`` of what ``save`` writes, in the JAX
        trainer's layout (``flatten_with_paths(to_plain(...))`` of its
        params and optax state): ``params/<path>``; Adam's ``mu/<path>``
        and ``nu/<path>`` (``exp_avg``, ``exp_avg_sq``; zeros before the
        first update, as optax's init) and its ``count``, and the
        schedule's ``count``, both the step (int32)."""
        adam, sched = self._opt_prefixes()
        count = np.int32(self.step)
        out = {f"{adam}/count": count, f"{sched}/count": count}
        for k, p in flatten_with_paths(self.model.params).items():
            out[f"params/{k}"] = p.detach().cpu().numpy().copy()
            st = self.optimizer.state.get(p, {})
            for name, key in (("mu", "exp_avg"), ("nu", "exp_avg_sq")):
                out[f"{adam}/{name}/{k}"] = (st[key].detach().cpu().numpy().copy() if key in st
                                             else np.zeros(tuple(p.shape), np.float32))
        return out

    def save(self) -> str:
        """Write ``log_dir/ckpt_<step>.npz``: ``state()`` and the step, in
        the JAX package's format, so that either package's trainer resumes
        from it and either package's stage 2 reads its parameters
        (``stage2_runner.load_neus_checkpoint``, ``robir_tpu/cli.py``).
        Returns the path; under a mesh rank 0 alone writes it."""
        if not self.log_dir:
            raise ValueError("NeusTrainer.save needs a log_dir")
        path = ckpt_lib.step_path(self.log_dir, self.step)
        if is_writer(self.mesh):
            ckpt_lib.save(path, self.state(), step=self.step)
        return path

    def restore(self, path: str | None = None) -> None:
        """Resume from ``path`` (default: the newest ``ckpt_<step>.npz`` of
        ``log_dir``; nothing where there is none), written by either
        package: the parameters in place, the step, and the Adam moments
        where the file has them (a file without them leaves the moments
        fresh, as a JAX trainer does). A path that ``state()`` lacks raises
        KeyError."""
        path = path or (self.log_dir and ckpt_lib.latest_path(self.log_dir))
        if not path:
            return
        loaded, meta = ckpt_lib.load(path)
        flat = flatten_with_paths(loaded)
        unknown = sorted(set(flat) - set(self.state()))
        if unknown:
            raise KeyError(f"{path}: paths this trainer does not have: {unknown[:5]}")
        ckpt_lib.copy_into(self.model.params, {k[len("params/"):]: v for k, v in flat.items()
                                               if k.startswith("params/")})
        adam, _ = self._opt_prefixes()
        if f"{adam}/count" in flat:
            step = torch.tensor(float(flat[f"{adam}/count"]), dtype=torch.float32)
            for k, p in flatten_with_paths(self.model.params).items():
                self.optimizer.state[p] = {
                    "step": step.clone(),
                    "exp_avg": torch.from_numpy(np.array(flat[f"{adam}/mu/{k}"])).to(p.device),
                    "exp_avg_sq": torch.from_numpy(np.array(flat[f"{adam}/nu/{k}"])).to(p.device)}
        self.step = int(meta.get("step", 0))

    def extract_mesh(self, resolution: int | None = None) -> Mesh:
        """The marching-tetrahedra mesh of the current SDF over
        ``[-mesh_bbox, mesh_bbox]^3`` at ``resolution`` (default
        ``mesh_resolution``) nodes per axis. The SDF trunk's weights are
        folded, and on the card packed, once for all the grid's chunks.
        Raises ValueError for a density model (no SDF, no mesh)."""
        if self.bindings.sdf is None:
            raise ValueError(f"{type(self.model).__name__} is a density model: it has no "
                             "SDF to mesh")
        bb = self.train_cfg.mesh_bbox
        return extract_mesh(self.bindings.sdf(self.model), bbox_min=(-bb,) * 3,
                            bbox_max=(bb,) * 3,
                            resolution=resolution or self.train_cfg.mesh_resolution,
                            device=self.device)

    def throughput(self, n_steps: int = 20, warmup: int = 3, reps: int = 4) -> float:
        """Rays/s sustained, as the JAX trainer's: ``batch_size`` (the
        global batch) over the best time a step of ``reps`` runs of
        ``n_steps`` chained train steps on one batch, after ``warmup``
        steps (``tools/profiler.py:time_scanned_reps``: CUDA events on the
        card, the host clock on the CPU). The batch comes from its own RNG,
        and afterwards the parameters, the Adam state, the step and the
        draws' generator are as they were: the trainer does not move. Under
        a mesh every rank runs the steps and the slowest rank's best time
        counts."""
        params = [p for g in self.optimizer.param_groups for p in g["params"]]
        saved = ([p.detach().clone() for p in params],
                 copy.deepcopy(self.optimizer.state_dict()), self._noise.get_state())
        batch = self._put(self.scene.sample(np.random.default_rng(self.step),
                                            self.train_cfg.batch_size))

        def one(step: int) -> int:
            self._train_step(self._inputs(batch, step), step)
            return step + 1

        try:
            best = min(time_scanned_reps(one, self.step, n_steps, reps, self.device,
                                         warmup=warmup))
        finally:
            with torch.no_grad():
                for p, v in zip(params, saved[0]):
                    p.copy_(v)
            self.optimizer.load_state_dict(saved[1])
            self._noise.set_state(saved[2])
        return self.train_cfg.batch_size / global_max(self.mesh, best)

    def close(self) -> None:
        """Stop the prefetch thread."""
        if self._prefetch is not None:
            self._prefetch.close()
            self._prefetch = None
        self._ahead = None

    def render_image(self, idx: int = 0, scene: BlenderScene | None = None) -> dict:
        """Chunked whole-image render of one view, with its MSE and PSNR
        against the view's image. Under a mesh each chunk (``eval_chunk``
        rounded up to a multiple of the world size) is split over the ranks
        and gathered: every rank returns the whole image."""
        scene = scene or self.scene
        full = scene.image_rays(idx)
        n = full.origins.shape[0]
        world = self.mesh.world if self.mesh is not None else 1
        chunk = pad_to_multiple(self.train_cfg.eval_chunk, world)
        rows = slice(None) if self.mesh is None else self.mesh.local_slice(chunk)
        outs = []
        for i in range(0, n, chunk):
            sl = RayBatch(*[np.asarray(x[i:i + chunk]) for x in full])
            valid = sl.origins.shape[0]
            pad = chunk - valid
            if pad:
                sl = RayBatch(*[np.concatenate([x, np.repeat(x[-1:], pad, 0)])
                                for x in sl])
            # this rank's share of the chunk, then every rank's gathered
            local = RayBatch(*[torch.as_tensor(x[rows], device=self.device) for x in sl])
            out = eval_render(self.model, self.render_cfg, local, self.bindings.render)
            outs.append({k: gather_rows(self.mesh, v)[:valid].cpu().numpy()
                         for k, v in out.items()})
        # per-image shapes for ragged scenes (Multicam); others have h, w
        h, w = scene.image_shape(idx) if hasattr(scene, "image_shape") else (scene.h, scene.w)
        img = {k: np.concatenate([o[k] for o in outs], 0) for k in outs[0]}
        rgb = img["rgb"].reshape(h, w, 3)
        mse = float(np.mean((rgb - scene.images[idx]) ** 2))
        return {"rgb": rgb, "acc": img["acc"].reshape(h, w), "dist": img["dist"].reshape(h, w),
                "mse": mse, "psnr": -10.0 / np.log(10.0) * np.log(mse)}
