"""Command-line entry points of the port (counterpart of
``robir_tpu/cli.py``): the same subcommands, flags, configs, log-dir layout
and checkpoint files, on the card unless ``--device cpu`` is given.

    python -m robir_tpu_torch.cli neus --conf configs/neus_blender.json --data DIR
    python -m robir_tpu_torch.cli mesh --conf ... --ckpt CKPT --out mesh.ply
    python -m robir_tpu_torch.cli norm --conf configs/hotdog.json --data DIR --mesh mesh.ply
    python -m robir_tpu_torch.cli vis  --conf ... --data DIR
    python -m robir_tpu_torch.cli pbr  --conf ... --data DIR
    python -m robir_tpu_torch.cli cesr --conf ... --data DIR
    python -m robir_tpu_torch.cli relight  --conf ... --data DIR --envmap ENVDIR
    python -m robir_tpu_torch.cli textures --conf ... --data DIR --mesh mesh.ply
    python -m robir_tpu_torch.cli import-ref --conf ... [--stage1_tar T] [--stage2_pth P]
    python -m robir_tpu_torch.cli sgfit --envmap_path ENV.exr

Each stage reads the previous one's files under ``--log_dir``:
``NeuS/ckpt_<step>.npz`` (or ``neus_checkpoint``), ``Norm``, ``Vis`` and
``PBR``'s ``checkpoints/latest.npz``; ``relight`` and ``textures`` read
CESR's ``latest.npz``, else PBR's (or ``--ckpt``); ``import-ref`` writes
reference checkpoints there. The files are the JAX package's, so a run may
switch packages between any two stages. Where a config asks for a piece
the port lacks, the command raises NotImplementedError naming its
ROADMAP.md item. Errors of a plot or of the logger are raised, not
printed: on the card they may be a failed kernel launch.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os

import numpy as np
import torch

# the dataset keys of the JAX package's LLFF and Multicam loaders
# (robir_tpu/data/llff.py, multicam.py), not ported yet (ROADMAP.md A.6):
# a config valid for the JAX CLI parses here too


@dataclasses.dataclass
class LLFFConfig:
    data_dir: str = ""
    factor: int = 0
    llffhold: int = 8
    spherify: bool = False
    near_ndc: float = 1.0


@dataclasses.dataclass
class MulticamConfig:
    dataset_dir: str = ""
    white_bkgd: bool = True


def _add_common(p: argparse.ArgumentParser) -> None:
    p.add_argument("--conf", type=str, required=True)
    p.add_argument("--data", type=str, default=None)
    p.add_argument("--log_dir", type=str, default="logs")
    p.add_argument("--n_iters", type=int, default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--set", dest="overrides", action="append", default=[],
                   help="dotted config override, e.g. --set model.grid.resolution=128")
    p.add_argument("--is_continue", action="store_true")
    p.add_argument("--plot_freq", type=int, default=0,
                   help="render the stage's diagnostic grid every N iters "
                        "(0 = only once, after training)")
    p.add_argument("--no_plot", action="store_true",
                   help="skip diagnostic plots entirely")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="where the port runs (cuda raises without a card)")


def _known_dataset_keys() -> set:
    """Every dataset loader's config field names, and 'type'."""
    from .data.blender import BlenderConfig
    from .data.neus_npz import DTUConfig, NeuSNpzSceneConfig
    from .data.syn_dataset import SynDatasetConfig
    keys = {"type"}
    for dc in (BlenderConfig, LLFFConfig, MulticamConfig, NeuSNpzSceneConfig, DTUConfig,
               SynDatasetConfig):
        keys |= {f.name for f in dataclasses.fields(dc)}
    return keys


def _filter_fields(dc_type, d: dict) -> dict:
    """The keys of ``d`` that dataclass ``dc_type`` takes (the dataset dict
    is shared by the stage-1 and stage-2 loaders). A key that no loader
    takes raises KeyError: a typo dropped in silence degrades a run."""
    unknown = set(d) - _known_dataset_keys()
    if unknown:
        raise KeyError(f"unknown dataset config key(s) {sorted(unknown)}; no loader "
                       "accepts them (check for typos)")
    names = {f.name for f in dataclasses.fields(dc_type)}
    return {k: v for k, v in d.items() if k in names}


def _load(args) -> dict:
    from .core.config import apply_overrides, load_config
    return apply_overrides(load_config(args.conf), args.overrides)


def _stage1_configs(cfg_dict: dict):
    """(model, render, train) configs of stage 1. ``model.type`` "neus"
    (its fields at ``model`` or, in a stage-2 config, at ``model.neus``);
    "hash" and "vnerf" and ``render.type`` "mip" are not ported."""
    from .core.config import _build, build_neus_config, build_neus_render_config
    from .stages.neus_stage import NeusTrainConfig
    model_d = dict(cfg_dict.get("model", {}))
    render_d = dict(cfg_dict.get("render", {}))
    model_type = model_d.pop("type", "neus")
    render_type = render_d.pop("type", "mip" if model_type == "vnerf" else "neus")
    if model_type in ("hash", "vnerf") or render_type == "mip":
        raise NotImplementedError(
            f"stage-1 model.type {model_type!r} with render.type {render_type!r}: the port "
            "has the NeuS model and renderer only (ROADMAP.md A.9)")
    if model_type != "neus":
        raise KeyError(f"unknown stage-1 model.type {model_type!r}")
    src = model_d["neus"] if "neus" in model_d and "sdf" not in model_d else model_d
    return (build_neus_config(src), build_neus_render_config(render_d),
            _build(NeusTrainConfig, cfg_dict.get("train")))


def _stage1_scenes(args, cfg_dict: dict):
    """``make_scene(split)`` of the config's stage-1 ``dataset.type``:
    "blender"/"syn" (BlenderScene) or "neus_npz"/"dtu"/"neus"
    (NeuSNpzScene, both splits on one loaded dataset)."""
    ds_dict = dict(cfg_dict.get("dataset", {}))
    kind = ds_dict.pop("type", "blender")
    if kind in ("neus_npz", "dtu", "neus"):
        from .data.neus_npz import NeuSNpzScene, NeuSNpzSceneConfig
        ds = _filter_fields(NeuSNpzSceneConfig, ds_dict)
        bases = []

        def make_scene(split):
            sc = NeuSNpzScene(NeuSNpzSceneConfig(dataset_dir=args.data, **ds), split,
                              base=bases[0] if bases else None)
            bases[:] = [sc.base]
            return sc
        return make_scene
    if kind in ("blender", "syn"):
        from .data.blender import BlenderConfig, BlenderScene
        ds = _filter_fields(BlenderConfig, ds_dict)
        return lambda split: BlenderScene(BlenderConfig(dataset_dir=args.data, **ds), split)
    if kind in ("multicam", "mip", "llff"):
        raise NotImplementedError(f"dataset.type {kind!r}: the LLFF and Multicam loaders "
                                  "are not ported (ROADMAP.md A.6)")
    raise KeyError(f"unknown stage-1 dataset.type {kind!r} (expected 'blender', "
                   "'neus_npz', 'multicam', or 'llff')")


def _stage2_dataset(data_dir: str, cfg_dict: dict):
    """The stage-2 dataset of ``dataset.type``: "syn" (SynDataset) or
    "dtu" (DTUSceneDataset)."""
    ds_cfg = dict(cfg_dict.get("dataset", {}))
    kind = ds_cfg.pop("type", "syn")
    if kind == "dtu":
        from .data.neus_npz import DTUConfig, DTUSceneDataset
        return DTUSceneDataset(DTUConfig(data_dir=data_dir, **_filter_fields(DTUConfig, ds_cfg)))
    if kind == "syn":
        from .data.syn_dataset import SynDataset, SynDatasetConfig
        return SynDataset(SynDatasetConfig(instance_dir=data_dir,
                                           **_filter_fields(SynDatasetConfig, ds_cfg)))
    raise KeyError(f"unknown dataset.type {kind!r} (expected 'syn' or 'dtu')")


def _stage2_setup(args, cfg_dict: dict):
    """(Stage2Config, dataset, fresh params from ``--seed``) with the frozen
    NeuS of ``neus_checkpoint`` (a file, or a directory's newest
    ``ckpt_<step>.npz``; default ``<log_dir>/NeuS``) as the
    ``implicit_network``, or its fresh init, with a warning, where there is
    none. A NeuS whose leaves' shapes are not ``model.neus``'s raises
    ValueError (the JAX CLI takes it and fails in the first matmul)."""
    from .core import checkpoint as ckpt_lib
    from .core.config import build_stage2_config
    from .core.tree import flatten_with_paths
    from .stages.stage2_runner import init_stage2_params

    if not cfg_dict["model"].get("use_neus", True):
        raise NotImplementedError("model.use_neus=false (IDR mode): the plain IDR pair is "
                                  "not ported (ROADMAP.md A.9)")
    cfg = build_stage2_config(cfg_dict["model"])
    dataset = _stage2_dataset(args.data, cfg_dict)
    params = init_stage2_params(torch.Generator().manual_seed(args.seed), cfg)
    neus_ckpt = cfg_dict.get("neus_checkpoint") or os.path.join(args.log_dir, "NeuS")
    path = neus_ckpt if os.path.isfile(neus_ckpt) else ckpt_lib.latest_path(neus_ckpt)
    if path:
        loaded = ckpt_lib.load(path)[0]["params"]
        want, got = ({k: tuple(v.shape) for k, v in flatten_with_paths(tree).items()}
                     for tree in (params["implicit_network"], loaded))
        if got != want:
            diff = sorted(k for k in set(got) | set(want) if got.get(k) != want.get(k))
            raise ValueError(
                f"the NeuS of {path} does not fit the config's model.neus (e.g. {diff[0]}: "
                f"{got.get(diff[0])} in the file, {want.get(diff[0])} in the config); give "
                "model.neus stage 1's widths, e.g. --set model.neus.sdf.multires=10 for a "
                "stage 1 trained at configs/neus_blender.json")
        params["implicit_network"] = loaded
        print(f"[stage2] frozen NeuS geometry from {path}")
    else:
        print("[stage2] warning: no NeuS checkpoint found; using fresh init")
    return cfg, dataset, params


def _plot_stage(runner, dataset, log_name: str) -> None:
    """The stage's diagnostic grid of view 0 (the reference plots every
    train.plot_freq iters, e.g. train_pbr.py:435) and, for PBR and CESR,
    the SG envmap image (train_cesr.py:363-369) as
    ``<stage>/plots/envmap_<iter>.png``."""
    from .stages.cesr import cesr_plot_to_disk
    from .stages.norm import norm_plot_to_disk
    from .stages.pbr import pbr_plot_to_disk
    from .stages.vis import vis_plot_to_disk
    if dataset is None:
        return
    plotter = {"Norm": norm_plot_to_disk, "Vis": vis_plot_to_disk, "PBR": pbr_plot_to_disk,
               "CESR": cesr_plot_to_disk}[log_name]
    print(f"[{log_name}] plot -> {plotter(runner, dataset)}", flush=True)
    if log_name in ("PBR", "CESR"):
        from PIL import Image

        from .render.sg import compute_envmap
        with torch.no_grad():
            lgt = runner.model().material(torch.zeros((1, 3), device=runner.device)).lgt_sgs
            env = compute_envmap(lgt, 128, 256).cpu().numpy()
        img = np.clip(np.power(np.clip(env, 0, None), 1 / 2.2), 0, 1)
        path = os.path.join(runner.log_dir or ".", runner.stage_name, "plots",
                            f"envmap_{runner.cur_iter}.png")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        Image.fromarray((img * 255).astype(np.uint8)).save(path)


def _run_stage(runner, args, stage_cfg_iters: int, log_name: str, dataset=None):
    """The stage-2 loop of every stage: ``--is_continue`` restores
    ``latest.npz``; the grid is baked if it is not yet; ``--n_iters`` (or
    the stage's ``max_iters``) steps, logged every 50 to the console and
    ``<log_dir>/<stage>/<stage>/scalars.jsonl``, plotted every
    ``--plot_freq`` and at the end (none with ``--no_plot``); then
    ``save``. Returns the runner."""
    from .tools.logger import Logger
    if args.is_continue:
        runner.restore_latest()
    if runner.grid_values is None:
        runner.bake_grid()
    n = args.n_iters or stage_cfg_iters
    tb = Logger(os.path.join(runner.log_dir, log_name), log_name) if runner.log_dir else None

    def log(it, m):
        print(f"[{log_name}] iter {it}: " + ", ".join(f"{k}={v:.5g}" for k, v in m.items()),
              flush=True)
        if tb is not None:
            tb.log_scalars(it, tag_prefix=log_name.lower(), **m)

    plot_freq = 0 if args.no_plot else args.plot_freq
    if plot_freq > 0:
        done = 0
        while done < n:
            step = min(plot_freq, n - done)
            runner.run(step, log_every=50, log_fn=log)
            done += step
            _plot_stage(runner, dataset, log_name)
    else:
        runner.run(n, log_every=50, log_fn=log)
        if not args.no_plot:
            _plot_stage(runner, dataset, log_name)
    print(f"[{log_name}] saved {runner.save()}", flush=True)
    return runner


def cmd_neus(args):
    """Stage 1: train (or, with ``--test_only``, restore) a NeuS in
    ``<log_dir>/NeuS``, with the in-train evals and the test pass into its
    ``neus`` run directory; returns the trainer."""
    from .stages.neus_stage import NeusTrainer
    from .tools.logger import Logger
    cfg_dict = _load(args)
    model_cfg, render_cfg, train_cfg = _stage1_configs(cfg_dict)
    make_scene = _stage1_scenes(args, cfg_dict)
    trainer = NeusTrainer(make_scene("train"), model_cfg, render_cfg, train_cfg,
                          seed=args.seed, device=args.device,
                          log_dir=os.path.join(args.log_dir, "NeuS"))
    try:
        if args.is_continue or args.test_only:
            trainer.restore()
        logger = Logger(os.path.join(args.log_dir, "NeuS"), exp_name="neus")
        try:
            test_scene = make_scene("test")
        except (FileNotFoundError, KeyError, OSError) as e:
            print(f"[NeuS] no test split ({e}); in-train eval and the final test pass are "
                  "disabled")
            test_scene = None
        if not args.test_only:
            def log(it, m):
                print(f"[NeuS] step {it}: " + ", ".join(f"{k}={v:.5g}" for k, v in m.items()),
                      flush=True)
            trainer.run(args.n_iters or train_cfg.max_steps, log_every=50, metrics_cb=log,
                        test_scene=test_scene, logger=logger)
            print("[NeuS] saved", trainer.save())
        elif test_scene is None:
            raise FileNotFoundError("--test_only needs a test split (none could be loaded)")
        if test_scene is not None:
            metrics = trainer.test(test_scene, logger=logger)
            print("[NeuS] test: " + ", ".join(f"{k}={v:.5g}" for k, v in metrics.items()),
                  flush=True)
    finally:
        trainer.close()
    return trainer


def cmd_mesh(args):
    """The marching-tetrahedra mesh of a stage-1 checkpoint's SDF at the
    config's ``mesh`` section, written as a PLY to ``--out``; returns it."""
    from .core import checkpoint as ckpt_lib
    from .core.config import build_mesh_config
    from .core.tree import flatten_with_paths
    from .fields.neus_model import NeuS, init_neus
    from .fields.sdf import frozen_sdf
    from .texture.mesh import extract_mesh
    cfg_dict = _load(args)
    model_cfg, _, _ = _stage1_configs(cfg_dict)
    model = NeuS(init_neus(torch.Generator().manual_seed(0), model_cfg), model_cfg,
                 args.device)
    loaded, _ = ckpt_lib.load(args.ckpt)
    ckpt_lib.copy_into(model.params, flatten_with_paths(loaded["params"]))
    mcfg = build_mesh_config(cfg_dict)
    mesh = extract_mesh(frozen_sdf(model.params["sdf_network"], model_cfg.sdf, out_cols=1),
                        bbox_min=tuple(mcfg.bbox_min), bbox_max=tuple(mcfg.bbox_max),
                        resolution=mcfg.resolution, device=args.device)
    mesh.export_ply(args.out)
    print(f"[mesh] {len(mesh.verts)} verts, {len(mesh.tris)} tris -> {args.out}")
    return mesh


def cmd_norm(args):
    """The Norm stage on the texture-space samples of ``--mesh`` (its
    texture cache beside it, made on first use); returns the runner."""
    from .core.config import build_stage_config, texture_resolution
    from .stages.norm import NormRunner, NormStageConfig
    from .texture.focus_sampler import TexSpaceSampler, focus_sampler_from_dataset
    from .texture.pipeline import TexSampler
    from .tracing.grid import grid_cast
    cfg_dict = _load(args)
    cfg, dataset, params = _stage2_setup(args, cfg_dict)
    stage_cfg = build_stage_config(NormStageConfig, cfg_dict.get("norm"))
    runner = NormRunner(cfg, params, None, stage_cfg, seed=args.seed, device=args.device,
                        log_dir=args.log_dir)
    runner.bake_grid()
    runner.sampler = TexSpaceSampler(
        TexSampler(args.mesh, texture_resolution(cfg_dict)), focus_sampler_from_dataset(dataset),
        lambda o, d: grid_cast(runner.grid_values, cfg.grid, o, d),
        offset=TexSpaceSampler.offset_for_grid(cfg.grid), device=args.device)
    return _run_stage(runner, args, stage_cfg.max_iters, "Norm", dataset=dataset)


def cmd_vis(args):
    """The Vis stage, from the Norm stage's normal decoder where there is
    one; the energy prologue first; returns the runner."""
    from .core import checkpoint as ckpt_lib
    from .core.config import build_stage_config
    from .stages.vis import VisRunner, VisStageConfig
    cfg_dict = _load(args)
    cfg, dataset, params = _stage2_setup(args, cfg_dict)
    stage_cfg = build_stage_config(VisStageConfig, cfg_dict.get("vis"))
    # the Illum forward offsets the secondary rays' origins along the AE
    # normal map, so the Norm stage's decoder comes first
    # (train_visibility.py:116-123); a random one poisons the labels
    norm_ckpt = os.path.join(args.log_dir, "Norm", "checkpoints", "latest.npz")
    if os.path.exists(norm_ckpt):
        params, _ = ckpt_lib.restore_into(params, norm_ckpt,
                                          keep=lambda p: "normal_decoder_layer" in p)
        print(f"[Vis] normal decoder from {norm_ckpt}")
    else:
        print("[Vis] warning: no Norm checkpoint; AE normals are untrained")
    runner = VisRunner(cfg, params, dataset, stage_cfg, seed=args.seed, device=args.device,
                       log_dir=args.log_dir)
    runner.bake_grid()
    runner.fit_energy_prologue()
    return _run_stage(runner, args, stage_cfg.max_iters, "Vis", dataset=dataset)


def cmd_pbr(args):
    """The PBR stage from the Vis stage's checkpoint (required) and the Norm
    stage's decoder where there is one; returns the runner."""
    from .core.config import build_stage_config
    from .stages.pbr import PBRRunner, PBRStageConfig
    cfg_dict = _load(args)
    cfg, dataset, params = _stage2_setup(args, cfg_dict)
    stage_cfg = build_stage_config(PBRStageConfig, cfg_dict.get("pbr"))
    runner = PBRRunner(cfg, params, dataset, stage_cfg, seed=args.seed, device=args.device,
                       log_dir=args.log_dir)
    norm_ckpt = os.path.join(args.log_dir, "Norm", "checkpoints", "latest.npz")
    vis_ckpt = os.path.join(args.log_dir, "Vis", "checkpoints", "latest.npz")
    if os.path.exists(norm_ckpt):
        runner.load_norm_checkpoint(norm_ckpt)
    else:
        print("[PBR] warning: no Norm checkpoint; shading with "
              + ("the untrained AE normal map" if stage_cfg.use_normal_map
                 else "the geometry normals"))
    if not os.path.exists(vis_ckpt):
        raise SystemExit("[PBR] missing Vis checkpoint; train Vis first")
    runner.load_vis_checkpoint(vis_ckpt)
    return _run_stage(runner, args, stage_cfg.max_iters, "PBR", dataset=dataset)


def cmd_cesr(args):
    """The CESR stage from the PBR stage's checkpoint (required); returns
    the runner."""
    from .core.config import build_stage_config
    from .stages.cesr import CESRRunner, CESRStageConfig
    cfg_dict = _load(args)
    cfg, dataset, params = _stage2_setup(args, cfg_dict)
    stage_cfg = build_stage_config(CESRStageConfig, cfg_dict.get("cesr"))
    runner = CESRRunner(cfg, params, dataset, stage_cfg, seed=args.seed, device=args.device,
                        log_dir=args.log_dir)
    pbr_ckpt = os.path.join(args.log_dir, "PBR", "checkpoints", "latest.npz")
    if not os.path.exists(pbr_ckpt):
        raise SystemExit("[CESR] missing PBR checkpoint; train PBR first")
    runner.load_pbr_checkpoint(pbr_ckpt)
    return _run_stage(runner, args, stage_cfg.max_iters, "CESR", dataset=dataset)


def _stage2_checkpoint(args) -> str:
    """``--ckpt``, else CESR's ``latest.npz``, else PBR's."""
    ckpt = args.ckpt or os.path.join(args.log_dir, "CESR", "checkpoints", "latest.npz")
    if not os.path.exists(ckpt):
        ckpt = os.path.join(args.log_dir, "PBR", "checkpoints", "latest.npz")
    return ckpt


def cmd_relight(args):
    """Relit renders of the test views (the train views where there is no
    test split) under the prefit envmap ``--envmap``, from the latest CESR
    (or PBR) checkpoint, into ``--out`` (default
    ``<log_dir>/relight/<envmap name>``), with ``metrics.json`` where the
    scene has relit ground truth. The grid is baked as the stage runners
    bake it. Returns (the views, the metrics, the grid)."""
    from .core import checkpoint as ckpt_lib
    from .render.stage2 import Stage2Model
    from .tools.relight import relight_views
    from .tracing.grid import build_sdf_grid
    cfg_dict = _load(args)
    cfg, dataset, params = _stage2_setup(args, cfg_dict)
    params, _ = ckpt_lib.restore_into(params, _stage2_checkpoint(args), ignore_unknown=True)
    grid = build_sdf_grid(Stage2Model(params, cfg, args.device).frozen_sdf(), cfg.grid,
                          device=args.device)
    out_dir = args.out or os.path.join(args.log_dir, "relight", os.path.basename(args.envmap))
    # the relit ground truth comes with the test split (syn_dataset.py:101-115)
    if os.path.exists(os.path.join(args.data, "transforms_test.json")):
        from .data.syn_dataset import SynDataset, SynDatasetConfig
        test_cfg = _filter_fields(SynDatasetConfig, dict(cfg_dict.get("dataset", {})))
        test_cfg["split"] = "test"
        dataset = SynDataset(SynDatasetConfig(instance_dir=args.data, **test_cfg))
    views, metrics = relight_views(
        params, cfg, grid, dataset, args.envmap, out_dir,
        view_indices=range(min(dataset.n_cameras, args.n_views)),
        light_origin=args.light_origin, background=args.background, device=args.device)
    if "mean_relit_psnr" in metrics:
        for i, p in enumerate(metrics["relit_psnr"]):
            print(f"[relight] view {i}: relit_psnr={p:.3f}")
        print(f"[relight] mean_relit_psnr={metrics['mean_relit_psnr']:.3f}"
              + (f" masked={metrics['mean_relit_psnr_masked']:.3f}"
                 if "mean_relit_psnr_masked" in metrics else ""))
        with open(os.path.join(out_dir, "metrics.json"), "w") as fp:
            json.dump(metrics, fp, indent=1)
    print("[relight] wrote", out_dir)
    return views, metrics, grid


def cmd_textures(args):
    """The PBR texture maps and the OBJ/MTL of ``--mesh`` from the latest
    CESR (or PBR) checkpoint, into ``--out`` (default
    ``<log_dir>/textures``); returns the maps."""
    from .core import checkpoint as ckpt_lib
    from .tools.tex_extract import extract_textures
    cfg_dict = _load(args)
    cfg, _, params = _stage2_setup(args, cfg_dict)
    params, _ = ckpt_lib.restore_into(params, _stage2_checkpoint(args), ignore_unknown=True)
    out_dir = args.out or os.path.join(args.log_dir, "textures")
    maps = extract_textures(params, cfg, args.mesh, out_dir, resolution=args.resolution,
                            device=args.device)
    print("[textures] wrote", out_dir)
    return maps


def cmd_import_ref(args):
    """Reference checkpoints into this layout: ``--stage1_tar
    {step:06d}.tar`` -> ``<log_dir>/NeuS/ckpt_<step>.npz``; ``--stage2_pth
    *.pth`` -> ``<log_dir>/<--stage>/checkpoints/latest.npz``, grafted
    onto a fresh init through the reference's surgery filter ``--filter``
    (train_pbr.py:122-203). Returns the paths written."""
    from .core import import_ref
    paths = []
    if args.stage1_tar:
        paths.append(import_ref.import_stage1(args.stage1_tar,
                                              os.path.join(args.log_dir, "NeuS")))
        print(f"[import-ref] stage-1 {args.stage1_tar} -> {paths[-1]}")
    if args.stage2_pth:
        cfg_dict = _load(args)
        _, _, params = _stage2_setup(args, cfg_dict)
        stage_dir = os.path.join(args.log_dir, args.stage, "checkpoints")
        os.makedirs(stage_dir, exist_ok=True)
        paths.append(import_ref.import_stage2(
            args.stage2_pth, params, os.path.join(stage_dir, "latest.npz"),
            filter_name=args.filter, ignore_unknown=args.ignore_unknown))
        print(f"[import-ref] stage-2 {args.stage2_pth} (filter={args.filter}) -> {paths[-1]}")
    if not paths:
        raise SystemExit("import-ref: pass --stage1_tar and/or --stage2_pth")
    return paths


def cmd_sgfit(args):
    """``stages/sg_fit.py:main``; returns its (SGs, logged losses)."""
    from .stages import sg_fit
    return sg_fit.main(["--envmap_path", args.envmap_path, "--num_sg", str(args.num_sg),
                        "--n_iters", str(args.n_iters), "--device", args.device]
                       + (["--out_dir", args.out_dir] if args.out_dir else []))


def main(argv=None):
    """Parse ``argv`` and run its subcommand; returns what the command
    returns (its trainer, runner, mesh, or the outputs named in its
    docstring)."""
    parser = argparse.ArgumentParser(prog="robir_tpu_torch")
    sub = parser.add_subparsers(dest="cmd", required=True)
    for name, fn in [("neus", cmd_neus), ("norm", cmd_norm), ("vis", cmd_vis),
                     ("pbr", cmd_pbr), ("cesr", cmd_cesr)]:
        p = sub.add_parser(name)
        _add_common(p)
        if name == "norm":
            p.add_argument("--mesh", type=str, required=True)
        if name == "neus":
            p.add_argument("--test_only", action="store_true",
                           help="skip training; restore the latest checkpoint and run the "
                                "test pass (reference exp_runner.py --test)")
        p.set_defaults(fn=fn)
    p = sub.add_parser("mesh")
    _add_common(p)
    p.add_argument("--ckpt", type=str, required=True)
    p.add_argument("--out", type=str, required=True)
    p.set_defaults(fn=cmd_mesh)

    p = sub.add_parser("relight")
    _add_common(p)
    p.add_argument("--envmap", type=str, required=True,
                   help="dir containing sg_128.npy, with sibling <dir>.exr")
    p.add_argument("--ckpt", type=str, default=None)
    p.add_argument("--out", type=str, default=None)
    p.add_argument("--n_views", type=int, default=4)
    p.add_argument("--light_origin", action="store_true",
                   help="render under the training light (sg+indir; scripts/relight.py:78-81)")
    p.add_argument("--background", choices=["envmap", "white"], default="envmap",
                   help="background compositing for relit frames")
    p.set_defaults(fn=cmd_relight)

    p = sub.add_parser("textures")
    _add_common(p)
    p.add_argument("--mesh", type=str, required=True)
    p.add_argument("--ckpt", type=str, default=None)
    p.add_argument("--out", type=str, default=None)
    p.add_argument("--resolution", type=int, default=1024)
    p.set_defaults(fn=cmd_textures)

    p = sub.add_parser("import-ref")
    _add_common(p)
    p.add_argument("--stage1_tar", type=str, default=None,
                   help="reference {step:06d}.tar stage-1 checkpoint")
    p.add_argument("--stage2_pth", type=str, default=None,
                   help="reference ModelParameters/*.pth stage-2 checkpoint")
    p.add_argument("--stage", type=str, default="CESR", choices=["Norm", "Vis", "PBR", "CESR"],
                   help="which stage directory the stage-2 import lands in")
    p.add_argument("--filter", type=str, default="all",
                   choices=["all", "pbr_resume", "norm_only", "illum"],
                   help="reference surgery filter (train_pbr.py:122-203)")
    p.add_argument("--ignore_unknown", action="store_true",
                   help="drop imported paths missing from this config's param tree instead of "
                        "raising")
    p.set_defaults(fn=cmd_import_ref)

    p = sub.add_parser("sgfit")
    p.add_argument("--envmap_path", type=str, required=True)
    p.add_argument("--num_sg", type=int, default=128)
    p.add_argument("--n_iters", type=int, default=100_000)
    p.add_argument("--out_dir", type=str, default=None)
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="where the fit runs (cuda raises without a card)")
    p.set_defaults(fn=cmd_sgfit)
    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    main()
