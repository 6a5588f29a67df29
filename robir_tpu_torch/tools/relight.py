"""Relighting: the learnt illumination swapped for a prefit SG envmap, and
the test views rendered again (counterpart of
``robir_tpu/tools/relight.py``; the reference's ``scripts/relight.py``).

``relight_views`` loads the prefit lights with ``load_light``
(``sg_128.npy`` and the ``.exr`` beside it), renders each view through
``stage2_runner.py:map_view`` as ``render_view`` does (chunks of 8,000
rays, the last padded by repeating its last ray; each chunk one
``stage2_forward(trainstage="Material")`` with ``pbr_sg_render``, compacted
at 512, without a graph: on the card one grid march and one K3 launch a
chunk), composes the background, writes the PNGs and the video, and scores
the frames against the dataset's relit ground truth.
"""

from __future__ import annotations

import itertools
import os
from typing import Callable

import numpy as np
import torch

from .. import resolve_device
from ..core.draws import Draws
from ..fields.envmap_material import load_light
from ..render.color import as_input, hdr2ldr
from ..render.sg import render_envmap
from ..render.stage2 import Stage2Config, Stage2Model, stage2_forward
from ..stages.pbr import pbr_sg_render
from ..stages.stage2_runner import map_view
from .plots import _save, lin2img, tonemap


def relight_views(params: dict, cfg: Stage2Config, grid_values, dataset, envmap_path: str,
                  out_dir: str, view_indices=None, chunk: int = 8000,
                  draws: Callable[[int], Draws] | None = None, light_origin: bool = False,
                  write_video: bool = True, background: str = "envmap",
                  device="cuda") -> tuple[list[dict], dict]:
    """Render relit frames of ``view_indices`` (default: every view) of
    ``dataset`` under the envmap at ``envmap_path``. Returns (per-view
    output dicts of flat [H * W, .] numpy buffers: ``rgb``, ``albedo``,
    ``roughness``, ``normal``, ``mask``; metrics) and writes
    ``{rgb,albedo,roughness,normal}_<view>.png`` and the video into
    ``out_dir``.

    ``draws(c)`` gives the c-th chunk's draws, counted over all the views
    (default: one ``Draws`` a chunk from a generator seeded 0 on
    ``device``). Under a swapped light the cached indirect term is stale,
    so the frame is ``sg_rgb`` alone; ``light_origin`` adds ``indir_rgb``
    (scripts/relight.py:78-81). Off the surface: the target envmap along
    each ray (``background="envmap"``) or white (``"white"``, for ground
    truths rendered on white).

    Metrics, where the dataset carries relit ground truth named after the
    envmap (``SynDataset.relit_images``): per-view and mean relit PSNR in
    the display domain (``_display_psnr``), whole image and, with
    ``object_masks``, on the object."""
    device = resolve_device(device)
    params, envmap_img = _swap_light(params, envmap_path)
    model = Stage2Model(params, cfg, device, grid_values)
    envmap = torch.as_tensor(np.asarray(envmap_img, np.float32), device=device)
    if draws is None:
        gen = torch.Generator(device=device).manual_seed(0)
        draws = lambda _: Draws(gen, device=device)  # noqa: E731
    os.makedirs(out_dir, exist_ok=True)
    env_name = os.path.splitext(os.path.basename(envmap_path))[0]
    gt_views = getattr(dataset, "relit_images", {}).get(env_name)
    masks = getattr(dataset, "object_masks", None)
    chunks = itertools.count()  # over all the views, as JAX splits its key

    def render(_, origins, dirs):
        out = _render_chunk(model, draws(next(chunks)), origins, dirs, light_origin)
        bg = (torch.ones_like(out["rgb"]) if background == "white"
              else torch.clamp(render_envmap(envmap, dirs), 0, 1))
        out["rgb"] = torch.where(out["mask"][:, None], out["rgb"], bg)
        return out

    results, frames, psnrs, psnrs_masked = [], [], [], []
    views = view_indices if view_indices is not None else range(dataset.n_cameras)
    res = dataset.img_res
    for vi in views:
        view = map_view(dataset, vi, chunk, device, render)
        frame = tonemap(lin2img(view["rgb"], res))
        _save(os.path.join(out_dir, f"rgb_{vi:03d}.png"), frame)
        frames.append(frame)
        _save(os.path.join(out_dir, f"albedo_{vi:03d}.png"),
              tonemap(lin2img(view["albedo"], res)))
        _save(os.path.join(out_dir, f"roughness_{vi:03d}.png"), lin2img(view["roughness"], res))
        _save(os.path.join(out_dir, f"normal_{vi:03d}.png"),
              lin2img(view["normal"] * 0.5 + 0.5, res))
        if gt_views is not None:
            gt = np.asarray(gt_views[vi])
            psnrs.append(_display_psnr(view["rgb"], gt))
            if masks:
                m = np.asarray(masks[vi])
                psnrs_masked.append(_display_psnr(view["rgb"][m], gt[m]))
        results.append(view)

    metrics = {}
    if psnrs:
        metrics["relit_psnr"] = [float(p) for p in psnrs]
        metrics["mean_relit_psnr"] = float(np.mean(psnrs))
        if psnrs_masked:
            metrics["relit_psnr_masked"] = [float(p) for p in psnrs_masked]
            metrics["mean_relit_psnr_masked"] = float(np.mean(psnrs_masked))
    if write_video and frames:
        metrics["video"] = _write_video(os.path.join(out_dir, "video_rgb"), frames)
    return results, metrics


def _display_psnr(pred_lin: np.ndarray, gt_lin: np.ndarray) -> float:
    """PSNR in the 8-bit display domain: both sides gamma-1/2.2 encoded and
    clipped, the space of the reference's saved PNGs."""
    enc = lambda x: np.clip(x, 0.0, 1.0) ** (1.0 / 2.2)  # noqa: E731
    mse = float(np.mean((enc(pred_lin) - enc(gt_lin)) ** 2))
    return -10.0 * np.log10(max(mse, 1e-12))


def _write_video(path_base: str, frames: list[np.ndarray], fps: int = 20) -> str:
    """``<path_base>.mp4`` through imageio where it can write one, else a
    GIF through PIL (the reference's scripts/relight.py:116
    ``imageio.mimwrite``); returns the path written."""
    arrs = [(np.clip(f, 0, 1) * 255).astype(np.uint8) if f.dtype != np.uint8 else f
            for f in frames]
    try:
        import imageio
        path = path_base + ".mp4"
        imageio.mimwrite(path, arrs, fps=fps)
    except Exception:
        from PIL import Image
        path = path_base + ".gif"
        ims = [Image.fromarray(a) for a in arrs]
        ims[0].save(path, save_all=True, append_images=ims[1:], duration=int(1000 / fps),
                    loop=0)
    return path


def _swap_light(params: dict, envmap_path: str):
    """(params with the prefit lights of ``envmap_path``, envmap image)."""
    env_params, envmap_img = load_light(params["envmap_material_network"], envmap_path)
    new_params = dict(params)
    new_params["envmap_material_network"] = env_params
    return new_params, envmap_img


def _render_chunk(model: Stage2Model, draws: Draws, origins, dirs,
                  light_origin: bool = False) -> dict:
    """One chunk's relit colour (tone-mapped under the learnt shift), albedo,
    roughness, AE normal map and traced hits, without a graph."""
    params = model.params
    n = dirs.shape[0]
    inp = {"points": origins, "dirs": dirs,
           "hdr_shift": as_input(params["gamma"]).expand(n, 1)}
    with torch.no_grad():
        out = stage2_forward(model, draws, inp, trainstage="Material",
                             sg_render_fn=pbr_sg_render, train_spec=False, compact_chunk=512)
        pred = out["sg_rgb"] + out["indir_rgb"] if light_origin else out["sg_rgb"]
        pred = hdr2ldr(params["gamma"], model.cfg.tonemap, pred)
    return {"rgb": pred, "albedo": out["diffuse_albedo"], "roughness": out["roughness"],
            "normal": out["normal_map"], "mask": out["network_object_mask"]}
