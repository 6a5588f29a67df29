"""Experiment logger: a run directory of scalars, images, a test video,
meshes and ``description.json`` (the port's copy of
``robir_tpu/tools/logger.py``; the reference's ``neus/optimization/log.py``).

The run directory is ``<log_dir>/<exp_name>``, with the JAX logger's files:
``plots/<tag>_<step>.png``, ``plots/<tag>.mp4`` (or ``<tag>.gif`` through
PIL where no mp4 writer is installed), ``meshes/mesh_<step:06d>.ply`` and
``description.json``. Scalars differ: the JAX logger writes them as
tensorboardX events, which the card's machine cannot write (it has no
``tensorboardX``); the port writes each ``log_scalars`` call as one JSON
line, ``{"step": ..., "<prefix>/<name>": value, ...}``, of
``scalars.jsonl`` in the run directory, on every machine.
"""

from __future__ import annotations

import json
import os

import numpy as np


class Logger:
    def __init__(self, log_dir: str, exp_name: str = "exp"):
        self.log_dir = os.path.join(log_dir, exp_name)
        self.plots_dir = os.path.join(self.log_dir, "plots")
        os.makedirs(self.plots_dir, exist_ok=True)
        self._scalars_path = os.path.join(self.log_dir, "scalars.jsonl")
        self._desc_path = os.path.join(self.log_dir, "description.json")
        self._desc: dict = {}

    def log_scalars(self, step: int, tag_prefix: str = "", **scalars) -> None:
        line = {"step": int(step)}
        line.update({f"{tag_prefix}/{k}" if tag_prefix else k: float(v)
                     for k, v in scalars.items()})
        with open(self._scalars_path, "a") as f:
            f.write(json.dumps(line) + "\n")

    def log_rays_per_sec(self, step: int, rays_per_sec: float) -> None:
        self.log_scalars(step, "perf", rays_per_sec=rays_per_sec)

    def log_image(self, step: int, tag: str, img: np.ndarray) -> str:
        """img [H, W, 3] in [0, 1], saved as ``plots/<tag>_<step>.png``."""
        from PIL import Image
        path = os.path.join(self.plots_dir, f"{tag}_{step}.png")
        Image.fromarray((np.clip(img, 0, 1) * 255).astype(np.uint8)).save(path)
        return path

    def log_video(self, tag: str, frames: list[np.ndarray], fps: int = 24) -> str:
        """Frames [H, W, 3] in [0, 1] -> ``plots/<tag>.mp4``, or
        ``plots/<tag>.gif`` where imageio or its mp4 backend is missing."""
        arrs = [(np.clip(f, 0, 1) * 255).astype(np.uint8) for f in frames]
        path = os.path.join(self.plots_dir, f"{tag}.mp4")
        try:
            import imageio
            imageio.mimwrite(path, arrs, fps=fps)
            return path
        except (ImportError, ValueError):  # no imageio, or no mp4 backend
            from PIL import Image
            path = os.path.join(self.plots_dir, f"{tag}.gif")
            ims = [Image.fromarray(a) for a in arrs]
            ims[0].save(path, save_all=True, append_images=ims[1:],
                        duration=int(1000 / fps), loop=0)
            return path

    def log_mesh(self, step: int, mesh) -> str:
        path = os.path.join(self.log_dir, "meshes", f"mesh_{step:06d}.ply")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        mesh.export_ply(path)
        return path

    def log_json(self, **kv) -> None:
        """Run-description key-values (render_time etc., log.py:121-128)."""
        self._desc.update(kv)
        with open(self._desc_path, "w") as f:
            json.dump(self._desc, f, indent=2)
