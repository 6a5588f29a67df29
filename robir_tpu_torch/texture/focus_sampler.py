"""Inverse-camera observation sampling (counterpart of
``robir_tpu/texture/focus_sampler.py``; the reference's
``model/focus_sampler.py``, inv_camera_params:17-30 and
scatter_sample:63-101, and ``training/tex_module.py``'s TexSpaceSampler).

``FocusSampler`` projects points into the training cameras and samples
their images and masks; ``TexSpaceSampler`` builds the texture-space
batches of the stage-2 stages: points with their mesh normals
(``simple_data_batch``, the Norm stage's) or camera rays toward the
visible texture points (``data_batch``), whose occlusion test traces
secondary rays through ``trace_fn`` (the grid tracer on the runner's baked
grid). Projections and image sampling are numpy on the host, as in the JAX
package; only the trace runs on the device.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import resolve_device
from ..data.syn_dataset import SynDataset
from .pipeline import TexSampler, bilinear_sample


class FocusSampler:
    """Project 3D points into every training camera and sample colours and
    masks there."""

    def __init__(self, images: np.ndarray, masks: np.ndarray,
                 poses: np.ndarray, intrinsics: np.ndarray,
                 img_res: tuple[int, int]):
        # images [M, H*W, 3] or [M, H, W, 3]
        h, w = img_res
        self.images = images.reshape(-1, h, w, 3).astype(np.float32)
        self.masks = masks.reshape(-1, h, w, 1).astype(np.float32)
        self.poses = poses.astype(np.float32)
        self.cam_loc = poses[:, :3, 3].astype(np.float32)
        p = np.tile(np.eye(4, dtype=np.float32), (len(poses), 1, 1))
        p[:, :3, :4] = poses[:, :3, :4]
        self.pose_inv = np.linalg.inv(p)
        K = intrinsics.astype(np.float32)
        self.intrinsics = K if K.ndim == 3 else np.tile(K[None], (len(poses), 1, 1))
        self.img_size = np.array([h, w], np.float32)
        self.n_cameras = len(self.images)

    def _cam_sel(self, cameras) -> np.ndarray:
        return (np.arange(self.n_cameras) if cameras is None
                else np.asarray(cameras, int))

    def project(self, x: np.ndarray, cameras=None):
        """x [N, 3] -> (uv [M, N, 2] pixel coordinates, view_dir [M, N, 3]
        camera -> point) (inv_camera_params, focus_sampler.py:17-30).
        ``cameras`` restricts to those camera indices (M = their count)."""
        sel = self._cam_sel(cameras)
        cam_loc = self.cam_loc[sel]
        ray = x[None] - cam_loc[:, None]                          # [M, N, 3]
        ray = ray / np.clip(np.linalg.norm(ray, axis=-1, keepdims=True), 1e-9, None)
        pts = ray + cam_loc[:, None]                              # unit sphere around cam
        hom = np.concatenate([pts, np.ones_like(pts[..., :1])], -1)
        cam_pts = np.einsum("mij,mnj->mni", self.pose_inv[sel], hom)  # camera space
        z = -cam_pts[..., 2:3]
        ndc = cam_pts / np.where(np.abs(z) > 1e-9, z, 1e-5)
        ndc[..., 1:3] *= -1
        uvh = np.einsum("mij,mnj->mni", self.intrinsics[sel], ndc[..., :3])
        return uvh[..., :2], ray

    def sample_images(self, uv: np.ndarray, cameras=None) -> np.ndarray:
        sel = self._cam_sel(cameras)
        out = np.zeros(uv.shape[:2] + (3,), np.float32)
        for i, m in enumerate(sel):
            g = uv[i] / np.array([self.img_size[1], self.img_size[0]])
            out[i] = bilinear_sample(self.images[m], g)
        return out

    def sample_masks(self, uv: np.ndarray, cameras=None) -> np.ndarray:
        sel = self._cam_sel(cameras)
        out = np.zeros(uv.shape[:2], bool)
        for i, m in enumerate(sel):
            g = uv[i] / np.array([self.img_size[1], self.img_size[0]])
            out[i] = bilinear_sample(self.masks[m], g)[:, 0] > 0.5
        return out

    def scatter_sample(self, x: np.ndarray, cameras=None):
        """x [N, 3] -> (sample dict, ground truth) (focus_sampler.py:
        63-101). With ``cameras``, only those camera rows are projected and
        sampled, in the given order."""
        uv, view_dir = self.project(x, cameras)
        rgb = self.sample_images(uv, cameras)
        in_bounds = ((uv >= 0) & (uv < np.array([self.img_size[1],
                                                 self.img_size[0]]))).all(-1)
        valid = in_bounds & self.sample_masks(uv, cameras)
        return ({"object_mask": valid, "uv": uv, "view_dir": view_dir},
                {"rgb": rgb})


def focus_sampler_from_dataset(ds: SynDataset) -> FocusSampler:
    images = np.stack(ds.rgb_images)
    masks = np.stack([m.astype(np.float32) for m in ds.object_masks])
    K = np.tile(ds.intrinsics[None], (ds.n_cameras, 1, 1))
    return FocusSampler(images, masks, ds.poses, K, ds.img_res)


class TexSpaceSampler:
    """Texture-space batch builder of the stage-2 stages
    (training/tex_module.py). ``trace_fn(origins, dirs) -> (t, hit, x)``
    takes [N, 3] tensors on ``device`` (``cuda`` unless the caller asks for
    the CPU): the grid tracer on the frozen SDF's baked grid, e.g.
    ``lambda o, d: grid_cast(runner.grid_values, cfg.grid, o, d)`` with
    ``offset=TexSpaceSampler.offset_for_grid(cfg.grid)``."""

    def __init__(self, tex_sampler: TexSampler, focus_sampler: FocusSampler,
                 trace_fn, offset: float = 0.005, device="cuda"):
        self.tex_sampler = tex_sampler
        self.focus_sampler = focus_sampler
        self.trace_fn = trace_fn
        # the secondary rays' origin bias: the reference's 0.005
        # (tex_module.py:24); against the grid tracer it must also clear the
        # hit epsilon, or grazing rays hit their own surface
        self.offset = offset
        self.device = resolve_device(device)

    @staticmethod
    def offset_for_grid(grid_cfg) -> float:
        """max(0.005, 2 * hit_eps) for a trace_fn on a GridConfig's grid."""
        return max(0.005, 2.0 * grid_cfg.hit_eps_cells * grid_cfg.cell)

    def sample_observations(self, rng: np.random.Generator, x: np.ndarray,
                            normals: np.ndarray):
        """One random camera: the colour, direction and visibility of each
        point (tex_module.py:13-33) -> (rgb [N, 3], cam_dir [N, 3], vis [N],
        cam_pos [3]). Only the chosen camera is projected and sampled."""
        cam = int(rng.integers(self.focus_sampler.n_cameras))
        sample, gt = self.focus_sampler.scatter_sample(x, cameras=[cam])
        cam_dir = sample["view_dir"][0]         # [N, 3] camera -> point
        obj_mask = sample["object_mask"][0]     # [N]
        cam_pos = self.focus_sampler.cam_loc[cam]
        rgb = gt["rgb"][0]

        origins = torch.as_tensor(np.asarray(x + normals * self.offset, np.float32),
                                  device=self.device)
        dirs = torch.as_tensor(np.asarray(-cam_dir, np.float32), device=self.device)
        _, hit, _ = self.trace_fn(origins, dirs)
        vis = obj_mask & ~hit.cpu().numpy()
        return rgb, cam_dir, vis, cam_pos

    def data_batch(self, rng: np.random.Generator, n: int):
        """Inputs of the stage-2 forward (tex_module.py:61-75): the camera's
        origin and directions toward visible texture points -> (inputs,
        normals, rgb)."""
        tex = self.tex_sampler.sample(rng, n)
        x, normal = tex["x"], tex["normal"]
        rgb, cam_dir, vis, cam_pos = self.sample_observations(rng, x, normal)
        mask = tex["object_mask"] & vis
        inputs = {
            "points": np.broadcast_to(cam_pos, (n, 3)).astype(np.float32).copy(),
            "dirs": cam_dir.astype(np.float32),
            "object_mask": mask,
            "tex_uv": tex["uv"],
        }
        return inputs, normal, rgb

    def simple_data_batch(self, rng: np.random.Generator, n: int):
        """Points-only batch (tex_module.py:77-89): surface samples with
        their mesh normals, no camera."""
        tex = self.tex_sampler.sample(rng, n)
        return {"points": tex["x"], "normals": tex["normal"],
                "object_mask": tex["object_mask"]}
