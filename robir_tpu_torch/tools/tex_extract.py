"""PBR texture extraction: the learnt materials baked into texture maps and
an OBJ (counterpart of ``robir_tpu/tools/tex_extract.py``; the reference's
``scripts/tex_extract.py``). The material net is queried at every texel's
3-D position on the mesh's atlas, in chunks, without a graph; it is plain
PyTorch, so no kernel of the port runs here.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from .. import resolve_device
from ..render.stage2 import Stage2Config, Stage2Model
from ..texture.pipeline import TexSampler, TextureCache, bilinear_sample
from .plots import _save, tonemap


def extract_textures(params: dict, cfg: Stage2Config, mesh_path: str, out_dir: str,
                     resolution: int = 1024, chunk: int = 65536, device="cuda") -> dict:
    """Bake the albedo, roughness, metallic and normal maps of ``params``'s
    material net at ``resolution``^2 over the atlas of ``mesh_path`` (its
    texture cache, made on first use) into ``out_dir`` as PNGs, and export
    ``mesh.obj`` (with the atlas's UVs) and ``mesh.mtl`` naming them.
    Returns the maps, [res, res, 3] each."""
    device = resolve_device(device)
    model = Stage2Model(params, cfg, device)
    sampler = TexSampler(mesh_path, resolution)
    os.makedirs(out_dir, exist_ok=True)

    H = W = resolution
    u, v = np.meshgrid(np.linspace(0, 1, W, dtype=np.float32),
                       np.linspace(0, 1, H, dtype=np.float32), indexing="xy")
    uv = np.stack([u, v], -1).reshape(-1, 2)
    verts = bilinear_sample(sampler.vert, uv) * sampler.coord_scale
    mask = bilinear_sample(sampler.maskf, uv)[:, 0] > 0.1

    albedo = np.zeros((H * W, 3), np.float32)
    rough = np.zeros((H * W, 1), np.float32)
    metal = np.zeros((H * W, 1), np.float32)
    normal = np.zeros((H * W, 3), np.float32)
    with torch.no_grad():
        for i in range(0, H * W, chunk):
            sl = slice(i, min(i + chunk, H * W))
            block = verts[sl]
            cut = block.shape[0]
            if cut < chunk:
                block = np.concatenate([block, np.zeros((chunk - cut, 3), np.float32)])
            m = model.material(torch.as_tensor(block, dtype=torch.float32, device=device),
                               None, train_spec=False)
            albedo[sl] = m.diffuse_albedo[:cut].cpu().numpy()
            rough[sl] = m.roughness[:cut].cpu().numpy()
            metal[sl] = m.metallic[:cut].cpu().numpy()
            normal[sl] = m.normal_map[:cut].cpu().numpy()

    m3 = mask[:, None]
    maps = {
        "albedo": tonemap((albedo * m3).reshape(H, W, 3)),
        "roughness": (rough * m3).reshape(H, W, 1).repeat(3, -1),
        "metallic": (metal * m3).reshape(H, W, 1).repeat(3, -1),
        "normal": ((normal * 0.5 + 0.5) * m3).reshape(H, W, 3),
    }
    for name, img in maps.items():
        _save(os.path.join(out_dir, f"{name}.png"), img)

    cache = TextureCache(mesh_path)
    cache.mesh.export_obj(os.path.join(out_dir, "mesh.obj"), uv=cache.uv, mtl_name="mesh")
    with open(os.path.join(out_dir, "mesh.mtl"), "w") as f:
        f.write("newmtl mesh\nmap_Kd albedo.png\nmap_Ns roughness.png\n"
                "map_refl metallic.png\nmap_bump normal.png\n")
    return maps


def mutual_information(img_a: np.ndarray, img_b: np.ndarray, bins: int = 64) -> float:
    """Mutual information of the Sobel edge magnitudes of two maps, the
    shadow-removal quality metric (the reference's
    ``scripts/mutual_info.py:19-39``): high between the lighting map and
    the albedo map means shadows leaked into the albedo."""
    from scipy.signal import convolve2d

    def sobel_mag(img):
        g = img.mean(-1) if img.ndim == 3 else img
        kx = np.array([[-1, 0, 1], [-2, 0, 2], [-1, 0, 1]], np.float32)
        gx = convolve2d(g, kx, mode="same")
        gy = convolve2d(g, kx.T, mode="same")
        return np.sqrt(gx ** 2 + gy ** 2)

    ea, eb = sobel_mag(img_a).ravel(), sobel_mag(img_b).ravel()
    hist, _, _ = np.histogram2d(ea, eb, bins=bins)
    pxy = hist / np.clip(hist.sum(), 1, None)
    px = pxy.sum(1, keepdims=True)
    py = pxy.sum(0, keepdims=True)
    nz = pxy > 0
    return float(np.sum(pxy[nz] * np.log(pxy[nz] / (px @ py)[nz])))
