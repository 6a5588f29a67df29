"""Mesh container, SDF mesh export and PLY/OBJ I/O (counterpart of
``robir_tpu/texture/mesh.py``; the reference's trimesh/PyMCubes export,
``neus/optimization/extraction.py``, ``scripts/tex_extract.py:40-77``).

``extract_mesh`` evaluates an SDF on the card over a regular grid, in
chunks of 65,536 points (the last one padded with zeros, as the JAX
package pads it), then meshes the grid on the host with the native
marching tetrahedra (``texture/native.py``). Files written by either
package read in the other.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable

import numpy as np
import torch

from .. import resolve_device
from .native import marching_tetrahedra

# points a call of the SDF in extract_mesh, as in the JAX package
MESH_CHUNK = 65536


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """A stage-1 config's ``mesh`` section (``robir_tpu/cli.py:cmd_mesh``'s
    defaults): the grid's resolution per axis and its box."""
    resolution: int = 256
    bbox_min: tuple[float, float, float] = (-1.2, -1.2, -1.2)
    bbox_max: tuple[float, float, float] = (1.2, 1.2, 1.2)


@dataclasses.dataclass
class Mesh:
    verts: np.ndarray  # [V, 3] float32
    tris: np.ndarray   # [T, 3] int32

    def vertex_normals(self) -> np.ndarray:
        """Area-weighted face normals summed at each vertex, normalised."""
        v, t = self.verts, self.tris
        fn = np.cross(v[t[:, 1]] - v[t[:, 0]], v[t[:, 2]] - v[t[:, 0]])
        out = np.zeros_like(v)
        for c in range(3):
            np.add.at(out, t[:, c], fn)
        return out / np.clip(np.linalg.norm(out, axis=-1, keepdims=True), 1e-12, None)

    def bounds(self) -> tuple[np.ndarray, np.ndarray]:
        return self.verts.min(0), self.verts.max(0)

    def export_ply(self, path: str) -> None:
        """Binary little-endian PLY: float x, y, z; uchar-counted int faces."""
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "wb") as f:
            header = (
                "ply\nformat binary_little_endian 1.0\n"
                f"element vertex {len(self.verts)}\n"
                "property float x\nproperty float y\nproperty float z\n"
                f"element face {len(self.tris)}\n"
                "property list uchar int vertex_indices\nend_header\n")
            f.write(header.encode())
            f.write(self.verts.astype("<f4").tobytes())
            face = np.empty((len(self.tris), 13), np.uint8)
            face[:, 0] = 3
            face[:, 1:] = self.tris.astype("<i4").view(np.uint8).reshape(-1, 12)
            f.write(face.tobytes())

    def export_obj(self, path: str, uv: np.ndarray | None = None,
                   mtl_name: str | None = None) -> None:
        """OBJ, with per-corner UVs where given (``uv`` [T * 3, 2], as
        ``atlas_parameterize`` returns them)."""
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        lines = []
        if mtl_name:
            lines.append(f"mtllib {mtl_name}.mtl")
            lines.append(f"usemtl {mtl_name}")
        for v in self.verts:
            lines.append(f"v {v[0]:.6f} {v[1]:.6f} {v[2]:.6f}")
        if uv is not None:
            for t in uv:
                lines.append(f"vt {t[0]:.6f} {t[1]:.6f}")
            for i, tri in enumerate(self.tris):
                c = 3 * i
                lines.append(f"f {tri[0]+1}/{c+1} {tri[1]+1}/{c+2} {tri[2]+1}/{c+3}")
        else:
            for tri in self.tris:
                lines.append(f"f {tri[0]+1} {tri[1]+1} {tri[2]+1}")
        with open(path, "w") as f:
            f.write("\n".join(lines) + "\n")

    @classmethod
    def load_ply(cls, path: str) -> "Mesh":
        """A PLY of triangles, binary little-endian or ASCII."""
        with open(path, "rb") as f:
            data = f.read()
        head_end = data.index(b"end_header\n") + len(b"end_header\n")
        header = data[:head_end].decode()
        n_v = n_f = 0
        binary = "binary_little_endian" in header
        for line in header.splitlines():
            if line.startswith("element vertex"):
                n_v = int(line.split()[-1])
            elif line.startswith("element face"):
                n_f = int(line.split()[-1])
        if binary:
            verts = np.frombuffer(data, "<f4", n_v * 3, head_end).reshape(-1, 3)
            off = head_end + n_v * 12
            face = np.frombuffer(data, np.uint8, n_f * 13, off).reshape(-1, 13)
            tris = face[:, 1:].copy().view("<i4").reshape(-1, 3)
        else:
            body = data[head_end:].decode().split()
            verts = np.array(body[:n_v * 3], np.float32).reshape(-1, 3)
            tris = np.array(body[n_v * 3:], np.int32).reshape(-1, 4)[:, 1:]
        return cls(np.ascontiguousarray(verts, np.float32),
                   np.ascontiguousarray(tris, np.int32))


def sdf_grid(sdf_fn: Callable[[torch.Tensor], torch.Tensor], bbox_min, bbox_max,
             resolution: int, device="cuda") -> np.ndarray:
    """``sdf_fn`` ([N, 3] -> [N] or [N, 1] on ``device``) on the
    ``resolution``^3 nodes of the box, as a float32 [R, R, R] numpy grid
    (x-major). The axes are numpy's float32 ``linspace``, as the JAX
    package builds them; each MESH_CHUNK points are gathered from them on
    the device, the last chunk padded with zero points to MESH_CHUNK
    rows."""
    device = resolve_device(device)
    R = resolution
    lo = np.asarray(bbox_min, np.float32)
    hi = np.asarray(bbox_max, np.float32)
    axes = [torch.as_tensor(np.linspace(lo[i], hi[i], R, dtype=np.float32), device=device)
            for i in range(3)]
    n, chunk = R ** 3, MESH_CHUNK
    vals = torch.empty(n, device=device)
    with torch.no_grad():
        for start in range(0, n, chunk):
            idx = torch.arange(start, start + chunk, device=device)
            pts = torch.stack([axes[0][idx // (R * R) % R], axes[1][(idx // R) % R],
                               axes[2][idx % R]], -1)
            valid = min(chunk, n - start)
            if valid < chunk:
                pts[valid:] = 0.0
            vals[start:start + valid] = sdf_fn(pts).reshape(-1)[:valid]
    return vals.cpu().numpy().reshape(R, R, R)


def extract_mesh(sdf_fn: Callable[[torch.Tensor], torch.Tensor],
                 bbox_min=(-1.2, -1.2, -1.2), bbox_max=(1.2, 1.2, 1.2),
                 resolution: int = 128, device="cuda") -> Mesh:
    """SDF -> mesh: ``sdf_grid`` on ``device`` (``cuda`` unless the caller
    asks for the CPU), then the host marching tetrahedra at the zero level
    (``extract_fields``/``extract_mesh``, extraction.py:12-49)."""
    grid = sdf_grid(sdf_fn, bbox_min, bbox_max, resolution, device)
    verts, tris = marching_tetrahedra(grid, np.asarray(bbox_min, np.float32),
                                      np.asarray(bbox_max, np.float32))
    return Mesh(verts, tris)
