"""ctypes bindings for the host C++ geometry code (counterpart of
``robir_tpu/texture/native.py``): marching tetrahedra, barycentric
rasterisation, the UV atlas and the EXR PIZ codec.

The port keeps its own copy of the C++ source (``csrc/robir_native.cpp``),
because it reads no file of the JAX package or of ``native/``, which go
when the JAX package is retired. Until then ``tests/test_torch_mesh.py``
holds the copy byte for byte to ``native/robir_native.cpp``, so a fix
there fails that test until it lands here too. The port builds it on
first use with ``g++ -O3 -fPIC -shared -std=c++17`` (no
``-march=native``: the library may be built on one host and loaded on
another) into ``robir_tpu_torch/build/``, under a file name that carries a
hash of the source and flags, so an edited source is rebuilt. Concurrent
processes (test workers) build under an exclusive ``fcntl.flock`` and move
the finished library into place with ``os.replace``: one compiles, the
others wait and load it. A failed build raises; nothing here reads or
writes the repository's ``native/`` directory.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

PKG_DIR = Path(__file__).resolve().parents[1]
SOURCE = PKG_DIR / "csrc" / "robir_native.cpp"
BUILD_DIR = PKG_DIR / "build"
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17")
# the atlas's gutter between charts and the texture side it packs for (the
# JAX package's defaults, which its callers keep), and its chart growth
# (0: against the running-mean normal; 1, axis clusters, packs worse)
ATLAS_PADDING_PX = 4
ATLAS_RES = 2048
ATLAS_CHART_MODE = 0

_lock = threading.Lock()
_lib = None


def library_path() -> Path:
    """Where the library of the current source and flags is built."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"librobir_native-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library unless it is built; returns its path. Raises
    RuntimeError with the compiler's output if ``g++`` fails."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "librobir_native.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if out.exists():  # another process built it while this one waited
            return out
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp")
        cmd = ["g++", *CXX_FLAGS, "-o", str(tmp), str(SOURCE)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"building the native library failed ({' '.join(cmd)}):\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
    return out


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build()))

        lib.marching_tetrahedra.restype = ctypes.c_int
        lib.marching_tetrahedra.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_float), ctypes.c_float,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
            ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.POINTER(ctypes.c_int)),
            ctypes.POINTER(ctypes.c_int),
        ]
        lib.rasterize_attributes.restype = ctypes.c_int
        lib.rasterize_attributes.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int),
            ctypes.c_int, ctypes.POINTER(ctypes.c_float), ctypes.c_int,
            ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ]
        lib.atlas_parameterize.restype = ctypes.c_int
        lib.atlas_parameterize.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int,
            ctypes.POINTER(ctypes.c_int), ctypes.c_int,
            ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_float,  # merge_frac (tiny-chart merge threshold)
            ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
            ctypes.POINTER(ctypes.POINTER(ctypes.c_int)),
        ]
        lib.piz_uncompress.restype = ctypes.c_int
        lib.piz_uncompress.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_uint16)]
        lib.piz_compress.restype = ctypes.c_int64
        lib.piz_compress.argtypes = [
            ctypes.POINTER(ctypes.c_uint16), ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.POINTER(ctypes.c_void_p)]
        lib.free_buffer.argtypes = [ctypes.c_void_p]
        lib.free_buffer.restype = None
        _lib = lib
        return lib


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _iptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int))


def marching_tetrahedra(grid: np.ndarray, bbox_min,
                        bbox_max) -> tuple[np.ndarray, np.ndarray]:
    """SDF grid [nx, ny, nz] over the box -> (verts [V, 3] float32, tris
    [T, 3] int32), the zero level set (the reference's PyMCubes marching
    cubes, neus/optimization/extraction.py:35, with a simpler case
    table)."""
    lib = _load()
    grid = np.ascontiguousarray(grid, np.float32)
    if grid.ndim != 3:
        raise ValueError(f"marching_tetrahedra takes a 3-D grid, got {grid.shape}")
    lo = np.ascontiguousarray(bbox_min, np.float32)
    hi = np.ascontiguousarray(bbox_max, np.float32)
    verts_p = ctypes.POINTER(ctypes.c_float)()
    tris_p = ctypes.POINTER(ctypes.c_int)()
    nv = ctypes.c_int()
    nt = ctypes.c_int()
    rc = lib.marching_tetrahedra(
        _fptr(grid), grid.shape[0], grid.shape[1], grid.shape[2],
        _fptr(lo), _fptr(hi), ctypes.c_float(0.0),
        ctypes.byref(verts_p), ctypes.byref(nv),
        ctypes.byref(tris_p), ctypes.byref(nt))
    if rc != 0:
        raise RuntimeError(f"marching_tetrahedra failed rc={rc}")
    verts = np.ctypeslib.as_array(verts_p, (nv.value, 3)).copy()
    tris = np.ctypeslib.as_array(tris_p, (nt.value, 3)).copy()
    lib.free_buffer(verts_p)
    lib.free_buffer(tris_p)
    return verts, tris


def rasterize_attributes(uv: np.ndarray, tris: np.ndarray, attrs: np.ndarray,
                         h: int, w: int) -> tuple[np.ndarray, np.ndarray]:
    """Barycentric fill of per-vertex ``attrs`` [V, D] over the triangles
    ``tris`` [T, 3] laid out at ``uv`` [V, 2] in [0, 1] -> (img [h, w, D],
    mask [h, w]) (the reference's GLSL rasteriser, model/rasterizor.py:
    171-205)."""
    lib = _load()
    uv = np.ascontiguousarray(uv, np.float32)
    tris = np.ascontiguousarray(tris, np.int32)
    attrs = np.ascontiguousarray(attrs, np.float32)
    if attrs.ndim != 2 or len(uv) != len(attrs) or tris.ndim != 2 or tris.shape[1] != 3:
        raise ValueError(f"uv {uv.shape}, tris {tris.shape}, attrs {attrs.shape}")
    d = attrs.shape[1]
    img = np.zeros((h, w, d), np.float32)
    mask = np.zeros((h, w), np.float32)
    rc = lib.rasterize_attributes(_fptr(uv), _iptr(tris), tris.shape[0],
                                  _fptr(attrs), d, h, w, _fptr(img), _fptr(mask))
    if rc != 0:
        raise RuntimeError(f"rasterize_attributes failed rc={rc}")
    return img, mask


def _warn_if_overlapping(util: float, uv: np.ndarray, res: int = 1024,
                         floor: float = 0.90) -> float:
    """The share of the summed triangle area that the union of the UV
    triangles covers, rasterised at ``res``; warns on stderr below
    ``floor`` (overlapping charts, which the area utilisation cannot see,
    would make the bake bleed). Returns the ratio."""
    n = uv.shape[0] // 3
    tris = np.arange(n * 3, dtype=np.int32).reshape(-1, 3)
    _, cov = rasterize_attributes(uv, tris, np.ones((n * 3, 1), np.float32), res, res)
    ratio = float(cov.sum()) / (res * res) / max(util, 1e-9)
    if ratio < floor:
        import sys
        print(f"WARNING: atlas UV union covers only {ratio:.2f} of the "
              f"summed triangle area — charts overlap; the texture bake "
              f"will bleed (atlas_parameterize internal error)",
              file=sys.stderr, flush=True)
    return ratio


def atlas_parameterize(verts: np.ndarray, tris: np.ndarray,
                       normal_thresh: float | None = None,
                       merge_frac: float | None = None,
                       ) -> tuple[np.ndarray, np.ndarray, int]:
    """UV atlas of a mesh (the reference's xatlas, model/texture_model.py:
    14-21) -> (uv [T * 3, 2], vert_idx [T * 3] into ``verts``, n_charts);
    chart boundaries split vertices.

    ``normal_thresh`` None runs the JAX package's portfolio: thresholds
    {0.55, 0.6, 0.65, 0.75} x tiny-chart merge {off, 0.002} (only
    ``merge_frac`` if given), keeping the parameterisation of the largest
    triangle-area utilisation, then checks it for overlapping charts."""
    if normal_thresh is None:
        best = None
        merge_arms = (0.0, 0.002) if merge_frac is None else (merge_frac,)
        for mf in merge_arms:
            for th in (0.55, 0.6, 0.65, 0.75):
                uv, idx, nc = atlas_parameterize(verts, tris, th, mf)
                tri_uv = uv.reshape(-1, 3, 2)
                e1 = tri_uv[:, 1] - tri_uv[:, 0]
                e2 = tri_uv[:, 2] - tri_uv[:, 0]
                util = float(np.abs(e1[:, 0] * e2[:, 1] - e1[:, 1] * e2[:, 0]).sum() * 0.5)
                if best is None or util > best[0]:
                    best = (util, uv, idx, nc)
        _warn_if_overlapping(best[0], best[1])
        return best[1], best[2], best[3]
    lib = _load()
    verts = np.ascontiguousarray(verts, np.float32)
    tris = np.ascontiguousarray(tris, np.int32)
    uv_p = ctypes.POINTER(ctypes.c_float)()
    idx_p = ctypes.POINTER(ctypes.c_int)()
    n_charts = lib.atlas_parameterize(
        _fptr(verts), verts.shape[0], _iptr(tris), tris.shape[0],
        ctypes.c_float(normal_thresh), ATLAS_PADDING_PX, ATLAS_RES, ATLAS_CHART_MODE,
        ctypes.c_float(merge_frac or 0.0),
        ctypes.byref(uv_p), ctypes.byref(idx_p))
    if n_charts < 0:
        raise RuntimeError("atlas_parameterize failed")
    n = tris.shape[0] * 3
    uv = np.ctypeslib.as_array(uv_p, (n, 2)).copy()
    idx = np.ctypeslib.as_array(idx_p, (n,)).copy()
    lib.free_buffer(uv_p)
    lib.free_buffer(idx_p)
    return uv, idx, n_charts
