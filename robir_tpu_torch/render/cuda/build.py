"""Build the port's CUDA kernels and call them through ctypes.

Each source under ``robir_tpu_torch/csrc/`` is compiled on first use by
``nvcc`` for ``sm_90a`` into its own shared library with a plain C
interface, under ``robir_tpu_torch/build/`` (listed in ``.gitignore``). A
library's file name carries a hash of its sources and flags, so an edited
source is rebuilt and a stale library is never loaded. ``build_all``
compiles every source at once, one ``nvcc`` process each.

Nothing here runs at import time: the CPU tests import every module, and
``nvcc`` is only reached when a kernel is first launched on a CUDA tensor
(or ``build_all`` is called).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "build"
SOURCES = ("fused_mlp.cu", "fused_value_grad.cu", "grid_march.cu")
HEADERS = ("trunk.cuh", "wgrad.cuh")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# the grid march must round every product and sum as its plain version does
# (a hit is a comparison), so nvcc may not contract them into multiply-adds
SOURCE_FLAGS = {"grid_march.cu": ("-fmad=false",)}

_LIBS: dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def nvcc_flags(source: str) -> tuple[str, ...]:
    return NVCC_FLAGS + SOURCE_FLAGS.get(source, ())


def library_path(source: str) -> Path:
    h = hashlib.sha256(" ".join(nvcc_flags(source)).encode())
    for name in (source, *HEADERS):
        h.update((CSRC_DIR / name).read_bytes())
    return BUILD_DIR / f"{Path(source).stem}-{h.hexdigest()[:16]}.so"


def compile_source(source: str) -> Path:
    """nvcc one source into its shared library unless it is already built.
    The compiler's report (registers, shared memory, spills) is kept beside
    it as ``.log``."""
    out = library_path(source)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [nvcc_path(), *nvcc_flags(source), "-o", str(tmp), str(CSRC_DIR / source)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {source} ({' '.join(cmd)}):\n"
                           f"{proc.stdout}{proc.stderr}")
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, out)
    return out


def build_all() -> float:
    """Compile every kernel source in parallel; returns the seconds taken."""
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(SOURCES)) as ex:
        for fut in [ex.submit(compile_source, s) for s in SOURCES]:
            fut.result()
    return time.perf_counter() - t0


def library(source: str) -> ctypes.CDLL:
    with _LOCK:
        if source not in _LIBS:
            _LIBS[source] = ctypes.CDLL(str(compile_source(source)))
        return _LIBS[source]


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def int_array(values) -> ctypes.Array:
    values = list(values)
    return (ctypes.c_int * len(values))(*values)


class Kernel:
    """One C entry point of a kernel library, with its count of launches.

    Calling it launches the kernel(s) behind the entry point on the given
    stream, raises if CUDA reports an error, and adds one to ``launches``
    and to ``by_shape[shape]``, where the caller names the launch's shape
    (for the trunk kernels: the widest layer of the build and the rows).
    """

    def __init__(self, source: str, symbol: str, argtypes: list):
        self.source = source
        self.symbol = symbol
        self.argtypes = argtypes
        self.launches = 0
        self.by_shape: dict[tuple, int] = {}

    def reset(self) -> None:
        self.launches = 0
        self.by_shape = {}

    def __call__(self, *args, shape: tuple) -> None:
        lib = library(self.source)
        fn = getattr(lib, self.symbol)
        fn.argtypes = self.argtypes
        fn.restype = ctypes.c_int
        err = fn(*args)
        if err != 0:
            msg = lib.trunk_error_string
            msg.argtypes = [ctypes.c_int]
            msg.restype = ctypes.c_char_p
            raise RuntimeError(f"{self.symbol}: CUDA error {err} "
                               f"({msg(err).decode()})")
        self.launches += 1
        self.by_shape[shape] = self.by_shape.get(shape, 0) + 1
