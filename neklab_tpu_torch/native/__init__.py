"""ctypes bindings for the native (C++) mesh-preprocessing library.

Counterpart of `neklab_tpu.native`, with its own copy of the source
(`neklab_native.cpp`). g++ compiles it at first use into
`neklab_tpu_torch/build/`, under a name that carries a hash of the source
and the flags (as `ops/_build.py` names the CUDA library), written under a
temporary name and moved into place, so processes that build at the same
moment never load a partial file. Every entry point returns None when the
library cannot be built or loaded, and its callers fall back to pure
Python (host preprocessing, not a device kernel). Nothing runs at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "neklab_native.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_DIR), "build")
FLAGS = ["-O3", "-march=native", "-shared", "-fPIC"]

_lib = None
_tried = False


def library_path() -> str:
    h = hashlib.sha256()
    with open(_SRC, "rb") as f:
        h.update(f.read())
    h.update(" ".join(FLAGS).encode())
    return os.path.join(BUILD_DIR, f"libneklab_native_{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile the library if no up-to-date one exists; returns its path."""
    path = library_path()
    if not os.path.exists(path):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{path}.tmp{os.getpid()}"
        subprocess.run(["g++", *FLAGS, "-o", tmp, _SRC], check=True, capture_output=True)
        os.replace(tmp, path)
    return path


def _load():
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    try:
        lib = ctypes.CDLL(build())
        i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
        lib.nt_adjacency_coloring.restype = ctypes.c_int64
        lib.nt_adjacency_coloring.argtypes = [ctypes.c_int64, ctypes.c_int64, i64p, i32p, i32p]
        lib.nt_rcb_partition.restype = None
        lib.nt_rcb_partition.argtypes = [ctypes.c_int64, ctypes.c_int32, f64p, ctypes.c_int32,
                                         i32p]
        _lib = lib
    except (OSError, subprocess.CalledProcessError):
        _lib = None
    return _lib


def available() -> bool:
    return _load() is not None


def adjacency_colorings(gidx: np.ndarray, nel: int) -> tuple[np.ndarray, np.ndarray] | None:
    """(colors of the element graph, colors of its square) by greedy
    colouring, elements adjacent when they share a DOF; None without the
    library. gidx: [nel, npts] global ids in element-major order."""
    lib = _load()
    if lib is None:
        return None
    g = np.ascontiguousarray(gidx.reshape(nel, -1), dtype=np.int64)
    c2 = np.zeros(nel, dtype=np.int32)
    c3 = np.zeros(nel, dtype=np.int32)
    if lib.nt_adjacency_coloring(nel, g.shape[1], g, c2, c3) < 0:
        return None
    return c2.astype(np.int64), c3.astype(np.int64)


def rcb_partition(centroids: np.ndarray, nparts: int) -> np.ndarray | None:
    """Balanced element partition by recursive coordinate bisection of the
    centroids [nel, ndim]; None without the library."""
    lib = _load()
    if lib is None:
        return None
    c = np.ascontiguousarray(centroids, dtype=np.float64)
    part = np.zeros(c.shape[0], dtype=np.int32)
    lib.nt_rcb_partition(c.shape[0], c.shape[1], c, nparts, part)
    return part.astype(np.int64)
