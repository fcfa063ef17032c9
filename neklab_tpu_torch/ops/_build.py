"""Build and load the port's CUDA kernels (nvcc -> shared library -> ctypes).

The library is compiled from `neklab_tpu_torch/csrc/*.cu` at first use into
`neklab_tpu_torch/build/`, under a name that carries a hash of the sources
and flags, so an edited source is rebuilt and a stale library is never
loaded. The sources have a plain C interface (no PyTorch headers), which
keeps a build to seconds. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "build")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_lib = None
# what the last build did: {"path", "seconds", "log"} (seconds = 0.0 when an
# up-to-date library was already on disk; the log is then the one nvcc wrote
# when it built that library)
last_build: dict = {}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (os.path.join(cuda_home, "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels cannot be built")


def _sources() -> list[str]:
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")))


def library_path() -> str:
    h = hashlib.sha256()
    for src in _sources():
        with open(src, "rb") as f:
            h.update(os.path.basename(src).encode())
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"libneklab_kernels_{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile the kernel library if no up-to-date one exists; returns its path."""
    path = library_path()
    if os.path.exists(path):
        log = ""
        if os.path.exists(f"{path}.log"):
            with open(f"{path}.log") as f:
                log = f.read()
        last_build.update(path=path, seconds=0.0, log=log)
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.tmp{os.getpid()}"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *_sources()]
    t0 = time.time()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}")
    log = proc.stdout + proc.stderr
    with open(f"{tmp}.log", "w") as f:
        f.write(log)
    os.replace(f"{tmp}.log", f"{path}.log")
    os.replace(tmp, path)
    last_build.update(path=path, seconds=time.time() - t0, log=log)
    return path


def load() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        ptr, i32, f64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
        for name in ("helmholtz2d_f32", "helmholtz2d_f64"):
            fn = getattr(lib, name)
            # u, d, g00, g01, g11, bm1, out; batch, nel, n; h1, h2; the run
            # counter and the stream (pointers as c_void_p)
            fn.argtypes = [ptr] * 7 + [i32, i32, i32, f64, f64, ptr, ptr]
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib
