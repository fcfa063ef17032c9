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

import torch

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
        for name in ("e3d_f32", "e3d_f64"):
            fn = getattr(lib, name)
            # p, bm2, rx, binv, d, j12, node, table, g, out; batch, nel, n; c;
            # the run counter and the stream
            fn.argtypes = [ptr] * 10 + [i32, i32, i32, f64, ptr, ptr]
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


class RunCounter:
    """A kernel's runs on each card, counted by the kernel itself in a 64-bit
    counter in device memory, so that a run replayed from a CUDA graph
    counts like a launch from the host. The counter of a card is made at the
    kernel's first launch there, outside any graph capture, and never freed:
    captured launches keep its address."""

    def __init__(self, name: str):
        self.name = name
        self._runs: dict[int, torch.Tensor] = {}

    @staticmethod
    def _index(device: torch.device) -> int:
        return device.index if device.index is not None else torch.cuda.current_device()

    def tensor(self, device: torch.device) -> torch.Tensor:
        """The int64 [1] counter of a card, made here at its first use."""
        index = self._index(device)
        runs = self._runs.get(index)
        if runs is None:
            if torch.cuda.is_current_stream_capturing():
                raise RuntimeError(f"{self.name}: the run counter of cuda:{index} would be made "
                                   "inside a graph capture; launch the kernel once before "
                                   "capturing")
            runs = self._runs[index] = torch.zeros(1, dtype=torch.int64,
                                                   device=torch.device("cuda", index))
        return runs

    def existing(self, device) -> torch.Tensor | None:
        device = torch.device(device)
        if device.type != "cuda":
            return None
        return self._runs.get(self._index(device))

    def read(self, device) -> int:
        """Runs on `device` since its counter was made or last reset, graph
        replays included. Synchronizes the card; 0 for the CPU and for a
        card the kernel never ran on."""
        runs = self.existing(device)
        if runs is None:
            return 0
        torch.cuda.synchronize(runs.device)
        return int(runs.item())

    def reset(self, device) -> None:
        """Zero the counter of `device`."""
        runs = self.existing(device)
        if runs is not None:
            runs.zero_()
