"""Fused local 2-D Helmholtz apply: the CUDA kernel and its plain twin.

    H u = h1 * [Dr^T (g00 Dr u + g01 Ds u) + Ds^T (g01 Dr u + g11 Ds u)] + h2 * bm1 * u

equal to the reference's `sem.helmholtz_local` on 2-D meshes. The kernel
(`csrc/helmholtz2d.cu`) replaces the Pallas TPU kernel
`neklab_tpu/ops/pallas_kernels.py::_helmholtz2d_call`; see the source for
its design and what bounds it.

`helmholtz2d` launches the kernel for CUDA tensors, always: a build or
launch failure raises. It uses `helmholtz2d_plain` only because a tensor
lies on the CPU.

The kernel counts its own runs in a 64-bit counter in device memory, one
per card, so a run replayed from a CUDA graph counts like a launch from the
host. `launches` reads the counter and `reset_launches` zeroes it; the plain
twin never counts.
"""

from __future__ import annotations

import torch

from .tensor import apply_r, apply_s

NMAX = 12  # largest n = order + 1 the kernel takes

# device index -> int64 [1] run counter of the kernel on that card. Made at
# the first launch on the card, outside any graph capture, and never freed:
# captured launches keep its address.
_RUNS: dict[int, torch.Tensor] = {}


def helmholtz2d_plain(u, d, g00, g01, g11, bm1, h1, h2):
    """Plain torch version (reference for the kernel; used for CPU tensors).

    u: [..., n, n, nel]; d: [n, n]; g00, g01, g11, bm1: [n, n, nel]."""
    ur = apply_r(d, u)
    us = apply_s(d, u)
    wr = g00 * ur + g01 * us
    ws = g01 * ur + g11 * us
    return h1 * (apply_r(d.T, wr) + apply_s(d.T, ws)) + h2 * bm1 * u


def helmholtz2d(u, d, g00, g01, g11, bm1, h1, h2):
    """Fused local Helmholtz apply on [..., n, n, nel] fields.

    CPU tensors: `helmholtz2d_plain`. CUDA tensors: the kernel, launched on
    the current stream without synchronizing, into a fresh output; the
    launcher picks its tile from the shape and the card."""
    if u.device.type == "cpu":
        return helmholtz2d_plain(u, d, g00, g01, g11, bm1, h1, h2)
    _check(u, d, g00, g01, g11, bm1)
    from . import _build

    n, nel = d.shape[0], u.shape[-1]
    batch = u.numel() // (n * n * nel)
    runs = _counter(u.device)
    out = torch.empty_like(u)
    lib = _build.load()
    fn = lib.helmholtz2d_f32 if u.dtype == torch.float32 else lib.helmholtz2d_f64
    with torch.cuda.device(u.device):
        stream = torch.cuda.current_stream(u.device).cuda_stream
        err = fn(u.data_ptr(), d.data_ptr(), g00.data_ptr(), g01.data_ptr(),
                 g11.data_ptr(), bm1.data_ptr(), out.data_ptr(),
                 batch, nel, n, float(h1), float(h2), runs.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"helmholtz2d kernel launch failed: cudaError {err}")
    return out


def _index(device: torch.device) -> int:
    return device.index if device.index is not None else torch.cuda.current_device()


def _counter(device: torch.device) -> torch.Tensor:
    index = _index(device)
    runs = _RUNS.get(index)
    if runs is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("helmholtz2d: the run counter of cuda:%d would be made inside a "
                               "graph capture; launch the kernel once before capturing" % index)
        runs = _RUNS[index] = torch.zeros(1, dtype=torch.int64, device=torch.device("cuda", index))
    return runs


def _existing_counter(device) -> torch.Tensor | None:
    device = torch.device(device)
    if device.type != "cuda":
        return None
    return _RUNS.get(_index(device))


def launches(device) -> int:
    """Kernel runs on `device` since its counter was made or last reset,
    graph replays included. Synchronizes the card; 0 for the CPU and for a
    card the kernel never ran on."""
    runs = _existing_counter(device)
    if runs is None:
        return 0
    torch.cuda.synchronize(runs.device)
    return int(runs.item())


def reset_launches(device) -> None:
    """Zero the run counter of `device`."""
    runs = _existing_counter(device)
    if runs is not None:
        runs.zero_()


def _check(u, d, g00, g01, g11, bm1) -> None:
    tensors = {"u": u, "d": d, "g00": g00, "g01": g01, "g11": g11, "bm1": bm1}
    if u.device.type != "cuda":
        raise ValueError(f"helmholtz2d: u on {u.device}; the kernel takes CUDA tensors")
    if u.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"helmholtz2d: dtype {u.dtype} (float32 or float64 only)")
    for name, t in tensors.items():
        if t.device != u.device or t.dtype != u.dtype:
            raise ValueError(f"helmholtz2d: {name} is {t.dtype} on {t.device}, "
                             f"u is {u.dtype} on {u.device}")
        if not t.is_contiguous():
            raise ValueError(f"helmholtz2d: {name} is not contiguous")
    n = d.shape[0]
    if d.dim() != 2 or d.shape[1] != n or not 2 <= n <= NMAX:
        raise ValueError(f"helmholtz2d: d must be [n, n] with 2 <= n <= {NMAX}, got {tuple(d.shape)}")
    if u.dim() < 3 or u.shape[-3:-1] != (n, n):
        raise ValueError(f"helmholtz2d: u must be [..., {n}, {n}, nel], got {tuple(u.shape)}")
    geo = (n, n, u.shape[-1])
    for name in ("g00", "g01", "g11", "bm1"):
        if tuple(tensors[name].shape) != geo:
            raise ValueError(f"helmholtz2d: {name} must be {geo}, got {tuple(tensors[name].shape)}")
