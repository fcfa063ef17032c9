"""The 3-D pressure operator E as two CUDA kernels: the wrapper, the gather
plan, the run counter and the tracing's count.

    E p = div_weak( (dt/g0) Binv vmask dssum( grad_weak_t p ) )

`models/stokes.py::e_op` calls `e3d` where `applies` holds: a CUDA tensor
on a 3-D mesh of one process (`mesh.part is None`: a partitioned mesh's
`dssum` all-reduces between the two halves). Everywhere else it runs the
plain chain, `stokes.e_op_plain`, which is the kernels' twin. `e3d` takes
every such apply or raises: it runs the plain chain for nothing.
`csrc/e3d.cu` holds the kernels (kernel A: the local grad-transpose;
kernel B: the gather-dssum fused with Binv, the mask and the local
divergence), built for n = order + 1 in `NS`; see the source for their
design and what bounds them. They replace no TPU kernel: the reference's
3-D E is plain XLA.

The gather plan is built once per mesh from `mesh.dss_copies` and
`mesh.vmask` (host, numpy) and kept on the mesh's device: an int32 code
per node, (offset << 3) | the node's three mask bits, where offset is 0
for a node with one copy and otherwise where its DOF's copy list starts in
an int32 table: the count, then the copies' positions, one list per
shared DOF in `dss_copies`' order (the table's first three entries are
padding, so offset 0 is free).

E is symmetric, so `e3d` runs through `tensor.linear`: a backward or a
forward-mode tangent runs the kernels again. E is linear in dt/g0, so a
tensor dt/g0 (0-dim) multiplies the kernels' E at 1.

The kernels count their applies in a 64-bit counter in device memory, one
per card, so applies replayed from a CUDA graph count. `launches` reads
it and `reset_launches` zeroes it; a traced call of the linearized
propagator and of its exact adjoint appends its count to
stats["neklab.e3d"] (`runs_mark`, `log_runs`).
"""

from __future__ import annotations

import numbers
import weakref

import numpy as np
import torch

from . import _build
from .tensor import linear

NS = range(4, 9)  # the n = order + 1 the kernels are built for (orders 3-7)
STATS_KEY = "neklab.e3d"
_INT32 = 2**31  # positions in a field and the gather plan are int32
_PAD = 3  # the table's leading entries that no copy list uses

_RUNS = _build.RunCounter("e3d")
# id(mesh.dss_copies) -> (weakref to it, weakref to mesh.vmask, plan)
_PLANS: dict[int, tuple] = {}


class _Plan:
    """The gather plan of one mesh, on its device: `node` int32 [n^3 nel],
    `table` int32."""

    def __init__(self, node: torch.Tensor, table: torch.Tensor):
        self.node, self.table = node, table


def build_plan(mesh) -> _Plan:
    """The gather plan of a 3-D mesh (see the module's docstring). Raises
    ValueError for a mask that is not 0/1 (the kernels keep it as bits) and
    for a mesh whose positions or plan pass int32."""
    copies = mesh.dss_copies.cpu().numpy()  # [npos, maxmult], padded with npos
    npos = copies.shape[0]
    if npos >= _INT32:
        raise ValueError(f"e3d: {npos} points; the kernels index fields with int32")
    vm = mesh.vmask.reshape(mesh.ndim, npos).cpu().numpy()
    if not np.all((vm == 0) | (vm == 1)):
        raise ValueError("e3d: the velocity mask is not 0/1; the kernels keep it as bits")
    count = (copies < npos).sum(1)
    first = copies.min(1)  # the DOF's first copy, the same in each copy's row
    shared = count > 1
    heads = np.nonzero(shared & (first == np.arange(npos)))[0]
    size = count[heads] + 1  # a list: the count, then the positions
    offs = _PAD + np.cumsum(size) - size
    total = _PAD + int(size.sum())
    if total >= _INT32 >> 3:
        raise ValueError(f"e3d: a gather table of {total} entries; the codes hold {_INT32 >> 3}")
    table = np.zeros(total, np.int32)
    table[offs] = count[heads]
    for j in range(copies.shape[1]):
        sel = j < count[heads]
        table[offs[sel] + 1 + j] = copies[heads[sel], j]
    head_off = np.zeros(npos, np.int64)
    head_off[heads] = offs
    off = np.where(shared, head_off[first], 0)
    bits = (vm[0] != 0) | ((vm[1] != 0) << 1) | ((vm[2] != 0) << 2)
    node = ((off << 3) | bits).astype(np.int32)
    dev = mesh.device
    return _Plan(torch.as_tensor(node, device=dev), torch.as_tensor(table, device=dev))


def plan(mesh) -> _Plan:
    """The mesh's gather plan, built at its first use (never inside a graph
    capture: the solvers' warm-up builds it)."""
    key = id(mesh.dss_copies)
    hit = _PLANS.get(key)
    if hit is not None and hit[0]() is mesh.dss_copies and hit[1]() is mesh.vmask:
        return hit[2]
    if mesh.device.type == "cuda" and torch.cuda.is_current_stream_capturing():
        raise RuntimeError("e3d: the gather plan would be built inside a graph capture; "
                           "apply E once before capturing")
    built = build_plan(mesh)
    _PLANS[key] = (weakref.ref(mesh.dss_copies), weakref.ref(mesh.vmask), built)
    weakref.finalize(mesh.dss_copies, _PLANS.pop, key, None)
    return built


def applies(mesh, dp: torch.Tensor) -> bool:
    """Whether `stokes.e_op` runs E dp through `e3d`: a CUDA tensor on a 3-D
    mesh of one process."""
    return dp.is_cuda and mesh.ndim == 3 and mesh.part is None


def e3d(mesh, dp: torch.Tensor, dt_over_g0) -> torch.Tensor:
    """E dp through the kernels, [*lead, M, M, M, nel] -> the same, on the
    current stream without synchronizing, into a fresh output. Raises
    ValueError where the kernels cannot take the apply: another dtype or
    device than the mesh's, another shape, n outside `NS`, a dt/g0 that is
    neither a real number nor a 0-dim tensor (and `build_plan`'s)."""
    _check(mesh, dp)
    if isinstance(dt_over_g0, torch.Tensor):
        if dt_over_g0.dim() != 0:
            raise ValueError(f"e3d: dt/g0 of shape {tuple(dt_over_g0.shape)}; a number or a "
                             "0-dim tensor")
        return dt_over_g0 * linear(lambda v: _launch(mesh, v.contiguous(), 1.0), dp)
    if not isinstance(dt_over_g0, numbers.Real):
        raise ValueError(f"e3d: dt/g0 of type {type(dt_over_g0).__name__}")
    c = float(dt_over_g0)
    return linear(lambda v: _launch(mesh, v.contiguous(), c), dp)


def _check(mesh, dp: torch.Tensor) -> None:
    if dp.dtype not in (torch.float32, torch.float64) or dp.dtype != mesh.dtype:
        raise ValueError(f"e3d: dp is {dp.dtype}, the mesh {mesh.dtype} (float32 or float64, "
                         "the same)")
    if dp.device != mesh.device:
        raise ValueError(f"e3d: dp on {dp.device}, the mesh on {mesh.device}")
    if dp.dim() < 4 or dp.shape[-4:] != mesh.bm2.shape:
        raise ValueError(f"e3d: dp must be [*lead, {', '.join(map(str, mesh.bm2.shape))}], "
                         f"got {tuple(dp.shape)}")
    if mesh.basis.n not in NS:
        raise ValueError(f"e3d: n = {mesh.basis.n}; the kernels are built for n = "
                         f"{NS.start}..{NS.stop - 1} (another n is a case line in "
                         "csrc/e3d.cu's `launch` and an entry of `NS`)")


def _launch(mesh, dp: torch.Tensor, c: float) -> torch.Tensor:
    """One apply on a contiguous dp."""
    p = plan(mesh)
    batch = dp.numel() // mesh.bm2.numel()
    out = torch.empty_like(dp)
    if batch == 0:
        return out
    runs = _RUNS.tensor(dp.device)
    g = torch.empty((mesh.ndim, batch) + tuple(mesh.bm1.shape), dtype=dp.dtype, device=dp.device)
    bm2, rx, binv, d, j12 = (getattr(mesh, k).contiguous()
                             for k in ("bm2", "rx", "binv", "d", "j12"))
    lib = _build.load()
    fn = lib.e3d_f32 if dp.dtype == torch.float32 else lib.e3d_f64
    with torch.cuda.device(dp.device):
        stream = torch.cuda.current_stream(dp.device).cuda_stream
        err = fn(dp.data_ptr(), bm2.data_ptr(), rx.data_ptr(), binv.data_ptr(), d.data_ptr(),
                 j12.data_ptr(), p.node.data_ptr(), p.table.data_ptr(), g.data_ptr(),
                 out.data_ptr(), batch, mesh.nel, mesh.basis.n, c, runs.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"e3d kernel launch failed: cudaError {err}")
    return out


def launches(device) -> int:
    """E applies the kernels ran on `device` since the counter was made or
    last reset, graph replays included. Synchronizes the card; 0 for the
    CPU and for a card they never ran on."""
    return _RUNS.read(device)


def reset_launches(device) -> None:
    """Zero the run counter of `device`."""
    _RUNS.reset(device)


def runs_mark(device) -> torch.Tensor | None:
    """At the start of a traced call: a copy of the card's counter, taken on
    its stream without waiting; None on the CPU."""
    device = torch.device(device)
    return _RUNS.tensor(device).clone() if device.type == "cuda" else None


def log_runs(stats: dict, mark: torch.Tensor | None) -> None:
    """At the end of a traced call, once its last stamp has passed: appends
    the applies since `mark` to stats["neklab.e3d"] (one read of the
    counter). Nothing for a None mark."""
    if mark is not None:
        now = _RUNS.tensor(mark.device)
        stats.setdefault(STATS_KEY, []).append(int(now.item()) - int(mark.item()))
