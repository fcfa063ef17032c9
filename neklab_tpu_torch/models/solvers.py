"""Matrix-free preconditioned CG and the local-diagonal probe.

The CG is a Python loop with the reference's stopping rule: continue while
||r||^2 > tol^2 and k < maxiter, checked every iteration. Each check reads
one scalar back to the host (a device sync per iteration on the card); that
keeps iteration counts identical to the reference's `lax.while_loop`.

`PCG` keeps the iterates in fixed buffers and updates them in place, so that
on the card one iteration is captured once as a CUDA graph and replayed:
one graph launch per iteration in place of ~35-40 host dispatches, which
bound the step time (PERF.md). The velocity and pressure solvers both build
their `PCG` once and replay it; the Helmholtz kernel counts its runs on the
device, so the replays count too.

The reference wraps its CG in `lax.custom_linear_solve(symmetric=True)` so
that the solve can be transposed (exact discrete adjoints). `linear_solve`
is the port's counterpart: the solve is a symmetric linear map of its
right-hand side, and under autograd its backward runs the same built-once
`PCG`, at the same tolerance and with the same graph, on the cotangent; in
forward mode its jvp does the same on the tangent (`jax.jvp` through
`custom_linear_solve`), with the operator's own tangent when it depends on
a scalar that carries one (dt). The iterations are re-solved, never
differentiated.

A solve whose `log` carries a traced `stats=` dict (`SolveLog`) is timed:
`PCG.solve(timings=)` stamps the card's stream before and after each
iteration's replay and after its final read, and appends one `CGTiming`.
"""

from __future__ import annotations

import math
import time
from typing import Callable, NamedTuple

import torch

from ..ops.tensor import linear
from ..utils.timers import Clock, profiler_range, profiling, traced


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.sum(a * b)


_WARMUP_STREAMS: dict = {}


def _warmup_stream(device: torch.device) -> torch.cuda.Stream:
    """The one side stream of each card on which every `PCG` warms up before
    its capture. A stream of its own per build would leave cuBLAS a
    workspace per stream (32 MiB on an H100, kept while the process runs),
    so a caller that rebuilds its solvers (`advance_adaptive` at each new
    dt) would grow device memory with every rebuild."""
    if device not in _WARMUP_STREAMS:
        _WARMUP_STREAMS[device] = torch.cuda.Stream(device)
    return _WARMUP_STREAMS[device]


class CGTiming(NamedTuple):
    """One traced solve as the card's stream saw it (CUDA events; the host's
    clock on the CPU), in seconds."""

    iters: int  # CG iterations
    iter_s: float  # the iterations: each from the stamp before its launch to its end
    gap_s: float  # between them: from the end of the set-up or of an iteration to the
    # next one's stamp, i.e. the residual's copy, the host's wake-up and test
    span_s: float  # the whole solve, from its set-up to its final read
    read_s: float  # the host's time blocked in the residual reads


class SolveLog:
    """Where a solve reports to a `stats=` dict: `log(k)` appends its CG's
    iteration count to stats[key], and `log(k, timing)` also its `CGTiming`
    to stats["neklab.cg.<key>"]. `traced()` says whether the dict takes
    timings (`timers.traced`); it is asked at each solve, so that a
    backward recorded with the dict follows the call that runs it."""

    def __init__(self, stats: dict, key: str):
        self.stats, self.key = stats, key
        self.name = "neklab.cg." + key

    def __call__(self, k: int, timing: CGTiming | None = None) -> None:
        self.stats.setdefault(self.key, []).append(k)
        if timing is not None:
            self.stats.setdefault(self.name, []).append(timing)

    def traced(self) -> bool:
        return traced(self.stats)


class PCG:
    """Preconditioned CG for one operator and preconditioner, on buffers
    shaped like `like`. With a CUDA `like`, the iteration is captured as a
    CUDA graph at construction (after one warm-up run) and replayed by
    `solve`; on the CPU it runs eagerly.

    project: for an operator with a nullspace, the projection onto its range,
    applied to the residual at every update (Nek5000's `ortho` in its
    pressure CG). Without it the residual keeps the nullspace part that
    rounding adds, which no iteration can remove: in float32 that part
    (~1e-8 of the right-hand side) stalls a CG asked for a tighter residual
    until it breaks down.

    part: the `Partition` of a rank's block in an element-partitioned run:
    the dots are then summed across the ranks, p.Ap in one all-reduce and
    (r.z, r.r) in one more, so every rank reads the same residual and
    stops at the same iteration. `graphed` says whether the iteration
    replays a CUDA graph: on the card unless the partition's all-reduce
    cannot be captured (gloo), when it runs eagerly; each replay adds the
    all-reduces it runs to the partition's log."""

    def __init__(self, op: Callable, like: torch.Tensor, precond: Callable | None = None,
                 project: Callable | None = None, part=None):
        self.op = op
        self.precond = precond if precond is not None else (lambda r: r)
        self.project = project
        self.part = part
        # every buffer is set by `solve` before the first iteration reads it
        self.x, self.r, self.z, self.p = (torch.empty_like(like) for _ in range(4))
        self.rz, self.rr = (torch.empty((), dtype=like.dtype, device=like.device) for _ in range(2))
        self._step = self._iterate
        self._clock: Clock | None = None  # the event pool, made at the first timed solve
        # a CUDA iteration is captured unless its all-reduces cannot be (gloo)
        self.graphed = like.is_cuda and (part is None or part.capturable)
        if self.graphed:
            # warm up on a side stream (lazy library set-up), then capture
            side = _warmup_stream(like.device)
            side.wait_stream(torch.cuda.current_stream(like.device))
            with torch.cuda.stream(side):
                self._iterate()
            torch.cuda.current_stream(like.device).wait_stream(side)
            snap = None if part is None else part.log.snapshot()
            self._graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self._graph):
                self._iterate()
            self._step = self._graph.replay
            if part is not None:
                # the capture ran none of the all-reduces it logged; every
                # replay runs them all
                self._per_replay = part.log.since(snap)
                part.log.add(*self._per_replay, times=-1)
                self._step = self._replay

    def _replay(self) -> None:
        self._graph.replay()
        self.part.log.add(*self._per_replay)

    def _dots(self, *pairs) -> list[torch.Tensor]:
        """sum(a * b) of each (a, b) pair, summed across the ranks of a
        partitioned run in one all-reduce."""
        sums = [_dot(a, b) for a, b in pairs]
        if self.part is None:
            return sums
        return list(self.part.all_reduce(torch.stack(sums)).unbind())

    def _iterate(self) -> None:
        """One CG iteration, in place."""
        ap = self.op(self.p)
        (pap,) = self._dots((self.p, ap))
        alpha = self.rz / torch.clamp_min(pap, 1e-300)
        self.x.addcmul_(alpha, self.p)
        self.r.addcmul_(alpha, ap, value=-1.0)
        if self.project is not None:
            self.r.copy_(self.project(self.r))
        self.z.copy_(self.precond(self.r))
        rz_new, rr = self._dots((self.r, self.z), (self.r, self.r))
        beta = rz_new / torch.clamp_min(self.rz, 1e-300)
        torch.addcmul(self.z, beta, self.p, out=self.p)  # p = z + beta p
        self.rz.copy_(rz_new)
        self.rr.copy_(rr)

    def _begin(self, b: torch.Tensor, x0: torch.Tensor | None) -> None:
        """The buffers at iteration 0: x, the residual, z, p, r.z and r.r."""
        if x0 is None:
            self.x.zero_()
            self.r.copy_(b)
        else:
            self.x.copy_(x0)
            self.r.copy_(b - self.op(x0))
        if self.project is not None:
            self.r.copy_(self.project(self.r))
        self.z.copy_(self.precond(self.r))
        self.p.copy_(self.z)
        rz, rr = self._dots((self.r, self.z), (self.r, self.r))
        self.rz.copy_(rz)
        self.rr.copy_(rr)

    def solve(self, b: torch.Tensor, x0: torch.Tensor | None = None, tol: float = 1e-8,
              maxiter: int = 500, timings: list | None = None):
        """-> (x, iterations, final ||r||^2). Stops at ||r||_2 <= tol
        (absolute, Euclidean), Nek's residual-based rule. A non-finite
        residual (a non-finite right-hand side, or a breakdown) raises
        instead of returning the iterate.

        timings: a list to which the solve appends its `CGTiming` (a traced
        solve; while a profiler records, it opens its ranges and appends
        nothing); the iterates are the same bit for bit."""
        if timings is not None:
            return self._solve_traced(b, x0, tol, maxiter, timings)
        self._begin(b, x0)
        k = 0
        while True:
            rr = float(self.rr)
            if not math.isfinite(rr):
                raise FloatingPointError(f"CG: residual norm^2 {rr} after {k} iterations")
            if k == maxiter or rr <= tol * tol:
                return self.x.clone(), k, self.rr.clone()
            self._step()
            k += 1

    def _solve_traced(self, b, x0, tol, maxiter, timings: list):
        """`solve` with a stamp before the set-up, after it, before and after
        each iteration and after the final read, which are read once that
        last stamp has passed; while a profiler records, each residual read
        is the range `neklab.cg.read` and the solve takes no stamp."""
        clock = None
        if not profiling():
            if self._clock is None:
                self._clock = Clock(self.x.device)
            clock = self._clock
            clock.start()
        stamp = clock.stamp if clock is not None else (lambda: None)
        first = stamp()
        self._begin(b, x0)
        marks = [stamp()]
        read_s = 0.0
        k = 0
        while True:
            with profiler_range("neklab.cg.read"):
                t = time.perf_counter()
                rr = float(self.rr)
                read_s += time.perf_counter() - t
            if not math.isfinite(rr):
                raise FloatingPointError(f"CG: residual norm^2 {rr} after {k} iterations")
            if k == maxiter or rr <= tol * tol:
                break
            marks.append(stamp())
            self._step()
            marks.append(stamp())
            k += 1
        if clock is None:
            return self.x.clone(), k, self.rr.clone()
        last = clock.stamp()
        clock.wait(last)
        iter_s = sum(clock.seconds(marks[i], marks[i + 1]) for i in range(1, 2 * k, 2))
        gap_s = clock.seconds(marks[0], marks[-1]) - iter_s if k else 0.0
        timings.append(CGTiming(k, iter_s, gap_s, clock.seconds(first, last), read_s))
        return self.x.clone(), k, self.rr.clone()


def pcg(
    op: Callable,
    b: torch.Tensor,
    precond: Callable | None = None,
    x0: torch.Tensor | None = None,
    tol: float = 1e-8,
    maxiter: int = 500,
    part=None,
) -> torch.Tensor:
    """Preconditioned CG on tensors -> x, the reference's functional `pcg`.

    Stops at ||r||_2 <= tol (absolute, Euclidean), Nek's residual-based
    rule. A solver that solves repeatedly builds one `PCG` instead (on the
    card each call here captures a graph). part: as in `PCG`."""
    return pcg_info(op, b, precond, x0=x0, tol=tol, maxiter=maxiter, part=part)[0]


def pcg_info(
    op: Callable,
    b: torch.Tensor,
    precond: Callable | None = None,
    x0: torch.Tensor | None = None,
    tol: float = 1e-8,
    maxiter: int = 500,
    part=None,
):
    """Preconditioned CG on tensors -> (x, iterations, final ||r||^2).

    Stops at ||r||_2 <= tol (absolute, Euclidean), Nek's residual-based rule.
    part: as in `PCG`."""
    return PCG(op, b, precond, part=part).solve(b, x0=x0, tol=tol, maxiter=maxiter)


def linear_solve(cg: PCG, b: torch.Tensor, tol: float, maxiter: int,
                 project: Callable | None = None, log: Callable | None = None,
                 param: torch.Tensor | None = None, dop: Callable | None = None) -> torch.Tensor:
    """x = cg.solve(b) as a linear map of b, for a Euclidean-symmetric
    `cg.op`. The backward solves the cotangent with the same CG: the
    reference's `custom_linear_solve(..., symmetric=True)`. project: a
    symmetric projection that commutes with cg.op and whose range holds
    every b (the pressure's range of E, the velocity's consistent
    subspace); the map is then solve o project, and the backward projects
    the cotangent before it solves. In forward mode the tangent is solved
    the same way (its right-hand side lies in the range as b does). log(k)
    receives each solve's iteration count, the backward's and the tangent's
    too. A `SolveLog` that reports to a traced dict (`timers.traced`, asked
    at each solve, the backward's too) also receives each solve's
    `CGTiming`; while a profiler records, the solve is the range
    `neklab.cg.<key>` instead.

    param, dop: the operator's own tangent, for an operator built at a
    fixed value of a scalar s (h2 = rho g0 / dt): param carries s' as
    `tensor.tangent_part` makes it, and dop(x) applies dA/ds. The tangent
    is then A^-1 (b' - s' dA/ds x), one solve, as `jax.jvp` through
    `custom_linear_solve` gives it."""

    def solve(rhs):
        if isinstance(log, SolveLog) and log.traced():
            timings = []
            with profiler_range(log.name):
                x, k, _ = cg.solve(rhs, tol=tol, maxiter=maxiter, timings=timings)
            log(k, *timings)
            return x
        x, k, _ = cg.solve(rhs, tol=tol, maxiter=maxiter)
        if log is not None:
            log(k)
        return x

    shift = None if dop is None else (lambda _b, x: -dop(x))
    return linear(solve, b, None if project is None else (lambda g: solve(project(g))),
                  param=param, shift=shift)


# bytes of one chunk of the diagonal probe: the plain 3-D chain holds about
# ten intermediates of the probe's size at once, so ~1 GB at the peak
_PROBE_BYTES = 96 * 2**20


def local_diagonal(op_local: Callable, shape, dtype, ndim_pts: int, device=None) -> torch.Tensor:
    """Exact diagonal of an element-local operator by probing.

    op_local maps [*batch, pts..., nel] -> [*batch, pts..., nel] per element.
    The npts within-element basis functions are probed across all elements,
    as one leading batch axis, in chunks of nodes whose probe stays under
    _PROBE_BYTES (one chunk for every 2-D mesh the port meets; at box3d,
    216 nodes of 1,728 elements, a few chunks in place of a 0.3-0.6 GB
    probe). Each chunk reads the probed nodes' own entries, so the values
    do not depend on the chunking."""
    pts_shape = tuple(shape[-ndim_pts - 1 : -1])
    nel = shape[-1]
    lead = tuple(shape[: -ndim_pts - 1])
    npts = math.prod(pts_shape)
    per_node = math.prod(shape) * torch.empty((), dtype=dtype).element_size()
    chunk = max(1, min(npts, _PROBE_BYTES // per_node))
    eye = torch.eye(npts, dtype=dtype, device=device)
    vals = []
    for j0 in range(0, npts, chunk):
        m = min(chunk, npts - j0)
        e = eye[j0:j0 + m].reshape((m,) + (1,) * len(lead) + pts_shape + (1,))
        out = op_local(e.expand((m,) + tuple(shape)).contiguous())
        # value at the probed node, per element: out[k, ..., j0 + k, :]
        out = out.reshape((m,) + lead + (npts, nel))
        idx = torch.arange(j0, j0 + m, device=device).reshape((m,) + (1,) * len(lead) + (1, 1))
        vals.append(out.gather(-2, idx.expand((m,) + lead + (1, nel))).squeeze(-2))
    vals = torch.cat(vals).movedim(0, -2)  # [lead..., npts, nel]
    return vals.reshape(lead + pts_shape + (nel,))
