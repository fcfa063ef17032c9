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
"""

from __future__ import annotations

import math
from typing import Callable

import torch

from ..ops.tensor import linear


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.sum(a * b)


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
    until it breaks down."""

    def __init__(self, op: Callable, like: torch.Tensor, precond: Callable | None = None,
                 project: Callable | None = None):
        self.op = op
        self.precond = precond if precond is not None else (lambda r: r)
        self.project = project
        # every buffer is set by `solve` before the first iteration reads it
        self.x, self.r, self.z, self.p = (torch.empty_like(like) for _ in range(4))
        self.rz, self.rr = (torch.empty((), dtype=like.dtype, device=like.device) for _ in range(2))
        self._step = self._iterate
        if like.is_cuda:
            # warm up on a side stream (lazy library set-up), then capture
            side = torch.cuda.Stream(like.device)
            side.wait_stream(torch.cuda.current_stream(like.device))
            with torch.cuda.stream(side):
                self._iterate()
            torch.cuda.current_stream(like.device).wait_stream(side)
            self._graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self._graph):
                self._iterate()
            self._step = self._graph.replay

    def _iterate(self) -> None:
        """One CG iteration, in place."""
        ap = self.op(self.p)
        alpha = self.rz / torch.clamp_min(_dot(self.p, ap), 1e-300)
        self.x.addcmul_(alpha, self.p)
        self.r.addcmul_(alpha, ap, value=-1.0)
        if self.project is not None:
            self.r.copy_(self.project(self.r))
        self.z.copy_(self.precond(self.r))
        rz_new = _dot(self.r, self.z)
        beta = rz_new / torch.clamp_min(self.rz, 1e-300)
        torch.addcmul(self.z, beta, self.p, out=self.p)  # p = z + beta p
        self.rz.copy_(rz_new)
        self.rr.copy_(_dot(self.r, self.r))

    def solve(self, b: torch.Tensor, x0: torch.Tensor | None = None, tol: float = 1e-8,
              maxiter: int = 500):
        """-> (x, iterations, final ||r||^2). Stops at ||r||_2 <= tol
        (absolute, Euclidean), Nek's residual-based rule. A non-finite
        residual (a non-finite right-hand side, or a breakdown) raises
        instead of returning the iterate."""
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
        self.rz.copy_(_dot(self.r, self.z))
        self.rr.copy_(_dot(self.r, self.r))
        k = 0
        while True:
            rr = float(self.rr)
            if not math.isfinite(rr):
                raise FloatingPointError(f"CG: residual norm^2 {rr} after {k} iterations")
            if k == maxiter or rr <= tol * tol:
                return self.x.clone(), k, self.rr.clone()
            self._step()
            k += 1


def pcg_info(
    op: Callable,
    b: torch.Tensor,
    precond: Callable | None = None,
    x0: torch.Tensor | None = None,
    tol: float = 1e-8,
    maxiter: int = 500,
):
    """Preconditioned CG on tensors -> (x, iterations, final ||r||^2).

    Stops at ||r||_2 <= tol (absolute, Euclidean), Nek's residual-based rule."""
    return PCG(op, b, precond).solve(b, x0=x0, tol=tol, maxiter=maxiter)


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
    too.

    param, dop: the operator's own tangent, for an operator built at a
    fixed value of a scalar s (h2 = rho g0 / dt): param carries s' as
    `tensor.tangent_part` makes it, and dop(x) applies dA/ds. The tangent
    is then A^-1 (b' - s' dA/ds x), one solve, as `jax.jvp` through
    `custom_linear_solve` gives it."""

    def solve(rhs):
        x, k, _ = cg.solve(rhs, tol=tol, maxiter=maxiter)
        if log is not None:
            log(k)
        return x

    shift = None if dop is None else (lambda _b, x: -dop(x))
    return linear(solve, b, None if project is None else (lambda g: solve(project(g))),
                  param=param, shift=shift)


def local_diagonal(op_local: Callable, shape, dtype, ndim_pts: int, device=None) -> torch.Tensor:
    """Exact diagonal of an element-local operator by probing.

    op_local maps [*batch, pts..., nel] -> [*batch, pts..., nel] per element.
    All npts within-element basis functions are probed at once, across all
    elements, as one leading batch axis of size npts."""
    pts_shape = tuple(shape[-ndim_pts - 1 : -1])
    nel = shape[-1]
    lead = tuple(shape[: -ndim_pts - 1])
    npts = 1
    for s in pts_shape:
        npts *= s
    eye = torch.eye(npts, dtype=dtype, device=device)
    e = eye.reshape((npts,) + (1,) * len(lead) + pts_shape + (1,))
    e = e.expand((npts,) + tuple(shape)).contiguous()
    out = op_local(e)
    # value at the probed node, per element
    vals = (out * e).reshape((npts,) + lead + (npts, nel)).sum(-2)  # [npts, lead..., nel]
    vals = vals.movedim(0, -2)
    return vals.reshape(lead + pts_shape + (nel,))
