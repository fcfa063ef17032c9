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

The reference wraps its CG in `lax.custom_linear_solve` only so the solve
can be transposed (exact discrete adjoints); the port runs `PCG` directly
until the adjoint is ported.
"""

from __future__ import annotations

from typing import Callable

import torch


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.sum(a * b)


class PCG:
    """Preconditioned CG for one operator and preconditioner, on buffers
    shaped like `like`. With a CUDA `like`, the iteration is captured as a
    CUDA graph at construction (after one warm-up run) and replayed by
    `solve`; on the CPU it runs eagerly."""

    def __init__(self, op: Callable, like: torch.Tensor, precond: Callable | None = None):
        self.op = op
        self.precond = precond if precond is not None else (lambda r: r)
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
        self.z.copy_(self.precond(self.r))
        rz_new = _dot(self.r, self.z)
        beta = rz_new / torch.clamp_min(self.rz, 1e-300)
        torch.addcmul(self.z, beta, self.p, out=self.p)  # p = z + beta p
        self.rz.copy_(rz_new)
        self.rr.copy_(_dot(self.r, self.r))

    def solve(self, b: torch.Tensor, x0: torch.Tensor | None = None, tol: float = 1e-8,
              maxiter: int = 500):
        """-> (x, iterations, final ||r||^2). Stops at ||r||_2 <= tol
        (absolute, Euclidean), Nek's residual-based rule."""
        if x0 is None:
            self.x.zero_()
            self.r.copy_(b)
        else:
            self.x.copy_(x0)
            self.r.copy_(b - self.op(x0))
        self.z.copy_(self.precond(self.r))
        self.p.copy_(self.z)
        self.rz.copy_(_dot(self.r, self.z))
        self.rr.copy_(_dot(self.r, self.r))
        k = 0
        while k < maxiter and float(self.rr) > tol * tol:
            self._step()
            k += 1
        return self.x.clone(), k, self.rr.clone()


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
