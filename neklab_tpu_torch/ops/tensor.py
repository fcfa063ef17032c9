"""Tensor-product contractions over element-local SEM fields.

Field convention (as in the reference package) — ELEMENT-LAST layout:
  2-D: f[..., s, r, nel]
  3-D: f[..., t, s, r, nel]

A 1-D operator a[m, n] applied along one reference axis is a small
contraction batched over every other axis: with the contracted axis folded
against the (contiguous) axes after it, it is one `torch.matmul` (a single
batched GEMM, no transposed copy). With TF32 off (see the package
`__init__`) these run in true float32 on the card.

`linear` applies a linear map whose transpose the caller gives, or which is
its own transpose (dssum, the Helmholtz kernel, a CG solve, the E apply),
so that autograd's backward is that map and not the derivative of its
insides: the port's counterpart of `custom_linear_solve(...,
symmetric=True)` and of transposing a symmetric primitive in JAX. In
forward mode (`torch.autograd.forward_ad`) the tangent of a linear map is
the map applied to the tangent, so its `jvp` is the map itself: the
counterpart of `jax.jvp` through those primitives.
"""

from __future__ import annotations

import functools
import operator
from typing import Callable

import torch
import torch.autograd.forward_ad as fwAD

__all__ = [
    "apply_r", "apply_s", "apply_t", "grad_rst", "grad_rst_t", "interp_nd", "interp_nd_t", "tsum",
    "linear",
]


class _Linear(torch.autograd.Function):
    """forward receives the primal x (never a dual tensor), so op runs
    outside both modes of autograd; backward and jvp are the only rules."""

    @staticmethod
    def forward(ctx, x, op, transpose):
        ctx.op, ctx.transpose = op, transpose
        return op(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.transpose(g), None, None

    @staticmethod
    def jvp(ctx, t, _op, _transpose):
        return ctx.op(t)


def _is_dual(x: torch.Tensor) -> bool:
    """x carries a forward-mode tangent (inside a `forward_ad.dual_level`)."""
    return fwAD.unpack_dual(x).tangent is not None


def linear(op: Callable, x: torch.Tensor, transpose: Callable | None = None) -> torch.Tensor:
    """op(x) for a linear op. When x takes part in autograd, the backward
    applies `transpose` (Euclidean; op itself when None, for a symmetric op)
    to the cotangent, so a reverse pass reuses op as it is (its kernel, its
    built-once CG) instead of differentiating its insides. When x carries a
    forward-mode tangent, the tangent's image is op applied to it, by the
    same reuse. Otherwise this is op(x)."""
    if (x.requires_grad and torch.is_grad_enabled()) or _is_dual(x):
        return _Linear.apply(x, op, op if transpose is None else transpose)
    return op(x)


def tsum(terms):
    """Sum of tensors. Python's `sum` starts from 0, and `0 + t` is one more
    kernel launch on the card."""
    return functools.reduce(operator.add, terms)


def _apply_axis(a, u, axis: int):
    """out[..., i, rest] = sum_j a[i, j] u[..., j, rest], contracting `axis` (< 0)."""
    shape = u.shape
    out = torch.matmul(a, u.reshape(shape[: axis + 1] + (-1,)))
    return out.reshape(shape[:axis] + (a.shape[0],) + shape[axis + 1 :])


def apply_r(a, u):
    """Contract the r axis (second-to-last): out[..., i, e] = sum_j a[i,j] u[..., j, e]."""
    return torch.matmul(a, u)


def apply_s(a, u):
    """Contract the s axis (third-to-last)."""
    return _apply_axis(a, u, -3)


def apply_t(a, u):
    """Contract the t axis (fourth-to-last, 3-D only)."""
    return _apply_axis(a, u, -4)


def grad_rst(u, d, ndim: int):
    """Reference-space gradient: tuple (u_r, u_s[, u_t])."""
    if ndim == 2:
        return apply_r(d, u), apply_s(d, u)
    return apply_r(d, u), apply_s(d, u), apply_t(d, u)


def grad_rst_t(u, d, ndim: int):
    """Transpose-gradient accumulation: sum_k A_k^T f_k for fluxes
    (f_r, f_s[, f_t]) — the weak Laplacian's outer contraction."""
    dt = d.T
    if ndim == 2:
        fr, fs = u
        return apply_r(dt, fr) + apply_s(dt, fs)
    fr, fs, ft = u
    return apply_r(dt, fr) + apply_s(dt, fs) + apply_t(dt, ft)


def interp_nd(j, u, ndim: int):
    """Apply interpolation matrix j along every reference axis (grid change)."""
    if ndim == 2:
        return apply_s(j, apply_r(j, u))
    return apply_t(j, apply_s(j, apply_r(j, u)))


def interp_nd_t(j, u, ndim: int):
    """Transpose interpolation along every axis (fine -> coarse projection)."""
    return interp_nd(j.T, u, ndim)
