"""Vector space over dict-of-tensor vectors + stacked Krylov basis.

The Krylov algorithms see vectors only through this interface: dot, norm,
rand and normalize. A vector is a dict of tensors. The space's `dot_fn`
contracts the trailing field axes, so applied to a stacked basis [k, ...]
and one vector it returns the k Gram entries at once: CGS2 is two batched
Gram products and two basis combinations per Arnoldi step.
"""

from __future__ import annotations

import dataclasses
import functools
import operator
from typing import Any, Callable

import numpy as np
import torch

Vector = Any


def tree_axpby(a, x: dict, b, y: dict) -> dict:
    return {k: a * v + b * y[k] for k, v in x.items()}


def tree_scale(a, x: dict) -> dict:
    return {k: a * v for k, v in x.items()}


def tree_add(x: dict, y: dict) -> dict:
    return {k: v + y[k] for k, v in x.items()}


def tree_sub(x: dict, y: dict) -> dict:
    return {k: v - y[k] for k, v in x.items()}


def tree_zeros_like(x: dict) -> dict:
    return {k: torch.zeros_like(v) for k, v in x.items()}


@dataclasses.dataclass
class VectorSpace:
    """dot_fn: (x, y) -> tensor; broadcasts over a leading stack axis of x.
    rand_fn: (seed: int) -> random admissible vector (C0, BC-masked).
    part: the `Partition` of a rank's block when the vectors are blocks of
    an element-partitioned run (dot_fn then sums across the ranks; the
    checkpoints gather and split along the element axis); None in one
    process."""

    dot_fn: Callable[[Vector, Vector], torch.Tensor]
    rand_fn: Callable[[int], Vector] | None = None
    part: Any = None

    def dot(self, x: Vector, y: Vector) -> float:
        return float(self.dot_fn(x, y))

    def norm(self, x: Vector) -> float:
        return float(np.sqrt(max(self.dot(x, x), 0.0)))

    def rand(self, seed: int) -> Vector:
        if self.rand_fn is None:
            raise ValueError("VectorSpace has no rand_fn")
        return self.rand_fn(seed)

    def normalize(self, w: Vector) -> tuple[Vector, float]:
        nrm = self.norm(w)
        if nrm > 0:
            w = tree_scale(1.0 / nrm, w)
        return w, nrm


def _combine(c: torch.Tensor, stack: dict, k: int) -> dict:
    """sum_j c[j] * stack[j] over the first k slots, per leaf."""
    return {name: torch.tensordot(c, s[:k], dims=([0], [0])) for name, s in stack.items()}


class KrylovBasis:
    """Preallocated orthonormal basis buffer of capacity kmax (a dict of
    stacked tensors [kmax, ...]); `k` filled slots. Slots are written in
    place."""

    def __init__(self, space: VectorSpace, template: Vector, kmax: int, _stack=None, _k=0):
        self.space = space
        self.kmax = kmax
        self.k = _k
        if _stack is not None:
            self.stack = _stack
        else:
            self.stack = {name: torch.zeros((kmax,) + tuple(v.shape), dtype=v.dtype, device=v.device)
                          for name, v in template.items()}

    def append(self, w: Vector) -> None:
        if self.k >= self.kmax:
            raise IndexError("KrylovBasis full")
        for name, s in self.stack.items():
            s[self.k].copy_(w[name])
        self.k += 1

    def __getitem__(self, j: int) -> Vector:
        if not -self.k <= j < self.k:
            raise IndexError(j)
        return {name: s[j % self.k] for name, s in self.stack.items()}

    def vectors(self) -> list[Vector]:
        """The filled slots, in order."""
        return [self[j] for j in range(self.k)]

    def orthogonalize(self, w: Vector, passes: int = 2) -> tuple[Vector, np.ndarray]:
        """Classical Gram-Schmidt against the filled slots, `passes` times
        (CGS2 by default). Returns (w_orth, h[:k]), h the summed projections."""
        stack_k = {name: s[: self.k] for name, s in self.stack.items()}
        h_sum = None
        for _ in range(passes):
            h = self.space.dot_fn(stack_k, w)  # [k]
            proj = _combine(h, self.stack, self.k)
            w = {name: w[name] - proj[name] for name in w}
            h_sum = h if h_sum is None else h_sum + h
        return w, h_sum.cpu().numpy()

    def lincomb(self, coeffs: np.ndarray) -> Vector:
        """sum_j coeffs[j] V_j (coeffs len k; may be complex).

        Complex coefficients: two real combinations on the device, joined on
        the host into complex numpy leaves (complex eigenvectors are
        terminal outputs)."""
        if np.iscomplexobj(coeffs):
            vr = self.lincomb(np.ascontiguousarray(coeffs.real))
            vi = self.lincomb(np.ascontiguousarray(coeffs.imag))
            return {name: vr[name].cpu().numpy() + 1j * vi[name].cpu().numpy() for name in vr}
        dtype = next(iter(self.stack.values())).dtype
        device = next(iter(self.stack.values())).device
        c = torch.as_tensor(np.asarray(coeffs)[: self.k], dtype=dtype, device=device)
        return _combine(c, self.stack, self.k)

    def lincomb_many(self, coeffs: np.ndarray) -> list[Vector]:
        """Columns: out[i] = sum_j coeffs[j, i] V_j."""
        return [self.lincomb(coeffs[:, i]) for i in range(coeffs.shape[1])]

    def rotated(self, coeffs: np.ndarray) -> "KrylovBasis":
        """New basis whose first p slots are V @ coeffs (coeffs [k, p] real)."""
        k, p = coeffs.shape
        if k != self.k:
            raise ValueError(f"rotated: {k} coefficient rows for {self.k} vectors")
        new = KrylovBasis(self.space, self[0], self.kmax)
        some = next(iter(self.stack.values()))
        c = torch.as_tensor(coeffs, dtype=some.dtype, device=some.device)
        for name, s in self.stack.items():
            new.stack[name][:p] = torch.tensordot(c, s[:k], dims=([0], [0]))
        new.k = p
        return new


def euclidean_space(rand_template: Vector | None = None) -> VectorSpace:
    """The plain Euclidean dot over every leaf of dict vectors (the dense
    tests' space). dot_fn contracts each leaf's own axes, so a stacked basis
    [k, ...] against one vector gives its k Gram entries. rand_template: a
    vector whose leaves' shapes, dtypes and device `rand(seed)` draws
    standard normals for (from a `torch.Generator` seeded with seed); None
    gives a space without rand."""

    def dot_fn(x, y):
        terms = []
        for name, b in y.items():
            a = x[name]
            ab = a * b
            terms.append(ab.reshape(ab.shape[: ab.dim() - b.dim()] + (b.numel(),)).sum(-1))
        return functools.reduce(operator.add, terms)

    rand_fn = None
    if rand_template is not None:

        def rand_fn(seed: int):
            out = {}
            for name, leaf in rand_template.items():
                gen = torch.Generator(device=leaf.device)
                gen.manual_seed(int(seed) + len(out))
                out[name] = torch.randn(tuple(leaf.shape), generator=gen, dtype=leaf.dtype,
                                        device=leaf.device)
            return out

    return VectorSpace(dot_fn=dot_fn, rand_fn=rand_fn)
