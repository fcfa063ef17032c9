"""Abstract linear operator interface (LightKrylov's `abstract_linop_rdp`
as a plain Python class over dict-of-tensor vectors)."""

from __future__ import annotations

from typing import Any, Callable

Vector = Any


class LinearOperator:
    """Matrix-free linear operator. Subclasses implement matvec (and rmatvec
    for adjoint-requiring algorithms: svds, adjoint eigs)."""

    def matvec(self, x: Vector) -> Vector:
        raise NotImplementedError

    def rmatvec(self, x: Vector) -> Vector:
        raise NotImplementedError


class FunctionOperator(LinearOperator):
    """An operator from its matvec (and optional rmatvec) functions."""

    def __init__(self, matvec: Callable, rmatvec: Callable | None = None):
        self._mv = matvec
        self._rmv = rmatvec

    def matvec(self, x):
        return self._mv(x)

    def rmatvec(self, x):
        if self._rmv is None:
            raise NotImplementedError("no rmatvec supplied")
        return self._rmv(x)


class AdjointOperator(LinearOperator):
    """The adjoint of `op`: matvec and rmatvec swapped."""

    def __init__(self, op: LinearOperator):
        self.op = op

    def matvec(self, x):
        return self.op.rmatvec(x)

    def rmatvec(self, x):
        return self.op.matvec(x)
