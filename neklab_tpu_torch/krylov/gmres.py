"""Restarted GMRES, flexible GMRES and CG over abstract vectors.

Used for the Newton-Krylov Jacobian solves (and later the resolvent's
(I - exptA) solves), where each matvec is a full time integration. The
vectors stay on their device; the least-squares problem on the projected
Hessenberg matrix is solved on the host in numpy. Counterpart of
`neklab_tpu/krylov/gmres.py` (LightKrylov `gmres_rdp`, `fgmres`, `cg`).
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Any

import numpy as np

from .linop import LinearOperator
from .space import KrylovBasis, VectorSpace, tree_axpby, tree_scale

logger = logging.getLogger("neklab_tpu_torch.krylov")

Vector = Any


@dataclasses.dataclass
class GmresResult:
    x: Vector
    residual: float
    n_matvec: int
    converged: bool
    n_restart: int


def _arnoldi_cycle(apply, space, r, beta, kdim, target, precond=None):
    """One restart cycle from the residual r (norm beta): -> (the update,
    the least-squares residual). With `precond` (flexible GMRES) the
    preconditioned directions Z_j = M_j^-1 V_j are kept beside the basis
    and the update is Z y; without, the update is V y."""
    v1 = tree_scale(1.0 / beta, r)
    V = KrylovBasis(space, v1, kdim + 1)
    V.append(v1)
    Z = KrylovBasis(space, v1, kdim) if precond is not None else None
    H = np.zeros((kdim + 1, kdim))
    ym, m_used, res = None, 0, beta
    for j in range(kdim):
        z = V[j]
        if Z is not None:
            z = precond(z)
            Z.append(z)
        w, h = V.orthogonalize(apply(z), passes=2)
        w, hnext = space.normalize(w)
        H[: j + 1, j] = h
        H[j + 1, j] = hnext
        V.append(w)
        m_used = j + 1
        # the (j+2) x (j+1) least squares for the current residual
        e1 = np.zeros(j + 2)
        e1[0] = beta
        ym, *_ = np.linalg.lstsq(H[: j + 2, : j + 1], e1, rcond=None)
        res = float(np.linalg.norm(H[: j + 2, : j + 1] @ ym - e1))
        if res <= target or hnext < 1e-14:
            break
    basis = Z if Z is not None else V
    sub = KrylovBasis(space, None, basis.kmax, _stack=basis.stack, _k=m_used)
    return sub.lincomb(ym[:m_used]), res, m_used


def fgmres(
    op: LinearOperator,
    b: Vector,
    space: VectorSpace,
    precond=None,
    x0: Vector | None = None,
    kdim: int = 64,
    rtol: float = 1e-6,
    atol: float = 1e-12,
    max_restarts: int = 10,
    adjoint: bool = False,
) -> GmresResult:
    """Flexible GMRES (Saad): right-preconditioned by `precond`, v ->
    M^-1 v, which may change between iterations (an inner iterative solve);
    None is plain GMRES. Stops at ||b - A x|| <= max(rtol ||b||, atol);
    `adjoint` solves with op.rmatvec."""
    apply = op.rmatvec if adjoint else op.matvec
    target = max(rtol * space.norm(b), atol)
    x, n_mv, res = x0, 0, space.norm(b)
    for restart in range(max_restarts):
        if x is None:
            r = b
        else:
            r = tree_axpby(1.0, b, -1.0, apply(x))
            n_mv += 1
        beta = space.norm(r)
        if beta <= target:
            return GmresResult(x=x if x is not None else tree_scale(0.0, b), residual=beta,
                               n_matvec=n_mv, converged=True, n_restart=restart)
        upd, res, m_used = _arnoldi_cycle(apply, space, r, beta, kdim, target, precond)
        n_mv += m_used
        x = upd if x is None else tree_axpby(1.0, x, 1.0, upd)
        logger.info("gmres restart %d: residual %.3e (target %.3e)", restart, res, target)
        if res <= target:
            return GmresResult(x=x, residual=res, n_matvec=n_mv, converged=True,
                               n_restart=restart)
    return GmresResult(x=x, residual=res, n_matvec=n_mv, converged=False,
                       n_restart=max_restarts)


def gmres(
    op: LinearOperator,
    b: Vector,
    space: VectorSpace,
    x0: Vector | None = None,
    kdim: int = 64,
    rtol: float = 1e-6,
    atol: float = 1e-12,
    max_restarts: int = 10,
    adjoint: bool = False,
) -> GmresResult:
    """Restarted GMRES(kdim): `fgmres` without a preconditioner."""
    return fgmres(op, b, space, x0=x0, kdim=kdim, rtol=rtol, atol=atol,
                  max_restarts=max_restarts, adjoint=adjoint)


def cg(
    op: LinearOperator,
    b: Vector,
    space: VectorSpace,
    x0: Vector | None = None,
    rtol: float = 1e-8,
    atol: float = 1e-12,
    maxiter: int = 500,
) -> GmresResult:
    """Conjugate gradient for an operator symmetric positive definite in the
    space's inner product. (The implicit solves of the steppers use
    `models.solvers.PCG` instead.) n_restart is the iteration count."""
    x = x0 if x0 is not None else tree_scale(0.0, b)
    r = tree_axpby(1.0, b, -1.0, op.matvec(x))
    p = r
    rz = space.dot(r, r)
    target = max(rtol * space.norm(b), atol)
    n_mv = 1
    for it in range(maxiter):
        if np.sqrt(rz) <= target:
            return GmresResult(x=x, residual=float(np.sqrt(rz)), n_matvec=n_mv, converged=True,
                               n_restart=it)
        ap = op.matvec(p)
        n_mv += 1
        alpha = rz / space.dot(p, ap)
        x = tree_axpby(1.0, x, alpha, p)
        r = tree_axpby(1.0, r, -alpha, ap)
        rz_new = space.dot(r, r)
        p = tree_axpby(1.0, r, rz_new / rz, p)
        rz = rz_new
    return GmresResult(x=x, residual=float(np.sqrt(rz)), n_matvec=n_mv, converged=False,
                       n_restart=maxiter)
