"""Lanczos bidiagonalization SVD over dict-of-tensor vectors (transient growth).

Golub-Kahan-Lanczos with full CGS2 reorthogonalization of both bases (stacked
buffers, batched Gram products), dense SVD of the projected bidiagonal
matrix on the host. Each iteration costs one matvec and one rmatvec.
Counterpart of `neklab_tpu.krylov.svd` (Lanczos checkpoints are not ported,
as `eigs`'s are not).
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Any

import numpy as np

from .linop import LinearOperator
from .space import KrylovBasis, VectorSpace

logger = logging.getLogger("neklab_tpu_torch.krylov")

Vector = Any


@dataclasses.dataclass
class SvdsResult:
    s: np.ndarray  # singular values [nsv], descending
    u_coeffs: np.ndarray  # [m, nsv] left singular vectors in the U basis
    v_coeffs: np.ndarray  # [m, nsv] right singular vectors in the V basis
    u_basis: KrylovBasis
    v_basis: KrylovBasis
    residuals: np.ndarray
    n_matvec: int

    def left_vectors(self) -> list[Vector]:
        return _sub(self.u_basis, self.u_coeffs.shape[0]).lincomb_many(self.u_coeffs)

    def right_vectors(self) -> list[Vector]:
        return _sub(self.v_basis, self.v_coeffs.shape[0]).lincomb_many(self.v_coeffs)


def _sub(basis: KrylovBasis, m: int) -> KrylovBasis:
    """The first m vectors of `basis`, sharing its storage."""
    return KrylovBasis(basis.space, None, basis.kmax, _stack=basis.stack, _k=m)


def svds(
    op: LinearOperator,
    space: VectorSpace,
    nsv: int,
    kdim: int = 64,
    tol: float = 1e-6,
    v0: Vector | None = None,
    seed: int = 0,
) -> SvdsResult:
    """Leading nsv singular triplets of `op` via Lanczos bidiagonalization.

    Stops once the nsv leading triplets' residuals fall below tol times the
    largest singular value, or after kdim iterations. v0: start vector;
    otherwise `space.rand(seed)`."""
    if v0 is None:
        v0 = space.rand(seed)
    v, _ = space.normalize(v0)

    V = KrylovBasis(space, v, kdim + 1)
    V.append(v)
    U: KrylovBasis | None = None
    alphas = np.zeros(kdim)
    betas = np.zeros(kdim)  # betas[j]: coupling A^T u_j -> v_{j+1}
    n_mv = 0
    for j in range(kdim):
        u = op.matvec(V[j])
        n_mv += 1
        if U is None:
            U = KrylovBasis(space, u, kdim + 1)
        u, _ = U.orthogonalize(u, passes=2)
        u, a = space.normalize(u)
        if not np.isfinite(a):
            raise FloatingPointError(
                f"svds: non-finite alpha at iteration {j} — the operator returned NaN/Inf")
        alphas[j] = a
        U.append(u)

        w = op.rmatvec(U[j])
        n_mv += 1
        w, _ = V.orthogonalize(w, passes=2)
        w, b = space.normalize(w)
        if not np.isfinite(b):
            raise FloatingPointError(f"svds: non-finite beta at iteration {j} (see alpha)")
        betas[j] = b
        V.append(w)
        logger.info("svds iter %d: alpha=%.6e beta=%.6e (%d matvecs)", j, a, b, n_mv)

        if j + 1 >= max(nsv, 2):
            ub, s, _ = np.linalg.svd(_bidiag(alphas[: j + 1], betas[:j]))
            res = betas[j] * np.abs(ub[-1, :nsv])
            if np.all(res[: min(nsv, len(s))] < tol * max(s[0], 1e-30)):
                logger.info("svds converged at m=%d", j + 1)
                return _finalize(U, V, alphas[: j + 1], betas[: j + 1], nsv, n_mv)
    return _finalize(U, V, alphas, betas, nsv, n_mv)


def _bidiag(alphas: np.ndarray, betas: np.ndarray) -> np.ndarray:
    """Projected matrix U^T A V: upper bidiagonal.

    Recurrences: A v_j = beta_{j-1} u_{j-1} + alpha_j u_j  (exact),
                 A^T u_j = alpha_j v_j + beta_j v_{j+1},
    so B[j, j] = alpha_j and B[j-1, j] = beta_{j-1}.
    """
    B = np.diag(alphas)
    for j in range(len(betas)):
        B[j, j + 1] = betas[j]
    return B


def _finalize(U, V, alphas, betas, nsv, n_mv) -> SvdsResult:
    """alphas: len m; betas: len m (betas[m-1] is the residual coupling)."""
    m = len(alphas)
    ub, s, vbt = np.linalg.svd(_bidiag(alphas, betas[: m - 1]))
    nsv_eff = min(nsv, m)
    res = betas[m - 1] * np.abs(ub[-1, :nsv_eff])
    return SvdsResult(
        s=s[:nsv_eff],
        u_coeffs=ub[:, :nsv_eff],
        v_coeffs=vbt.T[:, :nsv_eff],
        u_basis=U,
        v_basis=V,
        residuals=res,
        n_matvec=n_mv,
    )
