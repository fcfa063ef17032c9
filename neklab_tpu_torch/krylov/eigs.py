"""Arnoldi eigensolver with Krylov-Schur restart and CGS2 reorthogonalization.

Python orchestration over dict-of-tensor vectors; the vector algebra runs on
the vectors' device (see space.KrylovBasis) and the small dense algebra
(Schur form, eigendecomposition of the projected matrix) on the host in
numpy/scipy. Counterpart of `neklab_tpu.krylov.eigs` (Arnoldi-factorization
checkpoints are not ported).
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Any, Callable

import numpy as np
import scipy.linalg

from .linop import AdjointOperator, LinearOperator
from .space import KrylovBasis, VectorSpace

logger = logging.getLogger("neklab_tpu_torch.krylov")

Vector = Any


@dataclasses.dataclass
class EigsResult:
    eigvals: np.ndarray  # complex [nev]
    residuals: np.ndarray  # [nev]
    basis: KrylovBasis  # orthonormal Krylov basis (m+1 filled slots)
    eigvec_coeffs: np.ndarray  # complex [m, nev]: eigvec_i = sum_j coeffs[j,i] V[j]
    n_matvec: int
    converged: np.ndarray  # bool [nev]

    def eigenvectors(self) -> list[Vector]:
        m = self.eigvec_coeffs.shape[0]
        sub = KrylovBasis(self.basis.space, None, self.basis.kmax, _stack=self.basis.stack, _k=m)
        return sub.lincomb_many(self.eigvec_coeffs)


def _expand_krylov(
    op: LinearOperator,
    space: VectorSpace,
    V: KrylovBasis,
    H: np.ndarray,
    j0: int,
    j1: int,
    breakdown_tol: float = 1e-12,
    conv_cb: Callable | None = None,
) -> tuple[int, int]:
    """Arnoldi expansion columns j0..j1-1 (V has j0+1 filled slots on entry).
    Returns (matvecs performed, columns now valid). conv_cb(m) may return
    True to stop early once the size-m projected problem has converged."""
    n_mv = 0
    for j in range(j0, j1):
        w = op.matvec(V[j])
        n_mv += 1
        w, h = V.orthogonalize(w, passes=2)
        w, beta = space.normalize(w)
        if not (np.all(np.isfinite(h)) and np.isfinite(beta)):
            raise FloatingPointError(
                f"eigs: non-finite Arnoldi coefficients at column {j} — the "
                "operator returned NaN/Inf")
        H[: j + 1, j] = h
        H[j + 1, j] = beta
        if beta < breakdown_tol:
            logger.info("Arnoldi breakdown at column %d (beta=%.3e)", j, beta)
            if space.rand_fn is None:
                V.append(w)
                return n_mv, j + 1
            w = space.rand(977 + j)
            w, _ = V.orthogonalize(w, passes=2)
            w, _ = space.normalize(w)
        V.append(w)
        if conv_cb is not None and j + 1 < j1 and conv_cb(j + 1):
            logger.info("eigs: early expansion stop at m=%d (< kdim=%d)", j + 1, j1)
            return n_mv, j + 1
    return n_mv, j1


def eigs(
    op: LinearOperator,
    space: VectorSpace,
    nev: int,
    kdim: int = 128,
    tol: float = 1e-6,
    maxiter: int = 20,
    adjoint: bool = False,
    v0: Vector | None = None,
    callback: Callable | None = None,
    seed: int = 0,
    check_every: int = 8,
) -> EigsResult:
    """Largest-modulus eigenpairs of `op` by Krylov-Schur-restarted Arnoldi.

    maxiter counts restart cycles of dimension kdim; `callback(cycle,
    result)` runs after each cycle. `tol` bounds the Ritz residual
    ||A x - mu x|| / ||x||, not the eigenvalue error (which is ~ the
    eigenvalue condition number times the residual for non-normal A).

    adjoint: eigenpairs of the adjoint, through `op.rmatvec`. v0: start
    vector; otherwise `space.rand(seed)`. check_every: test the projected
    problem every so many columns during expansion and stop the cycle once
    all nev wanted pairs converged (0 = only at kdim). Converged leading
    Schur blocks are locked at each restart."""
    if adjoint:
        op = AdjointOperator(op)
    if v0 is None:
        v0 = space.rand(seed)
    v0, nrm = space.normalize(v0)
    if nrm == 0:
        raise ValueError("zero start vector")

    n_mv = 0
    V = KrylovBasis(space, v0, kdim + 1)
    V.append(v0)
    H = np.zeros((kdim + 1, kdim))
    k_active = 0  # currently valid columns of H

    def spectrum(m, H):
        """Ritz values/vectors + residuals of the m-column factorization."""
        S = H[:m, :m]
        b = H[m, :m]
        evals, evecs = np.linalg.eig(S)
        res = np.abs(b @ evecs) / np.maximum(np.linalg.norm(evecs, axis=0), 1e-300)
        order = np.argsort(-np.abs(evals), kind="stable")
        return evals[order], res[order], evecs[:, order]

    for cycle in range(maxiter):
        conv_cb = None
        if check_every:
            def conv_cb(m, _H=H):
                if m % check_every or m <= max(nev, 2):
                    return False
                _, res_s, _ = spectrum(m, _H)
                return bool(np.all(res_s[:nev] < tol))

        mv, m = _expand_krylov(op, space, V, H, k_active, kdim, conv_cb=conv_cb)
        n_mv += mv
        evals_sorted, res_sorted, evecs_sorted = spectrum(m, H)
        conv = res_sorted[:nev] < tol
        result = EigsResult(
            eigvals=evals_sorted[:nev],
            residuals=res_sorted[:nev],
            basis=V,
            eigvec_coeffs=evecs_sorted[:, :nev],
            n_matvec=n_mv,
            converged=conv,
        )
        if callback is not None:
            callback(cycle, result)
        logger.info("eigs cycle %d: m=%d, %d/%d converged, worst residual %.3e",
                    cycle, m, int(conv.sum()), nev, float(res_sorted[:nev].max()))
        if conv.all() or cycle == maxiter - 1 or m - 2 < 1:
            # m - 2 < 1: a hard breakdown left an invariant subspace too
            # small to restart; its spectrum is the result
            return result

        # ---- Krylov-Schur restart (with locking of converged blocks) ----
        S = H[:m, :m]
        b = H[m, :m]
        p = min(max(2 * nev, nev + 8), m - 2)
        thresh = np.abs(evals_sorted)[p - 1]
        sel = lambda re, im: np.hypot(re, im) >= thresh * (1 - 1e-12)
        T, Q, sdim = scipy.linalg.schur(S, output="real", sort=sel)
        p_eff = int(sdim)
        if p_eff == 0 or p_eff >= m:
            p_eff = p

        res_vec = V[m]
        Vm = KrylovBasis(space, None, V.kmax, _stack=V.stack, _k=m)
        V = Vm.rotated(Q[:, :p_eff])
        V.append(res_vec)
        bnew = b @ Q[:, :p_eff]

        # lock the leading converged invariant block (cut only at 2x2-block
        # boundaries of the real Schur form): zeroing its couplings commits
        # an O(tol) perturbation and deflates those pairs exactly
        k_lock = 0
        for i in range(p_eff):
            if abs(bnew[i]) >= tol:
                break
            if i + 1 >= p_eff or abs(T[i + 1, i]) == 0.0:
                k_lock = i + 1
        if k_lock:
            bnew = bnew.copy()
            bnew[:k_lock] = 0.0
            logger.info("eigs: locked %d converged Schur columns", k_lock)

        H = np.zeros((kdim + 1, kdim))
        H[:p_eff, :p_eff] = T[:p_eff, :p_eff]
        H[p_eff, :p_eff] = bnew
        k_active = p_eff

    raise RuntimeError("unreachable")
