"""Lanczos bidiagonalization SVD over dict-of-tensor vectors (transient growth).

Golub-Kahan-Lanczos with full CGS2 reorthogonalization of both bases (stacked
buffers, batched Gram products), dense SVD of the projected bidiagonal
matrix on the host. Each iteration costs one matvec and one rmatvec.
Counterpart of `neklab_tpu/krylov/svd.py`, with its Lanczos checkpoint in the
reference's npz layout.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Any

import numpy as np

from .eigs import (check_fingerprint, checkpoint_exists, load_stack, remove_checkpoint,
                   save_atomic, save_stack)
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


def _save_lanczos_state(path, U, V, alphas, betas, j, n_mv, fingerprint=""):
    """Both bases and the couplings, atomically, under the reference's npz
    keys (u_<i>, v_<i>, alphas, betas, j, n_mv, uk, vk, fingerprint), in
    the one-process layout in a partitioned run (rank 0 writes)."""
    part = U.space.part
    data = {}
    save_stack(data, "u_", U.stack, part)
    save_stack(data, "v_", V.stack, part)
    data.update(alphas=alphas, betas=betas, j=np.asarray(j), n_mv=np.asarray(n_mv),
                uk=np.asarray(U.k), vk=np.asarray(V.k), fingerprint=np.asarray(fingerprint))
    save_atomic(path, data, part)


def _load_lanczos_state(path, space, template, kdim, fingerprint=""):
    """-> (U, V, alphas, betas, j, n_mv) from a `_save_lanczos_state` file
    (the port's or the reference's)."""
    with np.load(path) as z:
        check_fingerprint(path, z, fingerprint)
        U = KrylovBasis(space, None, kdim + 1, _stack=load_stack(z, "u_", template, kdim + 1,
                                                                space.part),
                        _k=int(z["uk"]))
        V = KrylovBasis(space, None, kdim + 1, _stack=load_stack(z, "v_", template, kdim + 1,
                                                                space.part),
                        _k=int(z["vk"]))
        return U, V, np.asarray(z["alphas"]), np.asarray(z["betas"]), int(z["j"]), int(z["n_mv"])


def svds(
    op: LinearOperator,
    space: VectorSpace,
    nsv: int,
    kdim: int = 64,
    tol: float = 1e-6,
    v0: Vector | None = None,
    seed: int = 0,
    checkpoint: str | None = None,
    checkpoint_every: int = 4,
    tag: str = "",
) -> SvdsResult:
    """Leading nsv singular triplets of `op` via Lanczos bidiagonalization.

    Stops once the nsv leading triplets' residuals fall below tol times the
    largest singular value, or after kdim iterations. v0: start vector;
    otherwise `space.rand(seed)`.

    checkpoint: path of the kill-and-resume state (both bases and the
    couplings), saved atomically every `checkpoint_every` iterations,
    resumed when the file exists, deleted on convergence only. Its
    fingerprint (kdim, nsv, seed, `tag`) is checked at resume. Layout and
    fingerprint are the reference's, as in `eigs`."""
    if v0 is None:
        v0 = space.rand(seed)
    v, _ = space.normalize(v0)

    fp = f"svds;kdim={kdim};nsv={nsv};seed={seed};tag={tag}"
    V = KrylovBasis(space, v, kdim + 1)
    V.append(v)
    U: KrylovBasis | None = None
    alphas = np.zeros(kdim)
    betas = np.zeros(kdim)  # betas[j]: coupling A^T u_j -> v_{j+1}
    n_mv = 0
    j0 = 0
    if checkpoint is not None and checkpoint_exists(checkpoint, space.part):
        U, V, alphas_l, betas_l, j0, n_mv = _load_lanczos_state(checkpoint, space, v, kdim,
                                                                fingerprint=fp)
        m = min(len(alphas_l), kdim)
        alphas[:m], betas[:m] = alphas_l[:m], betas_l[:m]
        logger.info("svds: resumed from %s (j=%d, %d matvecs)", checkpoint, j0, n_mv)

    def done(result):
        if checkpoint is not None:
            remove_checkpoint(checkpoint, space.part)
        return result

    for j in range(j0, kdim):
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
        if checkpoint is not None and checkpoint_every and (j + 1) % checkpoint_every == 0:
            _save_lanczos_state(checkpoint, U, V, alphas, betas, j + 1, n_mv, fingerprint=fp)

        if j + 1 >= max(nsv, 2):
            ub, s, _ = np.linalg.svd(_bidiag(alphas[: j + 1], betas[:j]))
            res = betas[j] * np.abs(ub[-1, :nsv])
            if np.all(res[: min(nsv, len(s))] < tol * max(s[0], 1e-30)):
                logger.info("svds converged at m=%d", j + 1)
                return done(_finalize(U, V, alphas[: j + 1], betas[: j + 1], nsv, n_mv))
    # kdim spent short of tol: the checkpoint stays, to resume or inspect
    if checkpoint is not None and U is not None:
        _save_lanczos_state(checkpoint, U, V, alphas, betas, kdim, n_mv, fingerprint=fp)
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
