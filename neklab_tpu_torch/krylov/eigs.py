"""Arnoldi eigensolver with Krylov-Schur restart and CGS2 reorthogonalization.

Python orchestration over dict-of-tensor vectors; the vector algebra runs on
the vectors' device (see space.KrylovBasis) and the small dense algebra
(Schur form, eigendecomposition of the projected matrix) on the host in
numpy/scipy. Counterpart of `neklab_tpu/krylov/eigs.py`, with its
Arnoldi-factorization checkpoint in the reference's npz layout.
"""

from __future__ import annotations

import dataclasses
import logging
import os
from typing import Any, Callable

import numpy as np
import scipy.linalg
import torch

from ..parallel.sharding import gather_field, shard_field
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
    save_cb: Callable | None = None,
    conv_cb: Callable | None = None,
) -> tuple[int, int]:
    """Arnoldi expansion columns j0..j1-1 (V has j0+1 filled slots on entry).
    Returns (matvecs performed, columns now valid). save_cb(kfilled, n_mv)
    runs after each completed column (the checkpoint's hook). conv_cb(m) may
    return True to stop early once the size-m projected problem has
    converged."""
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
        if save_cb is not None:
            save_cb(j + 1, n_mv)
        if conv_cb is not None and j + 1 < j1 and conv_cb(j + 1):
            logger.info("eigs: early expansion stop at m=%d (< kdim=%d)", j + 1, j1)
            return n_mv, j + 1
    return n_mv, j1


def save_stack(data: dict, prefix: str, stack: dict, part=None) -> None:
    """Host copies of a stacked basis's leaves as data[f"{prefix}{i}"], in the
    order JAX flattens a dict (sorted keys), so the reference reads them.
    part: the `Partition` of an element-partitioned run; the field leaves
    are then gathered whole on rank 0 (every rank must call this; the
    other ranks' data gets no field leaves)."""
    for i, name in enumerate(sorted(stack)):
        leaf = stack[name]
        if part is not None and leaf.dim() > 1:
            leaf = gather_field(leaf, part)
        if leaf is not None:
            data[f"{prefix}{i}"] = leaf.detach().cpu().numpy()


def load_stack(z, prefix: str, template: Vector, kmax: int, part=None) -> dict:
    """The stacked basis written by `save_stack` (or by the reference), on
    the template's device and in its dtypes; raises on a shape that is not
    [kmax, *leaf.shape] (the whole field's, with part: each rank then keeps
    its block of the file's field leaves)."""
    stack = {}
    for i, name in enumerate(sorted(template)):
        leaf = template[name]
        arr = z[f"{prefix}{i}"]
        shape = tuple(leaf.shape)
        split = part is not None and leaf.dim() > 0
        if split:
            shape = shape[:-1] + (shape[-1] * part.size,)
        want = (kmax,) + shape
        if arr.shape != want:
            raise ValueError(f"checkpoint leaf {i} shape {arr.shape} != expected {want} "
                             "(kdim or mesh changed?)")
        t = torch.as_tensor(arr, dtype=leaf.dtype)
        stack[name] = (shard_field(t, part) if split else t).to(leaf.device)
    return {name: stack[name] for name in template}


def check_fingerprint(path: str, z, fingerprint: str) -> None:
    if "fingerprint" in z and str(z["fingerprint"]) != fingerprint:
        raise ValueError(f"checkpoint {path} fingerprint {z['fingerprint']!s} != expected "
                         f"{fingerprint!r} (different solve: delete the stale file)")


def save_atomic(path: str, data: dict, part=None) -> None:
    """np.savez to a temporary name, then renamed over path: a reader sees
    the old file or the new one, never a partial one. Rank 0 alone writes
    in a partitioned run."""
    if part is not None and not part.is_root:
        return
    tmp = path + ".tmp.npz"
    np.savez(tmp, **data)
    os.replace(tmp, path)


def checkpoint_exists(path: str, part=None) -> bool:
    """Whether the checkpoint file exists, as rank 0 sees it (on every rank)."""
    found = os.path.exists(path)
    return found if part is None else part.from_root(found) > 0.5


def remove_checkpoint(path: str, part=None) -> None:
    """Deletes a finished solve's checkpoint (rank 0 alone)."""
    if (part is None or part.is_root) and os.path.exists(path):
        os.remove(path)


def _save_krylov_state(path: str, V: KrylovBasis, H: np.ndarray, n_mv: int,
                       fingerprint: str = "") -> None:
    """The running Arnoldi factorization, atomically: the reference's npz
    keys (leaf_<i>, H, vk, n_mv, fingerprint). H columns 0..V.k-2 are valid
    and V holds V.k slots. In a partitioned run the basis is gathered and
    rank 0 writes the one-process layout."""
    part = V.space.part
    data = {}
    save_stack(data, "leaf_", V.stack, part)
    data.update(H=H, vk=np.asarray(V.k), n_mv=np.asarray(n_mv),
                fingerprint=np.asarray(fingerprint))
    save_atomic(path, data, part)


def _load_krylov_state(path: str, space: VectorSpace, template: Vector, kmax: int,
                       fingerprint: str = ""):
    """-> (V, H, n_mv) resuming a `_save_krylov_state` file (the port's or
    the reference's)."""
    with np.load(path) as z:
        check_fingerprint(path, z, fingerprint)
        stack = load_stack(z, "leaf_", template, kmax, space.part)
        H = np.asarray(z["H"])
        vk, n_mv = int(z["vk"]), int(z["n_mv"])
    return KrylovBasis(space, None, kmax, _stack=stack, _k=vk), H, n_mv


def _sort_key(ev: np.ndarray, which: str) -> np.ndarray:
    """The order of the wanted eigenvalues, largest key first: "lm" the
    largest modulus, "lr" the largest real part."""
    return np.abs(ev) if which == "lm" else ev.real


def eigs(
    op: LinearOperator,
    space: VectorSpace,
    nev: int,
    kdim: int = 128,
    tol: float = 1e-6,
    maxiter: int = 20,
    which: str = "lm",
    adjoint: bool = False,
    v0: Vector | None = None,
    callback: Callable | None = None,
    seed: int = 0,
    checkpoint: str | None = None,
    checkpoint_every: int = 8,
    tag: str = "",
    check_every: int = 8,
) -> EigsResult:
    """The wanted eigenpairs of `op` by Krylov-Schur-restarted Arnoldi:
    `which` "lm" the largest modulus, "lr" the largest real part (the
    restart keeps the Schur vectors of those, and the result is ordered by
    them).

    maxiter counts restart cycles of dimension kdim; `callback(cycle,
    result)` runs after each cycle. `tol` bounds the Ritz residual
    ||A x - mu x|| / ||x||, not the eigenvalue error (which is ~ the
    eigenvalue condition number times the residual for non-normal A).

    adjoint: eigenpairs of the adjoint, through `op.rmatvec`. v0: start
    vector; otherwise `space.rand(seed)`. check_every: test the projected
    problem every so many columns during expansion and stop the cycle once
    all nev wanted pairs converged (0 = only at kdim). Converged leading
    Schur blocks are locked at each restart.

    checkpoint: path of the running factorization (basis, H, matvec
    count). If the file exists the solve resumes from it; while running it
    is re-saved atomically every `checkpoint_every` Arnoldi columns and at
    every restart, so a killed solve loses at most that many matvecs. The
    file records a fingerprint of the problem (kdim, nev, seed, `tag`),
    checked at resume, and is deleted on success only: a solve that ends
    unconverged keeps it, to resume with a larger maxiter. The layout and
    the fingerprint (`which` included) are the reference's, so either
    package resumes the other's file; a seed names a different start
    vector in each, which a resume does not use."""
    if which not in ("lm", "lr"):
        raise ValueError(f"eigs: which={which!r}, not 'lm' or 'lr'")
    if adjoint:
        op = AdjointOperator(op)
    if v0 is None:
        v0 = space.rand(seed)
    v0, nrm = space.normalize(v0)
    if nrm == 0:
        raise ValueError("zero start vector")

    fp = f"eigs;kdim={kdim};nev={nev};which={which};seed={seed};tag={tag}"
    n_mv = 0
    if checkpoint is not None and checkpoint_exists(checkpoint, space.part):
        V, H, n_mv = _load_krylov_state(checkpoint, space, v0, kdim + 1, fingerprint=fp)
        k_active = V.k - 1
        logger.info("eigs: resumed from %s (%d columns, %d matvecs so far)", checkpoint,
                    k_active, n_mv)
    else:
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
        order = np.argsort(-_sort_key(evals, which), kind="stable")
        return evals[order], res[order], evecs[:, order]

    for cycle in range(maxiter):
        save_cb = None
        if checkpoint is not None and checkpoint_every:
            # this cycle's (V, H, n_mv): V is rebound at restarts
            def save_cb(kfilled, mv, _V=V, _H=H, _mv=n_mv):
                if kfilled % checkpoint_every == 0:
                    _save_krylov_state(checkpoint, _V, _H, _mv + mv, fingerprint=fp)

        conv_cb = None
        if check_every:
            def conv_cb(m, _H=H):
                if m % check_every or m <= max(nev, 2):
                    return False
                _, res_s, _ = spectrum(m, _H)
                return bool(np.all(res_s[:nev] < tol))

        mv, m = _expand_krylov(op, space, V, H, k_active, kdim, save_cb=save_cb,
                               conv_cb=conv_cb)
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
            if checkpoint is not None:
                if conv.all():
                    remove_checkpoint(checkpoint, space.part)
                else:
                    _save_krylov_state(checkpoint, V, H, n_mv, fingerprint=fp)
                    logger.info("eigs: unconverged at maxiter=%d; checkpoint kept at %s",
                                maxiter, checkpoint)
            return result

        # ---- Krylov-Schur restart (with locking of converged blocks) ----
        S = H[:m, :m]
        b = H[m, :m]
        p = min(max(2 * nev, nev + 8), m - 2)
        thresh = _sort_key(evals_sorted, which)[p - 1]
        if which == "lm":
            sel = lambda re, im: np.hypot(re, im) >= thresh * (1 - 1e-12)
        else:
            sel = lambda re, im: re >= thresh - 1e-12
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
        if checkpoint is not None:
            _save_krylov_state(checkpoint, V, H, n_mv, fingerprint=fp)

    raise RuntimeError("unreachable")
