"""Analysis drivers: linear stability (direct and adjoint) and transient
growth of a fixed point.

Counterparts of `neklab_tpu.analysis.linear_stability_analysis_fixed_point`
and `transient_growth_analysis_fixed_point`, writing the same
`<dir|adj>_eigenspectrum.npy` and `singular_spectrum.dat` (the Newton and
OTD drivers, the timers and the eigenvector outposting are later ROADMAP
items).
"""

from __future__ import annotations

import dataclasses
import logging
import os
import time

import numpy as np

from .krylov.eigs import eigs
from .krylov.space import VectorSpace
from .krylov.svd import svds
from .linops.exponential_propagator import ExponentialPropagator

logger = logging.getLogger("neklab_tpu_torch.analysis")


@dataclasses.dataclass
class StabilityResult:
    eigvals: np.ndarray  # continuous-time: log(mu)/tau
    multipliers: np.ndarray  # discrete mu
    residuals: np.ndarray
    eigenvectors: list
    n_matvec: int
    elapsed: float


def _save_spectrum(outdir: str, prefix: str, mus: np.ndarray, tau: float) -> None:
    os.makedirs(outdir, exist_ok=True)
    lam = np.log(mus.astype(complex)) / tau
    np.save(os.path.join(outdir, f"{prefix}_eigenspectrum.npy"), np.stack([lam.real, lam.imag]))


def linear_stability_analysis_fixed_point(
    exptA: ExponentialPropagator,
    space: VectorSpace,
    kdim: int = 128,
    nev: int = 8,
    tol: float = 1e-6,
    adjoint: bool = False,
    maxiter: int = 30,
    outdir: str | None = None,
    seed: int = 1234,
    check_every: int = 8,
    v0: dict | None = None,
) -> StabilityResult:
    """Krylov-Schur eigensolve of exp(tau A), or with `adjoint` of its
    adjoint (through `rmatvec`); eigenvalues mapped back by lambda =
    log(mu)/tau. With `outdir`, writes dir_eigenspectrum.npy (or
    adj_eigenspectrum.npy; [2, nev]: real and imaginary parts) after every
    cycle."""
    t0 = time.time()
    prefix = "adj" if adjoint else "dir"

    def cb(cycle, result):
        if outdir:
            _save_spectrum(outdir, prefix, result.eigvals, exptA.tau)

    res = eigs(exptA, space, nev=nev, kdim=kdim, tol=tol, maxiter=maxiter, adjoint=adjoint,
               v0=v0, callback=cb, seed=seed, check_every=check_every)
    lam = np.log(res.eigvals.astype(complex)) / exptA.tau
    elapsed = time.time() - t0
    logger.info("%s stability: %d matvecs, %.1fs; leading lambda = %s",
                prefix, res.n_matvec, elapsed, lam[0])
    return StabilityResult(
        eigvals=lam,
        multipliers=res.eigvals,
        residuals=res.residuals,
        eigenvectors=res.eigenvectors(),
        n_matvec=res.n_matvec,
        elapsed=elapsed,
    )


@dataclasses.dataclass
class TransientGrowthResult:
    sigma: np.ndarray  # singular values of exp(tau A) = sqrt(max energy growth)
    optimal_inputs: list  # right singular vectors (optimal perturbations)
    optimal_outputs: list  # left singular vectors (responses)
    residuals: np.ndarray
    n_matvec: int
    elapsed: float


def transient_growth_analysis_fixed_point(
    exptA: ExponentialPropagator,
    space: VectorSpace,
    kdim: int = 64,
    nsv: int = 4,
    tol: float = 1e-6,
    outdir: str | None = None,
    seed: int = 1234,
) -> TransientGrowthResult:
    """Lanczos SVD of exp(tau A), from `space.rand(seed)`: optimal transient
    energy growth over tau. Each Lanczos iteration is one matvec and one
    rmatvec. With `outdir`, writes singular_spectrum.dat (one line per
    singular value: index, sigma, residual)."""
    t0 = time.time()
    res = svds(exptA, space, nsv=nsv, kdim=kdim, tol=tol, seed=seed)
    elapsed = time.time() - t0
    logger.info("transient growth: sigma = %s (%d matvecs, %.1fs)", res.s, res.n_matvec, elapsed)
    if outdir:
        os.makedirs(outdir, exist_ok=True)
        with open(os.path.join(outdir, "singular_spectrum.dat"), "w") as f:
            for i, (s, r) in enumerate(zip(res.s, res.residuals)):
                f.write(f"{i + 1} {s:.12e} {r:.3e}\n")
    return TransientGrowthResult(
        sigma=res.s,
        optimal_inputs=res.right_vectors(),
        optimal_outputs=res.left_vectors(),
        residuals=res.residuals,
        n_matvec=res.n_matvec,
        elapsed=elapsed,
    )
