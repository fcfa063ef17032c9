"""Analysis drivers: linear stability (direct and adjoint) and transient
growth of a fixed point, and the Newton-Krylov computation of the fixed
point itself.

Counterparts of `neklab_tpu/analysis.py::linear_stability_analysis_fixed_point`,
`transient_growth_analysis_fixed_point` and `newton_fixed_point_iteration`,
writing the same `<dir|adj>_eigenspectrum.npy`, `singular_spectrum.dat`,
`residual.dat`, eigenvector field files (`<dir|adj>mode0.f<NNNNN>.npz`) and
`timers.log`. Every driver runs inside a named timer and every (r)matvec of
the propagator inside `exptA/matvec` or `exptA/rmatvec`; at its exit the
driver writes the timers' report (the reference's LightKrylov timer
report). The OTD driver is `otd.otd_analysis`.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import time

from typing import Any

import numpy as np

from .krylov.eigs import eigs
from .krylov.linop import LinearOperator
from .krylov.newton import constant_tol, dynamic_tol, newton
from .krylov.space import VectorSpace
from .krylov.svd import svds
from .linops.exponential_propagator import ExponentialPropagator
from .utils.fldfile import _host
from .utils.io import outpost
from .utils.timers import timer

logger = logging.getLogger("neklab_tpu_torch.analysis")


class _TimedOp(LinearOperator):
    """An operator whose every matvec and rmatvec lands in the timers, under
    `<name>/matvec` and `<name>/rmatvec`."""

    def __init__(self, op, name: str):
        self._op = op
        self._name = name

    def matvec(self, x):
        with timer(f"{self._name}/matvec"):
            return self._op.matvec(x)

    def rmatvec(self, x):
        with timer(f"{self._name}/rmatvec"):
            return self._op.rmatvec(x)


def _finalize_timers(outdir: str | None, part=None) -> None:
    """The driver's exit report, printed and (with outdir) written to
    timers.log; by rank 0 alone in a partitioned run (`part`)."""
    if part is not None and not part.is_root:
        return
    report = timer.report()
    if outdir:
        os.makedirs(outdir, exist_ok=True)
        with open(os.path.join(outdir, "timers.log"), "w") as f:
            f.write(report + "\n")


def _outpost_modes(outdir: str, prefix: str, eigenvectors: list, part=None) -> None:
    """One field file per eigenvector, `<prefix>mode0.f<i>.npz`, a complex
    leaf split into `<name>_re` and `<name>_im`. In a partitioned run
    (`part`) every rank gives its blocks, and rank 0 writes the gathered
    fields (`outpost`)."""
    for i, v in enumerate(eigenvectors):
        fields = {}
        for name, leaf in v.items():
            arr = _host(leaf)
            if np.iscomplexobj(arr):
                fields[name + "_re"], fields[name + "_im"] = arr.real, arr.imag
            else:
                fields[name] = arr
        outpost(outdir, fields, prefix=prefix, case="mode", counter=i + 1, part=part)


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
    checkpoint: str | None = None,
    checkpoint_every: int = 8,
    check_every: int = 8,
    v0: dict | None = None,
) -> StabilityResult:
    """Krylov-Schur eigensolve of exp(tau A), or with `adjoint` of its
    adjoint (through `rmatvec`); eigenvalues mapped back by lambda =
    log(mu)/tau. With `outdir`, writes dir_eigenspectrum.npy (or
    adj_eigenspectrum.npy; [2, nev]: real and imaginary parts) after every
    cycle, and at the end the eigenvectors as field files
    (`dirmode0.f00001.npz`, ...; complex leaves split into `_re`/`_im`)
    and timers.log. checkpoint, checkpoint_every: the Arnoldi
    kill-and-resume file (`krylov.eigs`).

    Element-partitioned (a space of a rank's block, `space.part`): every
    rank returns the same eigenvalues and its blocks of the eigenvectors;
    rank 0 alone writes the files, in the one-process layout."""
    t0 = time.time()
    prefix = "adj" if adjoint else "dir"
    part = space.part
    writes = outdir and (part is None or part.is_root)

    def cb(cycle, result):
        if writes:
            _save_spectrum(outdir, prefix, result.eigvals, exptA.tau)

    with timer(f"{prefix}_stability"):
        res = eigs(_TimedOp(exptA, "exptA"), space, nev=nev, kdim=kdim, tol=tol,
                   maxiter=maxiter, which="lm", adjoint=adjoint, v0=v0, callback=cb, seed=seed,
                   checkpoint=checkpoint, checkpoint_every=checkpoint_every,
                   check_every=check_every)
    lam = np.log(res.eigvals.astype(complex)) / exptA.tau
    elapsed = time.time() - t0
    _finalize_timers(outdir, part)
    logger.info("%s stability: %d matvecs, %.1fs; leading lambda = %s",
                prefix, res.n_matvec, elapsed, lam[0])
    eigenvectors = res.eigenvectors()
    if outdir:
        if writes:
            _save_spectrum(outdir, prefix, res.eigvals, exptA.tau)
        _outpost_modes(outdir, prefix, eigenvectors, part)
    return StabilityResult(
        eigvals=lam,
        multipliers=res.eigvals,
        residuals=res.residuals,
        eigenvectors=eigenvectors,
        n_matvec=res.n_matvec,
        elapsed=elapsed,
    )


@dataclasses.dataclass
class NewtonFPResult:
    x: Any
    residual_norm: float
    converged: bool
    iterations: int
    history: list  # ||F|| at the start and after every iteration
    matvecs: list  # Jacobian matvecs of every iteration's GMRES solve
    elapsed: float


def newton_fixed_point_iteration(
    system,
    x0,
    space: VectorSpace,
    tol: float = 1e-6,
    maxiter: int = 40,
    scheduler: str = "dynamic",
    gmres_kdim: int = 64,
    outdir: str | None = None,
    callback=None,
) -> NewtonFPResult:
    """Newton-Krylov base-flow computation: `krylov.newton` on `system`
    (e.g. `systems.fixed_point.FixedPointSystem`) with the scheduler
    nek_dynamic_tol ("dynamic") or nek_constant_tol. With `outdir`, writes
    residual.dat: one line per entry of the history, `i |F|`, and
    timers.log.

    Element-partitioned (`space.part`): every rank returns the same history
    and its block of the solution; rank 0 alone writes the files."""
    t0 = time.time()
    part = space.part
    sched = dynamic_tol(tol) if scheduler == "dynamic" else constant_tol(tol)
    with timer("newton_fixed_point"):
        res = newton(system, x0, space, tol=tol, maxiter=maxiter, scheduler=sched,
                     gmres_kdim=gmres_kdim, callback=callback)
    elapsed = time.time() - t0
    _finalize_timers(outdir, part)
    logger.info("newton: converged=%s |F|=%.3e in %d its (%.1fs)", res.converged,
                res.residual_norm, res.iterations, elapsed)
    if outdir and (part is None or part.is_root):
        os.makedirs(outdir, exist_ok=True)
        with open(os.path.join(outdir, "residual.dat"), "w") as f:
            for i, r in enumerate(res.history):
                f.write(f"{i} {r:.12e}\n")
    return NewtonFPResult(x=res.x, residual_norm=res.residual_norm, converged=res.converged,
                          iterations=res.iterations, history=res.history, matvecs=res.matvecs,
                          elapsed=elapsed)


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
    checkpoint: str | None = None,
    checkpoint_every: int = 4,
) -> TransientGrowthResult:
    """Lanczos SVD of exp(tau A), from `space.rand(seed)`: optimal transient
    energy growth over tau. Each Lanczos iteration is one matvec and one
    rmatvec. With `outdir`, writes singular_spectrum.dat (one line per
    singular value: index, sigma, residual) and timers.log. checkpoint,
    checkpoint_every: the Lanczos kill-and-resume file (`krylov.svds`).

    Element-partitioned (`space.part`): every rank returns the same singular
    values and its blocks of the optimal inputs and outputs; rank 0 alone
    writes the files."""
    t0 = time.time()
    part = space.part
    with timer("transient_growth"):
        res = svds(_TimedOp(exptA, "exptA"), space, nsv=nsv, kdim=kdim, tol=tol, seed=seed,
                   checkpoint=checkpoint, checkpoint_every=checkpoint_every)
    elapsed = time.time() - t0
    _finalize_timers(outdir, part)
    logger.info("transient growth: sigma = %s (%d matvecs, %.1fs)", res.s, res.n_matvec, elapsed)
    if outdir and (part is None or part.is_root):
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
