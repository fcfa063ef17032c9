"""Inexact Newton-Krylov with pluggable tolerance schedulers.

Solves F(x) = 0 for a `NonlinearSystem` (response + Jacobian operator): the
Jacobian system of each iteration is solved by GMRES to an absolute
tolerance set by the scheduler, with optional bisection backtracking.
Counterpart of `neklab_tpu/krylov/newton.py` (LightKrylov `newton` and
neklab's `nek_constant_tol` / `nek_dynamic_tol`).
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Any, Callable

import numpy as np

from .gmres import gmres
from .linop import NonlinearSystem
from .space import VectorSpace, tree_axpby, tree_scale

logger = logging.getLogger("neklab_tpu_torch.krylov")

Vector = Any


def constant_tol(target: float) -> Callable[[float, int], float]:
    """nek_constant_tol: always the target tolerance."""
    return lambda rnorm, it: target


def dynamic_tol(target: float, cap: float = 1e-4,
                factor: float = 0.1) -> Callable[[float, int], float]:
    """nek_dynamic_tol: clamp(factor * ||r||, target, cap)."""
    return lambda rnorm, it: float(np.clip(factor * rnorm, target, cap))


@dataclasses.dataclass
class NewtonResult:
    x: Vector
    residual_norm: float
    converged: bool
    iterations: int
    history: list  # ||F|| at x0 and after every iteration
    matvecs: list  # Jacobian matvecs of every iteration's GMRES solve


def newton(
    system: NonlinearSystem,
    x0: Vector,
    space: VectorSpace,
    tol: float = 1e-6,
    maxiter: int = 40,
    scheduler: Callable[[float, int], float] | None = None,
    gmres_kdim: int = 64,
    gmres_max_restarts: int = 4,
    max_bisections: int = 0,
    callback: Callable | None = None,
) -> NewtonResult:
    """Newton iteration on F(x) = 0, until ||F|| < tol.

    scheduler(rnorm, iter) -> the ABSOLUTE residual tolerance of this
    iteration's inner GMRES solve (GMRES runs with rtol = 0 and atol =
    max(scheduler value, 0.1 tol)): the semantics of nek_dynamic_tol, whose
    clamp(0.1 ||r||, target, 1e-4) is the inexact-Newton forcing term
    eta = atol / ||r|| <= 0.1. Defaults to dynamic_tol(tol).
    max_bisections > 0 halves the step while ||F|| does not decrease
    (LightKrylov's ifbisect). callback(it, x, rnorm) runs after every
    iteration."""
    if scheduler is None:
        scheduler = dynamic_tol(tol)

    x = x0
    r = system.response(x)
    rnorm = space.norm(r)
    history, matvecs = [rnorm], []
    logger.info("newton it 0: |F| = %.6e", rnorm)

    for it in range(1, maxiter + 1):
        if rnorm < tol:
            return NewtonResult(x=x, residual_norm=rnorm, converged=True, iterations=it - 1,
                                history=history, matvecs=matvecs)
        inner_tol = scheduler(rnorm, it)
        sol = gmres(system.jacobian(x), tree_scale(-1.0, r), space, kdim=gmres_kdim, rtol=0.0,
                    atol=max(inner_tol, 0.1 * tol), max_restarts=gmres_max_restarts)
        if not sol.converged:
            logger.warning("newton it %d: inner GMRES stalled at %.3e", it, sol.residual)

        alpha = 1.0
        for bis in range(max_bisections + 1):
            x_new = tree_axpby(1.0, x, alpha, sol.x)
            r_new = system.response(x_new)
            rnorm_new = space.norm(r_new)
            if rnorm_new < rnorm or bis == max_bisections:
                break
            alpha *= 0.5
            logger.info("newton it %d: bisect step to alpha=%.3f", it, alpha)
        x, r, rnorm = x_new, r_new, rnorm_new
        history.append(rnorm)
        matvecs.append(sol.n_matvec)
        logger.info("newton it %d: |F| = %.6e (inner tol %.2e, %d matvecs)", it, rnorm,
                    inner_tol, sol.n_matvec)
        if callback is not None:
            callback(it, x, rnorm)

    return NewtonResult(x=x, residual_norm=rnorm, converged=rnorm < tol, iterations=maxiter,
                        history=history, matvecs=matvecs)
