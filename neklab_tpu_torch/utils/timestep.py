"""CFL-driven time-step selection with the exact-horizon contract.

Reference parity: `setup_nek`'s dt/nsteps re-derivation
(the reference neklab source, src/neklab_nek_setup.f90:159-224): given a horizon tau and a
CFL target against the current base flow, pick dt = tau / nsteps with
nsteps = ceil(tau / dt_cfl) so that fintim = nsteps * dt hits tau EXACTLY
(SURVEY hard part 5).
"""

from __future__ import annotations

import logging
import math

import numpy as np
import torch

from ..mesh.core import SemMesh

logger = logging.getLogger("neklab_tpu_torch.timestep")


def _host(a) -> np.ndarray:
    """numpy view of a tensor on any device (or of an array-like)."""
    return a.detach().cpu().numpy() if hasattr(a, "detach") else np.asarray(a)


def clamp_cfl(cfl: float, limit: float = 0.5) -> float:
    """Clamp-and-warn on the target CFL — the reference's input-validation
    style (neklab_nek_setup.f90:147-153: invalid/over-limit targets are
    forced to 0.5 with a logged warning, not an abort)."""
    if cfl <= 0.0 or cfl > limit:
        logger.warning("invalid target CFL %.4f; forcing it to %.2f", cfl, limit)
        return limit
    return cfl


def min_grid_spacing(mesh: SemMesh) -> np.ndarray:
    """Per-node characteristic spacing: min distance to the neighboring GLL
    node along each reference direction (host-side, numpy).

    x layout: [ndim, pts..., nel] (element-last)."""
    x = _host(mesh.x)
    ndim = mesh.ndim
    d2 = None
    for ax in range(ndim):
        a = x.ndim - 2 - ax  # array axis (in x) for reference direction ax (r first)
        diff = np.diff(x, axis=a)
        dist = np.sqrt((diff**2).sum(axis=0))  # component axis dropped
        ad = a - 1  # the same axis within dist
        lo = np.concatenate([dist.take([0], axis=ad), dist], axis=ad)
        hi = np.concatenate([dist, dist.take([-1], axis=ad)], axis=ad)
        sp = np.minimum(lo, hi)
        d2 = sp if d2 is None else np.minimum(d2, sp)
    return d2


def cfl_dt(mesh: SemMesh, u, cfl: float = 0.5, umin: float = 1e-12) -> float:
    """Largest dt meeting the CFL target for velocity field u [ndim, ...]."""
    sp = min_grid_spacing(mesh)
    speed = np.sqrt((_host(u) ** 2).sum(axis=0))
    ratio = float((sp / np.maximum(speed, umin)).min())
    if mesh.part is not None:  # the least over every rank's block
        ratio = float(mesh.part.all_reduce(torch.tensor([ratio], dtype=torch.float64,
                                                        device=mesh.part.device),
                                           op="min"))
    return float(cfl * ratio)


def horizon_steps(tau: float, dt_max: float) -> tuple[float, int]:
    """(dt, nsteps) with nsteps*dt == tau exactly and dt <= dt_max."""
    nsteps = max(1, math.ceil(tau / dt_max - 1e-12))
    return tau / nsteps, nsteps
