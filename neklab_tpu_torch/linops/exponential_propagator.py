"""The exponential propagator M = exp(tau A): the eigensolve's matvec.

matvec integrates the linearized Navier-Stokes equations over the horizon
tau (nsteps * dt == tau exactly) about a frozen base flow. Eigenvalues of A
are recovered as log(mu)/tau from Ritz values mu of M. Counterpart of
`neklab_tpu.linops.exponential_propagator` (direct map; the chunked path
only bounded the TPU compiler's program size and has no counterpart here).
"""

from __future__ import annotations

import dataclasses

import torch

from ..krylov.linop import LinearOperator
from ..mesh.core import SemMesh
from ..models.linearized import LinConfig, pressure_solvers, propagate, velocity_solvers
from ..models.navier_stokes import _BDF, helmholtz_diag
from ..models.precond import build_e_preconditioner
from ..utils.timestep import cfl_dt, clamp_cfl, horizon_steps


class ExponentialPropagator(LinearOperator):
    """M = exp(tau A) via time integration of the linearized equations."""

    def __init__(
        self,
        mesh: SemMesh,
        cfg: LinConfig,
        base_u,
        base_theta=None,
        tau: float = 1.0,
        cfl: float = 0.5,
    ):
        """The step is tau / ceil(tau / dt_cfl), dt_cfl from the CFL target
        against the base flow, so nsteps * dt == tau exactly. The pressure
        solves use the two-level E preconditioner and the exact
        neighbor-block E apply. Every solver of the matvec, pressure,
        velocity and scalar, one per BDF order (on the card each with its
        captured CG graph), is built here once for every matvec."""
        self.mesh = mesh
        self.base_u = base_u
        self.base_theta = (
            base_theta
            if base_theta is not None
            else torch.zeros((cfg.nscal,) + tuple(mesh.bm1.shape), dtype=mesh.dtype,
                             device=mesh.device)
        )
        self.tau = float(tau)
        self.dt, self.nsteps = horizon_steps(tau, cfl_dt(mesh, base_u, cfl=clamp_cfl(cfl)))
        self.cfg = dataclasses.replace(cfg, flow=dataclasses.replace(cfg.flow, dt=self.dt))
        self.pc_e = build_e_preconditioner(mesh)
        fc = self.cfg.flow
        g0 = _BDF[min(fc.torder, 3)][0]
        self.vdiag = helmholtz_diag(mesh, fc.viscosity, fc.rho * g0 / fc.dt, mesh.vmask)
        self.tdiags = [
            helmholtz_diag(mesh, fc.conductivity[i], g0 / fc.dt, mesh.tmask)
            for i in range(fc.nscal)
        ] or None
        self.psolves = pressure_solvers(mesh, self.cfg, self.nsteps, self.pc_e)
        self.vsolves = velocity_solvers(mesh, self.cfg, self.nsteps, self.vdiag, self.tdiags)

    def matvec(self, x: dict, stats: dict | None = None) -> dict:
        """stats: optional dict, filled as `propagate` fills it."""
        u, theta = propagate(
            self.mesh, self.cfg, self.base_u, self.base_theta, x["u"], x["theta"], self.nsteps,
            pc_e=self.pc_e, vdiag=self.vdiag, tdiags=self.tdiags, psolves=self.psolves,
            vsolves=self.vsolves, stats=stats,
        )
        return {"u": u, "theta": theta}

    def rmatvec(self, x: dict) -> dict:
        raise NotImplementedError(
            "ExponentialPropagator.rmatvec: the exact discrete adjoint is a later "
            "ROADMAP item (port queue: adjoint, svd.py and transient growth)")
