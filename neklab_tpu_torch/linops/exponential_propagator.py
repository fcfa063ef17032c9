"""The exponential propagator M = exp(tau A): the eigensolve's matvec.

matvec integrates the linearized Navier-Stokes equations over the horizon
tau (nsteps * dt == tau exactly) about a frozen base flow; rmatvec is the
EXACT discrete adjoint (see models/linearized.py). Eigenvalues of A are
recovered as log(mu)/tau from Ritz values mu of M. Counterpart of
`neklab_tpu/linops/exponential_propagator.py` (the chunked path only bounded
the TPU compiler's program size and has no counterpart here).
"""

from __future__ import annotations

import dataclasses

import torch

from ..krylov.linop import LinearOperator
from ..mesh.core import SemMesh
from ..models import navier_stokes as ns
from ..models.linearized import AdjointPropagator, LinConfig, make_adjoint_propagator, propagate
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
        dt: float | None = None,
        precondition: bool = True,
        adjoint_tol_factor: float = 0.1,
        recycle: int = 0,
    ):
        """The step is tau / ceil(tau / dt), with dt from the CFL target
        against the base flow unless given, so nsteps * dt == tau exactly.
        The pressure solves use the two-level E preconditioner
        (`build_e_preconditioner(mesh)`) and, where it carries them, E's
        exact neighbour blocks; with `precondition=False` the pressure CG is
        unpreconditioned and applies the matrix-free E. Every solver of the
        matvec, pressure, velocity and scalar, one per BDF order (on the
        card each with its captured CG graph), is built here once for every
        matvec.

        adjoint_tol_factor: the adjoint is the transpose of a forward
        program whose vtol and ptol are scaled by this factor (default 10x
        tighter): adjoint Ritz values are more sensitive to the inner solves'
        truncation than direct ones (the reference's round-4 cylinder
        study). 1.0 gives the exact transpose of the matvec's own program.
        The adjoint, with its own solvers, is built at the first rmatvec.

        recycle: if > 0, matvec deflates each post-ramp pressure solve
        against the last `recycle` solutions (Nek5000's residual
        projection, param(93-95)): the same map to the solvers' tolerance,
        with fewer E iterations. rmatvec is the adjoint of the recycle-free
        program (the basis update is not linear in the data)."""
        self.mesh = mesh
        self.base_u = base_u
        self.base_theta = (
            base_theta
            if base_theta is not None
            else torch.zeros((cfg.nscal,) + tuple(mesh.bm1.shape), dtype=mesh.dtype,
                             device=mesh.device)
        )
        self.tau = float(tau)
        if dt is None:
            dt = cfl_dt(mesh, base_u, cfl=clamp_cfl(cfl))
        self.dt, self.nsteps = horizon_steps(tau, dt)
        self.cfg = dataclasses.replace(cfg, flow=dataclasses.replace(cfg.flow, dt=self.dt))
        self.pc_e = build_e_preconditioner(mesh) if precondition else None
        fc = self.cfg.flow
        self.vdiag, self.tdiags = ns.bdf3_diags(mesh, fc)
        orders = ns.bdf_orders(fc, self.nsteps)
        self.psolves = ns.pressure_solvers(mesh, fc, orders, self.pc_e)
        self.vsolves = ns.velocity_solvers(mesh, fc, orders, self.vdiag, self.tdiags)
        f = float(adjoint_tol_factor)
        self.cfg_adj = self.cfg if f == 1.0 else dataclasses.replace(
            self.cfg, flow=dataclasses.replace(fc, vtol=fc.vtol * f, ptol=fc.ptol * f))
        self._adjoint: AdjointPropagator | None = None
        self.recycle = int(recycle)

    def matvec(self, x: dict, stats: dict | None = None) -> dict:
        """stats: optional dict, filled as `propagate` fills it."""
        u, theta = propagate(
            self.mesh, self.cfg, self.base_u, self.base_theta, x["u"], x["theta"], self.nsteps,
            pc_e=self.pc_e, vdiag=self.vdiag, tdiags=self.tdiags, psolves=self.psolves,
            vsolves=self.vsolves, stats=stats, recycle=self.recycle,
        )
        return {"u": u, "theta": theta}

    @property
    def adjoint(self) -> AdjointPropagator:
        """The exact discrete B-adjoint at `cfg_adj`'s tolerances, built (its
        solvers and its recorded tape) at first use."""
        if self._adjoint is None:
            self._adjoint = make_adjoint_propagator(
                self.mesh, self.cfg_adj, self.base_u, self.base_theta, self.nsteps,
                pc_e=self.pc_e, vdiag=self.vdiag, tdiags=self.tdiags)
        return self._adjoint

    def rmatvec(self, x: dict, stats: dict | None = None) -> dict:
        """stats: optional dict, filled by the adjoint's transposed solves
        (`AdjointPropagator.__call__`)."""
        u, theta = self.adjoint(x["u"], x["theta"], stats=stats)
        return {"u": u, "theta": theta}
