"""Nonlinear fixed-point system for Newton-Krylov base-flow computation.

F(X) = Phi_tau(X) - X: integrate the nonlinear Navier-Stokes equations over
the horizon tau from X and subtract X. The Jacobian is [exp(tau J_X) - I]
through the linearized propagator about the frozen iterate X (the
reference's semantics), or with exact_jacobian=True the true Jacobian of
the discrete map, by forward mode through the nonlinear integration; each
has its exact discrete adjoint as rmatvec. Counterpart of
`neklab_tpu.systems.fixed_point`.

The reference jits `advance` and `propagate` and jit's cache keeps one
program per (dt, nsteps). Here the pieces that cost a build are kept
explicitly: one E preconditioner per system (it serves every dt), and per
(dt, nsteps) one set of solvers (one velocity, pressure and scalar solver
per BDF order, each with its CUDA graph on the card), which every response,
every Jacobian matvec and every backward at that (dt, nsteps) shares.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.autograd.forward_ad as fwAD

from ..krylov.linop import LinearOperator, NonlinearSystem
from ..krylov.space import tree_axpby
from ..mesh.core import SemMesh
from ..models import navier_stokes as ns
from ..models.linearized import (AdjointPropagator, LinConfig, b_adjoint, make_adjoint_propagator,
                                 propagate)
from ..models.precond import build_e_preconditioner
from ..utils.timestep import cfl_dt, horizon_steps


@dataclasses.dataclass
class Derived:
    """What one (dt, nsteps) of a system needs: the configuration at that dt
    and its solvers (`navier_stokes.bdf3_diags`, `pressure_solvers`,
    `velocity_solvers`)."""

    cfg: LinConfig
    nsteps: int
    vdiag: torch.Tensor
    tdiags: list | None
    psolves: dict
    vsolves: dict


class FixedPointSystem(NonlinearSystem):
    """F(X) = Phi_tau(X) - X over vectors {u, theta}."""

    def __init__(
        self,
        mesh: SemMesh,
        cfg: LinConfig,
        tau: float,
        ub=None,
        tb=None,
        cfl: float = 0.4,
        dt: float | None = None,
        exact_jacobian: bool = False,
        precondition: bool = True,
        recycle: int = 0,
    ):
        """ub, tb: the velocity and scalar Dirichlet values of the nonlinear
        integration. The step is tau / ceil(tau / dt), with dt from the CFL
        target against each iterate unless given. precondition: the E
        solves use the two-level preconditioner, built once here: E(dt) =
        (dt/g0) E(1) and CG is invariant to a scaling of the
        preconditioner, so one serves every dt.

        recycle: each post-ramp E solve is deflated against the last
        `recycle` solutions (Nek5000's residual projection) in the nonlinear
        map, the frozen Jacobian's matvec and the exact Jacobian's forward
        mode and backward through `advance` (the basis carries no gradient
        and no tangent); the frozen Jacobian's rmatvec, the adjoint of a
        recorded `propagate`, stays recycle-free."""
        self.mesh = mesh
        self.recycle = int(recycle)
        self.base_cfg = cfg
        self.tau = float(tau)
        self.ub = ub
        self.tb = tb
        self.cfl = cfl
        self._fixed_dt = dt
        self.exact_jacobian = exact_jacobian
        self.pc_e = build_e_preconditioner(mesh) if precondition else None
        self.derived: dict = {}

    def _derive(self, u) -> Derived:
        """The configuration and solvers at dt (from the CFL target against
        iterate u unless fixed), built at the first use of its (dt, nsteps)."""
        dt = self._fixed_dt if self._fixed_dt is not None else cfl_dt(self.mesh, u, cfl=self.cfl)
        dt, nsteps = horizon_steps(self.tau, dt)
        key = (round(dt, 14), nsteps)
        if key not in self.derived:
            cfg = dataclasses.replace(self.base_cfg,
                                      flow=dataclasses.replace(self.base_cfg.flow, dt=dt))
            fc = cfg.flow
            orders = ns.bdf_orders(fc, nsteps)
            vdiag, tdiags = ns.bdf3_diags(self.mesh, fc)
            self.derived[key] = Derived(
                cfg=cfg, nsteps=nsteps, vdiag=vdiag, tdiags=tdiags,
                psolves=ns.pressure_solvers(self.mesh, fc, orders, self.pc_e),
                vsolves=ns.velocity_solvers(self.mesh, fc, orders, vdiag, tdiags))
        return self.derived[key]

    def _advance(self, d: Derived, u, theta, stats=None):
        """Phi_tau(u, theta) at d's dt, with d's solvers."""
        fc = d.cfg.flow
        st = ns.initial_state(self.mesh, fc, u=u, theta=theta)
        out = ns.advance(self.mesh, fc, st, d.nsteps, ub=self.ub, tb=self.tb, pc_e=self.pc_e,
                         psolves=d.psolves, vsolves=d.vsolves, stats=stats, recycle=self.recycle)
        return out.u, out.theta

    def advance_map(self, x: dict, stats: dict | None = None) -> dict:
        """Phi_tau(x). stats: optional dict, filled as `advance` fills it."""
        u, theta = self._advance(self._derive(x["u"]), x["u"], x["theta"], stats=stats)
        return {"u": u, "theta": theta}

    def response(self, x: dict, stats: dict | None = None) -> dict:
        return tree_axpby(1.0, self.advance_map(x, stats=stats), -1.0, x)

    def jacobian(self, x: dict) -> LinearOperator:
        d = self._derive(x["u"])
        if self.exact_jacobian:
            return _ExactJacobian(self, x, d)
        return _FrozenJacobian(self.mesh, d, x, pc_e=self.pc_e, recycle=self.recycle)


class _FrozenJacobian(LinearOperator):
    """[exp(tau J_X) - I] dx about the frozen base flow X (the reference's
    semantics): `propagate` with the system's solvers at X's (dt, nsteps),
    recycling as the system does. rmatvec: the exact discrete adjoint of
    the recycle-free map, recorded at its first call."""

    def __init__(self, mesh: SemMesh, d: Derived, x: dict, pc_e=None, recycle: int = 0):
        self.mesh, self.d, self.x, self.pc_e, self.recycle = mesh, d, x, pc_e, recycle
        self._adj: AdjointPropagator | None = None

    def matvec(self, dx, stats: dict | None = None):
        """stats: optional dict, filled as `propagate` fills it."""
        d = self.d
        u, theta = propagate(self.mesh, d.cfg, self.x["u"], self.x["theta"], dx["u"], dx["theta"],
                             d.nsteps, pc_e=self.pc_e, vdiag=d.vdiag, tdiags=d.tdiags,
                             psolves=d.psolves, vsolves=d.vsolves, stats=stats,
                             recycle=self.recycle)
        return {"u": u - dx["u"], "theta": theta - dx["theta"]}

    def rmatvec(self, dx):
        d = self.d
        if self._adj is None:
            self._adj = make_adjoint_propagator(
                self.mesh, d.cfg, self.x["u"], self.x["theta"], d.nsteps, pc_e=self.pc_e,
                vdiag=d.vdiag, tdiags=d.tdiags, psolves=d.psolves, vsolves=d.vsolves)
        u, theta = self._adj(dx["u"], dx["theta"])
        return {"u": u - dx["u"], "theta": theta - dx["theta"]}


class _ExactJacobian(LinearOperator):
    """The true Jacobian of Phi_tau - I at X: matvec by forward mode through
    the nonlinear integration (`torch.autograd.forward_ad`; every linear
    piece, solves included, maps the tangent with itself), rmatvec the
    B-adjoint by a backward through it, recorded at its first call and
    replayed (`retain_graph`)."""

    def __init__(self, system: FixedPointSystem, x: dict, d: Derived):
        self.system, self.x, self.d = system, x, d
        self._tape = None

    def matvec(self, dx, stats: dict | None = None):
        """stats: optional dict, filled as `advance` fills it; each solve of
        the primal appends its CG's count, and so does each tangent's."""
        x = self.x
        with fwAD.dual_level():
            u = fwAD.make_dual(x["u"], dx["u"])
            theta = fwAD.make_dual(x["theta"], dx["theta"])
            out = self.system._advance(self.d, u, theta, stats=stats)
            du, dth = (fwAD.unpack_dual(o).tangent for o in out)
        du = torch.zeros_like(dx["u"]) if du is None else du
        dth = torch.zeros_like(dx["theta"]) if dth is None else dth
        return {"u": du - dx["u"], "theta": dth - dx["theta"]}

    def rmatvec(self, dx):
        if self._tape is None:
            inputs = tuple(self.x[k].detach().requires_grad_(True) for k in ("u", "theta"))
            with torch.enable_grad():
                self._tape = inputs, self.system._advance(self.d, *inputs)
        au, at = b_adjoint(self.system.mesh, *self._tape, dx["u"], dx["theta"])
        return {"u": au - dx["u"], "theta": at - dx["theta"]}
