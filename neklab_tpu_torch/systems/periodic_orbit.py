"""Unsteady periodic-orbit (UPO) system: unknowns (X, T).

F(X, T) = (Phi_T(X) - X, 0) with the phase condition entering through the
bordered Jacobian:

  J (dx, dT) = ( (dPhi_T/dX) dx - dx + (dPhi/dT) dT,  <dx, f(X)>_B )

Counterpart of `neklab_tpu/systems/periodic_orbit.py`. Phi_T is `advance` over
a fixed number of steps at dt = T / nsteps, so T moves the step. The
reference takes (dPhi/dX) dx and dPhi/dT from one `jax.jvp` through the
nonlinear integration with dt traced. Here dPhi/dT is forward mode through
`advance` (`torch.autograd.forward_ad`), once per Jacobian, with a dt that
carries the tangent 1/nsteps into every step (its solves carry their
operators' tangents, `models/navier_stokes.py`); (dPhi/dX) dx, once per
matvec, is the linearized stepper about the orbit recorded once per
Jacobian, with the explicit terms' derivative about each recorded state
(the linearized convection and the tangents of the FlowConfig's
forcing_fn and source_fn), which is that derivative to the solvers'
tolerance without forward mode's primal pass and dual ops. matvec =
(dPhi/dX) dx - dx + dT dPhi/dT is exact by linearity. rmatvec is the
B-adjoint by a backward through `advance`, recorded once per Jacobian; T's
cotangent is dropped, as in the reference.

Every CG is a `PCG` built per (dt, order), so the system keeps one solver
set per (T, nsteps), the T of each Newton iterate, and one E
preconditioner for every T. The phase-condition direction f(X) is the
reference's compute_fdot finite difference: one step at dt = T / nsteps.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.autograd.forward_ad as fwAD

from ..krylov.linop import LinearOperator, NonlinearSystem
from ..mesh.core import SemMesh
from ..models import navier_stokes as ns
from ..models.linearized import (LinConfig, _explicit_lin_map, b_adjoint, pert_initial,
                                 step_lin)
from ..models.precond import build_e_preconditioner
from ..ops import sem
from ..parallel.sharding import global_sum
from ..utils.timestep import cfl_dt, horizon_steps
from .fixed_point import Derived


class PeriodicOrbitSystem(NonlinearSystem):
    """F(X, T) over vectors {u, theta, T} (`vectors.ext_flow_vector`)."""

    def __init__(
        self,
        mesh: SemMesh,
        cfg: LinConfig,
        t_guess: float,
        ub=None,
        tb=None,
        cfl: float = 0.4,
        nsteps: int | None = None,
        precondition: bool = True,
    ):
        """nsteps: the fixed step count; from the CFL target with a unit
        velocity at the period guess when None. precondition: the E solves
        use the two-level preconditioner, built once here for every T."""
        self.mesh = mesh
        self.cfg = cfg
        self.ub = ub
        self.tb = tb
        self.pc_e = build_e_preconditioner(mesh) if precondition else None
        if nsteps is None:
            unit = torch.ones((mesh.ndim,) + tuple(mesh.bm1.shape), dtype=mesh.dtype)
            _, nsteps = horizon_steps(t_guess, cfl_dt(mesh, unit, cfl=cfl))
        self.nsteps = nsteps
        self.derived: dict = {}

    def _derive(self, T) -> Derived:
        """The configuration and solvers at dt = T / nsteps, built at the
        first use of that T."""
        dt = float(T) / self.nsteps
        key = round(dt, 14)
        if key not in self.derived:
            base = self.cfg
            cfg = dataclasses.replace(base, flow=dataclasses.replace(base.flow, dt=dt))
            fc = cfg.flow
            orders = ns.bdf_orders(fc, self.nsteps)
            vdiag, tdiags = ns.bdf3_diags(self.mesh, fc)
            self.derived[key] = Derived(
                cfg=cfg, nsteps=self.nsteps, vdiag=vdiag, tdiags=tdiags,
                psolves=ns.pressure_solvers(self.mesh, fc, orders, self.pc_e),
                vsolves=ns.velocity_solvers(self.mesh, fc, orders, vdiag, tdiags))
        return self.derived[key]

    def _advance(self, u, theta, T, nsteps=None, stats=None):
        """Phi over nsteps (default the system's) steps at dt = T / self.nsteps
        from (u, theta); T may carry a forward-mode tangent."""
        d = self._derive(T)
        fc = d.cfg.flow
        st = ns.initial_state(self.mesh, fc, u=u, theta=theta)
        out = ns.advance(self.mesh, fc, st, self.nsteps if nsteps is None else nsteps,
                         ub=self.ub, tb=self.tb, dt=T / self.nsteps, psolves=d.psolves,
                         vsolves=d.vsolves, stats=stats)
        return out.u, out.theta

    def advance_map(self, x: dict, stats: dict | None = None) -> dict:
        u, theta = self._advance(x["u"], x["theta"], x["T"], stats=stats)
        return {"u": u, "theta": theta, "T": x["T"]}

    def response(self, x: dict, stats: dict | None = None) -> dict:
        u, theta = self._advance(x["u"], x["theta"], x["T"], stats=stats)
        return {"u": u - x["u"], "theta": theta - x["theta"], "T": torch.zeros_like(x["T"])}

    def fdot(self, x: dict) -> dict:
        """compute_fdot: f(X) ~ (Phi_dt(X) - X) / dt, one step at dt = T / nsteps."""
        u, theta = self._advance(x["u"], x["theta"], x["T"], nsteps=1)
        dt = x["T"] / self.nsteps
        return {"u": (u - x["u"]) / dt, "theta": (theta - x["theta"]) / dt}

    def jacobian(self, x: dict) -> LinearOperator:
        return _UPOJacobian(self, x)


def _mass_dot(mesh: SemMesh, a: dict, b: dict) -> torch.Tensor:
    """<a, b>_B over u and theta, summed over every rank's block of a
    partitioned mesh (one all-reduce)."""
    return global_sum(mesh.part, torch.sum(a["u"] * b["u"] * mesh.bm1)
                      + torch.sum(a["theta"] * b["theta"] * mesh.bm1))


def _step_tangent_map(mesh: SemMesh, cfg: LinConfig, conv_cache, t, u, theta):
    """The derivative about (u, theta) at time t of the nonlinear step's
    explicit terms (`navier_stokes._explicit_terms`), (du, dth) ->
    (n_u, n_t) in local weak form: the linearized convection (`conv_cache`)
    plus the tangents of the FlowConfig's forcing_fn and source_fn, by
    forward mode through those callables alone (`torch.func.jvp`). The
    LinConfig's lin_forcing_fn and lin_source_fn do not enter: the map
    being differentiated is the nonlinear step, as in the reference's
    `jax.jvp` through `advance`."""
    fc = cfg.flow
    conv = _explicit_lin_map(
        mesh, dataclasses.replace(cfg, lin_forcing_fn=None, lin_source_fn=None), conv_cache,
        tuple(theta.shape))
    hooks = [(fn, k) for fn, k in ((fc.forcing_fn, 0), (fc.source_fn if fc.nscal else None, 1))
             if fn is not None]
    if not hooks:
        return conv

    def emap(du, dth):
        terms = list(conv(du, dth))
        for fn, k in hooks:
            _, tangent = torch.func.jvp(lambda a, b: fn(mesh, t, a, b), (u, theta), (du, dth))
            terms[k] = terms[k] + mesh.bm1 * tangent
        return tuple(terms)

    return emap


class _Tangent:
    """The derivatives of Phi about (X, T): its linearization in X, applied by
    linearized steps about the recorded orbit; dPhi/dT by forward mode; the
    B-adjoint by a recorded backward."""

    def __init__(self, system: PeriodicOrbitSystem, x: dict):
        self.s, self.x = system, x
        self._orbit = None
        self._tape = None

    def orbit(self) -> list:
        """[(u, theta, time, BDF order, linearization cache)] of the state
        before every step of Phi from X, recorded at the first call."""
        if self._orbit is None:
            s, x = self.s, self.x
            d = s._derive(x["T"])
            fc = d.cfg.flow
            trajectory: list = []
            ns.advance(s.mesh, fc, ns.initial_state(s.mesh, fc, u=x["u"], theta=x["theta"]),
                       s.nsteps, ub=s.ub, tb=s.tb, psolves=d.psolves, vsolves=d.vsolves,
                       trajectory=trajectory)
            base_theta = lambda st: st.theta if fc.nscal else None
            self._orbit = [(st.u, st.theta, st.time, order,
                            sem.lin_convect_cache(s.mesh, st.u, base_theta(st)))
                           for st, order in trajectory]
        return self._orbit

    def apply(self, du, dth, stats=None):
        """(dPhi/dX)(du, dth): the linearized step (`step_lin`, the system's
        solvers) about the orbit's state at every step, with the derivative
        of that step's explicit terms (`_step_tangent_map`). It is the
        derivative of `advance`'s steps to the solvers' tolerance (the warm
        starts only shift the solves). The reference takes it by `jax.jvp`
        through the whole integration, which here would carry the primal
        along in every matvec, with every elementwise op twice or more
        (PERF.md)."""
        s = self.s
        d = s._derive(self.x["T"])
        pert = pert_initial(s.mesh, d.cfg, du, dth)
        for u, theta, t, order, cache in self.orbit():
            vsolve, tsolves = d.vsolves[order]
            pert = step_lin(s.mesh, d.cfg, pert, u, theta, order, d.psolves[order], vsolve,
                            tsolves, stats=stats,
                            emap=_step_tangent_map(s.mesh, d.cfg, cache, t, u, theta))
        return pert.u, pert.theta

    def period_jvp(self, stats=None):
        """dPhi/dT, by forward mode through `advance` with the tangent 1 on
        T alone: dt = T / nsteps carries 1/nsteps into every step."""
        x = self.x
        with fwAD.dual_level():
            T = fwAD.make_dual(x["T"], torch.ones_like(x["T"]))
            out = self.s._advance(x["u"], x["theta"], T, stats=stats)
            tangents = [fwAD.unpack_dual(o).tangent for o in out]
        return [torch.zeros_like(o) if t is None else t for o, t in zip(out, tangents)]

    def vjp_b(self, v: dict):
        """The B-adjoint of (dPhi/dX) applied to v: a backward through Phi,
        recorded at the first call and replayed."""
        if self._tape is None:
            inputs = tuple(self.x[k].detach().requires_grad_(True) for k in ("u", "theta"))
            with torch.enable_grad():
                self._tape = inputs, self.s._advance(*inputs, self.x["T"].detach())
        return b_adjoint(self.s.mesh, *self._tape, v["u"], v["theta"])


class _UPOJacobian(LinearOperator):
    def __init__(self, system: PeriodicOrbitSystem, x: dict):
        self.s = system
        self.x = x
        self._phi = _Tangent(system, x)
        self._c = None  # phase direction f(X(0))
        self._b = None  # dPhi/dT at the end point

    def phase_dir(self) -> dict:
        if self._c is None:
            self._c = self.s.fdot(self.x)
        return self._c

    def period_dir(self, stats: dict | None = None) -> dict:
        """dPhi/dT, by forward mode with the tangent 1 on T alone, once per
        Jacobian. stats: optional dict, filled by that pass as `advance`
        fills it."""
        if self._b is None:
            bu, bt = self._phi.period_jvp(stats=stats)
            self._b = {"u": bu, "theta": bt}
        return self._b

    def matvec(self, dx: dict, stats: dict | None = None) -> dict:
        """stats: optional dict, filled by the linearized steps as
        `step_lin` fills it."""
        du, dth = self._phi.apply(dx["u"], dx["theta"], stats=stats)
        b = self.period_dir()
        c = self.phase_dir()
        return {"u": du - dx["u"] + dx["T"] * b["u"],
                "theta": dth - dx["theta"] + dx["T"] * b["theta"],
                "T": _mass_dot(self.s.mesh, dx, c)}

    def rmatvec(self, v: dict) -> dict:
        au, at = self._phi.vjp_b(v)
        c = self.phase_dir()
        b = self.period_dir()
        return {"u": au - v["u"] + v["T"] * c["u"],
                "theta": at - v["theta"] + v["T"] * c["theta"],
                "T": _mass_dot(self.s.mesh, b, v)}


class MonodromyOperator(LinearOperator):
    """Floquet monodromy M = dPhi_T/dX about a converged orbit (X, T): the
    discrete linearization about the co-evolving orbit, recorded at the
    first matvec (`_Tangent.apply`). Feed it to `eigs` for the Floquet
    multipliers. rmatvec: its B-adjoint, recorded at the first call."""

    def __init__(self, system: PeriodicOrbitSystem, x: dict):
        self.s = system
        self.x = x
        self._phi = _Tangent(system, x)

    def matvec(self, dx: dict, stats: dict | None = None) -> dict:
        """stats: optional dict, filled by the linearized steps as
        `step_lin` fills it."""
        du, dth = self._phi.apply(dx["u"], dx["theta"], stats=stats)
        return {"u": du, "theta": dth}

    def rmatvec(self, v: dict) -> dict:
        au, at = self._phi.vjp_b(v)
        return {"u": au, "theta": at}
