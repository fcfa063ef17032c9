"""Linearized Navier-Stokes stepper about a frozen base flow.

Perturbation evolution about (U, Theta) with the same BDFk/EXTk fractional
step as the nonlinear solver and the convection linearized,

    N(u') = -(v, U . grad u') - (v, u' . grad U)  (+ linear coupling forces),

homogeneous Dirichlet BCs (the perturbation masks). `propagate` is the
exponential-propagator matvec: a BDF1/BDF2 self-starting ramp, then BDF3
steps in a Python loop. Counterpart of `neklab_tpu.models.linearized`
(the chunked and forced forms are later ROADMAP items).

Adjoint: the EXACT discrete adjoint with respect to the mass-weighted inner
product <u, v> = sum(u v bm1),

    M* v = vmask . Bhat^-1 dssum( M^T (bm1 . v) ),

as in the reference, which takes M^T from `jax.linear_transpose` of the
jitted forward. Torch has no linear transpose; `make_adjoint_propagator`
records `propagate` once on autograd's tape and runs the tape backward per
call. Every solve on the tape is a `solvers.linear_solve`, whose backward
re-solves with the same built-once CG, and dssum, the Helmholtz kernel and
the E apply are their own backward (`tensor.linear`).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from ..mesh.core import SemMesh
from ..ops import sem
from . import stokes
from .navier_stokes import (_BDF, _EXT, FlowConfig, helmholtz_diag, make_helmholtz_solver,
                            make_pressure_solver)


@dataclasses.dataclass(frozen=True)
class LinConfig:
    """Linearized-solver configuration. lin_forcing_fn(mesh, u, theta) and
    lin_source_fn(mesh, u, theta) must be LINEAR in (u, theta) — e.g.
    Boussinesq buoyancy g*beta*theta'."""

    flow: FlowConfig
    lin_forcing_fn: Callable | None = None
    lin_source_fn: Callable | None = None

    @property
    def nscal(self):
        return self.flow.nscal


@dataclasses.dataclass
class PertState:
    u: torch.Tensor  # [ndim, pts..., nel]
    p: torch.Tensor  # [pts2..., nel]
    theta: torch.Tensor  # [nscal, pts..., nel]
    ulag: torch.Tensor  # [torder-1, ndim, ...] velocity history
    nlag: torch.Tensor  # [torder-1, ndim, ...] explicit-term history
    tlag: torch.Tensor  # [torder-1, nscal, ...]
    ntlag: torch.Tensor  # [torder-1, nscal, ...]
    plag: torch.Tensor  # [1, pts2..., nel]


def pert_initial(mesh: SemMesh, cfg: LinConfig, u, theta=None) -> PertState:
    shape = tuple(mesh.bm1.shape)
    nd, ns, no = mesh.ndim, cfg.nscal, cfg.flow.torder - 1
    z = lambda s: torch.zeros(s, dtype=mesh.dtype, device=mesh.device)
    if theta is None:
        theta = z((ns,) + shape)
    return PertState(
        u=u,
        p=z(tuple(mesh.bm2.shape)),
        theta=theta,
        ulag=z((no, nd) + shape),
        nlag=z((no, nd) + shape),
        tlag=z((no, ns) + shape),
        ntlag=z((no, ns) + shape),
        plag=z((1,) + tuple(mesh.bm2.shape)),
    )


def _explicit_lin_map(mesh, cfg: LinConfig, conv_cache, theta_shape):
    """The explicit linearized operator (u, theta) -> (n_u, n_t) in local
    weak form (convection + linear coupling forces, before dssum)."""

    def emap(u, theta):
        cu, ct = sem.convect_lin_weak(mesh, u, theta if cfg.nscal else None, conv_cache)
        n_u = -cu
        if cfg.lin_forcing_fn is not None:
            n_u = n_u + mesh.bm1 * cfg.lin_forcing_fn(mesh, u, theta)
        if cfg.nscal:
            n_t = -ct
            if cfg.lin_source_fn is not None:
                n_t = n_t + mesh.bm1 * cfg.lin_source_fn(mesh, u, theta)
        else:
            n_t = torch.zeros(theta_shape, dtype=u.dtype, device=u.device)
        return n_u, n_t

    return emap


def _lin_terms(mesh, cfg: LinConfig, u, theta, base_u, base_theta, conv_cache=None):
    """Weak linearized explicit terms about (base_u, base_theta)."""
    if conv_cache is None:
        conv_cache = sem.lin_convect_cache(mesh, base_u, base_theta)
    return _explicit_lin_map(mesh, cfg, conv_cache, tuple(theta.shape))(u, theta)


def step_lin(
    mesh: SemMesh,
    cfg: LinConfig,
    state: PertState,
    base_u,
    base_theta,
    order: int,
    psolve,
    vsolve,
    tsolves,
    conv_cache=None,
    stats=None,
) -> PertState:
    """One linearized BDF(order)/EXT(order) step (homogeneous BCs).

    psolve, vsolve, tsolves: this order's pressure, velocity and scalar
    solvers (`pressure_solvers`, `velocity_solvers`).
    stats: optional dict; the velocity and pressure CG iteration counts are
    appended to stats["helmholtz"] and stats["pressure"]."""
    fc = cfg.flow
    dt = fc.dt
    g0, betas = _BDF[order]
    alphas = _EXT[order]

    n_u, n_t = _lin_terms(mesh, cfg, state.u, state.theta, base_u, base_theta,
                          conv_cache=conv_cache)

    pstar = state.p  # incremental pressure
    nstar = alphas[0] * n_u + alphas[1] * state.nlag[0] + alphas[2] * state.nlag[1]
    bsum = betas[0] * state.u + betas[1] * state.ulag[0] + betas[2] * state.ulag[1]
    # the perturbation meets each mesh field in a product of its own: a
    # product of constants made per step would be kept by autograd's tape
    rhs = mesh.bm1 * bsum * (fc.rho / dt) + nstar + stokes.grad_weak_t(mesh, pstar)

    ustar = vsolve(rhs, torch.zeros_like(state.u), stats=stats)

    dt_over_g0 = dt / (g0 * fc.rho)
    # warm start: the previous step's increment
    dp = psolve(-stokes.div_weak(mesh, ustar), x0=state.p - state.plag[0], stats=stats)
    du = stokes.pressure_correct_velocity(mesh, dp, dt_over_g0)
    u_new = ustar + du
    p_new = pstar + dp

    if cfg.nscal:
        ntstar = alphas[0] * n_t + alphas[1] * state.ntlag[0] + alphas[2] * state.ntlag[1]
        tbsum = betas[0] * state.theta + betas[1] * state.tlag[0] + betas[2] * state.tlag[1]
        comps = []
        for i in range(cfg.nscal):
            rhs_t = mesh.bm1 * tbsum[i] * (1.0 / dt) + ntstar[i]
            comps.append(tsolves[i](rhs_t, torch.zeros_like(state.theta[i])))
        theta_new = torch.stack(comps)
    else:
        theta_new = state.theta

    shift = lambda lag, cur: torch.cat([cur[None], lag[:-1]], dim=0)
    return PertState(
        u=u_new,
        p=p_new,
        theta=theta_new,
        ulag=shift(state.ulag, state.u),
        nlag=shift(state.nlag, n_u),
        tlag=shift(state.tlag, state.theta),
        ntlag=shift(state.ntlag, n_t),
        plag=state.p[None],
    )


def pressure_solvers(mesh: SemMesh, cfg: LinConfig, nsteps: int, pc_e=None) -> dict:
    """{order: pressure solver} for the BDF orders `propagate` steps with
    (the self-starting ramp, then the scheme's order)."""
    fc = cfg.flow
    tmax = min(fc.torder, 3)
    return {
        order: make_pressure_solver(mesh, fc, fc.dt / (_BDF[order][0] * fc.rho), pc=pc_e)
        for order in range(1, min(nsteps, tmax) + 1)
    }


def _helmholtz_solvers(mesh: SemMesh, fc: FlowConfig, order: int, vdiag, tdiags):
    """(velocity solver, [scalar solvers]) of one BDF order."""
    g0 = _BDF[order][0]
    vsolve = make_helmholtz_solver(mesh, fc.viscosity, fc.rho * g0 / fc.dt, mesh.vmask, vdiag,
                                   fc.vtol, fc.vmaxit)
    tsolves = [make_helmholtz_solver(mesh, fc.conductivity[i], g0 / fc.dt, mesh.tmask, tdiags[i],
                                     fc.ttol, fc.vmaxit)
               for i in range(fc.nscal)]
    return vsolve, tsolves


def velocity_solvers(mesh: SemMesh, cfg: LinConfig, nsteps: int, vdiag, tdiags) -> dict:
    """{order: (velocity solver, [scalar solvers])} for the BDF orders
    `propagate` steps with. h2 = rho g0 / dt changes with the order in the
    ramp, so each order has its own solvers; vdiag and tdiags (the BDF3
    Jacobi diagonals; tdiags may be None without scalars) serve every order,
    as in the reference."""
    fc = cfg.flow
    tmax = min(fc.torder, 3)
    return {order: _helmholtz_solvers(mesh, fc, order, vdiag, tdiags)
            for order in range(1, min(nsteps, tmax) + 1)}


def _bdf3_diags(mesh: SemMesh, fc: FlowConfig, vdiag, tdiags):
    """(vdiag, tdiags): the BDF3 Jacobi diagonals, each built when None."""
    g0 = _BDF[min(fc.torder, 3)][0]
    if vdiag is None:
        vdiag = helmholtz_diag(mesh, fc.viscosity, fc.rho * g0 / fc.dt, mesh.vmask)
    if tdiags is None:
        tdiags = [helmholtz_diag(mesh, fc.conductivity[i], g0 / fc.dt, mesh.tmask)
                  for i in range(fc.nscal)] or None
    return vdiag, tdiags


def propagate(mesh: SemMesh, cfg: LinConfig, base_u, base_theta, u0, theta0, nsteps: int,
              pc_e=None, vdiag=None, tdiags=None, psolves=None, vsolves=None, stats=None):
    """Linear map M: (u0, theta0) -> (u, theta) after nsteps of the
    linearized solver, with a BDF1/2/3 self-starting ramp and zero initial
    pressure — the exponential-propagator matvec exp(tau A), tau = nsteps*dt.

    vdiag/tdiags: the BDF3 Jacobi diagonals; psolves and vsolves: the
    pressure solvers (`pressure_solvers`) and the velocity and scalar
    solvers (`velocity_solvers`). A caller that applies the map repeatedly
    builds them once (the diagonals serve the ramp steps too); they are
    built here when None. stats: as in `step_lin`, one entry per step."""
    fc = cfg.flow
    state = pert_initial(mesh, cfg, u0, theta0)
    tmax = min(fc.torder, 3)
    vdiag3, tdiags3 = _bdf3_diags(mesh, fc, vdiag, tdiags)
    ccache = sem.lin_convect_cache(mesh, base_u, base_theta if fc.nscal else None)
    if psolves is None:
        psolves = pressure_solvers(mesh, cfg, nsteps, pc_e)
    if vsolves is None:
        vsolves = velocity_solvers(mesh, cfg, nsteps, vdiag3, tdiags3)

    for k in range(nsteps):
        order = min(k + 1, tmax)
        vsolve, tsolves = vsolves[order]
        state = step_lin(mesh, cfg, state, base_u, base_theta, order, psolves[order], vsolve,
                         tsolves, conv_cache=ccache, stats=stats)
    return state.u, state.theta


class AdjointPropagator:
    """The exact discrete B-adjoint of `propagate`, (v_u, v_theta) ->
    (w_u, w_theta) with w = vmask Bhat^-1 dssum( M^T (B v) ); built by
    `make_adjoint_propagator`.

    M^T is the backward of one recorded `propagate`: M is linear, so one
    tape serves every call (`retain_graph`), the counterpart of tracing and
    jitting the reference's transpose once. tape_bytes: device memory the
    tape holds (None on the CPU)."""

    def __init__(self, mesh: SemMesh, inputs, outputs, log: dict, tape_bytes):
        self.mesh = mesh
        self._inputs, self._outputs, self._log = inputs, outputs, log
        self.tape_bytes = tape_bytes

    def __call__(self, v_u, v_theta, stats: dict | None = None):
        """stats: optional dict; every transposed solve appends its CG's
        iteration count, under the forward solver's key ("helmholtz",
        "pressure"), in the order the backward runs them (last step first)."""
        mesh = self.mesh
        # scale normalization (exact by linearity; the reference's
        # make_adjoint_propagator): the seed bm1 * v is orders of magnitude
        # smaller than v, and the transposed solves stop at the forward's
        # ABSOLUTE tolerances, so the seed is rescaled to v's Euclidean size
        # and the result scaled back
        nv = torch.sqrt(torch.sum(v_u * v_u) + torch.sum(v_theta * v_theta))
        iu, it = mesh.bm1 * v_u, mesh.bm1 * v_theta
        ni = torch.sqrt(torch.sum(iu * iu) + torch.sum(it * it))
        c = torch.where(ni > 0, nv / torch.clamp_min(ni, torch.finfo(ni.dtype).tiny), 1.0)
        self._log.clear()
        grads = torch.autograd.grad(self._outputs, self._inputs, grad_outputs=(c * iu, c * it),
                                    retain_graph=True, allow_unused=True)
        if stats is not None:
            for key, counts in self._log.items():
                stats.setdefault(key, []).extend(counts)
        wu, wt = (torch.zeros_like(x) if g is None else g for g, x in zip(grads, self._inputs))
        au = mesh.vmask * mesh.binv * sem.dssum(mesh, wu) / c
        at = mesh.tmask * mesh.binv * sem.dssum(mesh, wt) / c
        return au, at


def make_adjoint_propagator(mesh: SemMesh, cfg: LinConfig, base_u, base_theta, nsteps: int,
                            pc_e=None, vdiag=None, tdiags=None) -> AdjointPropagator:
    """The exact discrete B-adjoint of `propagate` at cfg's tolerances.

    Builds its own solvers (one per BDF order, each with its CUDA graph on
    the card) and records `propagate` once, from a zero input that requires
    grad: every CG then exits at iteration 0, so recording runs no CG
    iteration, only the step's other ops."""
    fc = cfg.flow
    vdiag, tdiags = _bdf3_diags(mesh, fc, vdiag, tdiags)
    psolves = pressure_solvers(mesh, cfg, nsteps, pc_e)
    vsolves = velocity_solvers(mesh, cfg, nsteps, vdiag, tdiags)
    shape = tuple(mesh.bm1.shape)
    inputs = tuple(torch.zeros((lead,) + shape, dtype=mesh.dtype, device=mesh.device,
                               requires_grad=True) for lead in (mesh.ndim, cfg.nscal))
    on_card = mesh.device.type == "cuda"
    if on_card:
        torch.cuda.synchronize(mesh.device)
        before = torch.cuda.memory_allocated(mesh.device)
    log: dict = {}
    with torch.enable_grad():
        outputs = propagate(mesh, cfg, base_u, base_theta, *inputs, nsteps, pc_e=pc_e,
                            vdiag=vdiag, tdiags=tdiags, psolves=psolves, vsolves=vsolves,
                            stats=log)
    tape_bytes = torch.cuda.memory_allocated(mesh.device) - before if on_card else None
    return AdjointPropagator(mesh, inputs, outputs, log, tape_bytes)
