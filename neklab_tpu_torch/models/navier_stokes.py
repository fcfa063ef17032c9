"""Incompressible Navier-Stokes time stepper: BDFk/EXTk fractional step.

One step:

  1. explicit terms: dealiased convection extrapolated to t^{n+1} (EXTk),
     body forcing (a user hook), BDFk mass history;
  2. implicit Helmholtz solve for the velocity components (and each
     scalar): (g0/dt) B u + nu A u = rhs with u = ub on Dirichlet DOFs;
  3. pressure correction: solve E dp = -(q, div u*), update u and p
     (P(N)/P(N-2), no pressure BCs; see models/stokes.py).

Counterpart of `neklab_tpu/models/navier_stokes.py`. The reference jits
`advance` into one program per (mesh, nsteps) and lets jit's cache keep its
solves; here every CG is a `PCG` built once per (dt, BDF order) and, on the
card, captured as a CUDA graph when it is built. So `advance` takes its
solvers prebuilt (`pressure_solvers`, `velocity_solvers`), as the
linearized `propagate` does, and builds them only when the caller passes
none. The state's `time` is a host float (a 0-d tensor when dt carries a
forward-mode tangent, see `advance`). Unlike the reference, the
velocity and scalar solves start from the extrapolated fields (see
`step`). `advance(recycle=k)` deflates each pressure solve after the BDF
ramp against the last k solutions (Nek5000's residual projection,
`init_projection_basis`).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch

from ..mesh.core import SemMesh
from ..ops import sem
from ..ops.tensor import is_dual, linear, tangent_part
from ..parallel.sharding import global_sum
from ..utils.timestep import cfl_dt, clamp_cfl
from . import stokes
from .solvers import PCG, SolveLog, linear_solve, local_diagonal


@dataclasses.dataclass(frozen=True)
class FlowConfig:
    """Solver configuration (the `.par` GENERAL/VELOCITY/PRESSURE/TEMPERATURE
    tiers): viscosity, time step and order, scalars, density, and the
    absolute CG tolerances and iteration caps of the implicit solves.

    pextrap: the pressure treatment, 1 = incremental (p* = p^n, the
    previous increment warm-starts the E solve), 2 = extrapolated (p* = 2
    p^n - p^{n-1}, one more power of dt in the splitting error).
    forcing_fn(mesh, t, u, theta) -> [ndim, pts..., nel] strong body force;
    source_fn(mesh, t, u, theta) -> [nscal, pts..., nel] scalar sources."""

    viscosity: float
    dt: float
    torder: int = 3
    nscal: int = 0
    conductivity: tuple = ()
    rho: float = 1.0
    vtol: float = 1e-10
    ptol: float = 1e-9
    ttol: float = 1e-10
    vmaxit: int = 500
    pmaxit: int = 800
    pextrap: int = 1
    forcing_fn: Callable | None = None
    source_fn: Callable | None = None

    def __post_init__(self):
        if self.nscal and len(self.conductivity) != self.nscal:
            raise ValueError("conductivity must have nscal entries")


@dataclasses.dataclass
class FlowState:
    u: torch.Tensor  # [ndim, pts..., nel]
    p: torch.Tensor  # [pts2..., nel]
    theta: torch.Tensor  # [nscal, pts..., nel]
    ulag: torch.Tensor  # [torder-1, ndim, ...] velocity history
    nlag: torch.Tensor  # [torder-1, ndim, ...] advection-term history
    tlag: torch.Tensor  # [torder-1, nscal, ...]
    ntlag: torch.Tensor  # [torder-1, nscal, ...]
    plag: torch.Tensor  # [1, pts2..., nel] previous pressure
    time: float  # a 0-d tensor when dt carries a forward-mode tangent


def initial_state(mesh: SemMesh, cfg: FlowConfig, u=None, theta=None, p=None) -> FlowState:
    shape = tuple(mesh.bm1.shape)
    nd, ns, no = mesh.ndim, cfg.nscal, cfg.torder - 1
    z = lambda s: torch.zeros(s, dtype=mesh.dtype, device=mesh.device)
    if u is None:
        u = z((nd,) + shape)
    if theta is None:
        theta = z((ns,) + shape)
    if p is None:
        p = z(tuple(mesh.bm2.shape))
    return FlowState(u=u, p=p, theta=theta, ulag=z((no, nd) + shape), nlag=z((no, nd) + shape),
                     tlag=z((no, ns) + shape), ntlag=z((no, ns) + shape), plag=p[None], time=0.0)


# BDFk / EXTk coefficients (gamma0, beta_j for u^{n-j}, alpha_j for N^{n-j})
_BDF = {
    1: (1.0, (1.0, 0.0, 0.0)),
    2: (1.5, (2.0, -0.5, 0.0)),
    3: (11.0 / 6.0, (3.0, -1.5, 1.0 / 3.0)),
}
_EXT = {
    1: (1.0, 0.0, 0.0),
    2: (2.0, -1.0, 0.0),
    3: (3.0, -3.0, 1.0),
}


def _logger(stats: dict | None, key: str):
    """A solve's `SolveLog` to stats under key; None without stats."""
    return None if stats is None else SolveLog(stats, key)


def helmholtz_diag(mesh: SemMesh, h1, h2, mask) -> torch.Tensor:
    """Jacobi diagonal of the masked assembled Helmholtz operator, as a
    consistent local-copies field (1 on Dirichlet DOFs)."""
    op_local = lambda u: sem.helmholtz_local(mesh, u, h1, h2)
    dloc = local_diagonal(op_local, mesh.bm1.shape, mesh.dtype, mesh.ndim, device=mesh.device)
    d = sem.dssum(mesh, dloc)
    return mask * d + (1.0 - mask)


def make_helmholtz_solver(mesh: SemMesh, h1, h2, mask, diag, tol, maxiter, key="helmholtz"):
    """Returns u = solve(rhs_weak, bc_val, stats=None, x0=None), which solves
    (h1 A + h2 B) u = rhs with u = bc_val on Dirichlet DOFs at fixed h1, h2.

    rhs_weak: unassembled local weak residual shaped like `mask` (a leading
    component axis is solved jointly). The CG runs in the weighted
    local-copies representation: with t = dssum(sqw * y),

        op(y) = sqw * mask * (dssum(H_local(mask * t)) - t) + y,

    which is Euclidean-symmetric on the whole local space and acts as the
    assembled masked Helmholtz operator on the consistent subspace. Its
    iteration is built once here and, on the card, captured as a CUDA graph
    (`PCG`); the CG runs through `linear_solve`, so a reverse pass re-solves
    with it. stats: optional dict; each solve appends its CG's iteration
    count to stats[key] ("helmholtz"; the scalars' solvers log under
    "scalar"), and so does each backward of a solve recorded with that
    dict; a traced dict (`timers.traced`) also gets each solve's
    `solvers.CGTiming` under "neklab.cg.<key>". The solver's `PCG` is
    `solve.cg`.

    x0: an optional guess of u (a C0 field, e.g. the extrapolated one),
    entered as the shift y = y0 + delta with op(delta) = b - op(y0), so the
    map stays linear and equals the cold solve to the CG's tolerance. The
    CG then works on the correction alone: fewer iterations, and its
    float32 rounding scales with the correction instead of with u.

    h2_now: h2 again, as `step` computes it from its dt; when that carries
    a forward-mode tangent, the operator, the lift and the warm start carry
    h2's tangent too: the solve's tangent is op^-1 (b' - h2' M y),
    with M = d op / d h2 the masked assembled mass term."""
    sqw = torch.sqrt(mesh.vmult)
    msq = mask * sqw

    def op(y):
        t = sem.dssum(mesh, sqw * y)
        hv = sem.dssum(mesh, sem.helmholtz_local(mesh, mask * t, h1, h2))
        return torch.addcmul(y, msq, hv - t)

    def consistent(y):
        """P y = sqw * dssum(sqw * y): the projection onto the consistent
        subspace, which op keeps apart from its complement (where op is the
        identity). The right-hand side b lies in it; a backward's cotangent
        does not, and its complement part, which the transposed dssum of b
        discards anyway, would slow the Jacobi CG (its preconditioned
        spectrum there is 1/diag)."""
        return sqw * sem.dssum(mesh, sqw * y)

    like = torch.zeros(torch.broadcast_shapes(mask.shape, diag.shape), dtype=mesh.dtype,
                       device=mesh.device)
    cg = PCG(op, like, precond=lambda r: r / diag, part=mesh.part)

    def mass(y):
        """(d op / d h2) y: the masked assembled mass term of op."""
        return msq * sem.dssum(mesh, mesh.bm1 * (mask * sem.dssum(mesh, sqw * y)))

    def solve(rhs_weak, bc_val, stats=None, x0=None, h2_now=None):
        ub = (1.0 - mask) * bc_val
        lift = sem.helmholtz_local(mesh, ub, h1, h2)
        s = tangent_part(h2_now)  # h2_now's primal is the h2 of the build
        if s is not None:
            lift = lift + s * (mesh.bm1 * ub)
        b = msq * sem.dssum(mesh, rhs_weak - lift)
        if b.shape != like.shape:
            raise ValueError(f"helmholtz solve: right-hand side {tuple(b.shape)}, the solver "
                             f"was built for {tuple(like.shape)}")
        log = _logger(stats, key)
        kw = dict(project=consistent, log=log, param=s, dop=mass)
        if x0 is None:
            y = linear_solve(cg, b, tol, maxiter, **kw)
        else:
            y0 = msq * x0
            r0 = b - op(y0)
            if s is not None:
                r0 = r0 - s * mass(y0)
            y = y0 + linear_solve(cg, r0, tol, maxiter, **kw)
        return ub + mask * (y / sqw)

    solve.cg = cg
    return solve


def helmholtz_solve(mesh, rhs_weak, h1, h2, mask, bc_val, tol, maxiter, diag, stats=None):
    """Solve (h1 A + h2 B) u = rhs with u = bc_val on Dirichlet DOFs: one
    solve of a `make_helmholtz_solver` built for it, sized to the broadcast
    shape of the arguments, so rhs_weak may carry any leading axes. On the
    card that builds (and captures) a CG per call: a caller that solves
    repeatedly builds the solver once instead."""
    shape = torch.broadcast_shapes(rhs_weak.shape, bc_val.shape, mask.shape, diag.shape)
    solve = make_helmholtz_solver(mesh, h1, h2, mask.expand(shape), diag, tol, maxiter)
    return solve(rhs_weak, bc_val, stats=stats)


# ---------------------------------------------------------------------------
# cross-solve solution recycling (Nek5000 residual projection, param(93-95))
# ---------------------------------------------------------------------------


def init_projection_basis(mesh: SemMesh, k: int):
    """Empty rolling E-solution-recycling basis (X, AX, count): k slots of
    A-orthonormal previous solutions X and AX ~= A X, stored, never
    recomputed (A x_i is the solve's own right-hand side at convergence:
    Nek5000's projection, param(93-95)). Zero slots contribute nothing.
    count is a 0-d int64 tensor on the mesh's device, so choosing a slot
    reads nothing back to the host. A slot holds its solution in the
    pressure CG's layout (element-first when the solver applies E's exact
    blocks): a basis serves the solver that fills it."""
    shape = (k,) + tuple(mesh.bm2.shape)
    z = torch.zeros(shape, dtype=mesh.dtype, device=mesh.device)
    return z, torch.zeros_like(z), torch.zeros((), dtype=torch.int64, device=mesh.device)


def _basis_project(basis, rhs, part=None):
    """(xbar, rhs - A xbar), xbar the A-orthogonal projection of the
    solution onto span(X): alpha = X rhs (= X A x_true), one product of the
    k slots, summed across the ranks of a partitioned run in one
    all-reduce. The basis carries no gradient and no tangent, so the map
    rhs -> (xbar, rhs') is linear, and with the exact solve after it the
    whole map is A^-1 rhs for any basis value: its backward and its
    forward mode are those of a fixed linear map."""
    X, AX, _ = basis
    k = X.shape[0]
    Xf, AXf = X.reshape(k, -1), AX.reshape(k, -1)
    alpha = global_sum(part, Xf @ rhs.reshape(-1))
    rest = torch.addmv(rhs.reshape(-1), AXf.T, alpha, alpha=-1.0)
    return (alpha @ Xf).view(rhs.shape), rest.view(rhs.shape)


def _basis_update(basis, delta, adelta, rtol, part=None):
    """The basis with the new solution increment appended: A-Gram-Schmidt
    against the slots, written to slot count % k. adelta, the solve's
    right-hand side, equals A delta only to the solver's absolute residual
    tolerance rtol, so a small increment's A-norm is noise, and normalizing
    it poisons the basis: the update is skipped (the slots and count kept)
    unless ||d||_A^2 > 100 ||d|| rtol, the reference's guard. The increment
    is detached (no gradient, no tangent), and every tensor is new: a
    basis that a recorded step saved is never written in place. ok, the
    slot and count stay on the device (a masked write, no branch); its ops
    run eagerly around the captured CG. In a partitioned run beta and
    (||d||_A^2, ||d||^2) are all-reduced, so every rank takes the same ok
    and slot."""
    X, AX, count = basis
    k = X.shape[0]
    Xf, AXf = X.reshape(k, -1), AX.reshape(k, -1)
    delta, adelta = delta.detach().reshape(-1), adelta.detach().reshape(-1)
    beta = Xf @ adelta
    if part is not None:
        beta = part.all_reduce(beta)
    d = torch.addmv(delta, Xf.T, beta, alpha=-1.0)
    ad = torch.addmv(adelta, AXf.T, beta, alpha=-1.0)
    sums = torch.stack((ad, d)) @ d  # (||d||_A^2, ||d||^2)
    if part is not None:
        sums = part.all_reduce(sums)
    nrm2, d2 = sums.unbind()
    ok = nrm2 > torch.sqrt(d2) * (100.0 * rtol)
    inv = torch.where(ok, torch.rsqrt(nrm2), 0.0)  # nrm2 > 0 wherever it is taken
    write = ok & (torch.arange(k, device=count.device) == count % k)[:, None]
    return (torch.where(write, d * inv, Xf).view(X.shape),
            torch.where(write, ad * inv, AXf).view(AX.shape), count + ok.to(count.dtype))


def make_pressure_solver(mesh: SemMesh, cfg: FlowConfig, dt_over_g0, pc=None):
    """Returns dp = solve(rhs, x0=None, basis=None) for the E operator at
    fixed dt/g0.

    For enclosed flows (pure-Neumann pressure) the constant nullspace is
    projected out of the operator, the preconditioner and the RHS, and out
    of the CG's residual at every update (`PCG(project=)`). When the
    preconditioner carries E's exact neighbour blocks (`pc.eb_w`), E is
    applied through them and the CG runs on element-first copies of the
    fields ([nel, np2], the layout of `pc.e_apply_ef` and `pc.apply_ef`);
    otherwise E is the matrix-free `stokes.e_op` on element-last fields,
    with `pc.apply` (when given) as the preconditioner. The CG iteration is
    built once per solver and, on the card, captured as a CUDA graph
    (`PCG`); the CG runs through `linear_solve`, so a reverse pass re-solves
    with it. E is symmetric, and either apply is its own backward and
    forward mode under autograd (`tensor.linear`), so the warm start's
    backward is E again and not an atomic scatter-add. The solver's `PCG`
    is `solve.cg`."""
    pure = mesh.p_fixed
    proj = (lambda q: stokes.project_onto_range(q, mesh.part)) if pure else (lambda q: q)
    # the CG's direction and residual are in range(E) already (the residual
    # is projected at every update, the direction is built from projected
    # preconditioned residuals), so they enter E and the preconditioner as
    # they are and only the outputs are projected: one all-reduce each in a
    # partitioned run
    blocks = pc is not None and pc.eb_w is not None

    if blocks:
        e_apply = lambda q: linear(lambda v: pc.e_apply_ef(v, dt_over_g0), q)
        precond = lambda r: proj(pc.apply_ef(r))
        to_ef = lambda q: q.reshape(-1, mesh.nel).T.contiguous()
    else:
        e_apply = lambda q: linear(lambda v: stokes.e_op(mesh, v, dt_over_g0), q)
        precond = None if pc is None else (lambda r: proj(pc.apply(r)))
        to_ef = lambda q: q

    def op(dp):
        return proj(e_apply(dp))

    cg = PCG(op, to_ef(torch.zeros_like(mesh.bm2)), precond, project=proj if pure else None,
             part=mesh.part)

    def solve(rhs, x0=None, stats=None, dt_over_g0_now=None, basis=None):
        """x0: optional warm start (e.g. the previous step's increment),
        entered as the shift dp = x0 + delta, E delta = rhs - E x0, so it
        reaches the solve through the right-hand side and the map stays
        linear. stats: optional dict; the CG's iteration count is appended
        to stats["pressure"] (and a recorded solve's backward appends its
        own), and, traced, its `solvers.CGTiming` to
        stats["neklab.cg.pressure"]. dt_over_g0_now: dt/g0 again, as `step` computes it; when that
        carries a forward-mode tangent, so do E and the solve. E is linear
        in it, E(c) = (c / c0) E(c0), so the tangent of E x is
        E x' + (c'/c0) E x and that of E^-1 r is E^-1 r' - (c'/c0) E^-1 r:
        the solver's CG serves both.

        basis: an optional recycling basis (`init_projection_basis`), which
        returns (dp, basis'): the right-hand side is deflated by the
        A-orthogonal projection onto the span of previous solutions
        (Nek5000's residual projection), projected onto range(E) again,
        solved, and the increment enters the basis. The update is
        nonlinear in the data: the adjoint records a solve without one.
        A basis pairs with one E, so it takes no dt tangent."""
        s = tangent_part(dt_over_g0_now)
        if basis is not None and s is not None:
            raise ValueError("pressure solve: a recycling basis with a dt tangent (the basis "
                             "holds A x at the primal dt)")
        shape = rhs.shape
        rhs = to_ef(rhs)
        if x0 is not None:
            x0 = proj(to_ef(x0))
            ex = e_apply(x0)
            if s is not None:
                ex = ex * (1.0 + s / dt_over_g0)
            rhs = rhs - ex
        rhs = proj(rhs)
        if basis is not None:
            xbar, rhs = _basis_project(basis, rhs, mesh.part)
            rhs = proj(rhs)
        dp = linear_solve(cg, rhs, cfg.ptol, cfg.pmaxit, project=proj if pure else None,
                          log=_logger(stats, "pressure"))
        if s is not None:
            dp = dp * (1.0 - s / dt_over_g0)
        if basis is not None:
            basis = _basis_update(basis, dp, rhs, cfg.ptol, mesh.part)
            dp = dp + xbar
        if x0 is not None:
            dp = dp + x0
        if blocks:
            dp = dp.T.reshape(shape).contiguous()
        if pure:
            dp = stokes.remove_pressure_mean(mesh, dp)
        return dp if basis is None else (dp, basis)

    solve.cg = cg
    return solve


# ---------------------------------------------------------------------------
# the solvers of a run: one set per (dt, BDF order), built once
# ---------------------------------------------------------------------------


def bdf_orders(cfg: FlowConfig, nsteps: int, ramp: bool = True) -> list[int]:
    """The BDF orders a run of nsteps steps uses: the self-starting ramp
    1, 2 (with `ramp`), then the scheme's order."""
    tmax = min(cfg.torder, 3)
    if nsteps <= 0:
        return []
    if not ramp:
        return [tmax]
    return list(range(1, min(nsteps, tmax) + 1))


def bdf3_diags(mesh: SemMesh, cfg: FlowConfig, vdiag=None, tdiags=None):
    """(vdiag, tdiags): the Jacobi diagonals of the velocity and scalar
    solves at the scheme's order and cfg.dt, each built when None (tdiags
    stays None without scalars). They serve the ramp's orders too, as in
    the reference."""
    g0 = _BDF[min(cfg.torder, 3)][0]
    if vdiag is None:
        vdiag = helmholtz_diag(mesh, cfg.viscosity, cfg.rho * g0 / cfg.dt, mesh.vmask)
    if tdiags is None:
        tdiags = [helmholtz_diag(mesh, cfg.conductivity[i], g0 / cfg.dt, mesh.tmask)
                  for i in range(cfg.nscal)] or None
    return vdiag, tdiags


def pressure_solvers(mesh: SemMesh, cfg: FlowConfig, orders, pc_e=None) -> dict:
    """{order: pressure solver} at cfg.dt for the given BDF orders."""
    return {order: make_pressure_solver(mesh, cfg, cfg.dt / (_BDF[order][0] * cfg.rho), pc=pc_e)
            for order in orders}


def velocity_solvers(mesh: SemMesh, cfg: FlowConfig, orders, vdiag, tdiags) -> dict:
    """{order: (velocity solver, [scalar solvers])} at cfg.dt for the given
    BDF orders. h2 = rho g0 / dt changes with the order, so each order has
    its own solvers; vdiag and tdiags (`bdf3_diags`) serve every order. A
    solver takes its Dirichlet values per solve, so one set serves the
    nonlinear step (the lift ub) and the linearized one (zero)."""
    out = {}
    for order in orders:
        g0 = _BDF[order][0]
        vsolve = make_helmholtz_solver(mesh, cfg.viscosity, cfg.rho * g0 / cfg.dt, mesh.vmask,
                                       vdiag, cfg.vtol, cfg.vmaxit)
        tsolves = [make_helmholtz_solver(mesh, cfg.conductivity[i], g0 / cfg.dt, mesh.tmask,
                                         tdiags[i], cfg.ttol, cfg.vmaxit, key="scalar")
                   for i in range(cfg.nscal)]
        out[order] = (vsolve, tsolves)
    return out


# ---------------------------------------------------------------------------
# the step
# ---------------------------------------------------------------------------


def _explicit_terms(mesh: SemMesh, cfg: FlowConfig, u, theta, t, extra_force=None):
    """Weak-form explicit terms: N_u = -(v, u . grad u) + (v, f);
    N_theta_i = -(q, u . grad theta_i) + (q, s_i). The velocity and the
    scalars are convected in one batch."""
    nd = mesh.ndim
    if cfg.nscal:
        conv = sem.convect_volume_weak(mesh, torch.cat([u, theta]), u)
        n_u, n_t = -conv[:nd], -conv[nd:]
        if cfg.source_fn is not None:
            n_t = n_t + mesh.bm1 * cfg.source_fn(mesh, t, u, theta)
    else:
        n_u, n_t = -sem.convect_volume_weak(mesh, u, u), torch.zeros_like(theta)
    if cfg.forcing_fn is not None:
        n_u = n_u + mesh.bm1 * cfg.forcing_fn(mesh, t, u, theta)
    if extra_force is not None:
        n_u = n_u + mesh.bm1 * extra_force
    return n_u, n_t


def step(
    mesh: SemMesh,
    cfg: FlowConfig,
    state: FlowState,
    order: int,
    psolve,
    vsolve,
    tsolves,
    ub=None,
    tb=None,
    extra_force=None,
    stats=None,
    dt=None,
    pbasis=None,
) -> FlowState:
    """One BDF(order)/EXT(order) step of the nonlinear solver at cfg.dt.

    psolve, vsolve, tsolves: this order's pressure, velocity and scalar
    solvers at cfg.dt (`pressure_solvers`, `velocity_solvers`). ub, tb: the
    Dirichlet values of the velocity and scalars (zero when None), applied
    as a lift through each solve. stats: optional dict; the velocity,
    pressure and scalar CG iteration counts are appended to
    stats["helmholtz"], stats["pressure"] and stats["scalar"] (one entry
    per scalar), and a traced dict gets each solve's `solvers.CGTiming`
    under "neklab.cg.<key>" too. dt: cfg.dt again as a 0-d tensor that carries a
    forward-mode tangent (the period of a periodic orbit, d/dT): every use
    of dt then carries it, the solves' operators included. pbasis: an
    optional recycling basis of the pressure solve (`init_projection_basis`),
    threaded through and returned: -> (state', pbasis')."""
    dt = cfg.dt if dt is None else dt
    g0, betas = _BDF[order]
    alphas = _EXT[order]
    if ub is None:
        ub = torch.zeros_like(state.u)

    n_u, n_t = _explicit_terms(mesh, cfg, state.u, state.theta, state.time, extra_force)

    # ---- velocity ----
    # pressure treatment (cfg.pextrap): incremental p* = p^n, or extrapolated
    # p* = 2 p^n - p^{n-1}
    extrapolate = cfg.pextrap >= 2 and order >= 2
    pstar = 2.0 * state.p - state.plag[0] if extrapolate else state.p
    nstar = alphas[0] * n_u + alphas[1] * state.nlag[0] + alphas[2] * state.nlag[1]
    bsum = betas[0] * state.u + betas[1] * state.ulag[0] + betas[2] * state.ulag[1]
    rhs = mesh.bm1 * bsum * (cfg.rho / dt) + nstar + stokes.grad_weak_t(mesh, pstar)
    # warm start: the extrapolated velocity. A cold solve's float32
    # rounding is relative to u; warm, the CG works on the O(dt^k)
    # correction, which halves float32's bias of a 100-step map (the
    # residual a float32 Newton can reach on the cylinder).
    uext = alphas[0] * state.u + alphas[1] * state.ulag[0] + alphas[2] * state.ulag[1]
    ustar = vsolve(rhs, ub, stats=stats, x0=uext, h2_now=cfg.rho * g0 / dt)

    # ---- pressure correction ----
    # E carries dt/g0, so D(u* + du) = 0 reads E dp = -div u*. Warm start
    # (incremental pressure only): the previous increment; under
    # extrapolation dp is a second difference, for which zero is the
    # better guess.
    dt_over_g0 = dt / (g0 * cfg.rho)
    x0 = None if cfg.pextrap >= 2 else state.p - state.plag[0]
    dp = psolve(-stokes.div_weak(mesh, ustar), x0=x0, stats=stats, dt_over_g0_now=dt_over_g0,
                basis=pbasis)
    if pbasis is not None:
        dp, pbasis = dp
    u_new = ustar + stokes.pressure_correct_velocity(mesh, dp, dt_over_g0)
    p_new = pstar + dp

    # ---- scalars ----
    if cfg.nscal:
        if tb is None:
            tb = torch.zeros_like(state.theta)
        ntstar = alphas[0] * n_t + alphas[1] * state.ntlag[0] + alphas[2] * state.ntlag[1]
        tbsum = betas[0] * state.theta + betas[1] * state.tlag[0] + betas[2] * state.tlag[1]
        text = alphas[0] * state.theta + alphas[1] * state.tlag[0] + alphas[2] * state.tlag[1]
        theta_new = torch.stack([tsolves[i](mesh.bm1 * tbsum[i] * (1.0 / dt) + ntstar[i], tb[i],
                                            stats=stats, x0=text[i], h2_now=g0 / dt)
                                 for i in range(cfg.nscal)])
    else:
        theta_new = state.theta

    shift = lambda lag, cur: torch.cat([cur[None], lag[:-1]], dim=0)
    out = FlowState(
        u=u_new,
        p=p_new,
        theta=theta_new,
        ulag=shift(state.ulag, state.u),
        nlag=shift(state.nlag, n_u),
        tlag=shift(state.tlag, state.theta),
        ntlag=shift(state.ntlag, n_t),
        plag=state.p[None],
        time=state.time + dt,
    )
    return out if pbasis is None else (out, pbasis)


# ---------------------------------------------------------------------------
# multi-step advance
# ---------------------------------------------------------------------------


def advance(mesh: SemMesh, cfg: FlowConfig, state: FlowState, nsteps: int, ub=None, tb=None,
            ramp: bool = True, pc_e=None, vdiag=None, tdiags=None, dt=None, psolves=None,
            vsolves=None, stats=None, trajectory: list | None = None,
            recycle: int = 0) -> FlowState:
    """Integrate nsteps with a BDF1/2/3 startup ramp (self-starting: the map
    needs no externally supplied history); ramp=False continues at the
    scheme's order from the state's history.

    dt: replaces cfg.dt for this run; a 0-d tensor that carries a
    forward-mode tangent (dt = T / nsteps for a periodic orbit's period T)
    carries it through every step, while the solvers are those of its
    primal value. vdiag/tdiags: the Jacobi diagonals
    (`bdf3_diags`); psolves and vsolves: the solvers at this dt
    (`pressure_solvers`, `velocity_solvers`, for at least
    `bdf_orders(cfg, nsteps, ramp)`). A caller that advances repeatedly at
    one dt builds them once; they are built here when None. stats: as in
    `step`, one entry per step and solve. trajectory: optional list; the
    state before every step and the step's BDF order are appended, as
    (state, order) pairs (the orbit a linearization about it needs).

    recycle: if > 0, each pressure solve after the ramp is deflated against
    the last `recycle` solutions (Nek5000's residual projection,
    param(93-95)); the ramp's solves are not, since E scales with dt/g0,
    which changes with the BDF order. The output equals recycle=0's to
    the solvers' tolerance. Forward mode and the backward go through it
    (the basis carries neither); a dt that carries a tangent raises, since
    the stored A x do not."""
    if recycle and is_dual(dt):
        raise ValueError("advance: recycle > 0 with a dt that carries a tangent (the "
                         "recycling basis holds A x at the primal dt)")
    if dt is not None:
        cfg = dataclasses.replace(cfg, dt=float(dt))
    orders = bdf_orders(cfg, nsteps, ramp)
    if psolves is None:
        psolves = pressure_solvers(mesh, cfg, orders, pc_e)
    if vsolves is None:
        vdiag, tdiags = bdf3_diags(mesh, cfg, vdiag, tdiags)
        vsolves = velocity_solvers(mesh, cfg, orders, vdiag, tdiags)
    tmax = min(cfg.torder, 3)
    n_ramp = min(cfg.torder - 1, nsteps) if ramp else 0
    pbasis = None
    for k in range(nsteps):
        order = k + 1 if k < n_ramp else tmax
        vsolve, tsolves = vsolves[order]
        if trajectory is not None:
            trajectory.append((state, order))
        if recycle and k == n_ramp:
            pbasis = init_projection_basis(mesh, recycle)
        state = step(mesh, cfg, state, order, psolves[order], vsolve, tsolves, ub=ub, tb=tb,
                     stats=stats, dt=dt if is_dual(dt) else None, pbasis=pbasis)
        if pbasis is not None:
            state, pbasis = state
    return state


def advance_adaptive(
    mesh: SemMesh,
    cfg: FlowConfig,
    state: FlowState,
    endtime: float,
    cfl: float = 0.4,
    ub=None,
    tb=None,
    pc_e=None,
    chunk: int = 25,
    max_growth: float = 1.2,
    stats=None,
) -> FlowState:
    """Variable-dt nonlinear advance to `endtime` (DNS spin-up).

    The reference's variable-dt path: dt is re-derived per chunk from the
    target CFL against the current velocity, with at most `max_growth` per
    re-derivation, and the final chunk lands on endtime exactly. The BDF
    history is carried across dt changes with fixed coefficients (spin-up
    only; analysis runs use a fixed dt). Solvers and Jacobi diagonals are
    built anew only when dt changes; pc_e serves every dt. stats: as in
    `advance`, plus stats["solver_builds"], one entry (the dt) per set of
    solvers built."""
    cfl = clamp_cfl(cfl)
    t = state.time
    dt_old = None
    built_dt, diags, psolves, vsolves = None, None, {}, {}
    while t < endtime - 1e-12:
        dt_new = cfl_dt(mesh, state.u, cfl=cfl)
        if dt_old is not None:
            dt_new = min(dt_new, max_growth * dt_old)
        nleft = max(1, math.ceil((endtime - t) / dt_new - 1e-12))
        k = min(chunk, nleft)
        if nleft <= chunk:
            dt_new = (endtime - t) / nleft  # hit endtime exactly
        ramp = dt_old is None
        fc = dataclasses.replace(cfg, dt=dt_new)
        if dt_new != built_dt:
            built_dt, diags, psolves, vsolves = dt_new, bdf3_diags(mesh, fc), {}, {}
            if stats is not None:
                stats.setdefault("solver_builds", []).append(dt_new)
        missing = [o for o in bdf_orders(fc, k, ramp) if o not in psolves]
        psolves.update(pressure_solvers(mesh, fc, missing, pc_e))
        vsolves.update(velocity_solvers(mesh, fc, missing, *diags))
        state = advance(mesh, fc, state, k, ub=ub, tb=tb, ramp=ramp, psolves=psolves,
                        vsolves=vsolves, stats=stats)
        dt_old = dt_new
        t = state.time
    return state
