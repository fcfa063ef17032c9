"""Linearized Navier-Stokes stepper about a frozen base flow.

Perturbation evolution about (U, Theta) with the same BDFk/EXTk fractional
step as the nonlinear solver and the convection linearized,

    N(u') = -(v, U . grad u') - (v, u' . grad U)  (+ linear coupling forces),

homogeneous Dirichlet BCs (the perturbation masks). `propagate` is the
exponential-propagator matvec: a BDF1/BDF2 self-starting ramp, then BDF3
steps in a Python loop; `propagate_forced` adds a harmonic body force
(the resolvent's right-hand side). Counterpart of
`neklab_tpu/models/linearized.py` (its chunked form bounded the TPU compiler's
program size and has no counterpart here).

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
import math
from typing import Callable

import torch

from ..mesh.core import SemMesh
from ..ops import e_kernel, sem
from ..parallel.sharding import global_sum
from ..utils import timers
from . import stokes
from . import navier_stokes as ns
from .navier_stokes import _BDF, _EXT


@dataclasses.dataclass(frozen=True)
class LinConfig:
    """Linearized-solver configuration. lin_forcing_fn(mesh, u, theta) and
    lin_source_fn(mesh, u, theta) must be LINEAR in (u, theta) — e.g.
    Boussinesq buoyancy g*beta*theta'."""

    flow: ns.FlowConfig
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


def adjoint_explicit_lin_map(mesh, cfg: LinConfig, conv_cache, theta_shape, dtype=None):
    """Exact transpose of the explicit weak operator (`_explicit_lin_map`).

    For C0 fields the assembled bilinear form is a(u, v) = sum E(u) . v over
    local copies, so the adjoint weak form is the plain Euclidean transpose
    of the LOCAL map. The reference takes it from `jax.linear_transpose`;
    here E is recorded once on autograd's tape from zero inputs (E is
    linear, so one tape serves every call) and each call is a backward of
    it: exact at the discrete level (dealiasing, metric terms, coupling
    forces included). dtype: the fields' (None: the mesh's). Returns
    eadj(v, psi) -> (w_u, w_theta)."""
    emap = _explicit_lin_map(mesh, cfg, conv_cache, theta_shape)
    shape = tuple(mesh.bm1.shape)
    dtype = mesh.dtype if dtype is None else dtype
    inputs = tuple(torch.zeros(s, dtype=dtype, device=mesh.device, requires_grad=True)
                   for s in ((mesh.ndim,) + shape, tuple(theta_shape)))
    with torch.enable_grad():
        outputs = emap(*inputs)

    def eadj(v, psi):
        pairs = [(o, g) for o, g in zip(outputs, (v, psi)) if o.requires_grad]
        grads = torch.autograd.grad([o for o, _ in pairs], inputs, [g for _, g in pairs],
                                    retain_graph=True, allow_unused=True)
        return tuple(torch.zeros_like(x) if g is None else g for g, x in zip(grads, inputs))

    return eadj


def _lin_terms(mesh, cfg: LinConfig, u, theta, base_u, base_theta, force=None, source=None,
               conv_cache=None, emap=None):
    """Weak linearized explicit terms about (base_u, base_theta), plus the
    body force and scalar source (strong form) when given. emap: overrides
    the explicit operator (e.g. its adjoint, for adjoint OTD)."""
    if emap is None:
        if conv_cache is None:
            conv_cache = sem.lin_convect_cache(mesh, base_u, base_theta)
        emap = _explicit_lin_map(mesh, cfg, conv_cache, tuple(theta.shape))
    n_u, n_t = emap(u, theta)
    if force is not None:
        n_u = n_u + mesh.bm1 * force
    if cfg.nscal and source is not None:
        n_t = n_t + mesh.bm1 * source
    return n_u, n_t


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
    force=None,
    source=None,
    emap=None,
    pbasis=None,
    scalar_span=None,
) -> PertState:
    """One linearized BDF(order)/EXT(order) step (homogeneous BCs).

    psolve, vsolve, tsolves: this order's pressure, velocity and scalar
    solvers (`navier_stokes.pressure_solvers`, `navier_stokes.velocity_solvers`).
    stats: optional dict; the velocity, pressure and scalar CG iteration
    counts are appended to stats["helmholtz"], stats["pressure"] and
    stats["scalar"], and, where the dict is traced (`timers.traced`), each
    solve's `solvers.CGTiming` to stats["neklab.cg.<key>"]. force, source: a
    body force [ndim, ...] and scalar sources [nscal, ...] for this step
    (the reference's forcing hook: resolvent forcing, OTD rank coupling).
    emap: overrides the explicit operator (`adjoint_explicit_lin_map` for
    adjoint OTD). pbasis: an optional recycling basis of the pressure solve
    (`navier_stokes.init_projection_basis`), threaded through and
    returned: -> (state', pbasis'). Its update is nonlinear in the data, so
    an adjoint records steps without one (both maps agree to the solvers'
    tolerance). scalar_span: an optional `timers.Spans` that times the
    scalar block, from the scalars' extrapolation to their stack."""
    fc = cfg.flow
    dt = fc.dt
    g0, betas = _BDF[order]
    alphas = _EXT[order]

    n_u, n_t = _lin_terms(mesh, cfg, state.u, state.theta, base_u, base_theta, force, source,
                          conv_cache=conv_cache, emap=emap)

    # pressure treatment mirrors the nonlinear step (cfg.flow.pextrap)
    extrapolate = fc.pextrap >= 2 and order >= 2
    pstar = 2.0 * state.p - state.plag[0] if extrapolate else state.p
    nstar = alphas[0] * n_u + alphas[1] * state.nlag[0] + alphas[2] * state.nlag[1]
    bsum = betas[0] * state.u + betas[1] * state.ulag[0] + betas[2] * state.ulag[1]
    # the perturbation meets each mesh field in a product of its own: a
    # product of constants made per step would be kept by autograd's tape
    rhs = mesh.bm1 * bsum * (fc.rho / dt) + nstar + stokes.grad_weak_t(mesh, pstar)

    ustar = vsolve(rhs, torch.zeros_like(state.u), stats=stats)

    dt_over_g0 = dt / (g0 * fc.rho)
    # warm start (incremental pressure only): the previous step's increment
    x0 = None if fc.pextrap >= 2 else state.p - state.plag[0]
    dp = psolve(-stokes.div_weak(mesh, ustar), x0=x0, stats=stats, basis=pbasis)
    if pbasis is not None:
        dp, pbasis = dp
    du = stokes.pressure_correct_velocity(mesh, dp, dt_over_g0)
    u_new = ustar + du
    p_new = pstar + dp

    if cfg.nscal:
        with timers.NULL if scalar_span is None else scalar_span():
            ntstar = alphas[0] * n_t + alphas[1] * state.ntlag[0] + alphas[2] * state.ntlag[1]
            tbsum = betas[0] * state.theta + betas[1] * state.tlag[0] + betas[2] * state.tlag[1]
            comps = []
            for i in range(cfg.nscal):
                rhs_t = mesh.bm1 * tbsum[i] * (1.0 / dt) + ntstar[i]
                comps.append(tsolves[i](rhs_t, torch.zeros_like(state.theta[i]), stats=stats))
            theta_new = torch.stack(comps)
    else:
        theta_new = state.theta

    shift = lambda lag, cur: torch.cat([cur[None], lag[:-1]], dim=0)
    out = PertState(
        u=u_new,
        p=p_new,
        theta=theta_new,
        ulag=shift(state.ulag, state.u),
        nlag=shift(state.nlag, n_u),
        tlag=shift(state.tlag, state.theta),
        ntlag=shift(state.ntlag, n_t),
        plag=state.p[None],
    )
    return out if pbasis is None else (out, pbasis)


def propagate(mesh: SemMesh, cfg: LinConfig, base_u, base_theta, u0, theta0, nsteps: int,
              pc_e=None, vdiag=None, tdiags=None, psolves=None, vsolves=None, stats=None,
              recycle: int = 0):
    """Linear map M: (u0, theta0) -> (u, theta) after nsteps of the
    linearized solver, with a BDF1/2/3 self-starting ramp and zero initial
    pressure — the exponential-propagator matvec exp(tau A), tau = nsteps*dt.

    vdiag/tdiags: the BDF3 Jacobi diagonals; psolves and vsolves: the
    pressure solvers and the velocity and scalar solvers of the run's BDF
    orders (`navier_stokes.pressure_solvers`, `velocity_solvers` with
    `bdf_orders(cfg.flow, nsteps)`). A caller that applies the map repeatedly
    builds them once (the diagonals serve the ramp steps too); they are
    built here when None. stats: as in `step_lin`, one entry per step; a
    traced call also appends to stats["neklab.step"], per step, the seconds
    of the step on the card's stream (CUDA events around `step_lin`; the
    host's clock on the CPU) less its solves' `CGTiming.span_s`: the
    explicit terms, right-hand sides, pressure correction and lag shifts,
    as the device saw them, and, with scalars, to stats["neklab.scalar"]
    the same of the step's scalar block (a part of the step's); while a
    profiler records, each step is the range `neklab.step` and its scalar
    block `neklab.scalar` instead. A traced call on the card also appends to
    stats["neklab.e3d"] the E applies the 3-D kernels ran in it
    (`e_kernel.log_runs`).

    recycle: if > 0, each pressure solve after the BDF ramp is deflated
    against the last `recycle` solutions (Nek5000's residual projection;
    E changes with the ramp's orders, so their solves are not). The output
    equals recycle=0's to the solvers' tolerance, but the map is no longer
    linear in its program: the adjoint (`make_adjoint_propagator`) records
    the recycle-free one."""
    fc = cfg.flow
    state = pert_initial(mesh, cfg, u0, theta0)
    tmax = min(fc.torder, 3)
    vdiag3, tdiags3 = ns.bdf3_diags(mesh, fc, vdiag, tdiags)
    ccache = sem.lin_convect_cache(mesh, base_u, base_theta if fc.nscal else None)
    orders = ns.bdf_orders(fc, nsteps)
    if psolves is None:
        psolves = ns.pressure_solvers(mesh, fc, orders, pc_e)
    if vsolves is None:
        vsolves = ns.velocity_solvers(mesh, fc, orders, vdiag3, tdiags3)

    n_ramp = min(fc.torder - 1, nsteps)
    pbasis = None
    traced = timers.traced(stats)
    e3d_mark = e_kernel.runs_mark(mesh.device) if traced else None
    clock = timers.Clock(mesh.device) if traced and not timers.profiling() else None
    steps = timers.Spans("neklab.step", clock, stats) if traced else None
    scalars = timers.Spans("neklab.scalar", clock, stats) if traced and fc.nscal else None
    for k in range(nsteps):
        order = min(k + 1, tmax)
        vsolve, tsolves = vsolves[order]
        if recycle and k == n_ramp:
            pbasis = ns.init_projection_basis(mesh, recycle)
        with timers.NULL if steps is None else steps():
            state = step_lin(mesh, cfg, state, base_u, base_theta, order, psolves[order], vsolve,
                             tsolves, conv_cache=ccache, stats=stats, pbasis=pbasis,
                             scalar_span=scalars)
        if pbasis is not None:
            state, pbasis = state
    for spans in (scalars, steps):
        if spans is not None:
            spans.close()
    e_kernel.log_runs(stats, e3d_mark)
    return state.u, state.theta


def propagate_forced(mesh: SemMesh, cfg: LinConfig, base_u, base_theta, u0, theta0, f_re, f_im,
                     omega: float, nsteps: int, t0: float = 0.0, sign: int = 1, pc_e=None,
                     vdiag=None, tdiags=None, s_re=None, s_im=None, psolves=None, vsolves=None,
                     stats=None):
    """Integrate the linearized equations with the harmonic body force
    Re[(f_re + i f_im) e^{i sign omega t}] = f_re cos(w t) - sign f_im sin(w t)
    (and scalar sources s_re, s_im likewise), from (u0, theta0): the
    resolvent's evaluate_rhs. Solvers as in `propagate`.

    The ramp's steps take the force at their own time; after the ramp the
    force rides as a phase-rotating complex amplitude z = (f_re + i sign
    f_im) e^{i w t}, rotated by e^{i w dt} per step, force = Re z: the
    reference's recurrence and arithmetic. The map is linear in (u0,
    theta0, f, s), so autograd's tape of it is its transpose."""
    fc = cfg.flow
    state = pert_initial(mesh, cfg, u0, theta0)
    tmax = min(fc.torder, 3)
    vdiag3, tdiags3 = ns.bdf3_diags(mesh, fc, vdiag, tdiags)
    ccache = sem.lin_convect_cache(mesh, base_u, base_theta if fc.nscal else None)
    orders = ns.bdf_orders(fc, nsteps)
    if psolves is None:
        psolves = ns.pressure_solvers(mesh, fc, orders, pc_e)
    if vsolves is None:
        vsolves = ns.velocity_solvers(mesh, fc, orders, vdiag3, tdiags3)
    has_source = s_re is not None and s_re.numel() > 0

    def run(state, order, force, source):
        vsolve, tsolves = vsolves[order]
        return step_lin(mesh, cfg, state, base_u, base_theta, order, psolves[order], vsolve,
                        tsolves, conv_cache=ccache, stats=stats, force=force, source=source)

    n_ramp = min(fc.torder - 1, nsteps)
    for k in range(n_ramp):
        ph = omega * (t0 + k * fc.dt)
        c, sn = math.cos(ph), math.sin(ph)
        force = c * f_re - sign * sn * f_im
        source = c * s_re - sign * sn * s_im if has_source else None
        state = run(state, k + 1, force, source)

    remaining = nsteps - n_ramp
    if remaining > 0:
        ph0 = omega * (t0 + n_ramp * fc.dt)
        c0, s0 = math.cos(ph0), math.sin(ph0)
        dph = omega * fc.dt
        cd, sd = math.cos(dph), math.sin(dph)

        def rot0(re, im):
            im = sign * im
            return c0 * re - s0 * im, s0 * re + c0 * im

        def rot_step(zr, zi):
            return cd * zr - sd * zi, sd * zr + cd * zi

        zr, zi = rot0(f_re, f_im)
        wr, wi = rot0(s_re, s_im) if has_source else (None, None)
        for _ in range(remaining):
            state = run(state, tmax, zr, wr if fc.nscal else None)
            zr, zi = rot_step(zr, zi)
            if has_source:
                wr, wi = rot_step(wr, wi)
    return state.u, state.theta


class AdjointPropagator:
    """The exact discrete B-adjoint of `propagate`, (v_u, v_theta) ->
    (w_u, w_theta) with w = vmask Bhat^-1 dssum( M^T (B v) ); built by
    `make_adjoint_propagator`.

    M^T is the backward of one recorded `propagate`: M is linear, so one
    tape serves every call (`retain_graph`), the counterpart of tracing and
    jitting the reference's transpose once. tape_bytes: device memory the
    tape holds (None on the CPU). log: the `timers.Counts` the recorded
    solves report to; nsteps: the time steps recorded."""

    def __init__(self, mesh: SemMesh, inputs, outputs, log: timers.Counts, tape_bytes,
                 nsteps: int):
        self.mesh = mesh
        self._inputs, self._outputs, self._log = inputs, outputs, log
        self.tape_bytes = tape_bytes
        self.nsteps = nsteps
        self._clock: timers.Clock | None = None

    def __call__(self, v_u, v_theta, stats: dict | None = None):
        """stats: optional dict; every transposed solve appends its CG's
        iteration count, under the forward solver's key ("helmholtz",
        "pressure", "scalar"), in the order the backward runs them (last
        step first). A traced call (`timers.traced(stats)`) also appends
        each transposed solve's `solvers.CGTiming` under
        "neklab.cg.<key>", and to stats["neklab.adjoint"] the seconds of
        the call on the card's stream (CUDA events around it; the host's
        clock on the CPU) less its solves' spans, over the time steps: the
        autograd engine and the tape's own kernels, per time step; while a
        profiler records, the call is the range `neklab.adjoint` instead;
        on the card it appends to stats["neklab.e3d"] the E applies the 3-D
        kernels ran in it. An untraced call records no event."""
        log = self._log
        log.clear()
        log.traced = timers.traced(stats)
        e3d_mark = e_kernel.runs_mark(self.mesh.device) if log.traced else None
        try:
            if not log.traced:
                out = b_adjoint(self.mesh, self._inputs, self._outputs, v_u, v_theta)
            elif timers.profiling():
                with timers.profiler_range("neklab.adjoint"):
                    out = b_adjoint(self.mesh, self._inputs, self._outputs, v_u, v_theta)
            else:
                if self._clock is None:
                    self._clock = timers.Clock(self.mesh.device)
                clock = self._clock
                clock.start()
                before = clock.stamp()
                out = b_adjoint(self.mesh, self._inputs, self._outputs, v_u, v_theta)
                after = clock.stamp()
                clock.wait(after)
                other = clock.seconds(before, after) - timers.solve_seconds(log)
                stats.setdefault("neklab.adjoint", []).append(other / self.nsteps)
        finally:
            log.traced = False
        if stats is not None:
            for key, counts in log.items():
                stats.setdefault(key, []).extend(counts)
            e_kernel.log_runs(stats, e3d_mark)
        return out


def b_adjoint(mesh: SemMesh, inputs, outputs, v_u, v_theta):
    """The B-adjoint of the map inputs (u, theta) -> outputs (u, theta)
    recorded on autograd's tape, applied to (v_u, v_theta):
    vmask Bhat^-1 dssum( M^T (B v) ), the tape kept for the next call.

    Scale normalization (exact by linearity; the reference's
    make_adjoint_propagator): the seed bm1 * v is orders of magnitude
    smaller than v, and the transposed solves stop at the forward's
    ABSOLUTE tolerances, so the seed is rescaled to v's Euclidean size and
    the result scaled back."""
    iu, it = mesh.bm1 * v_u, mesh.bm1 * v_theta
    # both sizes over every rank's block of a partitioned mesh (one
    # all-reduce): the scale must be the same on every rank
    sq = torch.stack([torch.sum(v_u * v_u) + torch.sum(v_theta * v_theta),
                      torch.sum(iu * iu) + torch.sum(it * it)])
    nv, ni = torch.sqrt(global_sum(mesh.part, sq)).unbind()
    c = torch.where(ni > 0, nv / torch.clamp_min(ni, torch.finfo(ni.dtype).tiny), 1.0)
    grads = torch.autograd.grad(outputs, inputs, grad_outputs=(c * iu, c * it),
                                retain_graph=True, allow_unused=True)
    wu, wt = (torch.zeros_like(x) if g is None else g for g, x in zip(grads, inputs))
    au = mesh.vmask * mesh.binv * sem.dssum(mesh, wu) / c
    at = mesh.tmask * mesh.binv * sem.dssum(mesh, wt) / c
    return au, at


def make_adjoint_propagator(mesh: SemMesh, cfg: LinConfig, base_u, base_theta, nsteps: int,
                            pc_e=None, vdiag=None, tdiags=None, psolves=None,
                            vsolves=None) -> AdjointPropagator:
    """The exact discrete B-adjoint of `propagate` at cfg's tolerances.

    Takes the solvers of `propagate` at these tolerances (one per BDF order,
    each with its CUDA graph on the card; built here when None) and records
    `propagate` once, from a zero input that requires grad: every CG then
    exits at iteration 0, so recording runs no CG iteration, only the
    step's other ops. Every backward re-solves with the same solvers."""
    fc = cfg.flow
    vdiag, tdiags = ns.bdf3_diags(mesh, fc, vdiag, tdiags)
    orders = ns.bdf_orders(fc, nsteps)
    if psolves is None:
        psolves = ns.pressure_solvers(mesh, fc, orders, pc_e)
    if vsolves is None:
        vsolves = ns.velocity_solvers(mesh, fc, orders, vdiag, tdiags)
    shape = tuple(mesh.bm1.shape)
    inputs = tuple(torch.zeros((lead,) + shape, dtype=mesh.dtype, device=mesh.device,
                               requires_grad=True) for lead in (mesh.ndim, cfg.nscal))
    on_card = mesh.device.type == "cuda"
    if on_card:
        torch.cuda.synchronize(mesh.device)
        before = torch.cuda.memory_allocated(mesh.device)
    log = timers.Counts()
    with torch.enable_grad():
        outputs = propagate(mesh, cfg, base_u, base_theta, *inputs, nsteps, pc_e=pc_e,
                            vdiag=vdiag, tdiags=tdiags, psolves=psolves, vsolves=vsolves,
                            stats=log)
    tape_bytes = torch.cuda.memory_allocated(mesh.device) - before if on_card else None
    return AdjointPropagator(mesh, inputs, outputs, log, tape_bytes, nsteps)
