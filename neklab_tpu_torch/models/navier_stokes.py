"""BDFk/EXTk fractional-step building blocks shared by the steppers.

The configuration, the BDF/EXT coefficient tables, the implicit velocity
(and scalar) Helmholtz solve with its Jacobi diagonal, and the pressure E
solve. Counterparts of `neklab_tpu.models.navier_stokes` (the nonlinear
stepper itself is not ported yet; the linearized stepper uses these).
"""

from __future__ import annotations

import dataclasses

import torch

from ..mesh.core import SemMesh
from ..ops import sem
from ..ops.tensor import linear
from . import stokes
from .solvers import PCG, linear_solve, local_diagonal


@dataclasses.dataclass(frozen=True)
class FlowConfig:
    """Solver configuration (the `.par` GENERAL/VELOCITY/PRESSURE/TEMPERATURE
    tiers): viscosity, time step and order, scalars, density, and the
    absolute CG tolerances and iteration caps of the implicit solves. The
    pressure is incremental (p* = p^n), the reference's default."""

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

    def __post_init__(self):
        if self.nscal and len(self.conductivity) != self.nscal:
            raise ValueError("conductivity must have nscal entries")


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
    """Appends a CG's iteration count to stats[key]; None without stats."""
    if stats is None:
        return None
    return lambda k: stats.setdefault(key, []).append(k)


def helmholtz_diag(mesh: SemMesh, h1, h2, mask) -> torch.Tensor:
    """Jacobi diagonal of the masked assembled Helmholtz operator, as a
    consistent local-copies field (1 on Dirichlet DOFs)."""
    op_local = lambda u: sem.helmholtz_local(mesh, u, h1, h2)
    dloc = local_diagonal(op_local, mesh.bm1.shape, mesh.dtype, mesh.ndim, device=mesh.device)
    d = sem.dssum(mesh, dloc)
    return mask * d + (1.0 - mask)


def make_helmholtz_solver(mesh: SemMesh, h1, h2, mask, diag, tol, maxiter):
    """Returns u = solve(rhs_weak, bc_val, stats=None), which solves
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
    count to stats["helmholtz"], and so does each backward of a solve
    recorded with that dict."""
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
    cg = PCG(op, like, precond=lambda r: r / diag)

    def solve(rhs_weak, bc_val, stats=None):
        ub = (1.0 - mask) * bc_val
        b = msq * sem.dssum(mesh, rhs_weak - sem.helmholtz_local(mesh, ub, h1, h2))
        if b.shape != like.shape:
            raise ValueError(f"helmholtz solve: right-hand side {tuple(b.shape)}, the solver "
                             f"was built for {tuple(like.shape)}")
        y = linear_solve(cg, b, tol, maxiter, project=consistent, log=_logger(stats, "helmholtz"))
        return ub + mask * (y / sqw)

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


def make_pressure_solver(mesh: SemMesh, cfg: FlowConfig, dt_over_g0, pc=None):
    """Returns dp = solve(rhs, x0=None) for the E operator at fixed dt/g0.

    For enclosed flows (pure-Neumann pressure) the constant nullspace is
    projected out of the operator, the preconditioner and the RHS, and out
    of the CG's residual at every update (`PCG(project=)`). With a
    preconditioner, E is applied through its exact neighbor-block form, and
    the CG runs on element-first copies of the fields ([nel, np2], the
    layout of `pc.e_apply_ef` and `pc.apply_ef`). The CG iteration is built
    once per solver and, on the card, captured as a CUDA graph (`PCG`); the
    CG runs through `linear_solve`, so a reverse pass re-solves with it. E
    is symmetric, and its neighbor-block apply is one too under autograd
    (`tensor.linear`), so the warm start's backward is E again and not
    an atomic scatter-add."""
    pure = mesh.p_fixed
    proj = stokes.project_onto_range if pure else (lambda q: q)

    if pc is not None:
        e_apply = lambda q: linear(lambda v: pc.e_apply_ef(v, dt_over_g0), q)
        precond = lambda r: proj(pc.apply_ef(proj(r)))
        to_ef = lambda q: q.reshape(-1, mesh.nel).T.contiguous()
    else:
        e_apply = lambda q: stokes.e_op(mesh, q, dt_over_g0)
        precond = None
        to_ef = lambda q: q

    def op(dp):
        return proj(e_apply(proj(dp)))

    cg = PCG(op, to_ef(torch.zeros_like(mesh.bm2)), precond, project=proj if pure else None)

    def solve(rhs, x0=None, stats=None):
        """x0: optional warm start (e.g. the previous step's increment),
        entered as the shift dp = x0 + delta, E delta = rhs - E x0, so it
        reaches the solve through the right-hand side and the map stays
        linear. stats: optional dict; the CG's iteration count is appended
        to stats["pressure"] (and a recorded solve's backward appends its
        own)."""
        shape = rhs.shape
        rhs = to_ef(rhs)
        if x0 is not None:
            x0 = proj(to_ef(x0))
            rhs = rhs - e_apply(x0)
        dp = linear_solve(cg, proj(rhs), cfg.ptol, cfg.pmaxit, project=proj if pure else None,
                          log=_logger(stats, "pressure"))
        if x0 is not None:
            dp = dp + x0
        if pc is not None:
            dp = dp.T.reshape(shape).contiguous()
        if pure:
            dp = stokes.remove_pressure_mean(mesh, dp)
        return dp

    return solve
