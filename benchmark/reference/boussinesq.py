"""The plain linearized Boussinesq propagator exp(tau A): velocity and one
temperature about a frozen (U, Theta), on a `mesh.RefMesh`.

The step of `flow.Propagator` (BDF3/EXT3, the P(N)/P(N-2) splitting, the
velocity and pressure CGs, built from flow.py's helpers by import) with a
temperature beside the velocity:
  * the buoyancy Ra Pr theta along y, explicit, added to the velocity's
    explicit terms as its weak (mass-weighted) force;
  * the scalar's linearized convection (q, U . grad theta) + (q, u . grad
    Theta) on the dealias grid, extrapolated like the velocity's;
  * a Jacobi CG per step for (kappa A + g0/dt B) theta in the weighted
    local-copies form, held to 0 where the temperature is given (the mask
    of `temperature_mask`), after the velocity's pressure correction.
Fields are [ndim + 1, pts..., nel], the temperature last. Every tensor op
runs eagerly in the mesh's dtype. Imports nothing of the program.

Departures from the program: none in the arithmetic. Its explicit terms
are one batched convection of the velocity with the scalar beside it;
here each field is convected on its own (the same products, in another
order of launches). There is no adjoint: no cell asks for one.
"""

from __future__ import annotations

import numpy as np
import torch

from . import flow
from .flow import BDF, EXT
from .mesh import RefMesh


def temperature_mask(x: np.ndarray, lims, bc_temp: dict) -> np.ndarray:
    """0 at the nodes of the box's faces whose temperature is given ('t'),
    1 elsewhere; x the node coordinates [ndim, pts..., nel]."""
    mask = np.ones(x.shape[1:])
    for face, kind in bc_temp.items():
        if kind.lower() != "t":
            continue
        d, side = "xyz".index(face[0]), int(face[1] == "+")
        span = abs(lims[d][1] - lims[d][0])
        mask[np.abs(x[d] - lims[d][side]) <= 1e-12 * span] = 0.0
    return mask


def scalar_diag(m: RefMesh, tmask, h1, h2):
    """Jacobi diagonal of the temperature's masked assembled Helmholtz
    operator (1 where the temperature is given)."""
    d = flow.local_diagonal(lambda u: flow.helmholtz_local(m, u, h1, h2), m.bm1.shape, m.dtype,
                            m.ndim, m.device)
    d = flow.dssum(m, d)
    return tmask * d + (1.0 - tmask)


def scalar_solver(m: RefMesh, tmask, h1, h2, diag, tol, maxiter, log):
    """theta = solve(rhs_weak), 0 where the temperature is given: the
    velocity solver's weighted local-copies form with the temperature's
    mask."""
    sqw = torch.sqrt(m.vmult)
    msq = tmask * sqw

    def op(y):
        t = flow.dssum(m, sqw * y)
        hv = flow.dssum(m, flow.helmholtz_local(m, tmask * t, h1, h2))
        return torch.addcmul(y, msq, hv - t)

    solver = flow.Solver(flow.CG(op, precond=lambda r: r / diag), tol, maxiter, "scalar",
                         project=lambda y: sqw * flow.dssum(m, sqw * y), log=log)

    def solve(rhs_weak):
        y = solver.apply(msq * flow.dssum(m, rhs_weak))
        return tmask * (y / sqw)

    return solve


def convect_scalar_lin_weak(m: RefMesh, u, theta, ud_base, gradt_base):
    """(q, U . grad theta) + (q, u . grad Theta) on the dealias grid;
    ud_base the base velocity there, gradt_base grad Theta there."""
    nd, jd = m.ndim, m.jd
    dd = [flow.interp(jd, c, nd) for c in flow.grad_rst(theta, m.d, nd)]
    s = None
    for k in range(nd):
        g_k = flow._sum(m.rxd[a, k] * dd[a] for a in range(nd))
        term = ud_base[k] * g_k + flow.interp(jd, u[k], nd) * gradt_base[k]
        s = term if s is None else s + term
    return flow.interp(jd.T, s * m.bmd, nd)


class Propagator(flow.Propagator):
    """M = exp(tau A) of the linearized Boussinesq equations about base
    [ndim + 1, pts..., nel] (U, then Theta): viscosity nu, conductivity
    kappa, the buoyancy ra_pr theta along y, the step dt given, the
    velocity and pressure solves at vtol, ptol, the temperature's at ttol
    (vmaxit iterations at most, as the velocity's)."""

    def __init__(self, m: RefMesh, base, tmask, nu, kappa, ra_pr, tau, dt, vtol, ptol, ttol,
                 vmaxit, pmaxit, pc: flow.Precond | None = None):
        nd = m.ndim
        base = np.asarray(base)
        super().__init__(m, base[:nd], nu, tau, vtol, ptol, vmaxit, pmaxit, dt=dt, pc=pc)
        self.tmask = torch.as_tensor(tmask, dtype=m.dtype, device=m.device)
        self.kappa, self.ra_pr, self.ttol = float(kappa), float(ra_pr), ttol
        base_t = torch.as_tensor(base[nd], dtype=m.dtype, device=m.device)
        self.gradt = flow.grad_d(m, base_t)
        self.tdiag = scalar_diag(m, self.tmask, self.kappa, BDF[3][0] / self.dt)

    def _propagate(self, x0, f=1.0):
        m, dt, nd = self.m, self.dt, self.m.ndim
        vs, ps = self._solvers(f)
        ts = {o: scalar_solver(m, self.tmask, self.kappa, BDF[o][0] / dt, self.tdiag,
                               self.ttol * f, self.tols[2], self.log) for o in (1, 2, 3)}
        z = lambda *s: torch.zeros(s + tuple(m.bm1.shape), dtype=m.dtype, device=m.device)
        up = torch.zeros(nd, dtype=m.dtype, device=m.device)
        up[1] = self.ra_pr
        up = up.reshape((nd,) + (1,) * m.bm1.dim())
        u, th, p = x0[:nd], x0[nd], torch.zeros_like(m.bm2)
        ulag, nlag, tlag, ntlag = z(2, nd), z(2, nd), z(2), z(2)
        plag = torch.zeros_like(m.bm2)[None]
        for k in range(self.nsteps):
            order = min(k + 1, 3)
            g0, betas = BDF[order]
            alphas = EXT[order]
            n_u = -flow.convect_lin_weak(m, u, self.cache) + m.bm1 * (up * th)
            n_t = -convect_scalar_lin_weak(m, u, th, self.cache[0], self.gradt)
            nstar = alphas[0] * n_u + alphas[1] * nlag[0] + alphas[2] * nlag[1]
            bsum = betas[0] * u + betas[1] * ulag[0] + betas[2] * ulag[1]
            rhs = m.bm1 * bsum * (1.0 / dt) + nstar + flow.grad_weak_t(m, p)
            ustar = vs[order](rhs)
            dp = ps[order](-flow.div_weak(m, ustar), p - plag[0])
            u_new = ustar + flow.pressure_correct(m, dp, dt / g0)
            ntstar = alphas[0] * n_t + alphas[1] * ntlag[0] + alphas[2] * ntlag[1]
            tbsum = betas[0] * th + betas[1] * tlag[0] + betas[2] * tlag[1]
            th_new = ts[order](m.bm1 * tbsum * (1.0 / dt) + ntstar)
            ulag = torch.cat([u[None], ulag[:-1]], dim=0)
            nlag = torch.cat([n_u[None], nlag[:-1]], dim=0)
            tlag = torch.cat([th[None], tlag[:-1]], dim=0)
            ntlag = torch.cat([n_t[None], ntlag[:-1]], dim=0)
            plag = p[None]
            u, th, p = u_new, th_new, p + dp
        return torch.cat([u, th[None]])

    def rmatvec(self, v):
        raise NotImplementedError("the Boussinesq reference has no adjoint: no cell asks for one")
