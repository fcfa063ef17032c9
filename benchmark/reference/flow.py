"""The plain linearized Navier-Stokes propagator exp(tau A) and its exact
discrete adjoint, on a `mesh.RefMesh`.

A frozen, self-contained copy of the plain code paths behind the
exponential propagator of the benchmark's configurations: the P(N)/P(N-2)
BDF3/EXT3 fractional step about a frozen base flow, dealiased linearized
convection, Jacobi-preconditioned velocity CGs in the weighted
local-copies form, the pressure (E) CG with the block-Jacobi plus
element-constant coarse preconditioner, and the adjoint as autograd's
backward of one recorded propagate, every CG solve re-solved in the
backward. Every tensor op runs eagerly in the mesh's dtype; nothing is
captured, fused or hand-written. Imports nothing of the program.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from .mesh import RefMesh

# BDFk / EXTk coefficients (gamma0, beta_j for u^{n-j}); alpha_j for N^{n-j}
BDF = {1: (1.0, (1.0, 0.0, 0.0)), 2: (1.5, (2.0, -0.5, 0.0)),
       3: (11.0 / 6.0, (3.0, -1.5, 1.0 / 3.0))}
EXT = {1: (1.0, 0.0, 0.0), 2: (2.0, -1.0, 0.0), 3: (3.0, -3.0, 1.0)}


# ---------------------------------------------------------------------------
# tensor-product contractions (element-last fields)
# ---------------------------------------------------------------------------


def _axis(a, u, axis):
    shape = u.shape
    out = torch.matmul(a, u.reshape(shape[: axis + 1] + (-1,)))
    return out.reshape(shape[:axis] + (a.shape[0],) + shape[axis + 1:])


def _r(a, u):
    return torch.matmul(a, u)


def _s(a, u):
    return _axis(a, u, -3)


def _t(a, u):
    return _axis(a, u, -4)


def grad_rst(u, d, ndim):
    return (_r(d, u), _s(d, u)) if ndim == 2 else (_r(d, u), _s(d, u), _t(d, u))


def grad_rst_t(f, d, ndim):
    dt = d.T
    out = _r(dt, f[0]) + _s(dt, f[1])
    return out if ndim == 2 else out + _t(dt, f[2])


def interp(j, u, ndim):
    u = _s(j, _r(j, u))
    return u if ndim == 2 else _t(j, u)


def _sum(terms):
    out = None
    for t in terms:
        out = t if out is None else out + t
    return out


# ---------------------------------------------------------------------------
# assembled and element-local operators
# ---------------------------------------------------------------------------


def dssum(m: RefMesh, f: torch.Tensor) -> torch.Tensor:
    """Sum every element copy of each shared DOF into every copy (gather
    form: each copy gathers the copies of its DOF and sums them)."""
    lead = f.shape[: f.dim() - m.gidx.dim()]
    flat = torch.nn.functional.pad(f.reshape(lead + (-1,)), (0, 1))
    out = flat.index_select(-1, m.dss.view(-1)).view(lead + tuple(m.dss.shape)).sum(-1)
    return out.view(f.shape)


def dsavg(m: RefMesh, f):
    return dssum(m, f) * m.vmult


def helmholtz_local(m: RefMesh, u, h1, h2):
    """h1 A u + h2 B u, unassembled."""
    nd = m.ndim
    u = u.contiguous()
    du = grad_rst(u, m.d, nd)
    flux = tuple(_sum(m.g[a, b] * du[b] for b in range(nd)) for a in range(nd))
    return h1 * grad_rst_t(flux, m.d, nd) + h2 * m.bm1 * u


def grad_d(m: RefMesh, u):
    nd = m.ndim
    dd = [interp(m.jd, c, nd) for c in grad_rst(u, m.d, nd)]
    return torch.stack([_sum(m.rxd[a, j] * dd[a] for a in range(nd)) for j in range(nd)])


def lin_convect_cache(m: RefMesh, base_u):
    nd = m.ndim
    return (torch.stack([interp(m.jd, base_u[k], nd) for k in range(nd)]),
            torch.stack([grad_d(m, base_u[i]) for i in range(nd)]))


def convect_lin_weak(m: RefMesh, u, cache):
    """(phi_i, U . grad u_i) + (phi_i, u . grad U_i) on the dealias grid."""
    ud_base, gradud_base = cache
    nd, jd = m.ndim, m.jd
    u_d = [interp(jd, u[k], nd) for k in range(nd)]

    def one(field, grad_row):
        dd = [interp(jd, c, nd) for c in grad_rst(field, m.d, nd)]
        s = None
        for k in range(nd):
            g_k = _sum(m.rxd[a, k] * dd[a] for a in range(nd))
            term = ud_base[k] * g_k + u_d[k] * grad_row[k]
            s = term if s is None else s + term
        return interp(jd.T, s * m.bmd, nd)

    return torch.stack([one(u[i], gradud_base[i]) for i in range(nd)])


def _rx(m: RefMesh, nlead):
    return m.rx.reshape(m.rx.shape[:2] + (1,) * nlead + m.rx.shape[2:])


def div_weak(m: RefMesh, u):
    du = torch.stack(grad_rst(u, m.d, m.ndim))
    divu = (_rx(m, u.dim() - 1 - m.bm1.dim()) * du).sum((0, 1))
    return interp(m.j12, divu, m.ndim) * m.bm2


def grad_weak_t(m: RefMesh, p):
    w = interp(m.j12.T, p * m.bm2, m.ndim)
    f = _rx(m, p.dim() - m.bm2.dim()) * w
    return grad_rst_t(tuple(f), m.d, m.ndim)


def pressure_correct(m: RefMesh, dp, dt_over_g0):
    gp = grad_weak_t(m, dp)
    nlead = gp.dim() - m.vmask.dim()
    vmask = m.vmask.reshape(m.vmask.shape[:1] + (1,) * nlead + m.vmask.shape[1:])
    return dssum(m, gp) * vmask * m.binv * dt_over_g0


def e_op(m: RefMesh, dp, dt_over_g0):
    return div_weak(m, pressure_correct(m, dp, dt_over_g0))


def to_range(q):
    """Onto range(E): the constants are its nullspace (every face is a
    wall or periodic)."""
    return q - torch.mean(q)


def remove_mean(m: RefMesh, p):
    return p - torch.sum(p * m.bm2) / torch.sum(m.bm2)


# ---------------------------------------------------------------------------
# CG and the solve as a linear map whose backward re-solves
# ---------------------------------------------------------------------------


class CG:
    """Preconditioned CG, eager: stop at ||r||_2 <= tol (absolute) or at
    maxiter; the residual is read on the host every iteration."""

    def __init__(self, op, precond=None, project=None):
        self.op, self.project = op, project
        self.precond = precond if precond is not None else (lambda r: r)

    def solve(self, b, tol, maxiter):
        x = torch.zeros_like(b)
        r = b.clone()
        if self.project is not None:
            r = self.project(r)
        z = self.precond(r)
        p = z.clone()
        rz, rr = torch.sum(r * z), torch.sum(r * r)
        k = 0
        while True:
            rrf = float(rr)
            if not math.isfinite(rrf):
                raise FloatingPointError(f"CG: residual norm^2 {rrf} after {k} iterations")
            if k == maxiter or rrf <= tol * tol:
                return x, k
            ap = self.op(p)
            alpha = rz / torch.clamp_min(torch.sum(p * ap), 1e-300)
            x.addcmul_(alpha, p)
            r.addcmul_(alpha, ap, value=-1.0)
            if self.project is not None:
                r = self.project(r)
            z = self.precond(r)
            rz_new, rr = torch.sum(r * z), torch.sum(r * r)
            beta = rz_new / torch.clamp_min(rz, 1e-300)
            p = torch.addcmul(z, beta, p)
            rz = rz_new
            k += 1


class _Solve(torch.autograd.Function):
    """x = A^-1 b for a Euclidean-symmetric A: the backward solves the
    cotangent with the same CG (projected first, when A has a nullspace)."""

    @staticmethod
    def forward(ctx, b, solver):
        ctx.solver = solver
        return solver(b)

    @staticmethod
    def backward(ctx, g):
        return ctx.solver.transposed(g), None


class Solver:
    def __init__(self, cg: CG, tol, maxiter, key, project=None, log=None):
        self.cg, self.tol, self.maxiter, self.key = cg, tol, maxiter, key
        self.project, self.log = project, log

    def __call__(self, b):
        x, k = self.cg.solve(b, self.tol, self.maxiter)
        if self.log is not None:
            self.log.setdefault(self.key, []).append(k)
        return x

    def transposed(self, g):
        return self(self.project(g) if self.project is not None else g)

    def apply(self, b):
        if b.requires_grad and torch.is_grad_enabled():
            return _Solve.apply(b, self)
        return self(b)


def local_diagonal(op_local, shape, dtype, ndim, device, chunk_bytes=96 * 2**20):
    """Diagonal of an element-local operator, probed node by node in chunks."""
    pts = tuple(shape[-ndim - 1:-1])
    nel = shape[-1]
    npts = math.prod(pts)
    per_node = math.prod(shape) * torch.empty((), dtype=dtype).element_size()
    chunk = max(1, min(npts, chunk_bytes // per_node))
    eye = torch.eye(npts, dtype=dtype, device=device)
    vals = []
    for j0 in range(0, npts, chunk):
        k = min(chunk, npts - j0)
        e = eye[j0:j0 + k].reshape((k,) + pts + (1,))
        out = op_local(e.expand((k,) + tuple(shape)).contiguous()).reshape(k, npts, nel)
        idx = torch.arange(j0, j0 + k, device=device).reshape(k, 1, 1)
        vals.append(out.gather(1, idx.expand(k, 1, nel)).squeeze(1))
    return torch.cat(vals).reshape(pts + (nel,))


def helmholtz_diag(m: RefMesh, h1, h2):
    d = local_diagonal(lambda u: helmholtz_local(m, u, h1, h2), m.bm1.shape, m.dtype, m.ndim,
                       m.device)
    d = dssum(m, d)
    return m.vmask * d + (1.0 - m.vmask)


def velocity_solver(m: RefMesh, h1, h2, diag, tol, maxiter, log):
    """u = solve(rhs_weak), homogeneous Dirichlet, in the weighted
    local-copies form op(y) = y + sqw mask (dssum(H(mask t)) - t),
    t = dssum(sqw y)."""
    sqw = torch.sqrt(m.vmult)
    mask = m.vmask
    msq = mask * sqw

    def op(y):
        t = dssum(m, sqw * y)
        hv = dssum(m, helmholtz_local(m, mask * t, h1, h2))
        return torch.addcmul(y, msq, hv - t)

    solver = Solver(CG(op, precond=lambda r: r / diag), tol, maxiter, "helmholtz",
                    project=lambda y: sqw * dssum(m, sqw * y), log=log)

    def solve(rhs_weak):
        y = solver.apply(msq * dssum(m, rhs_weak))
        return mask * (y / sqw)

    return solve


# ---------------------------------------------------------------------------
# the pressure preconditioner: exact element blocks + element constants
# ---------------------------------------------------------------------------


def _adjacency(gidx_first: np.ndarray) -> list[set]:
    """Elements that share any global DOF."""
    nel = gidx_first.shape[0]
    owner = np.unique(np.stack([gidx_first.reshape(-1),
                                np.repeat(np.arange(nel), gidx_first.shape[1])], 1), axis=0)
    adj = [set() for _ in range(nel)]
    dof, el = owner[:, 0], owner[:, 1]
    starts = np.flatnonzero(np.r_[True, dof[1:] != dof[:-1]])
    ends = np.r_[starts[1:], len(dof)]
    for s, e in zip(starts, ends):
        els = el[s:e].tolist()
        for a in els:
            adj[a].update(els)
    for a in range(nel):
        adj[a].discard(a)
    return adj


def _greedy(adj) -> np.ndarray:
    colors = -np.ones(len(adj), np.int64)
    for v in range(len(adj)):
        used = {colors[u] for u in adj[v] if colors[u] >= 0}
        c = 0
        while c in used:
            c += 1
        colors[v] = c
    return colors


def _square(adj):
    out = []
    for v, nb in enumerate(adj):
        s = set(nb)
        for u in nb:
            s |= adj[u]
        s.discard(v)
        out.append(s)
    return out


@dataclasses.dataclass
class Precond:
    blocks_inv: torch.Tensor  # [nel, np2, np2]
    ec_inv: torch.Tensor  # [nel, nel]

    def apply(self, r):
        """P^-1 r on one element-last pressure field."""
        rf = r.reshape(-1, r.shape[-1]).T
        out = torch.bmm(self.blocks_inv, rf.unsqueeze(-1)).squeeze(-1)
        out = out + (self.ec_inv @ rf.sum(1))[:, None]
        return out.T.reshape(r.shape)


def build_precond(m: RefMesh, probe_bytes=128e6) -> Precond:
    """Block Jacobi (E's exact element blocks, probed with an element
    colouring, symmetrized, shifted by 1e-8 of their mean diagonal and
    inverted) plus the element-constant coarse space (R E R^T probed with a
    distance-3 colouring, its constant nullspace shifted), both at
    dt/g0 = 1."""
    np2 = int(np.prod(m.bm2.shape[:-1]))
    nel, dt_, dev = m.nel, m.dtype, m.device
    adj = _adjacency(m.gidx.cpu().numpy().reshape(-1, nel).T)
    colors2 = _greedy(adj)
    chunk = max(1, min(np2, int(probe_bytes / (np2 * nel * 4))))
    eye = torch.eye(np2, dtype=dt_, device=dev)
    blocks = torch.zeros((nel, np2, np2), dtype=dt_, device=dev)
    for c in range(int(colors2.max()) + 1):
        mask = torch.as_tensor(colors2 == c, dtype=dt_, device=dev)
        for j0 in range(0, np2, chunk):
            q = eye[j0:j0 + chunk, :, None] * mask
            k = q.shape[0]
            cols = e_op(m, q.reshape((k,) + tuple(m.bm2.shape)), 1.0)
            blocks[:, :, j0:j0 + k] += (cols.reshape(k, np2, nel) * mask).permute(2, 1, 0)
    b = blocks.to(torch.float64)
    b = 0.5 * (b + b.transpose(1, 2))
    tr = torch.diagonal(b, dim1=1, dim2=2).mean(-1)
    b = b + (1e-8 * torch.clamp_min(tr, 1e-30))[:, None, None] * torch.eye(np2, dtype=b.dtype,
                                                                          device=dev)
    blocks_inv = torch.linalg.inv(b).to(dt_)

    colors3 = _greedy(_square(adj))
    ncol3 = int(colors3.max()) + 1
    cmask = torch.as_tensor(colors3[None, :] == np.arange(ncol3)[:, None], dtype=dt_,
                            device=dev)
    cchunk = max(1, int(probe_bytes / (np2 * nel * 4)))
    outs = []
    for c0 in range(0, ncol3, cchunk):
        q = cmask[c0:c0 + cchunk, None, :].expand(-1, np2, -1)
        k = q.shape[0]
        out = e_op(m, q.reshape((k,) + tuple(m.bm2.shape)), 1.0)
        outs.append(out.reshape(k, np2, nel).sum(1))
    outs = torch.cat(outs).cpu().numpy().astype(np.float64)
    ec = np.zeros((nel, nel))
    for c in range(ncol3):
        for g in np.nonzero(colors3 == c)[0]:
            for g2 in {int(g)} | adj[g]:
                ec[g2, g] = outs[c, g2]
    ec = 0.5 * (ec + ec.T)
    ec = ec + np.abs(np.diag(ec)).mean() * np.ones_like(ec) / nel
    return Precond(blocks_inv=blocks_inv,
                   ec_inv=torch.as_tensor(np.linalg.inv(ec), dtype=dt_, device=dev))


def pressure_solver(m: RefMesh, pc: Precond, dt_over_g0, tol, maxiter, log):
    """dp = solve(rhs, x0): E dp = rhs from the warm start x0, the mean
    removed."""

    def op(q):
        return to_range(e_op(m, q, dt_over_g0))

    solver = Solver(CG(op, precond=lambda r: to_range(pc.apply(r)), project=to_range), tol,
                    maxiter, "pressure", project=to_range, log=log)

    def solve(rhs, x0):
        x0 = to_range(x0)
        rhs = to_range(rhs - e_op(m, x0, dt_over_g0))
        dp = solver.apply(rhs) + x0
        return remove_mean(m, dp)

    return solve


# ---------------------------------------------------------------------------
# the propagator
# ---------------------------------------------------------------------------


def cfl_dt(x_host: np.ndarray, base_u: np.ndarray, cfl: float = 0.5) -> float:
    """The largest dt at the CFL target: the least over the nodes of the
    node's smallest GLL gap over the base flow's speed there."""
    ndim = x_host.shape[0]
    d2 = None
    for ax in range(ndim):
        a = x_host.ndim - 2 - ax
        dist = np.sqrt((np.diff(x_host, axis=a) ** 2).sum(axis=0))
        ad = a - 1
        lo = np.concatenate([dist.take([0], axis=ad), dist], axis=ad)
        hi = np.concatenate([dist, dist.take([-1], axis=ad)], axis=ad)
        sp = np.minimum(lo, hi)
        d2 = sp if d2 is None else np.minimum(d2, sp)
    speed = np.sqrt((base_u**2).sum(axis=0))
    return float(cfl * (d2 / np.maximum(speed, 1e-12)).min())


def horizon(tau: float, dt_max: float) -> tuple[float, int]:
    nsteps = max(1, math.ceil(tau / dt_max - 1e-12))
    return tau / nsteps, nsteps


class Propagator:
    """M = exp(tau A) of the linearized equations about base_u, at the
    solve tolerances vtol, ptol (the adjoint at adjoint_factor times them),
    dt from CFL 0.5 against the base flow unless given."""

    def __init__(self, m: RefMesh, base_u, nu, tau, vtol, ptol, vmaxit, pmaxit, dt=None,
                 adjoint_factor=0.1, pc: Precond | None = None):
        self.m, self.nu, self.tau = m, float(nu), float(tau)
        self.base_u = torch.as_tensor(base_u, dtype=m.dtype, device=m.device)
        if dt is None:
            dt = cfl_dt(m.x_host, np.asarray(base_u, dtype=np.float64))
        self.dt, self.nsteps = horizon(tau, dt)
        self.pc = build_precond(m) if pc is None else pc
        self.vdiag = helmholtz_diag(m, self.nu, BDF[3][0] / self.dt)
        self.cache = lin_convect_cache(m, self.base_u)
        self.tols = (vtol, ptol, vmaxit, pmaxit)
        self.adjoint_factor = adjoint_factor
        self.log: dict = {}
        self._tape = None

    def _solvers(self, f):
        vtol, ptol, vmaxit, pmaxit = self.tols
        m = self.m
        vs = {o: velocity_solver(m, self.nu, BDF[o][0] / self.dt, self.vdiag, vtol * f, vmaxit,
                                 self.log) for o in (1, 2, 3)}
        ps = {o: pressure_solver(m, self.pc, self.dt / BDF[o][0], ptol * f, pmaxit, self.log)
              for o in (1, 2, 3)}
        return vs, ps

    def _propagate(self, u0, f=1.0):
        m, dt = self.m, self.dt
        vs, ps = self._solvers(f)
        z = lambda *s: torch.zeros(s + tuple(m.bm1.shape), dtype=m.dtype, device=m.device)
        nd = m.ndim
        u, p = u0, torch.zeros_like(m.bm2)
        ulag, nlag, plag = z(2, nd), z(2, nd), torch.zeros_like(m.bm2)[None]
        for k in range(self.nsteps):
            order = min(k + 1, 3)
            g0, betas = BDF[order]
            alphas = EXT[order]
            n_u = -convect_lin_weak(m, u, self.cache)
            nstar = alphas[0] * n_u + alphas[1] * nlag[0] + alphas[2] * nlag[1]
            bsum = betas[0] * u + betas[1] * ulag[0] + betas[2] * ulag[1]
            rhs = m.bm1 * bsum * (1.0 / dt) + nstar + grad_weak_t(m, p)
            ustar = vs[order](rhs)
            dt_over_g0 = dt / g0
            dp = ps[order](-div_weak(m, ustar), p - plag[0])
            u_new = ustar + pressure_correct(m, dp, dt_over_g0)
            ulag = torch.cat([u[None], ulag[:-1]], dim=0)
            nlag = torch.cat([n_u[None], nlag[:-1]], dim=0)
            plag = p[None]
            u, p = u_new, p + dp
        return u

    def matvec(self, u0):
        with torch.no_grad():
            return self._propagate(u0)

    def rmatvec(self, v):
        """The exact B-adjoint vmask Bhat^-1 dssum(M^T (B v)) of the
        propagate at adjoint_factor times the tolerances, M^T the backward
        of one recorded propagate (linear, so one tape serves every call)."""
        m = self.m
        if self._tape is None:
            x = torch.zeros((m.ndim,) + tuple(m.bm1.shape), dtype=m.dtype, device=m.device,
                            requires_grad=True)
            with torch.enable_grad():
                self._tape = (x, self._propagate(x, self.adjoint_factor))
        x, y = self._tape
        iu = m.bm1 * v
        c = torch.sqrt(torch.sum(v * v)) / torch.clamp_min(torch.sqrt(torch.sum(iu * iu)),
                                                           torch.finfo(v.dtype).tiny)
        (w,) = torch.autograd.grad(y, x, grad_outputs=c * iu, retain_graph=True)
        return m.vmask * m.binv * dssum(m, w) / c
