"""Time-domain resolvent operator R = (i omega - A)^{-1}.

Vectors are complex pairs {re: {u, theta}, im: {u, theta}}. matvec is the
reference's three-stage algorithm:

  1. b = G(f): integrate the linearized equations from zero over one period
     tau = 2 pi / omega with the harmonic force Re[f e^{i w t}];
  2. solve (I - exp(tau A)) x_re = b by GMRES over the real flow space (the
     periodic-response condition); x_re = Re[x_hat];
  3. the imaginary part from a quarter-period forced propagation:
     x(tau/4) = Re[x_hat e^{i pi/2}] = -Im[x_hat].

rmatvec is the exact Hermitian adjoint of this discrete pipeline:

  R* g = G* S* (g_re - Qh* g_im) - Qf* g_im

with S* GMRES on (I - exp(tau A)*) over the exact discrete adjoint
propagator, Qh* the quarter-period one, and G*, Qf* the mass-weighted
transposes of the forced propagations. Counterpart of
`neklab_tpu.linops.resolvent`, which takes G* and Qf* from
`jax.linear_transpose`; here each forced propagation is recorded once on
autograd's tape from a zero force and initial condition (every CG exits at
iteration 0) and every call is a backward of it, as `make_adjoint_propagator`
does for `propagate`.

dt = tau / nsteps differs for each omega, and every CG is a `PCG` built
for its dt, so each Resolvent builds its own solver set, which its direct
and adjoint propagations all share. One E preconditioner serves a whole
frequency sweep (`pc_e=`): E(dt) = (dt/g0) E(1) and CG is invariant to a
scaling of its preconditioner.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from ..krylov.gmres import gmres
from ..krylov.linop import FunctionOperator, LinearOperator
from ..krylov.space import VectorSpace, tree_axpby
from ..mesh.core import SemMesh
from ..models import navier_stokes as ns
from ..models.linearized import LinConfig, make_adjoint_propagator, propagate, propagate_forced
from ..models.precond import build_e_preconditioner
from ..ops import sem
from ..utils.timestep import cfl_dt, horizon_steps
from ..vectors import flow_vector_space


def complex_pair_space(mesh: SemMesh, nscal: int) -> VectorSpace:
    """Real dot over {re, im} pairs = Re<x, y>_H of the Hermitian mass inner
    product (the realification svds uses for resolvent analysis). On a
    rank's block the dot is global (`flow_vector_space`) and the space
    carries the partition, as the flow space does."""
    base = flow_vector_space(mesh, nscal)

    def dot_fn(x, y):
        return base.dot_fn(x["re"], y["re"]) + base.dot_fn(x["im"], y["im"])

    def rand_fn(seed: int):
        return {"re": base.rand_fn(2 * int(seed)), "im": base.rand_fn(2 * int(seed) + 1)}

    return VectorSpace(dot_fn=dot_fn, rand_fn=rand_fn, part=base.part)


class Resolvent(LinearOperator):
    def __init__(
        self,
        mesh: SemMesh,
        cfg: LinConfig,
        base_u,
        base_theta=None,
        omega: float = 1.0,
        cfl: float = 0.5,
        dt: float | None = None,
        gmres_kdim: int = 64,
        gmres_rtol: float = 1e-6,
        gmres_atol: float = 1e-12,
        precondition: bool = True,
        pc_e=None,
    ):
        """dt: the largest step (from the CFL target against the base flow
        when None); the step is tau / nsteps with nsteps a multiple of 4, so
        the quarter period lands on a step. pc_e: a prebuilt E
        preconditioner, to share across a sweep; built here when None and
        `precondition`."""
        self.mesh = mesh
        self.omega = float(omega)
        self.tau = 2.0 * math.pi / self.omega
        self.base_u = base_u
        self.base_theta = (
            base_theta
            if base_theta is not None
            else torch.zeros((cfg.nscal,) + tuple(mesh.bm1.shape), dtype=mesh.dtype,
                             device=mesh.device)
        )
        if dt is None:
            dt = cfl_dt(mesh, base_u, cfl=cfl)
        dt, nsteps = horizon_steps(self.tau, dt)
        nsteps = 4 * max(1, math.ceil(nsteps / 4))
        self.nsteps = nsteps
        self.nq = nsteps // 4
        self.dt = self.tau / nsteps
        self.cfg = dataclasses.replace(cfg, flow=dataclasses.replace(cfg.flow, dt=self.dt))
        self.gmres_kdim = gmres_kdim
        self.gmres_rtol = gmres_rtol
        self.gmres_atol = gmres_atol

        fc = self.cfg.flow
        self.pc_e = pc_e
        if precondition and self.pc_e is None:
            self.pc_e = build_e_preconditioner(mesh)
        self.vdiag, self.tdiags = ns.bdf3_diags(mesh, fc)
        orders = ns.bdf_orders(fc, nsteps)
        self.solvers = dict(pc_e=self.pc_e, vdiag=self.vdiag, tdiags=self.tdiags,
                            psolves=ns.pressure_solvers(mesh, fc, orders, self.pc_e),
                            vsolves=ns.velocity_solvers(mesh, fc, orders, self.vdiag,
                                                        self.tdiags))
        self.space = flow_vector_space(mesh, cfg.nscal)
        self._adjM = None
        self._adjQ = None
        self._transposes: dict = {}
        self.last_gmres_matvecs = None

    # -- linear pieces -------------------------------------------------------

    def _M(self, x: dict) -> dict:
        u, th = propagate(self.mesh, self.cfg, self.base_u, self.base_theta, x["u"], x["theta"],
                          self.nsteps, **self.solvers)
        return {"u": u, "theta": th}

    def _Mdag(self, x: dict) -> dict:
        if self._adjM is None:
            self._adjM = make_adjoint_propagator(self.mesh, self.cfg, self.base_u,
                                                 self.base_theta, self.nsteps, **self.solvers)
        u, th = self._adjM(x["u"], x["theta"])
        return {"u": u, "theta": th}

    def _zeros(self) -> dict:
        shape = tuple(self.mesh.bm1.shape)
        kw = dict(dtype=self.mesh.dtype, device=self.mesh.device)
        return {"u": torch.zeros((self.mesh.ndim,) + shape, **kw),
                "theta": torch.zeros((self.cfg.nscal,) + shape, **kw)}

    def _forced(self, u0, th0, f_re, f_im, nsteps, sign=1):
        return propagate_forced(
            self.mesh, self.cfg, self.base_u, self.base_theta, u0, th0,
            f_re["u"], f_im["u"], self.omega, nsteps, sign=sign,
            s_re=f_re["theta"], s_im=f_im["theta"], **self.solvers)

    def _G(self, f_re, f_im):
        z = self._zeros()
        u, th = self._forced(z["u"], z["theta"], f_re, f_im, self.nsteps)
        return {"u": u, "theta": th}

    def _Qf(self, f_re, f_im):
        z = self._zeros()
        u, th = self._forced(z["u"], z["theta"], f_re, f_im, self.nq)
        return {"u": u, "theta": th}

    def _pair_transpose(self, name: str):
        """The mass-weighted transpose g -> (f_re, f_im) of G or Qf: the
        forced propagation recorded once from a zero force (its tape is the
        map's transpose, the force enters it linearly), a backward per call,
        then the vmask Binv dssum projection onto admissible fields."""
        if name not in self._transposes:
            fn = {"G": self._G, "Qf": self._Qf}[name]
            pair = [{k: v.requires_grad_(True) for k, v in self._zeros().items()}
                    for _ in range(2)]
            with torch.enable_grad():
                out = fn(*pair)
            leaves = [pair[0]["u"], pair[0]["theta"], pair[1]["u"], pair[1]["theta"]]
            self._transposes[name] = (leaves, (out["u"], out["theta"]))
        leaves, outputs = self._transposes[name]
        mesh = self.mesh

        def apply(g):
            seeds = (mesh.bm1 * g["u"], mesh.bm1 * g["theta"])
            live = [(o, s) for o, s in zip(outputs, seeds) if o.requires_grad]
            grads = torch.autograd.grad([o for o, _ in live], leaves, [s for _, s in live],
                                        retain_graph=True, allow_unused=True)
            a_u, a_t, b_u, b_t = (torch.zeros_like(x) if d is None else d
                                  for d, x in zip(grads, leaves))
            proj = lambda du, dt_: {"u": mesh.vmask * mesh.binv * sem.dssum(mesh, du),
                                    "theta": mesh.tmask * mesh.binv * sem.dssum(mesh, dt_)}
            return proj(a_u, a_t), proj(b_u, b_t)

        return apply

    def _solve(self, b: dict, adjoint: bool, x0: dict | None = None) -> dict:
        mv = self._Mdag if adjoint else self._M
        op = FunctionOperator(lambda x: tree_axpby(1.0, x, -1.0, mv(x)))
        sol = gmres(op, b, self.space, x0=x0, kdim=self.gmres_kdim, rtol=self.gmres_rtol,
                    atol=self.gmres_atol, max_restarts=4)
        self.last_gmres_matvecs = sol.n_matvec
        return sol.x

    # -- the operator --------------------------------------------------------

    def matvec(self, f: dict, x0: dict | None = None) -> dict:
        """x0: optional warm start of the periodic-response GMRES solve
        (e.g. the previous frequency's x_re in a sweep)."""
        b = self._G(f["re"], f["im"])
        x_re = self._solve(b, adjoint=False, x0=x0)
        uq, thq = self._forced(x_re["u"], x_re["theta"], f["re"], f["im"], self.nq)
        return {"re": x_re, "im": {"u": -uq, "theta": -thq}}

    def rmatvec(self, g: dict) -> dict:
        # R* g = G* S* (g_re - Qh* g_im) - Qf* g_im; the adjoint quarter-period
        # propagator Qh* is recorded once and kept
        if self._adjQ is None:
            self._adjQ = make_adjoint_propagator(self.mesh, self.cfg, self.base_u,
                                                 self.base_theta, self.nq, **self.solvers)
        qh_u, qh_t = self._adjQ(g["im"]["u"], g["im"]["theta"])
        rhs = {"u": g["re"]["u"] - qh_u, "theta": g["re"]["theta"] - qh_t}
        y = self._solve(rhs, adjoint=True)
        f1_re, f1_im = self._pair_transpose("G")(y)
        f2_re, f2_im = self._pair_transpose("Qf")(g["im"])
        return {"re": tree_axpby(1.0, f1_re, -1.0, f2_re),
                "im": tree_axpby(1.0, f1_im, -1.0, f2_im)}
