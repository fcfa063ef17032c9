"""Port parity: GMRES, Newton-Krylov and the fixed-point system.

The fixture is tests/test_systems.py's forced channel ((3, 2) elements at
order 5, nu = 0.1, body force 2 nu, vtol = ptol = 1e-12, tau 0.4 or 0.5,
dt = 0.025), whose fixed point is u = (1 - y^2, 0). Inputs are
numpy-seeded and go through both packages, f64 on the CPU. Tolerances:
  * dense gmres, fgmres and cg: the reference's solution to 1e-10 (same
    algorithm, same host least squares), numpy.linalg.solve to 1e-8;
  * the system's response and the frozen and exact Jacobians' matvec and
    rmatvec: 1e-9 absolute (inner solves at 1e-12 over 16-20 steps);
  * newton_fixed_point_iteration, exact and frozen Jacobian: the
    reference's iteration count, and its |F| history to 1e-6 relative
    wherever |F| > 1e3 tol (below that, the 1e-12 inner solves set |F|);
    residual.dat in the reference's format.
The reuse of what a solve costs to build: across three Newton iterations the
system builds one E preconditioner and, per (dt, nsteps), one velocity and
one pressure CG per BDF order, which the responses, the Jacobian matvecs and
rmatvecs share.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neklab_tpu.analysis import newton_fixed_point_iteration as jnewton_fp
from neklab_tpu.krylov import FunctionOperator as JFunctionOperator
from neklab_tpu.krylov import euclidean_space
from neklab_tpu.krylov.gmres import cg as jcg
from neklab_tpu.krylov.gmres import fgmres as jfgmres
from neklab_tpu.krylov.gmres import gmres as jgmres
from neklab_tpu.mesh.box import box_mesh as jbox_mesh
from neklab_tpu.models.linearized import LinConfig as JLinConfig
from neklab_tpu.models.navier_stokes import FlowConfig as JFlowConfig
from neklab_tpu.ops import sem as jsem
from neklab_tpu.systems.fixed_point import FixedPointSystem as JFixedPointSystem
from neklab_tpu.vectors import flow_vector_space as jspace_of
from neklab_tpu_torch import analysis
from neklab_tpu_torch.krylov import gmres as kg
from neklab_tpu_torch.krylov.linop import FunctionOperator, LinearOperator, NonlinearSystem
from neklab_tpu_torch.krylov.newton import constant_tol, dynamic_tol, newton
from neklab_tpu_torch.krylov.space import (VectorSpace, tree_add, tree_axpby, tree_sub,
                                           tree_zeros_like)
from neklab_tpu_torch.mesh.box import box_mesh
from neklab_tpu_torch.models import navier_stokes as ns
from neklab_tpu_torch.models import precond, solvers
from neklab_tpu_torch.models.linearized import LinConfig
from neklab_tpu_torch.ops import sem
from neklab_tpu_torch.systems import fixed_point
from neklab_tpu_torch.systems.fixed_point import FixedPointSystem
from neklab_tpu_torch.vectors import flow_vector, flow_vector_space
from torch_port_helpers import CHANNEL_BC, absdiff, t, to_np

NU = 0.1
MESH = dict(nels=(3, 2), lims=((0, 2.0), (-1, 1)), bc=CHANNEL_BC, order=5)
FLOW = dict(viscosity=NU, dt=0.02, vtol=1e-12, ptol=1e-12)


# ---------------------------------------------------------------------------
# vectors, operators, dense Krylov solves
# ---------------------------------------------------------------------------


def test_tree_ops_and_operator_apply():
    rng = np.random.default_rng(0)
    x = {"a": t(rng.standard_normal(3)), "b": t(rng.standard_normal((2, 2)))}
    y = {"a": t(rng.standard_normal(3)), "b": t(rng.standard_normal((2, 2)))}
    for k in x:
        assert torch.equal(tree_add(x, y)[k], x[k] + y[k])
        assert torch.equal(tree_sub(x, y)[k], x[k] - y[k])
        assert torch.equal(tree_axpby(2.0, x, -3.0, y)[k], 2.0 * x[k] - 3.0 * y[k])
        assert torch.equal(tree_zeros_like(x)[k], torch.zeros_like(x[k]))
    op = FunctionOperator(matvec=lambda v: tree_axpby(2.0, v, 0.0, v),
                          rmatvec=lambda v: tree_axpby(3.0, v, 0.0, v))
    assert torch.equal(op.apply(x)["a"], 2.0 * x["a"])
    assert torch.equal(op.apply(x, adjoint=True)["a"], 3.0 * x["a"])
    for fn in (LinearOperator().matvec, NonlinearSystem().response, NonlinearSystem().jacobian):
        with pytest.raises(NotImplementedError):
            fn(x)


def _dense(kind, n=40, seed=0):
    rng = np.random.default_rng(seed)
    if kind == "spd":
        q = rng.standard_normal((n, n))
        return q @ q.T / n + np.eye(n), rng.standard_normal(n)
    return np.eye(n) + 0.4 * rng.standard_normal((n, n)) / np.sqrt(n), rng.standard_normal(n)


def _both(a):
    aj, at_ = jnp.asarray(a), t(a)
    jop = JFunctionOperator(matvec=lambda x: aj @ x, rmatvec=lambda x: aj.T @ x)
    op = FunctionOperator(matvec=lambda x: {"x": at_ @ x["x"]},
                          rmatvec=lambda x: {"x": at_.T @ x["x"]})
    space = VectorSpace(dot_fn=lambda x, y: (x["x"] * y["x"]).sum(-1))
    return jop, euclidean_space(), op, space


@pytest.mark.parametrize("kind, method", [
    (kind, method) for kind in ("spd", "nonsymmetric") for method in ("gmres", "fgmres",
                                                                      "gmres-adjoint")
] + [("spd", "cg")])
def test_dense_krylov_solves_match_reference(kind, method):
    """kdim 12 with restarts (GMRES), a Jacobi preconditioner (fgmres), the
    transposed system (adjoint=True) and CG on the SPD matrix: the
    reference's iterates and numpy.linalg.solve."""
    a, b = _dense(kind)
    jop, jspace, op, space = _both(a)
    kw = dict(rtol=1e-11, atol=1e-14)
    if method == "cg":
        ref = jcg(jop, jnp.asarray(b), jspace, maxiter=200, **kw)
        res = kg.cg(op, {"x": t(b)}, space, maxiter=200, **kw)
    elif method == "fgmres":
        d = np.diag(a)
        ref = jfgmres(jop, jnp.asarray(b), jspace, precond=lambda v: v / jnp.asarray(d), kdim=12,
                      max_restarts=20, **kw)
        res = kg.fgmres(op, {"x": t(b)}, space, precond=lambda v: {"x": v["x"] / t(d)},
                        kdim=12, max_restarts=20, **kw)
    else:
        adjoint = method == "gmres-adjoint"
        ref = jgmres(jop, jnp.asarray(b), jspace, kdim=12, max_restarts=20, adjoint=adjoint, **kw)
        res = kg.gmres(op, {"x": t(b)}, space, kdim=12, max_restarts=20, adjoint=adjoint, **kw)
        a = a.T if adjoint else a
    assert res.converged and ref.converged
    assert (res.n_matvec, res.n_restart) == (ref.n_matvec, ref.n_restart)
    assert absdiff(res.x["x"], ref.x) <= 1e-10
    assert np.abs(to_np(res.x["x"]) - np.linalg.solve(a, b)).max() <= 1e-8
    assert isinstance(res, kg.GmresResult)


def test_newton_on_a_small_system():
    """F(x) = x^3 - c with its exact Jacobian: quadratic convergence, the
    constant and dynamic schedulers, the callback."""
    c = t(np.array([2.0, 5.0, 0.5]))

    class Cubic(NonlinearSystem):
        def response(self, x):
            return {"x": x["x"] ** 3 - c}

        def jacobian(self, x):
            d = 3 * x["x"] ** 2
            return FunctionOperator(matvec=lambda v: {"x": d * v["x"]})

    space = VectorSpace(dot_fn=lambda x, y: (x["x"] * y["x"]).sum(-1))
    seen = []
    for sched in (constant_tol(1e-12), dynamic_tol(1e-12)):
        res = newton(Cubic(), {"x": t(np.ones(3))}, space, tol=1e-12, maxiter=20, gmres_kdim=3,
                     scheduler=sched, callback=lambda it, x, r: seen.append(it))
        assert res.converged and absdiff(res.x["x"], c ** (1 / 3)) < 1e-12
        assert len(res.history) == res.iterations + 1 == len(res.matvecs) + 1
    assert seen[:3] == [1, 2, 3]
    assert dynamic_tol(1e-6)(1.0, 1) == 1e-4 and dynamic_tol(1e-6)(1e-8, 1) == 1e-6


# ---------------------------------------------------------------------------
# the fixed-point system
# ---------------------------------------------------------------------------


def _forcing_j(m, t_, u, th):
    return jnp.zeros((2,) + m.bm1.shape, m.bm1.dtype).at[0].set(2.0 * NU)


def _forcing(m, t_, u, th):
    f = torch.zeros((2,) + tuple(m.bm1.shape), dtype=m.dtype, device=m.device)
    f[0] = 2.0 * NU
    return f


@pytest.fixture(scope="module")
def channel():
    jmesh, mesh = jbox_mesh(**MESH), box_mesh(**MESH, device="cpu")
    jcfg = JLinConfig(flow=JFlowConfig(**FLOW, forcing_fn=_forcing_j))
    cfg = LinConfig(flow=ns.FlowConfig(**FLOW, forcing_fn=_forcing))
    y = np.asarray(jmesh.x[1])
    rng = np.random.default_rng(1)
    guess = np.stack([0.7 * (1 - y**2), 0 * y]) + 0.05 * rng.standard_normal((2,) + y.shape)
    guess = np.asarray(jmesh.vmask * jsem.dsavg(jmesh, jnp.asarray(guess)))
    return jmesh, mesh, jcfg, cfg, guess


def _systems(channel, **kw):
    jmesh, mesh, jcfg, cfg, _ = channel
    return JFixedPointSystem(jmesh, jcfg, **kw), FixedPointSystem(mesh, cfg, **kw)


def _vec(u, nscal=0):
    return u, np.zeros((nscal,) + u.shape[1:])


@pytest.mark.parametrize("exact", [False, True], ids=["frozen", "exact"])
def test_system_and_jacobians_match_reference(channel, exact):
    jmesh, mesh, _, _, guess = channel
    jsys, sys_ = _systems(channel, tau=0.4, dt=0.025, exact_jacobian=exact)
    u, th = _vec(guess)
    jx = {"u": jnp.asarray(u), "theta": jnp.asarray(th)}
    x = {"u": t(u), "theta": t(th)}
    assert absdiff(sys_.response(x)["u"], jsys.response(jx)["u"]) <= 1e-9
    rng = np.random.default_rng(2)
    du = np.asarray(jmesh.vmask * jsem.dsavg(jmesh, jnp.asarray(rng.standard_normal(u.shape))))
    jdx = {"u": jnp.asarray(du), "theta": jnp.asarray(th)}
    dx = {"u": t(du), "theta": t(th)}
    jjac, jac = jsys.jacobian(jx), sys_.jacobian(x)
    for name in ("matvec", "rmatvec"):
        got, want = getattr(jac, name)(dx), getattr(jjac, name)(jdx)
        assert absdiff(got["u"], want["u"]) <= 1e-9, name
        assert tuple(got["theta"].shape) == th.shape
    # the B-adjoint identity <J dx, w>_B = <dx, J* w>_B of the port's pair
    w = {"u": t(np.asarray(jmesh.vmask * jsem.dsavg(jmesh, jnp.asarray(
        rng.standard_normal(u.shape))))), "theta": t(th)}
    space = flow_vector_space(mesh, 0)
    lhs, rhs = space.dot(jac.matvec(dx), w), space.dot(dx, jac.rmatvec(w))
    assert abs(lhs - rhs) <= 1e-9 * abs(lhs), (lhs, rhs)


def test_exact_jacobian_is_the_derivative_of_the_map(channel):
    """Forward mode through advance against a central difference of the
    port's own nonlinear map."""
    jmesh, mesh, _, _, guess = channel
    _, sys_ = _systems(channel, tau=0.4, dt=0.025, exact_jacobian=True)
    u, th = _vec(guess)
    x = {"u": t(u), "theta": t(th)}
    du = mesh.vmask * sem.dsavg(mesh, t(np.random.default_rng(3).standard_normal(u.shape)))
    dx = {"u": du, "theta": t(th)}
    jv = sys_.jacobian(x).matvec(dx)["u"] + du
    eps = 1e-4
    plus = sys_.advance_map(tree_axpby(1.0, x, eps, dx))["u"]
    minus = sys_.advance_map(tree_axpby(1.0, x, -eps, dx))["u"]
    fd = (plus - minus) / (2 * eps)
    assert absdiff(jv, fd) <= 1e-7 * float(fd.abs().max())


def _residual_file(path):
    rows = []
    for line in path.read_text().splitlines():
        assert re.fullmatch(r"\d+ \d\.\d{12}e[+-]\d\d", line), line
        i, r = line.split()
        rows.append((int(i), float(r)))
    return rows


@pytest.mark.parametrize("exact", [False, True], ids=["frozen", "exact"])
def test_newton_fixed_point_matches_reference(channel, exact, tmp_path):
    """tests/test_systems.py's Newton runs: the frozen Jacobian at tau = 0.5
    (test_newton_fixed_point) and the exact one at tau = 0.4
    (test_newton_exact_jacobian), tol 1e-9, GMRES kdim 20."""
    jmesh, mesh, _, _, guess = channel
    tau = 0.4 if exact else 0.5
    jsys, sys_ = _systems(channel, tau=tau, dt=0.025, exact_jacobian=exact)
    u, th = _vec(guess)
    kw = dict(tol=1e-9, maxiter=10, gmres_kdim=20)
    ref = jnewton_fp(jsys, {"u": jnp.asarray(u), "theta": jnp.asarray(th)}, jspace_of(jmesh, 0),
                     outdir=str(tmp_path / "ref"), **kw)
    res = analysis.newton_fixed_point_iteration(sys_, flow_vector(mesh, 0, u=t(u)),
                                                flow_vector_space(mesh, 0),
                                                outdir=str(tmp_path / "port"), **kw)
    assert res.converged and ref.converged
    assert res.iterations == ref.iterations
    assert len(res.matvecs) == res.iterations and min(res.matvecs) > 0
    for got, want in zip(res.history, ref.history):
        if want > 1e3 * kw["tol"]:
            assert abs(got - want) <= 1e-6 * want, (res.history, ref.history)
    y = mesh.x[1]
    err = res.x["u"] - torch.stack([1 - y**2, 0 * y])
    assert float(sem.mass_dot(mesh, err, err).sqrt()) < 1e-8
    got = _residual_file(tmp_path / "port" / "residual.dat")
    want = _residual_file(tmp_path / "ref" / "residual.dat")
    assert [r[0] for r in got] == [r[0] for r in want] == list(range(len(res.history)))
    np.testing.assert_allclose([r[1] for r in got], res.history, rtol=1e-12)


def test_solvers_are_built_once_per_step_size(channel, monkeypatch):
    """Three Newton iterations (responses, GMRES matvecs, an rmatvec each)
    build one E preconditioner and, at the one (dt, nsteps), one velocity
    and one pressure CG per BDF order; a second step size adds one set."""
    jmesh, mesh, _, _, guess = channel
    built = {"pcg": 0, "pc": 0}

    class CountedPCG(solvers.PCG):
        def __init__(self, *args, **kwargs):
            built["pcg"] += 1
            super().__init__(*args, **kwargs)

    build_pc = precond.build_e_preconditioner

    def counted_pc(m):
        built["pc"] += 1
        return build_pc(m)

    monkeypatch.setattr(ns, "PCG", CountedPCG)
    monkeypatch.setattr(fixed_point, "build_e_preconditioner", counted_pc)
    u, th = _vec(guess)
    sys_ = FixedPointSystem(mesh, channel[3], tau=0.5, dt=0.025)
    space = flow_vector_space(mesh, 0)

    def with_rmatvec(it, x, rnorm):
        jac = sys_.jacobian(x)
        jac.rmatvec(jac.matvec(x))

    res = newton(sys_, flow_vector(mesh, 0, u=t(u)), space, tol=1e-14, maxiter=3, gmres_kdim=20,
                 callback=with_rmatvec)
    assert res.iterations == 3 and sum(res.matvecs) > 6
    assert built == {"pcg": 6, "pc": 1}  # orders 1, 2, 3: a velocity and a pressure CG each
    assert len(sys_.derived) == 1
    sys_._fixed_dt = 0.03
    sys_.response(flow_vector(mesh, 0, u=t(u)))
    assert built == {"pcg": 12, "pc": 1} and len(sys_.derived) == 2
