"""Port parity: the periodic-orbit (UPO) system, its bordered Jacobian and
the Floquet monodromy operator.

Fixture: tests/test_systems.py's forced channel at order 4 ((3, 2)
elements, nu = 0.1, body force 2 nu, vtol = ptol = 1e-12) with the UPO
system at T = 0.3 over nsteps = 10, in both packages, f64 on the CPU.
Inputs are numpy-seeded. Tolerances:
  * the response Phi_T(X) - X and fdot: 1e-9 absolute (inner solves at
    1e-12 over 10 steps);
  * dPhi/dT: 1e-9 absolute against the reference's `jax.jvp` with the
    tangent on T alone, and 1e-6 relative against a central difference in
    T (step 1e-5; its truncation is ~1e-9 relative);
  * the bordered Jacobian's matvec with dT != 0, its rmatvec, and the
    monodromy's matvec and rmatvec: 1e-9 absolute against the reference's
    (linearized steps about the recorded orbit and a recorded backward
    here, `jax.jvp` and `jax.vjp` through the integration there); the T
    entries 1e-9 relative.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neklab_tpu.mesh.box import box_mesh as jbox_mesh
from neklab_tpu.models.linearized import LinConfig as JLinConfig
from neklab_tpu.models.navier_stokes import FlowConfig as JFlowConfig
from neklab_tpu.ops import sem as jsem
from neklab_tpu.systems.periodic_orbit import MonodromyOperator as JMonodromy
from neklab_tpu.systems.periodic_orbit import PeriodicOrbitSystem as JUPO
from neklab_tpu.vectors import ext_flow_vector_space as jext_space
from neklab_tpu.vectors import get_size as jget_size
from neklab_tpu_torch.mesh.box import box_mesh
from neklab_tpu_torch.models.linearized import LinConfig
from neklab_tpu_torch.models.navier_stokes import FlowConfig
from neklab_tpu_torch.systems.periodic_orbit import MonodromyOperator, PeriodicOrbitSystem
from neklab_tpu_torch.vectors import ext_flow_vector, ext_flow_vector_space, get_size
from torch_port_helpers import CHANNEL_BC, absdiff, t

NU = 0.1
MESH = dict(nels=(3, 2), lims=((0, 2.0), (-1, 1)), bc=CHANNEL_BC, order=4)
FLOW = dict(viscosity=NU, dt=0.02, vtol=1e-12, ptol=1e-12)
T0, NSTEPS = 0.3, 10


def _jforcing(m, t_, u, th):
    return jnp.zeros((2,) + m.bm1.shape, m.bm1.dtype).at[0].set(2.0 * NU)


def _forcing(m, t_, u, th):
    f = torch.zeros((2,) + tuple(m.bm1.shape), dtype=m.dtype, device=m.device)
    f[0] = 2.0 * NU
    return f


@pytest.fixture(scope="module")
def upo():
    jmesh, mesh = jbox_mesh(**MESH), box_mesh(**MESH, device="cpu")
    jsys = JUPO(jmesh, JLinConfig(flow=JFlowConfig(**FLOW, forcing_fn=_jforcing)),
                t_guess=T0, nsteps=NSTEPS)
    sys_ = PeriodicOrbitSystem(mesh, LinConfig(flow=FlowConfig(**FLOW, forcing_fn=_forcing)),
                               t_guess=T0, nsteps=NSTEPS)
    rng = np.random.default_rng(29)
    y = np.asarray(jmesh.x[1])

    def conforming(a):
        return np.asarray(jmesh.vmask * jsem.dsavg(jmesh, jnp.asarray(a)))

    shape = (2,) + tuple(jmesh.bm1.shape)
    u = conforming(np.stack([0.9 * (1 - y**2), 0.02 * np.sin(np.pi * y)])
                   + 0.05 * rng.standard_normal(shape))
    du, dv = conforming(rng.standard_normal(shape)), conforming(rng.standard_normal(shape))
    th = np.zeros((0,) + tuple(jmesh.bm1.shape))
    x = {"u": u, "theta": th, "T": T0}
    dx = {"u": du, "theta": th, "T": 0.7}
    v = {"u": dv, "theta": th, "T": -0.4}
    return jmesh, mesh, jsys, sys_, x, dx, v


def jvec(a):
    return {k: jnp.asarray(v) for k, v in a.items()}


def tvec(a):
    return {k: t(v) for k, v in a.items()}


def test_extended_vectors():
    jmesh, mesh = jbox_mesh(**MESH), box_mesh(**MESH, device="cpu")
    v = ext_flow_vector(mesh, 0, T=0.3)
    assert v["T"].dim() == 0 and float(v["T"]) == 0.3 and v["u"].shape == (2, 5, 5, 6)
    assert get_size(mesh, 1) == jget_size(jmesh, 1)
    assert get_size(mesh, 0, extended=True) == jget_size(jmesh, 0, extended=True)
    space, jspace = ext_flow_vector_space(mesh, 0), jext_space(jmesh, 0)
    rng = np.random.default_rng(1)
    a = {"u": rng.standard_normal((2, 5, 5, 6)), "theta": np.zeros((0, 5, 5, 6)), "T": 1.5}
    b = {"u": rng.standard_normal((2, 5, 5, 6)), "theta": np.zeros((0, 5, 5, 6)), "T": -2.0}
    assert abs(space.dot(tvec(a), tvec(b)) - float(jspace.dot(jvec(a), jvec(b)))) <= 1e-12
    r = space.rand(4)
    assert r["T"].dim() == 0 and float(r["T"]) != 0.0


def test_response_and_fdot_match_reference(upo):
    _, _, jsys, sys_, x, _, _ = upo
    ref, out = jsys.response(jvec(x)), sys_.response(tvec(x))
    assert np.abs(np.asarray(ref["u"])).max() > 1e-3
    assert absdiff(out["u"], ref["u"]) <= 1e-9
    assert float(out["T"]) == 0.0
    ref, out = jsys.fdot(jvec(x)), sys_.fdot(tvec(x))
    assert absdiff(out["u"], ref["u"]) <= 1e-9 * max(1.0, float(np.abs(ref["u"]).max()))


def test_period_direction_matches_jvp_and_difference(upo):
    _, _, jsys, sys_, x, _, _ = upo
    jac = sys_.jacobian(tvec(x))
    b = jac.period_dir()["u"]
    ref = jsys.jacobian(jvec(x))._period_dir()["u"]
    assert np.abs(np.asarray(ref)).max() > 1e-3
    assert absdiff(b, ref) <= 1e-9
    eps = 1e-5
    periods = (torch.tensor(T0 + s, dtype=torch.float64) for s in (eps, -eps))
    plus, minus = (sys_.advance_map({**tvec(x), "T": T})["u"] for T in periods)
    fd = (plus - minus) / (2 * eps)
    assert absdiff(b, fd) <= 1e-6 * float(fd.abs().max())
    # one solver set per T: x's, then the two differenced periods
    assert len(sys_.derived) >= 3


def test_bordered_jacobian_matches_reference(upo):
    jmesh, _, jsys, sys_, x, dx, v = upo
    jjac, jac = jsys.jacobian(jvec(x)), sys_.jacobian(tvec(x))
    ref, out = jjac.matvec(jvec(dx)), jac.matvec(tvec(dx))
    assert absdiff(out["u"], ref["u"]) <= 1e-9
    assert abs(float(out["T"]) - float(ref["T"])) <= 1e-9 * abs(float(ref["T"]))
    ref, out = jjac.rmatvec(jvec(v)), jac.rmatvec(tvec(v))
    assert np.abs(np.asarray(ref["u"])).max() > 1e-2
    assert absdiff(out["u"], ref["u"]) <= 1e-9
    assert abs(float(out["T"]) - float(ref["T"])) <= 1e-9 * abs(float(ref["T"]))
    # the bordered adjoint identity of the port
    space = ext_flow_vector_space(sys_.mesh, 0)
    lhs = space.dot(jac.matvec(tvec(dx)), tvec(v))
    rhs = space.dot(tvec(dx), jac.rmatvec(tvec(v)))
    assert abs(lhs - rhs) <= 1e-8 * abs(lhs), (lhs, rhs)


def test_matvec_is_linear_in_the_period_tangent(upo):
    """J (dx, dT) = J (dx, 0) + dT J (0, 1): the period direction is exact
    by linearity, so a second matvec reuses it."""
    _, _, _, sys_, x, dx, _ = upo
    jac = sys_.jacobian(tvec(x))
    full = jac.matvec(tvec(dx))
    part = jac.matvec({**tvec(dx), "T": torch.tensor(0.0, dtype=torch.float64)})
    b = jac.period_dir()["u"]
    assert absdiff(full["u"], part["u"] + 0.7 * b) <= 1e-13


def test_monodromy_matches_reference(upo):
    _, _, jsys, sys_, x, dx, v = upo
    jmono, mono = JMonodromy(jsys, jvec(x)), MonodromyOperator(sys_, tvec(x))
    strip = lambda a: {k: a[k] for k in ("u", "theta")}
    ref, out = jmono.matvec(jvec(strip(dx))), mono.matvec(tvec(strip(dx)))
    assert np.abs(np.asarray(ref["u"])).max() > 1e-2
    assert absdiff(out["u"], ref["u"]) <= 1e-9
    ref, out = jmono.rmatvec(jvec(strip(v))), mono.rmatvec(tvec(strip(v)))
    assert absdiff(out["u"], ref["u"]) <= 1e-9


@pytest.mark.parametrize("which", ["velocity", "pressure"])
def test_solve_dt_tangent_matches_difference(which):
    """A solve's forward mode with a dt tangent (velocity: through h2 = g0/dt
    in the operator, the Dirichlet lift and the warm start; pressure: E
    linear in dt/g0) against a central difference of solvers built at
    dt +- 1e-6, f64 on the CPU, inner solves at 1e-13: 1e-6 relative."""
    import torch.autograd.forward_ad as fwAD

    from neklab_tpu_torch.models import navier_stokes as ns
    from neklab_tpu_torch.models.precond import build_e_preconditioner
    from neklab_tpu_torch.ops import sem

    m = box_mesh(nels=(3, 2), lims=((0, 2 * np.pi), (-1, 1)), bc=CHANNEL_BC, order=5,
                 device="cpu")
    rng = np.random.default_rng(31)
    g0, dt0, nu = 11 / 6, 0.02, 0.05
    pc = build_e_preconditioner(m)
    if which == "velocity":
        shape = (2,) + tuple(m.bm1.shape)
        r, tr, x0, bc = (t(rng.standard_normal(shape)) for _ in range(4))
        x0 = sem.dsavg(m, x0)

        def run(dt, h2_now=None):
            h2 = g0 / float(fwAD.unpack_dual(dt).primal) if h2_now is not None else g0 / dt
            solve = ns.make_helmholtz_solver(m, nu, h2, m.vmask,
                                             ns.helmholtz_diag(m, nu, h2, m.vmask), 1e-13, 500)
            return solve(r if h2_now is None else fwAD.make_dual(r, tr), bc, x0=x0,
                         h2_now=h2_now)
    else:
        shape = tuple(m.bm2.shape)
        r, tr, x0 = (t(rng.standard_normal(shape)) for _ in range(3))
        r, tr = r - r.mean(), tr - tr.mean()

        def run(dt, h2_now=None):
            c = float(fwAD.unpack_dual(dt).primal) / g0 if h2_now is not None else dt / g0
            cfg = FlowConfig(viscosity=nu, dt=c * g0, ptol=1e-13, pmaxit=800)
            solve = ns.make_pressure_solver(m, cfg, c, pc=pc)
            return solve(r if h2_now is None else fwAD.make_dual(r, tr), x0=x0,
                         dt_over_g0_now=h2_now)

    with fwAD.dual_level():
        dt = fwAD.make_dual(torch.tensor(dt0, dtype=torch.float64),
                            torch.tensor(1.0, dtype=torch.float64))
        param = g0 / dt if which == "velocity" else dt / g0
        tangent = fwAD.unpack_dual(run(dt, param)).tangent
        # the right-hand side's part alone, at a fixed dt
        fixed = fwAD.unpack_dual(run(dt, torch.tensor(float(fwAD.unpack_dual(param).primal),
                                                      dtype=torch.float64))).tangent
    eps = 1e-6
    fd = (run(dt0 + eps) - run(dt0 - eps)) / (2 * eps)
    assert float(fd.abs().max()) > 1e-3
    assert absdiff(tangent - fixed, fd) <= 1e-6 * float(fd.abs().max())
