"""Port parity: harmonically forced propagation, the resolvent, and the
wavenumber-projected propagator.

Inputs are numpy-seeded and go through both packages, f64 on the CPU, on
small channels of tests/test_resolvent.py's kind. Tolerances:
  * propagate_forced (nscal 0 and 1, a ramp and 9 rotated steps, inner
    solves at 1e-13): 1e-11 absolute on O(1) fields;
  * Resolvent.matvec and rmatvec at a short period (nu = 0.2, omega = 4,
    32 steps, GMRES rtol 1e-10, inner solves at 1e-13): 1e-9 absolute on O(1e-1)
    responses;
  * the Hermitian identity Re<Rf, g> = Re<f, R*g> of the port: 1e-8
    relative;
  * one E preconditioner serves a sweep: the response with a shared one
    equals the response with its own to 1e-12 relative (the port's
    preconditioner does not depend on dt, so they are the same build);
  * ProjectedPropagator: the projection 1e-12 absolute; matvec and rmatvec
    (5 steps, inner solves at 1e-14) 1e-12 absolute on B-normalized input.
The closed-form Stokes oracle (GMRES rtol 1e-10, 244 steps) is `slow`.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neklab_tpu.linops.exponential_propagator import ExponentialPropagator as JProp
from neklab_tpu.linops.projected import ProjectedPropagator as JProjected
from neklab_tpu.linops.resolvent import Resolvent as JResolvent
from neklab_tpu.mesh.box import box_mesh as jbox_mesh
from neklab_tpu.models import linearized as jlin
from neklab_tpu.models.navier_stokes import FlowConfig as JFlowConfig
from neklab_tpu.models.precond import build_e_preconditioner as jbuild_pc
from neklab_tpu.ops import sem as jsem
from neklab_tpu_torch.linops.exponential_propagator import ExponentialPropagator
from neklab_tpu_torch.linops.projected import ProjectedPropagator
from neklab_tpu_torch.linops.resolvent import Resolvent, complex_pair_space
from neklab_tpu_torch.mesh.box import box_mesh
from neklab_tpu_torch.models import linearized as lin
from neklab_tpu_torch.models import navier_stokes as ns
from neklab_tpu_torch.models.navier_stokes import FlowConfig
from neklab_tpu_torch.models.precond import build_e_preconditioner
from neklab_tpu_torch.ops import sem
from torch_port_helpers import CHANNEL_BC, absdiff, t

PERIODIC_BC = {"x-": "P", "x+": "P", "y-": "P", "y+": "P"}


def _conforming(jmesh, rng, lead):
    """A numpy-seeded admissible field [lead, ...] (C0, masked)."""
    mask = jmesh.vmask if lead == jmesh.ndim else jmesh.tmask
    a = rng.standard_normal((lead,) + tuple(jmesh.bm1.shape))
    return np.asarray(mask * jsem.dsavg(jmesh, jnp.asarray(a)))


def _pair(jmesh, rng, nscal=0):
    return {part: {"u": _conforming(jmesh, rng, 2), "theta": _conforming(jmesh, rng, nscal)}
            for part in ("re", "im")}


def _as(pair, cast):
    return {p: {k: cast(v) for k, v in d.items()} for p, d in pair.items()}


# ---------------------------------------------------------------------------
# propagate_forced
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("nscal", [0, 1])
def test_propagate_forced_matches_reference(nscal):
    mesh_kw = dict(nels=(3, 2), lims=((0, 2 * np.pi), (-1, 1)), bc=CHANNEL_BC, order=4)
    jmesh, mesh = jbox_mesh(**mesh_kw), box_mesh(**mesh_kw, device="cpu")
    flow = dict(viscosity=0.02, dt=0.05, vtol=1e-13, ptol=1e-13, ttol=1e-13, nscal=nscal,
                conductivity=(0.03,) * nscal)
    # Boussinesq-like coupling, linear in (u, theta)
    jforce = None if not nscal else (lambda m, u, th: jnp.stack([0 * th[0], 0.5 * th[0]]))
    tforce = None if not nscal else (lambda m, u, th: torch.stack([0 * th[0], 0.5 * th[0]]))
    jcfg = jlin.LinConfig(flow=JFlowConfig(**flow), lin_forcing_fn=jforce)
    cfg = lin.LinConfig(flow=FlowConfig(**flow), lin_forcing_fn=tforce)
    rng = np.random.default_rng(3 + nscal)
    y = np.asarray(jmesh.x[1])
    base_u = np.stack([1 - y**2, 0 * y])
    base_th = np.repeat(0.3 * y[None], nscal, axis=0)
    u0, th0 = _conforming(jmesh, rng, 2), _conforming(jmesh, rng, nscal)
    f = _pair(jmesh, rng, nscal)
    nsteps, omega, t0, sign = 11, 1.3, 0.2, -1
    ref = jlin.propagate_forced(
        jmesh, jcfg, jnp.asarray(base_u), jnp.asarray(base_th), jnp.asarray(u0),
        jnp.asarray(th0), jnp.asarray(f["re"]["u"]), jnp.asarray(f["im"]["u"]), omega, nsteps,
        t0=t0, sign=sign, pc_e=jbuild_pc(jmesh, 1.0), s_re=jnp.asarray(f["re"]["theta"]),
        s_im=jnp.asarray(f["im"]["theta"]))
    out = lin.propagate_forced(
        mesh, cfg, t(base_u), t(base_th), t(u0), t(th0), t(f["re"]["u"]), t(f["im"]["u"]),
        omega, nsteps, t0=t0, sign=sign, pc_e=build_e_preconditioner(mesh),
        s_re=t(f["re"]["theta"]), s_im=t(f["im"]["theta"]))
    assert np.abs(np.asarray(ref[0])).max() > 0.1
    assert absdiff(out[0], ref[0]) <= 1e-11
    assert tuple(out[1].shape) == ref[1].shape
    if nscal:
        assert np.abs(np.asarray(ref[1])).max() > 0.1
        assert absdiff(out[1], ref[1]) <= 1e-11


def test_propagate_forced_is_linear_in_the_force():
    """Zero initial condition: the response to f_re + f_im splits into the
    responses to each, and it takes the prebuilt solvers of `propagate`."""
    mesh = box_mesh((3, 2), ((0, 2 * np.pi), (-1, 1)), CHANNEL_BC, order=4, device="cpu")
    fc = FlowConfig(viscosity=0.02, dt=0.05, vtol=1e-13, ptol=1e-13)
    cfg = lin.LinConfig(flow=fc)
    y = mesh.x[1]
    base = torch.stack([1 - y**2, 0 * y])
    th = torch.zeros((0,) + tuple(mesh.bm1.shape), dtype=torch.float64)
    rng = np.random.default_rng(5)
    jmesh = jbox_mesh((3, 2), ((0, 2 * np.pi), (-1, 1)), CHANNEL_BC, order=4)
    fr, fi = t(_conforming(jmesh, rng, 2)), t(_conforming(jmesh, rng, 2))
    z = torch.zeros_like(fr)
    orders = ns.bdf_orders(fc, 9)
    pc = build_e_preconditioner(mesh)
    vdiag, _ = ns.bdf3_diags(mesh, fc)
    kw = dict(psolves=ns.pressure_solvers(mesh, fc, orders, pc),
              vsolves=ns.velocity_solvers(mesh, fc, orders, vdiag, None))
    run = lambda a, b: lin.propagate_forced(mesh, cfg, base, th, z, th, a, b, 2.0, 9, **kw)[0]
    both, re, im = run(fr, fi), run(fr, z), run(z, fi)
    assert absdiff(both, re + im) <= 1e-12 * float(both.abs().max())


# ---------------------------------------------------------------------------
# the resolvent
# ---------------------------------------------------------------------------

RES_MESH = dict(nels=(3, 2), lims=((0, 2 * np.pi), (-1, 1)), bc=CHANNEL_BC, order=4)
RES_FLOW = dict(viscosity=0.2, dt=1.0, vtol=1e-13, ptol=1e-13)
RES_KW = dict(omega=4.0, dt=0.05, gmres_rtol=1e-10)


@pytest.fixture(scope="module")
def resolvents():
    jmesh, mesh = jbox_mesh(**RES_MESH), box_mesh(**RES_MESH, device="cpu")
    y = jmesh.x[1]
    jres = JResolvent(jmesh, jlin.LinConfig(flow=JFlowConfig(**RES_FLOW)),
                      jnp.stack([1 - y**2, 0 * y]), **RES_KW)
    y = mesh.x[1]
    res = Resolvent(mesh, lin.LinConfig(flow=FlowConfig(**RES_FLOW)),
                    torch.stack([1 - y**2, 0 * y]), **RES_KW)
    rng = np.random.default_rng(17)
    return jmesh, mesh, jres, res, _pair(jmesh, rng), _pair(jmesh, rng)


def test_resolvent_steps_match(resolvents):
    _, _, jres, res, _, _ = resolvents
    assert (res.nsteps, res.nq, res.dt) == (jres.nsteps, jres.nq, jres.dt)
    assert res.nsteps % 4 == 0


def test_resolvent_matvec_matches_reference(resolvents):
    _, _, jres, res, f, _ = resolvents
    ref = jres.matvec(_as(f, jnp.asarray))
    out = res.matvec(_as(f, t))
    for part in ("re", "im"):
        assert np.abs(np.asarray(ref[part]["u"])).max() > 1e-2
        assert absdiff(out[part]["u"], ref[part]["u"]) <= 1e-9, part
    assert res.last_gmres_matvecs == jres.last_gmres_matvecs


def test_resolvent_rmatvec_matches_reference(resolvents):
    _, _, jres, res, _, g = resolvents
    ref = jres.rmatvec(_as(g, jnp.asarray))
    out = res.rmatvec(_as(g, t))
    for part in ("re", "im"):
        assert np.abs(np.asarray(ref[part]["u"])).max() > 1e-2
        assert absdiff(out[part]["u"], ref[part]["u"]) <= 1e-9, part


def test_resolvent_hermitian_identity(resolvents):
    _, mesh, _, res, f, g = resolvents
    space = complex_pair_space(mesh, 0)
    f, g = _as(f, t), _as(g, t)
    lhs = space.dot(res.matvec(f), g)
    rhs = space.dot(f, res.rmatvec(g))
    assert abs(lhs - rhs) <= 1e-8 * abs(lhs), (lhs, rhs)
    # the port's rand: admissible pairs from torch.Generators
    r = space.rand(3)
    assert set(r) == {"re", "im"} and not torch.equal(r["re"]["u"], r["im"]["u"])


def test_resolvent_shared_preconditioner_serves_a_sweep():
    """One E preconditioner serves every omega of a sweep: E(dt) =
    (dt/g0) E(1) and CG is invariant to a scaling of its preconditioner
    (tests/test_resolvent.py::test_resolvent_prebuilt_pc_matches)."""
    mesh = box_mesh((3, 3), ((0, 2 * np.pi), (0, 2 * np.pi)), PERIODIC_BC, order=4,
                    device="cpu")
    cfg = lin.LinConfig(flow=FlowConfig(viscosity=0.1, dt=1.0, vtol=1e-11, ptol=1e-11))
    u = torch.zeros((2,) + tuple(mesh.bm1.shape), dtype=torch.float64)
    x, y = mesh.x[0], mesh.x[1]
    fmode = torch.stack([torch.sin(x) * torch.cos(y), -torch.cos(x) * torch.sin(y)])
    zero = torch.zeros((0,) + tuple(mesh.bm1.shape), dtype=torch.float64)
    f = {"re": {"u": fmode, "theta": zero}, "im": {"u": 0 * fmode, "theta": zero}}
    pc = build_e_preconditioner(mesh)
    for omega in (3.0, 6.0):
        own = Resolvent(mesh, cfg, u, omega=omega, dt=0.05, gmres_rtol=1e-9)
        shared = Resolvent(mesh, cfg, u, omega=omega, dt=0.05, gmres_rtol=1e-9, pc_e=pc)
        assert shared.pc_e is pc and own.pc_e is not pc
        xa, xb = own.matvec(f), shared.matvec(f)
        for part in ("re", "im"):
            da, db = xa[part]["u"], xb[part]["u"]
            assert absdiff(da, db) <= 1e-12 * float(da.abs().max()), (omega, part)


@pytest.mark.slow
def test_stokes_resolvent_oracle():
    """The closed form (i w - A)^-1 f = f / (i w + nu k^2) for a solenoidal
    Fourier mode (tests/test_resolvent.py::test_stokes_resolvent_oracle)."""
    mesh = box_mesh((3, 3), ((0, 2 * np.pi), (0, 2 * np.pi)), PERIODIC_BC, order=6,
                    device="cpu")
    nu, omega = 0.1, 1.3
    cfg = lin.LinConfig(flow=FlowConfig(viscosity=nu, dt=1.0, vtol=1e-12, ptol=1e-12))
    R = Resolvent(mesh, cfg, torch.zeros((2,) + tuple(mesh.bm1.shape), dtype=torch.float64),
                  omega=omega, dt=0.02, gmres_rtol=1e-10)
    x, y = mesh.x[0], mesh.x[1]
    fmode = torch.stack([torch.sin(x) * torch.cos(y), -torch.cos(x) * torch.sin(y)])
    zero = torch.zeros((0,) + tuple(mesh.bm1.shape), dtype=torch.float64)
    xhat = R.matvec({"re": {"u": fmode, "theta": zero}, "im": {"u": 0 * fmode, "theta": zero}})
    expect = 1.0 / (1j * omega + nu * 2.0)
    nrm = float(sem.mass_dot(mesh, fmode, fmode))
    got = (float(sem.mass_dot(mesh, xhat["re"]["u"], fmode)) / nrm
           + 1j * float(sem.mass_dot(mesh, xhat["im"]["u"], fmode)) / nrm)
    assert abs(got.real - expect.real) < 2e-4 * abs(expect)
    assert abs(got.imag - expect.imag) < 2e-4 * abs(expect)


# ---------------------------------------------------------------------------
# the wavenumber-projected propagator
# ---------------------------------------------------------------------------

PROJ_MESH = dict(nels=(4, 2), lims=((0, 2 * np.pi), (-1, 1)), bc=CHANNEL_BC, order=4)
PROJ_FLOW = dict(viscosity=1 / 500, dt=1e-2, vtol=1e-14, ptol=1e-14)


@pytest.fixture(scope="module")
def projected():
    jmesh, mesh = jbox_mesh(**PROJ_MESH), box_mesh(**PROJ_MESH, device="cpu")
    y = jmesh.x[1]
    jprop = JProp(jmesh, jlin.LinConfig(flow=JFlowConfig(**PROJ_FLOW)),
                  jnp.stack([1 - y**2, 0 * y]), tau=0.05, dt=1e-2)
    y = mesh.x[1]
    prop = ExponentialPropagator(mesh, lin.LinConfig(flow=FlowConfig(**PROJ_FLOW)),
                                 torch.stack([1 - y**2, 0 * y]), tau=0.05, dt=1e-2)
    u = _conforming(jmesh, np.random.default_rng(23), 2)
    u = u / np.sqrt(float(jsem.mass_dot(jmesh, u, u)))
    return jmesh, jprop, prop, u


@pytest.mark.parametrize("alpha", [0.0, 1.0, 2.0])
def test_projection_matches_reference(projected, alpha):
    jmesh, jprop, prop, u = projected
    jp, p = JProjected(jprop, alpha), ProjectedPropagator(prop, alpha)
    lead = np.random.default_rng(int(alpha) + 1).standard_normal((3,) + u.shape)
    ref = jp._project_field(jnp.asarray(lead))
    out = p._project_field(t(lead))
    assert absdiff(out, ref) <= 1e-12


@pytest.mark.parametrize("adjoint", [False, True], ids=["matvec", "rmatvec"])
def test_projected_propagator_matches_reference(projected, adjoint):
    jmesh, jprop, prop, u = projected
    jp, p = JProjected(jprop, 1.0), ProjectedPropagator(prop, 1.0)
    th = np.zeros((0,) + u.shape[1:])
    name = "rmatvec" if adjoint else "matvec"
    ref = getattr(jp, name)({"u": jnp.asarray(u), "theta": jnp.asarray(th)})
    out = getattr(p, name)({"u": t(u), "theta": t(th)})
    assert np.abs(np.asarray(ref["u"])).max() > 1e-2
    assert absdiff(out["u"], ref["u"]) <= 1e-12
    assert tuple(out["theta"].shape) == th.shape
    assert p.tau == prop.tau


def test_projected_requires_box_metadata(projected):
    _, _, prop, _ = projected
    mesh = prop.mesh
    bare = type(mesh)(**{**{f: getattr(mesh, f) for f in mesh.__dataclass_fields__},
                         "bc": tuple(kv for kv in mesh.bc if kv[0] != "__box__")})
    clone = object.__new__(type(prop))
    clone.__dict__.update(prop.__dict__, mesh=bare)
    with pytest.raises(ValueError, match="__box__"):
        ProjectedPropagator(clone, 1.0)
