"""Port parity: the nonlinear BDFk/EXTk stepper and what it stands on.

Inputs are numpy-seeded and go through both packages, f64 on the CPU
(the reference's `step` and `advance` under jit, as its own tests run
them). Meshes: the periodic channel (pure-Neumann pressure), the deformed
walled box (g01 != 0) and a small cylinder annulus with a 'vO' outer
boundary (the pressure pinned at the outflow, a non-zero inflow lift).
Tolerances:
  * convect_weak / convect_volume_weak: rel <= 1e-12 (same arithmetic,
    another summation order);
  * annulus_mesh, every field of both outer BCs: <= 1e-13 absolute;
  * one `step` at orders 1-3, with forcing, with nscal 0 and 1, from a
    random state with history: <= 1e-10 relative (inner solves at 1e-12);
  * `advance` over 20 steps with pextrap 1 and 2, and the linearized
    `propagate` with pextrap 2: <= 1e-10 relative;
  * `advance_adaptive` on tests/test_stepper.py's variable-dt fixture, cut
    to t = 0.6 in short chunks: the same end time to 1e-12, the state to 1e-10 relative,
    and one solver set per distinct dt.
The port's own physics: Taylor-Green decay against the analytic rate, and
the linearized map against a difference of the nonlinear one
(tests/test_stepper.py's thresholds).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neklab_tpu.mesh.box import box_mesh as jbox_mesh
from neklab_tpu.mesh.cylinder import annulus_mesh as jannulus_mesh
from neklab_tpu.models import linearized as jlin
from neklab_tpu.models import navier_stokes as jns
from neklab_tpu.models.precond import build_e_preconditioner as jbuild
from neklab_tpu.ops import sem as jsem
from neklab_tpu_torch.mesh.box import box_mesh
from neklab_tpu_torch.mesh.core import MESH_FIELDS
from neklab_tpu_torch.mesh.cylinder import annulus_mesh
from neklab_tpu_torch.models import linearized as lin
from neklab_tpu_torch.models import navier_stokes as ns
from neklab_tpu_torch.models import stokes
from neklab_tpu_torch.models.precond import build_e_preconditioner
from neklab_tpu_torch.ops import sem
from neklab_tpu_torch.ops.tensor import interp_nd
from torch_port_helpers import CHANNEL_BC, WALLED_BC, rel, t, to_np, wavy

ANNULUS = dict(nel_r=3, nel_t=8, r_in=0.5, r_out=4.0, order=4, grading=1.3, outer_bc="vO",
               shift=0.2, bc_temp=("t", "I"))
CHANNEL = dict(nels=(3, 2), lims=((0, 2 * np.pi), (-1, 1)), bc=CHANNEL_BC, order=5)
DEFORMED = dict(nels=(5, 3), lims=((0.0, 2.0), (-1.0, 1.0)), bc=WALLED_BC, order=5, deform=wavy)


def _meshes(name):
    if name == "annulus":
        return jannulus_mesh(**ANNULUS, dtype=jnp.float64), annulus_mesh(**ANNULUS, device="cpu")
    kw = CHANNEL if name == "channel" else DEFORMED
    return jbox_mesh(**kw), box_mesh(**kw, device="cpu")


@pytest.fixture(scope="module", params=["channel", "annulus"])
def flow_mesh(request):
    return request.param, _meshes(request.param)


# ---------------------------------------------------------------------------
# dealiased convection and the annulus
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["deformed", "annulus"])
def test_convect_weak_matches_reference(name):
    jmesh, mesh = _meshes(name)
    rng = np.random.default_rng(0)
    shape = tuple(jmesh.bm1.shape)
    c, u, th = (rng.standard_normal((k,) + shape) for k in (2, 2, 3))
    jc = jnp.asarray(c)
    for i in range(3):
        ref = jsem.convect_weak(jmesh, jnp.asarray(th[i]), jc)
        assert rel(sem.convect_weak(mesh, t(th[i]), t(c)), ref) <= 1e-12
    # several fields at once: one batch
    ref = jnp.stack([jsem.convect_weak(jmesh, jnp.asarray(th[i]), jc) for i in range(3)])
    assert rel(sem.convect_weak(mesh, t(th), t(c)), ref) <= 1e-12
    ref = jsem.convect_volume_weak(jmesh, jnp.asarray(u), jc)
    assert rel(sem.convect_volume_weak(mesh, t(u), t(c)), ref) <= 1e-12


@pytest.mark.parametrize("kw", [
    dict(nel_r=3, nel_t=8, r_in=0.5, r_out=2.0, order=4, outer_bc="W", bc_temp=("t", "t")),
    dict(nel_r=4, nel_t=10, r_in=0.5, r_out=6.0, order=5, grading=1.5, outer_bc="vO",
         shift=0.25, bc_temp=("t", "I"), dealias_order=8),
    dict(nel_r=2, nel_t=6, r_in=1.0, r_out=3.0, order=3, grading=1.0, outer_bc="W"),
], ids=["wall", "inflow-outflow", "uniform"])
def test_annulus_mesh_matches_reference(kw):
    jmesh = jannulus_mesh(**kw, dtype=jnp.float64)
    mesh = annulus_mesh(**kw, device="cpu")
    assert (mesh.nel, mesh.nglob, mesh.ndim, mesh.basis.n, mesh.basis.nd) == (
        jmesh.nel, jmesh.nglob, jmesh.ndim, jmesh.basis.n, jmesh.basis.nd)
    assert mesh.bc == tuple(tuple(p) for p in jmesh.bc)
    assert mesh.p_fixed == jmesh.p_fixed == (kw["outer_bc"] == "W")
    for k in MESH_FIELDS:
        want = np.asarray(getattr(jmesh, k))
        got = to_np(getattr(mesh, k))
        assert got.shape == want.shape, k
        assert np.abs(got - want).max(initial=0.0) <= 1e-13, k
    with pytest.raises(ValueError):
        annulus_mesh(2, 6, outer_bc="X", device="cpu")


# ---------------------------------------------------------------------------
# the step
# ---------------------------------------------------------------------------


def _forcing(cos, sin, stack):
    """forcing_fn and source_fn for either package: nonlinear in u, coupled
    to the scalar, dependent on the time (a traced scalar in the
    reference's jitted step, a float in the port's)."""

    def forcing(m, time, u, th):
        fx = 0.2 + 0.1 * cos(time) * u[1]
        fy = 0.05 * u[0] * u[0]
        if th.shape[0]:
            fy = fy + 0.3 * th[0]
        return stack([fx, fy])

    def source(m, time, u, th):
        return 0.3 * u[1:2] - 0.1 * sin(time) * th

    return forcing, source


J_FORCING, J_SOURCE = _forcing(jnp.cos, jnp.sin, jnp.stack)
FORCING, SOURCE = _forcing(np.cos, np.sin, torch.stack)


def _configs(nscal, **kw):
    common = dict(viscosity=0.05, dt=0.01, vtol=1e-12, ptol=1e-12, ttol=1e-12, **kw)
    if nscal:
        common.update(nscal=1, conductivity=(0.02,))
    return (jns.FlowConfig(**common, forcing_fn=J_FORCING, source_fn=J_SOURCE if nscal else None),
            ns.FlowConfig(**common, forcing_fn=FORCING, source_fn=SOURCE if nscal else None))


def _lifts(jmesh, nscal):
    """(ub, tb) as numpy: the annulus' free stream (1, 0) outside the
    cylinder, whose mask keeps it on the inflow only, and theta = 1 on the
    cylinder; zero on the channel."""
    shape = tuple(jmesh.bm1.shape)
    x = np.asarray(jmesh.x)
    r = np.sqrt(x[0] ** 2 + x[1] ** 2)
    if "outer" not in dict(jmesh.bc):
        return np.zeros((2,) + shape), np.zeros((nscal,) + shape)
    free = (r > 0.5 + 1e-8).astype(float)
    return np.stack([free, 0 * free]), np.broadcast_to(1.0 - free, (nscal,) + shape).copy()


def _random_state(jmesh, nscal, seed):
    """Fields with history, as numpy: velocity C0 and on its Dirichlet
    values, pressure, scalars, their lags."""
    rng = np.random.default_rng(seed)
    shape = tuple(jmesh.bm1.shape)
    pshape = tuple(jmesh.bm2.shape)

    def c0(lead):
        f = jsem.dsavg(jmesh, jnp.asarray(rng.standard_normal(lead + shape)))
        return np.asarray(f)

    return dict(u=c0((2,)), p=rng.standard_normal(pshape), theta=c0((nscal,)),
                ulag=c0((2, 2)), nlag=0.1 * c0((2, 2)), tlag=c0((2, nscal)),
                ntlag=0.1 * c0((2, nscal)), plag=rng.standard_normal((1,) + pshape), time=0.3)


def _states(fields):
    j = jns.FlowState(**{k: jnp.asarray(v) for k, v in fields.items()})
    p = ns.FlowState(**{k: (t(v) if k != "time" else v) for k, v in fields.items()})
    return j, p


def _compare(got, want, tol):
    for k in ("u", "p", "theta", "ulag", "nlag", "tlag", "ntlag", "plag"):
        g, w = getattr(got, k), np.asarray(getattr(want, k))
        if w.size:
            assert rel(g, w) <= tol, (k, rel(g, w))
    assert got.time == pytest.approx(float(want.time), abs=1e-14)


_jstep = jax.jit(jns.step, static_argnames=("cfg", "order"))


@pytest.mark.parametrize("nscal", [0, 1])
@pytest.mark.parametrize("order", [1, 2, 3])
def test_step_matches_reference(flow_mesh, order, nscal):
    name, (jmesh, mesh) = flow_mesh
    jcfg, cfg = _configs(nscal, pextrap=2 if order == 3 else 1)
    ub, tb = _lifts(jmesh, nscal)
    jst, st = _states(_random_state(jmesh, nscal, seed=order + 10 * nscal))
    g0 = ns._BDF[order][0]
    jdiags = [jns.helmholtz_diag(jmesh, 0.02, g0 / cfg.dt, jmesh.tmask)] if nscal else None
    want = _jstep(jmesh, jcfg, jst, order=order, ub=jnp.asarray(ub), tb=jnp.asarray(tb),
                  tdiags=jdiags, vdiag=jns.helmholtz_diag(jmesh, cfg.viscosity, g0 / cfg.dt,
                                                          jmesh.vmask))
    vdiag, tdiags = ns.bdf3_diags(mesh, dataclasses.replace(cfg, torder=order))
    (vsolve, tsolves), = ns.velocity_solvers(mesh, cfg, [order], vdiag, tdiags).values()
    (psolve,) = ns.pressure_solvers(mesh, cfg, [order]).values()
    stats = {}
    got = ns.step(mesh, cfg, st, order, psolve, vsolve, tsolves, ub=t(ub), tb=t(tb), stats=stats)
    _compare(got, want, 1e-10)
    # one velocity, one pressure and nscal scalar solves, each logged
    assert sorted(stats) == ["helmholtz", "pressure"] + ["scalar"] * nscal
    assert min(stats["helmholtz"]) > 0 and len(stats.get("scalar", [])) == nscal
    if name == "annulus":  # the lift reaches the solution
        inflow = (1 - mesh.vmask[0]) * (mesh.x[0] < -1.0)
        assert float((got.u[0] * inflow).max()) == pytest.approx(1.0)


# ---------------------------------------------------------------------------
# advance, advance_adaptive, the linearized stepper's pressure treatment
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("pextrap", [1, 2])
def test_advance_matches_reference(flow_mesh, pextrap):
    """20 steps from the smooth start, with the E preconditioner, on the
    annulus with a scalar (inflow lift, Dirichlet cylinder temperature)."""
    name, (jmesh, mesh) = flow_mesh
    nscal = 1 if name == "annulus" else 0
    jcfg, cfg = _configs(nscal, pextrap=pextrap)
    ub, tb = _lifts(jmesh, nscal)
    vmask = np.asarray(jmesh.vmask)
    y = np.asarray(jmesh.x[1])
    u0 = vmask * np.stack([0.5 + 0.2 * np.sin(y), 0.1 * np.cos(y)]) + (1 - vmask) * ub
    th0 = np.broadcast_to(0.5 * y, (nscal,) + y.shape).copy()
    jst = jns.initial_state(jmesh, jcfg, u=jnp.asarray(u0), theta=jnp.asarray(th0))
    want = jns.advance(jmesh, jcfg, jst, 20, ub=jnp.asarray(ub), tb=jnp.asarray(tb),
                       pc_e=jbuild(jmesh, cfg.dt / (11 / 6), compress=False))
    st = ns.initial_state(mesh, cfg, u=t(u0), theta=t(th0))
    stats = {}
    got = ns.advance(mesh, cfg, st, 20, ub=t(ub), tb=t(tb), pc_e=build_e_preconditioner(mesh),
                     stats=stats)
    _compare(got, want, 1e-10)
    assert len(stats["helmholtz"]) == len(stats["pressure"]) == 20
    assert float(stokes.div_weak(mesh, got.u).abs().max()) < 1e-9


def test_propagate_with_extrapolated_pressure_matches_reference():
    """step_lin honours pextrap = 2 as the reference's does."""
    jmesh, mesh = _meshes("channel")
    fc = dict(viscosity=1 / 500, dt=1e-2, vtol=1e-12, ptol=1e-12, pextrap=2)
    y = np.asarray(jmesh.x[1])
    base = np.stack([1 - y**2, 0 * y])
    rng = np.random.default_rng(4)
    u0 = np.asarray(jmesh.vmask * jsem.dsavg(jmesh, jnp.asarray(rng.standard_normal(base.shape))))
    th = np.zeros((0,) + y.shape)
    want, _ = jlin.propagate(jmesh, jlin.LinConfig(flow=jns.FlowConfig(**fc)), jnp.asarray(base),
                             jnp.asarray(th), jnp.asarray(u0), jnp.asarray(th), 12)
    cfg = lin.LinConfig(flow=ns.FlowConfig(**fc))
    got, _ = lin.propagate(mesh, cfg, t(base), t(th), t(u0), t(th), 12)
    assert rel(got, want) <= 1e-10
    incremental = lin.LinConfig(flow=dataclasses.replace(cfg.flow, pextrap=1))
    other, _ = lin.propagate(mesh, incremental, t(base), t(th), t(u0), t(th), 12)
    assert rel(other, want) > 1e-8  # the treatments differ


def test_advance_adaptive_matches_reference():
    """tests/test_stepper.py::test_advance_adaptive_variable_dt's forced
    channel, cut to t = 0.6 in chunks of 3 steps (dt re-derived 3-4 times)."""
    kw = dict(nels=(3, 4), lims=((0.0, 2 * np.pi), (-1.0, 1.0)), bc=CHANNEL_BC, order=4)
    jmesh, mesh = jbox_mesh(**kw), box_mesh(**kw, device="cpu")
    nu = 0.05
    common = dict(viscosity=nu, dt=0.02, vtol=1e-12, ptol=1e-12)
    jcfg = jns.FlowConfig(**common, forcing_fn=lambda m, tm, u, th: jnp.stack(
        [2 * nu * jnp.ones_like(m.x[0]), jnp.zeros_like(m.x[0])]))
    cfg = ns.FlowConfig(**common, forcing_fn=lambda m, tm, u, th: torch.stack(
        [2 * nu * torch.ones_like(m.x[0]), torch.zeros_like(m.x[0])]))
    y = np.asarray(jmesh.x[1])
    u0 = np.asarray(jmesh.vmask) * np.stack([0.5 * (1 - y**2), 0 * y])
    want = jns.advance_adaptive(jmesh, jcfg, jns.initial_state(jmesh, jcfg, u=jnp.asarray(u0)),
                                endtime=0.6, cfl=0.4, chunk=3)
    stats = {}
    got = ns.advance_adaptive(mesh, cfg, ns.initial_state(mesh, cfg, u=t(u0)), endtime=0.6,
                              cfl=0.4, chunk=3, stats=stats)
    assert abs(got.time - 0.6) < 1e-12 and abs(got.time - float(want.time)) < 1e-12
    assert rel(got.u, want.u) <= 1e-10 and rel(got.p, want.p) <= 1e-10
    dts = stats["solver_builds"]
    assert len(dts) == len(set(dts)) > 1  # one set per distinct dt
    assert len(stats["helmholtz"]) == len(stats["pressure"]) > 3 * (len(dts) - 1)


# ---------------------------------------------------------------------------
# the port's own physics
# ---------------------------------------------------------------------------


def test_taylor_green_decay():
    """tests/test_stepper.py::test_taylor_green on the port: the exact decay
    rate, the analytic pressure, a discretely divergence-free field."""
    mesh = box_mesh((4, 4), ((0, 2 * np.pi), (0, 2 * np.pi)),
                    {"x-": "P", "x+": "P", "y-": "P", "y+": "P"}, order=7, device="cpu")
    nu = 0.05
    cfg = ns.FlowConfig(viscosity=nu, dt=4e-3, vtol=1e-12, ptol=1e-12)
    x, y = mesh.x[0], mesh.x[1]
    u0 = torch.stack([torch.sin(x) * torch.cos(y), -torch.cos(x) * torch.sin(y)])
    st = ns.advance(mesh, cfg, ns.initial_state(mesh, cfg, u=u0), 50)
    ue = u0 * np.exp(-2 * nu * st.time)
    assert float(sem.mass_dot(mesh, st.u - ue, st.u - ue) / sem.mass_dot(mesh, ue, ue)) < 5e-6**2
    x2, y2 = interp_nd(mesh.j12, x, 2), interp_nd(mesh.j12, y, 2)
    pe = 0.25 * (torch.cos(2 * x2) + torch.cos(2 * y2)) * np.exp(-4 * nu * st.time)
    assert float((st.p - stokes.remove_pressure_mean(mesh, pe)).abs().max()) < 5e-4
    assert float(stokes.div_weak(mesh, st.u).abs().max()) < 1e-10


def test_linearized_matches_nonlinear_difference():
    """tests/test_stepper.py::test_linearized_matches_nonlinear_difference on
    the port: M u' ~ (Phi(U + eps u') - Phi(U)) / eps about the forced
    channel's steady Poiseuille flow."""
    mesh = box_mesh(**CHANNEL, device="cpu")
    nu = 0.05

    def forcing(m, time, u, th):
        return torch.stack([torch.full_like(m.x[0], 2.0 * nu), torch.zeros_like(m.x[0])])

    fc = ns.FlowConfig(viscosity=nu, dt=5e-3, vtol=1e-13, ptol=1e-13, forcing_fn=forcing)
    y = mesh.x[1]
    base = torch.stack([1 - y**2, 0 * y])
    th0 = torch.zeros((0,) + tuple(mesh.bm1.shape), dtype=torch.float64)
    rng = np.random.default_rng(2)
    du = mesh.vmask * sem.dsavg(mesh, t(rng.standard_normal(tuple(base.shape))))
    nsteps = 10
    mu, _ = lin.propagate(mesh, lin.LinConfig(flow=fc), base, th0, du, th0, nsteps)
    eps = 1e-6
    s_base = ns.advance(mesh, fc, ns.initial_state(mesh, fc, u=base), nsteps)
    s_pert = ns.advance(mesh, fc, ns.initial_state(mesh, fc, u=base + eps * du), nsteps)
    fd = (s_pert.u - s_base.u) / eps
    err = sem.mass_dot(mesh, mu - fd, mu - fd) / sem.mass_dot(mesh, fd, fd)
    assert float(err.sqrt()) < 1e-5
