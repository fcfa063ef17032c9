"""Port parity: the 3-D linearized propagator, its exact discrete adjoint,
and chip_smoke phase 15's propagator with its analytic oracle.

Inputs are numpy-seeded and go through both packages, f64 on the CPU.
Meshes: tests/test_stepper.py's channel, (2, 2, 2) elements at order 4,
periodic in x and z and walled in y, and chip_smoke phase 15's (4, 5, 2)
channel at order 6 (plane Poiseuille at Re = 500, extruded spanwise).
Tolerances:
  * `propagate` and the adjoint over 6 steps: 1e-10 relative (inner solves
    at 1e-12, the adjoint's at 1e-13);
  * the B-adjoint identity: 1e-9 relative, as in the 2-D tests;
  * one ExponentialPropagator matvec on phase 15's mesh: 1e-9 absolute on
    a B-normalized input (inner solves at 1e-12).
The oracle of phase 15: the spanwise-uniform shear modes cos(pi y / 2) e_x
and cos(pi y / 2) e_z are eigenvectors of the linearized operator about
plane Poiseuille flow with lambda = -nu (pi / 2)^2; one matvec maps each to
exp(lambda tau) times itself, to the discretisation's error: 1e-7
relative at 2 steps of dt = 0.05 (the BDF1 step's error, (lambda dt)^2 / 2
~ 3e-8, against 1 - exp(lambda tau) = 4.9e-4). That eigenvalue is double,
and an eigensolve from one start vector reports it once, then -nu pi^2:
both packages' `eigs` on a matrix with the phase's leading multipliers.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neklab_tpu.linops.exponential_propagator import ExponentialPropagator as JProp
from neklab_tpu.mesh.box import box_mesh as jbox_mesh
from neklab_tpu.models import linearized as jlin
from neklab_tpu.models import navier_stokes as jns
from neklab_tpu.models.precond import build_e_preconditioner as jbuild
from neklab_tpu.ops import sem as jsem
from neklab_tpu_torch.linops.exponential_propagator import ExponentialPropagator
from neklab_tpu_torch.mesh.box import box_mesh
from neklab_tpu_torch.models import linearized as lin
from neklab_tpu_torch.models import navier_stokes as ns
from neklab_tpu_torch.models.precond import build_e_preconditioner
from neklab_tpu_torch.ops import sem
from torch_port_helpers import absdiff, rel, t

CHANNEL3 = dict(nels=(2, 2, 2), lims=((0, 2.0), (-1, 1), (0, 2.0)),
                bc={"x-": "P", "x+": "P", "y-": "W", "y+": "W", "z-": "P", "z+": "P"}, order=4)
# chip_smoke phase 15: plane Poiseuille at Re = 500, extruded spanwise
CHANNEL15 = dict(nels=(4, 5, 2), lims=((0, 2 * np.pi), (-1, 1), (0, 2.0)),
                 bc=CHANNEL3["bc"], order=6)
NSTEPS = 6  # the linearized map's steps: the BDF1/2 ramp and four BDF3 steps


@pytest.fixture(autouse=True)
def no_cache(monkeypatch):
    monkeypatch.setenv("NEKLAB_PRECOND_CACHE", "0")


def _c0(jmesh, rng):
    """A C0, velocity-masked vector field as numpy."""
    f = jsem.dsavg(jmesh, jnp.asarray(rng.standard_normal((3,) + tuple(jmesh.bm1.shape))))
    return np.asarray(jmesh.vmask * f)


def _channel_propagators():
    """The (2, 2, 2) channel about (1 - y^2, 0, 0), nu = 0.01, dt = 0.02,
    inner solves at 1e-12, the default 3-D preconditioner."""
    jmesh, mesh = jbox_mesh(**CHANNEL3), box_mesh(**CHANNEL3, device="cpu")
    fc = dict(viscosity=0.01, dt=2e-2, vtol=1e-12, ptol=1e-12)
    y = np.asarray(jmesh.x[1])
    base = np.stack([1 - y**2, 0 * y, 0 * y])
    return (jmesh, jlin.LinConfig(flow=jns.FlowConfig(**fc)), mesh,
            lin.LinConfig(flow=ns.FlowConfig(**fc)), base)


def test_propagate_and_adjoint_3d():
    """propagate (6 steps) and the exact discrete B-adjoint against the
    reference's (`jax.linear_transpose` there), inner solves at 1e-12 and
    1e-13; then <M u, v>_B = <u, M* v>_B."""
    jmesh, jcfg, mesh, cfg, base = _channel_propagators()
    jcfg_a = dataclasses.replace(jcfg, flow=dataclasses.replace(jcfg.flow, vtol=1e-13,
                                                                 ptol=1e-13))
    cfg_a = dataclasses.replace(cfg, flow=dataclasses.replace(cfg.flow, vtol=1e-13, ptol=1e-13))
    rng = np.random.default_rng(4)
    u0, v0 = _c0(jmesh, rng), _c0(jmesh, rng)
    th = np.zeros((0,) + tuple(jmesh.bm1.shape))
    jpc, pc = jbuild(jmesh, 1.0), build_e_preconditioner(mesh)
    want, _ = jlin.propagate(jmesh, jcfg, jnp.asarray(base), jnp.asarray(th), jnp.asarray(u0),
                             jnp.asarray(th), NSTEPS, pc_e=jpc)
    stats = {}
    got, _ = lin.propagate(mesh, cfg, t(base), t(th), t(u0), t(th), NSTEPS, pc_e=pc,
                            stats=stats)
    assert rel(got, want) <= 1e-10
    assert len(stats["helmholtz"]) == NSTEPS and min(stats["pressure"]) > 0

    jadj = jlin.make_adjoint_propagator(jmesh, jcfg_a, jnp.asarray(base), jnp.asarray(th), NSTEPS,
                                        pc_e=jpc)
    adj = lin.make_adjoint_propagator(mesh, cfg_a, t(base), t(th), NSTEPS, pc_e=pc)
    want_a, _ = jadj(jnp.asarray(v0), jnp.asarray(th))
    got_a, _ = adj(t(v0), t(th))
    assert rel(got_a, want_a) <= 1e-10

    mu, _ = lin.propagate(mesh, cfg_a, t(base), t(th), t(u0), t(th), NSTEPS, pc_e=pc)
    lhs = float(sem.mass_dot(mesh, mu, t(v0)))
    rhs = float(sem.mass_dot(mesh, t(u0), got_a))
    assert abs(lhs - rhs) / abs(lhs) < 1e-9, (lhs, rhs)


# ---------------------------------------------------------------------------
# chip_smoke phase 15's propagator and its oracle
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def channel15():
    jmesh, mesh = jbox_mesh(**CHANNEL15), box_mesh(**CHANNEL15, device="cpu")
    fc = dict(viscosity=1 / 500, dt=1e-2, vtol=1e-12, ptol=1e-12)
    y = np.asarray(jmesh.x[1])
    base = np.stack([1 - y**2, 0 * y, 0 * y])
    prop = ExponentialPropagator(mesh, lin.LinConfig(flow=ns.FlowConfig(**fc)), t(base),
                                 tau=0.1, dt=0.05)
    return jmesh, mesh, base, fc, prop


def test_channel3d_matvec_matches_reference(channel15):
    """One matvec of the phase's propagator (here 2 steps of dt = 0.05, the
    phase's tau = 0.5 at its CFL step being ~50) against the reference's."""
    jmesh, mesh, base, fc, prop = channel15
    jprop = JProp(jmesh, jlin.LinConfig(flow=jns.FlowConfig(**fc)), jnp.asarray(base), tau=0.1,
                  dt=0.05)
    assert (prop.dt, prop.nsteps) == (jprop.dt, jprop.nsteps) == (0.05, 2)
    u = _c0(jmesh, np.random.default_rng(5))
    u = u / np.sqrt(float(jsem.mass_dot(jmesh, u, u)))
    th = np.zeros((0,) + tuple(jmesh.bm1.shape))
    want = jprop.matvec({"u": jnp.asarray(u), "theta": jnp.asarray(th)})
    got = prop.matvec({"u": t(u), "theta": t(th)})
    assert absdiff(got["u"], want["u"]) <= 1e-9


def test_channel3d_shear_modes_are_eigenvectors(channel15):
    """The oracle of chip_smoke phase 15: cos(pi y / 2) e_x and
    cos(pi y / 2) e_z are mapped to exp(-nu (pi / 2)^2 tau) times
    themselves, to the discretisation's error."""
    _, mesh, _, fc, prop = channel15
    y = mesh.x[1]
    mu = np.exp(-fc["viscosity"] * (np.pi / 2) ** 2 * prop.tau)
    th = torch.zeros((0,) + tuple(mesh.bm1.shape), dtype=torch.float64)
    for k in (0, 2):
        u = torch.zeros((3,) + tuple(mesh.bm1.shape), dtype=torch.float64)
        u[k] = torch.cos(np.pi * y / 2)
        out = prop.matvec({"u": u, "theta": th})["u"]
        assert rel(out, mu * u) <= 1e-7, (k, rel(out, mu * u))


def test_double_eigenvalue_shows_once_in_both_packages():
    """Phase 15's leading eigenvalue is double: the x and z shear modes above
    see one discrete operator. A Krylov space grown from one start vector
    holds one direction of a double eigenspace, so both packages' `eigs`
    report it once and then the next distinct eigenvalue, -nu pi^2 (also
    double). Shown on a symmetric matrix with the phase's leading
    multipliers exp(lambda tau), the reference's pair to 1e-10."""
    from neklab_tpu.krylov import FunctionOperator as JFunctionOperator
    from neklab_tpu.krylov import eigs as jeigs
    from neklab_tpu.krylov import euclidean_space as jeuclidean_space
    from neklab_tpu_torch.krylov import FunctionOperator, euclidean_space
    from neklab_tpu_torch.krylov.eigs import eigs

    nu, tau, n = 1 / 500, 0.5, 400
    rng = np.random.default_rng(7)
    lead = -nu * np.pi**2 * np.array([0.25, 0.25, 1.0, 1.0, 1.25, 1.25])
    mu = np.exp(tau * np.concatenate([lead, -rng.uniform(0.03, 2.0, n - lead.size)]))
    q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    a = (q * mu) @ q.T
    aj, at_ = jnp.asarray(a), t(a)
    kw = dict(nev=2, kdim=40, tol=1e-8, maxiter=20)
    want = jeigs(JFunctionOperator(matvec=lambda x: {"x": aj @ x["x"]}),
                 jeuclidean_space(rand_template={"x": jnp.zeros(n)}), **kw)
    got = eigs(FunctionOperator(matvec=lambda x: {"x": at_ @ x["x"]}),
               euclidean_space(rand_template={"x": torch.zeros(n, dtype=torch.float64)}), **kw)
    pair = np.exp(tau * lead[[0, 2]])
    assert np.abs(want.eigvals - pair).max() <= 1e-10
    assert np.abs(got.eigvals - pair).max() <= 1e-10
