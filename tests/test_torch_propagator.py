"""Port parity: the linearized propagator, Arnoldi and the stability driver.

Fixture: the Poiseuille case of tests/test_stability.py ((4,5) elements at
order 6, Re = 500, vtol = ptol = 1e-12, tau = 0.5) in both packages, f64 on
the CPU. Tolerances:
  * dt and nsteps: exact (same host arithmetic on the same base flow);
  * propagate: <= 1e-10 absolute on a B-normalized start — the inner solves
    run to 1e-12, and 29 steps accumulate their truncation;
  * Arnoldi (kdim 8, one cycle, no early exit): Hessenberg entries <= 1e-9;
    Ritz values, as sorted sets, <= 1e-8 (an unconverged 8x8 projection can
    amplify the 1e-10 matvec difference somewhat).
The full Orr-Sommerfeld oracle is the `slow` tier, as in test_stability.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neklab_tpu.krylov.eigs import _expand_krylov as jexpand
from neklab_tpu.krylov.space import KrylovBasis as JBasis
from neklab_tpu.linops.exponential_propagator import ExponentialPropagator as JProp
from neklab_tpu.mesh.box import box_mesh as jbox_mesh
from neklab_tpu.models import linearized as jlin
from neklab_tpu.models.navier_stokes import FlowConfig as JFlowConfig
from neklab_tpu.ops import sem as jsem
from neklab_tpu.vectors import flow_vector as jflow_vector
from neklab_tpu.vectors import flow_vector_space as jspace_of
from neklab_tpu_torch.analysis import linear_stability_analysis_fixed_point
from neklab_tpu_torch.krylov.eigs import _expand_krylov
from neklab_tpu_torch.krylov.space import KrylovBasis
from neklab_tpu_torch.linops.exponential_propagator import ExponentialPropagator
from neklab_tpu_torch.mesh.box import box_mesh
from neklab_tpu_torch.models import linearized as lin
from neklab_tpu_torch.models import navier_stokes as ns
from neklab_tpu_torch.models.navier_stokes import FlowConfig
from neklab_tpu_torch.utils.orr_sommerfeld import orr_sommerfeld_spectrum, shear_mode_eigenvalues
from neklab_tpu_torch.vectors import flow_vector, flow_vector_space, project_c0
from torch_port_helpers import CHANNEL_BC, absdiff, cg_counts, t

RE = 500.0
MESH = dict(nels=(4, 5), lims=((0, 2 * np.pi), (-1, 1)), bc=CHANNEL_BC, order=6)


@pytest.fixture(scope="module")
def poiseuille():
    jmesh, mesh = jbox_mesh(**MESH), box_mesh(**MESH, device="cpu")
    fc = dict(viscosity=1 / RE, dt=1e-2, vtol=1e-12, ptol=1e-12)
    y = jmesh.x[1]
    jprop = JProp(jmesh, jlin.LinConfig(flow=JFlowConfig(**fc)), jnp.stack([1 - y**2, 0 * y]),
                  tau=0.5, cfl=0.5)
    y = mesh.x[1]
    prop = ExponentialPropagator(mesh, lin.LinConfig(flow=FlowConfig(**fc)),
                                 torch.stack([1 - y**2, 0 * y]), tau=0.5, cfl=0.5)
    # numpy-seeded start: C0-projected, masked, B-normalized
    u = np.random.default_rng(11).standard_normal((2,) + tuple(jmesh.bm1.shape))
    u = np.asarray(jmesh.vmask * jsem.dsavg(jmesh, jnp.asarray(u)))
    u = u / np.sqrt(float(jsem.mass_dot(jmesh, u, u)))
    return jmesh, mesh, jprop, prop, u


def test_timestep_and_horizon_match(poiseuille):
    _, _, jprop, prop, _ = poiseuille
    assert prop.dt == jprop.dt
    assert prop.nsteps == jprop.nsteps


def test_propagate_matches_reference(poiseuille):
    jmesh, mesh, jprop, prop, u = poiseuille
    th = np.zeros((0,) + tuple(jmesh.bm1.shape))
    ref = jprop.matvec({"u": jnp.asarray(u), "theta": jnp.asarray(th)})
    out = prop.matvec({"u": t(u), "theta": t(th)})
    assert absdiff(out["u"], ref["u"]) <= 1e-10
    assert out["theta"].shape == (0,) + tuple(jmesh.bm1.shape)


def test_propagate_reports_iterations_per_step(poiseuille):
    """`stats` gets one velocity and one pressure CG count per step, and
    collecting them leaves the result as it was."""
    _, mesh, _, prop, u = poiseuille
    th = torch.zeros((0,) + tuple(mesh.bm1.shape), dtype=torch.float64)
    args = (mesh, prop.cfg, prop.base_u, prop.base_theta, t(u), th, 4)
    kw = dict(pc_e=prop.pc_e, vdiag=prop.vdiag, psolves=prop.psolves, vsolves=prop.vsolves)
    stats = {}
    out = lin.propagate(*args, stats=stats, **kw)[0]
    iters = cg_counts(stats)
    assert sorted(iters) == ["helmholtz", "pressure"]
    assert all(len(v) == 4 and min(v) > 0 for v in iters.values()), iters
    assert torch.equal(out, lin.propagate(*args, **kw)[0])


def test_propagate_with_prebuilt_solvers_matches_reference_twice(poiseuille):
    """`propagate` with velocity and pressure solvers built once
    (`velocity_solvers`, `pressure_solvers`) and reused for two calls
    matches the reference's `propagate` both times."""
    jmesh, mesh, jprop, prop, u = poiseuille
    th = np.zeros((0,) + tuple(jmesh.bm1.shape))
    ref = jlin.propagate(jmesh, jprop.cfg, jprop.base_u, jprop.base_theta, jnp.asarray(u),
                         jnp.asarray(th), jprop.nsteps, pc_e=jprop.pc_e, vdiag=jprop.vdiag)[0]
    fc = prop.cfg.flow
    orders = ns.bdf_orders(fc, prop.nsteps)
    psolves = ns.pressure_solvers(mesh, fc, orders, prop.pc_e)
    vsolves = ns.velocity_solvers(mesh, fc, orders, prop.vdiag, prop.tdiags)
    assert sorted(vsolves) == sorted(psolves) == [1, 2, 3]
    for _ in range(2):
        out = lin.propagate(mesh, prop.cfg, prop.base_u, prop.base_theta, t(u), t(th),
                            prop.nsteps, pc_e=prop.pc_e, vdiag=prop.vdiag, psolves=psolves,
                            vsolves=vsolves)[0]
        assert absdiff(out, ref) <= 1e-10


def test_arnoldi_and_ritz_values_match(poiseuille, tmp_path):
    jmesh, mesh, jprop, prop, u = poiseuille
    kdim = 8
    th = np.zeros((0,) + tuple(jmesh.bm1.shape))
    jv0 = {"u": jnp.asarray(u), "theta": jnp.asarray(th)}
    v0 = {"u": t(u), "theta": t(th)}

    jspace = jspace_of(jmesh, 0)
    jV = JBasis(jspace, jv0, kdim + 1)
    jV.append(jv0)
    jH = np.zeros((kdim + 1, kdim))
    assert jexpand(jprop, jspace, jV, jH, 0, kdim) == (kdim, kdim)

    space = flow_vector_space(mesh, 0)
    V = KrylovBasis(space, v0, kdim + 1)
    V.append(v0)
    H = np.zeros((kdim + 1, kdim))
    assert _expand_krylov(prop, space, V, H, 0, kdim) == (kdim, kdim)
    assert np.abs(H - jH).max() <= 1e-9

    res = linear_stability_analysis_fixed_point(prop, space, kdim=kdim, nev=kdim, maxiter=1,
                                                check_every=0, v0=v0, outdir=str(tmp_path))
    jritz = np.linalg.eigvals(jH[:kdim, :kdim])
    assert np.abs(np.sort_complex(res.multipliers) - np.sort_complex(jritz)).max() <= 1e-8
    np.testing.assert_allclose(res.eigvals, np.log(res.multipliers.astype(complex)) / prop.tau)
    assert res.n_matvec == kdim and len(res.eigenvectors) == kdim
    saved = np.load(tmp_path / "dir_eigenspectrum.npy")
    np.testing.assert_array_equal(saved, np.stack([res.eigvals.real, res.eigvals.imag]))


def test_flow_vector_space_matches_reference(poiseuille):
    """The Krylov space: B-weighted dots (also stacked against a basis, as
    CGS2 uses them) match the reference's; `rand` gives a seeded,
    C0-conforming, BC-masked vector on the mesh's device."""
    jmesh, mesh, _, _, u = poiseuille
    w = np.random.default_rng(12).standard_normal((3,) + u.shape)
    jspace, space = jspace_of(jmesh, 0), flow_vector_space(mesh, 0)
    jx, x = jflow_vector(jmesh, 0, u=jnp.asarray(u)), flow_vector(mesh, 0, u=t(u))
    stack = {"u": t(w), "theta": torch.zeros((3, 0) + u.shape[1:], dtype=torch.float64)}
    jdots = [jspace.dot(jflow_vector(jmesh, 0, u=jnp.asarray(wi)), jx) for wi in w]
    assert abs(space.dot(x, x) - jspace.dot(jx, jx)) <= 1e-12
    np.testing.assert_allclose(space.dot_fn(stack, x).numpy(), jdots, rtol=1e-12)
    assert tuple(flow_vector(mesh, 0)["theta"].shape) == (0,) + u.shape[1:]
    v = space.rand(3)
    assert torch.equal(v["u"], space.rand(3)["u"])
    assert absdiff(project_c0(mesh, v)["u"], v["u"]) <= 1e-14
    assert v["u"].device == mesh.device and float(v["u"].abs().max()) > 0


def test_propagate_with_scalar_matches_reference():
    """Scalar transport with a linear buoyancy coupling rides along."""
    kw = dict(nels=(3, 3), lims=((0, 2 * np.pi), (-1, 1)), bc=CHANNEL_BC, order=4)
    jmesh, mesh = jbox_mesh(**kw), box_mesh(**kw, device="cpu")
    fc = dict(viscosity=1e-2, dt=2e-2, nscal=1, conductivity=(2e-2,), vtol=1e-12,
              ptol=1e-12, ttol=1e-12)
    jcfg = jlin.LinConfig(flow=JFlowConfig(**fc),
                          lin_forcing_fn=lambda m, u, th: jnp.stack([0 * th[0], th[0]]))
    cfg = lin.LinConfig(flow=FlowConfig(**fc),
                        lin_forcing_fn=lambda m, u, th: torch.stack([0 * th[0], th[0]]))
    y = np.asarray(jmesh.x[1])
    base_u, base_th = np.stack([1 - y**2, 0 * y]), (0.5 * (1 - y))[None]
    rng = np.random.default_rng(4)
    u0 = np.asarray(jmesh.vmask * jsem.dsavg(jmesh, jnp.asarray(
        rng.standard_normal((2,) + tuple(jmesh.bm1.shape)))))
    th0 = np.asarray(jmesh.tmask * jsem.dsavg(jmesh, jnp.asarray(
        rng.standard_normal((1,) + tuple(jmesh.bm1.shape)))))
    ju, jth = jlin.propagate(jmesh, jcfg, jnp.asarray(base_u), jnp.asarray(base_th),
                             jnp.asarray(u0), jnp.asarray(th0), 6)
    uu, tth = lin.propagate(mesh, cfg, t(base_u), t(base_th), t(u0), t(th0), 6)
    assert absdiff(uu, ju) <= 1e-10
    assert absdiff(tth, jth) <= 1e-10


def _oracle(re):
    cand = list(shear_mode_eigenvalues(re, 6).astype(complex))
    for a in (1.0, 2.0):
        lam = orr_sommerfeld_spectrum(re, a, 96)[:6]
        cand.extend(lam)
        cand.extend(np.conj(lam))
    return np.array(cand)


@pytest.mark.slow
def test_poiseuille_eigenvalues_port(poiseuille):
    """The port's test_stability.py::test_poiseuille_eigenvalues."""
    _, mesh, _, prop, _ = poiseuille
    res = linear_stability_analysis_fixed_point(prop, flow_vector_space(mesh, 0), kdim=40,
                                                nev=4, tol=2e-6, maxiter=12)
    assert res.residuals.max() < 2e-6
    cand = _oracle(RE)
    for lam in res.eigvals:
        dist = np.min(np.abs(cand - lam))
        assert dist < 2e-4, (lam, dist)
    assert abs(res.eigvals[0] - (-(1 / RE) * (np.pi / 2) ** 2)) < 1e-5
