"""Port parity: the exact discrete adjoint, adjoint eigs, svds and transient
growth.

The port builds M^T as the backward of one recorded `propagate`, with every
symmetric piece its own backward (the Helmholtz twin, dssum, the CG solves,
the E apply); the reference takes it from `jax.linear_transpose`. Inputs
are numpy-seeded and go through both packages, f64 on the CPU.
Tolerances:
  * the symmetric pieces' backward against the pieces themselves: rel
    <= 1e-12 (the twin, another summation order) and exact (dssum);
  * the solve VJPs against `jax.linear_transpose` of the reference's
    solves: <= 1e-10 absolute at inner tolerances 1e-13;
  * rmatvec against the reference's on the Poiseuille Re=500 fixture of
    test_torch_propagator.py: <= 1e-9 absolute on a B-normalized input
    (the adjoint's inner solves run to 1e-13, 29 steps);
  * the B-adjoint identity <Mu, v>_B = <u, M*v>_B: 1e-9 relative, as the
    reference's tests/test_stepper.py::test_adjoint_consistency;
  * dense svds and adjoint eigs: the reference's answers to 1e-10 and 1e-8;
  * transient growth (kdim 12, nsv 2): sigma within 1e-8 relative of the
    reference's from the same start vector.
The Re=500 adjoint spectrum against the oracle is `slow`, as in the
reference's tests/test_stability.py.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neklab_tpu import analysis as janalysis
from neklab_tpu.krylov import FunctionOperator as JFunctionOperator
from neklab_tpu.krylov import eigs as jeigs
from neklab_tpu.krylov import euclidean_space
from neklab_tpu.krylov import svds as jsvds
from neklab_tpu.linops.exponential_propagator import ExponentialPropagator as JProp
from neklab_tpu.mesh.box import box_mesh as jbox_mesh
from neklab_tpu.mesh.cylinder import annulus_mesh
from neklab_tpu.models import linearized as jlin
from neklab_tpu.models import navier_stokes as jns
from neklab_tpu.models import stokes as jstokes
from neklab_tpu.models.precond import build_e_preconditioner as jbuild
from neklab_tpu.ops import sem as jsem
from neklab_tpu.vectors import flow_vector_space as jspace_of
from neklab_tpu_torch.analysis import (linear_stability_analysis_fixed_point,
                                       transient_growth_analysis_fixed_point)
from neklab_tpu_torch.krylov.eigs import eigs
from neklab_tpu_torch.krylov.linop import AdjointOperator, FunctionOperator
from neklab_tpu_torch.krylov.space import VectorSpace
from neklab_tpu_torch.krylov.svd import svds
from neklab_tpu_torch.linops.exponential_propagator import ExponentialPropagator
from neklab_tpu_torch.mesh.box import box_mesh
from neklab_tpu_torch.models import linearized as lin
from neklab_tpu_torch.models import navier_stokes as ns
from neklab_tpu_torch.models.precond import build_e_preconditioner
from neklab_tpu_torch.ops import helmholtz_kernel, sem
from neklab_tpu_torch.vectors import flow_vector_space
from torch_port_helpers import CHANNEL_BC, absdiff, carry_mesh, rel, t, to_np

RE = 500.0
MESH = dict(nels=(4, 5), lims=((0, 2 * np.pi), (-1, 1)), bc=CHANNEL_BC, order=6)
DT = 1e-2
H1, H2 = 1.0 / 500, (11.0 / 6.0) / DT
S = DT / (11.0 / 6.0)  # dt / g0


def grad_of(fn, inputs, cotangents):
    """The VJP of fn at `inputs` (f64 CPU tensors) for `cotangents`."""
    inputs = [x.clone().requires_grad_(True) for x in inputs]
    out = fn(*inputs)
    return torch.autograd.grad(out, inputs, cotangents)


# ---------------------------------------------------------------------------
# the symmetric pieces
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("lead", [(), (2,), (5,)])
def test_twin_vjp_is_the_twin(lead):
    """H is symmetric per element, so the plain twin's VJP is the twin on the
    cotangent: what the kernel's backward launches on the card."""
    n, nel = 6, 7
    rng = np.random.default_rng(len(lead))
    geo = (n, n, nel)
    args = (t(rng.standard_normal((n, n))), t(1 + rng.random(geo)), t(0.3 * rng.standard_normal(geo)),
            t(1 + rng.random(geo)), t(rng.random(geo)), 0.01, 3.7)
    u, g = (t(rng.standard_normal(lead + geo)) for _ in range(2))
    (vjp,) = grad_of(lambda v: helmholtz_kernel.helmholtz2d(v, *args), [u], [g])
    assert rel(vjp, helmholtz_kernel.helmholtz2d_plain(g, *args)) <= 1e-12
    # on CPU tensors the wrapper is the twin, differentiated by autograd
    out = helmholtz_kernel.helmholtz2d(u.requires_grad_(True), *args)
    assert out.grad_fn is not None


@pytest.fixture(scope="module")
def small_mesh():
    return box_mesh((2, 2), ((0, 2 * np.pi), (-1, 1)), CHANNEL_BC, order=3, device="cpu")


def test_dssum_gradcheck_and_backward(small_mesh):
    mesh = small_mesh
    rng = np.random.default_rng(2)
    f = t(rng.standard_normal((2,) + tuple(mesh.bm1.shape))).requires_grad_(True)
    assert torch.autograd.gradcheck(lambda x: sem.dssum(mesh, x), (f,))
    g = t(rng.standard_normal(tuple(f.shape)))
    (vjp,) = grad_of(lambda x: sem.dssum(mesh, x), [f.detach()], [g])
    assert torch.equal(vjp, sem.dssum(mesh, g))
    assert sem.dssum(mesh, f).grad_fn is not None


@pytest.fixture(scope="module")
def channel():
    return jbox_mesh(**MESH), box_mesh(**MESH, device="cpu")


def test_helmholtz_solve_vjp_matches_linear_transpose(channel):
    """The velocity solve's backward re-solves with the same built-once CG:
    the reference's custom_linear_solve(symmetric=True) transpose."""
    jmesh, mesh = channel
    rng = np.random.default_rng(3)
    shape = (2,) + tuple(jmesh.bm1.shape)
    rhs, ct = rng.standard_normal(shape), rng.standard_normal(shape)
    jdiag = jns.helmholtz_diag(jmesh, H1, H2, jmesh.vmask)
    zero = jnp.zeros(shape)
    (ref,) = jax.linear_transpose(
        lambda r: jns.helmholtz_solve(jmesh, r, H1, H2, jmesh.vmask, zero, 1e-13, 500, jdiag),
        jnp.asarray(rhs))(jnp.asarray(ct))
    solve = ns.make_helmholtz_solver(mesh, H1, H2, mesh.vmask,
                                     ns.helmholtz_diag(mesh, H1, H2, mesh.vmask), 1e-13, 500)
    stats = {}
    (vjp,) = grad_of(lambda r: solve(r, torch.zeros(shape, dtype=torch.float64), stats=stats),
                     [t(rhs)], [t(ct)])
    assert absdiff(vjp, ref) <= 1e-10
    # the forward solve and the backward re-solve each report their CG
    assert len(stats["helmholtz"]) == 2 and min(stats["helmholtz"]) > 3


def _pc_meshes(name):
    if name == "channel":
        kw = dict(nels=(8, 4), lims=((0, 2 * np.pi), (-1, 1)), bc=CHANNEL_BC, order=6)
        return jbox_mesh(**kw), box_mesh(**kw, device="cpu")
    jmesh = annulus_mesh(3, 8, r_in=0.5, r_out=2.0, order=4, dtype=jnp.float64)
    return jmesh, carry_mesh(jmesh)


@pytest.mark.parametrize("name", ["channel", "annulus"])
def test_pressure_solve_vjp_matches_linear_transpose(name):
    """The pressure solve with its warm start, as a linear map of (rhs, x0):
    the re-solve on the cotangent and the E apply's own backward against
    the reference's transpose (channel: the pure-Neumann projections)."""
    jmesh, mesh = _pc_meshes(name)
    rng = np.random.default_rng(6)
    pshape = tuple(jmesh.bm2.shape)
    rhs = -np.asarray(jstokes.div_weak(jmesh, jnp.asarray(
        rng.standard_normal((2,) + tuple(jmesh.bm1.shape)))))
    x0, ct = 1e-2 * rng.standard_normal(pshape), rng.standard_normal(pshape)
    jcfg = jns.FlowConfig(viscosity=H1, dt=DT, ptol=1e-13, pmaxit=500)
    cfg = ns.FlowConfig(viscosity=H1, dt=DT, ptol=1e-13, pmaxit=500)
    jsolve = jns.make_pressure_solver(jmesh, jcfg, S, pc=jbuild(jmesh, S, compress=False))
    ref = jax.linear_transpose(lambda r, x: jsolve(r, x0=x), jnp.asarray(rhs),
                               jnp.asarray(x0))(jnp.asarray(ct))
    solve = ns.make_pressure_solver(mesh, cfg, S, pc=build_e_preconditioner(mesh))
    vjp = grad_of(lambda r, x: solve(r, x0=x), [t(rhs), t(x0)], [t(ct)])
    for got, want in zip(vjp, ref):
        assert absdiff(got, want) <= 1e-10


# ---------------------------------------------------------------------------
# the adjoint propagator
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def poiseuille(channel):
    """test_torch_propagator.py's fixture: Re=500, vtol = ptol = 1e-12,
    tau = 0.5; a B-normalized C0 start; the reference's own Krylov space."""
    jmesh, mesh = channel
    fc = dict(viscosity=1 / RE, dt=1e-2, vtol=1e-12, ptol=1e-12)
    y = jmesh.x[1]
    jprop = JProp(jmesh, jlin.LinConfig(flow=jns.FlowConfig(**fc)), jnp.stack([1 - y**2, 0 * y]),
                  tau=0.5, cfl=0.5)
    y = mesh.x[1]
    prop = ExponentialPropagator(mesh, lin.LinConfig(flow=ns.FlowConfig(**fc)),
                                 torch.stack([1 - y**2, 0 * y]), tau=0.5, cfl=0.5)
    u = np.random.default_rng(11).standard_normal((2,) + tuple(jmesh.bm1.shape))
    u = np.asarray(jmesh.vmask * jsem.dsavg(jmesh, jnp.asarray(u)))
    u = u / np.sqrt(float(jsem.mass_dot(jmesh, u, u)))
    return jmesh, mesh, jprop, prop, u


def test_rmatvec_matches_reference(poiseuille):
    jmesh, mesh, jprop, prop, u = poiseuille
    th = np.zeros((0,) + tuple(jmesh.bm1.shape))
    ref = jprop.rmatvec({"u": jnp.asarray(u), "theta": jnp.asarray(th)})
    stats = {}
    out = prop.rmatvec({"u": t(u), "theta": t(th)}, stats=stats)
    assert absdiff(out["u"], ref["u"]) <= 1e-9
    assert tuple(out["theta"].shape) == th.shape
    # one transposed velocity and pressure solve per step, at 10x tighter
    # tolerances than the matvec's
    assert sorted(stats) == ["helmholtz", "pressure"]
    assert all(len(v) == prop.nsteps and min(v) > 0 for v in stats.values()), stats
    assert prop.cfg_adj.flow.vtol == prop.cfg_adj.flow.ptol == pytest.approx(1e-13)
    # one tape serves every call: a second call gives the same bits
    assert torch.equal(out["u"], prop.rmatvec({"u": t(u), "theta": t(th)})["u"])


def test_given_step_matches_reference(channel):
    """dt= replaces the CFL-derived step (the BFS example's use), in both
    packages the same way."""
    jmesh, mesh = channel
    fc = dict(viscosity=1 / RE, dt=1e-2)
    y = jmesh.x[1]
    jprop = JProp(jmesh, jlin.LinConfig(flow=jns.FlowConfig(**fc)), jnp.stack([1 - y**2, 0 * y]),
                  tau=0.5, dt=0.03)
    y = mesh.x[1]
    prop = ExponentialPropagator(mesh, lin.LinConfig(flow=ns.FlowConfig(**fc)),
                                 torch.stack([1 - y**2, 0 * y]), tau=0.5, dt=0.03)
    assert (prop.dt, prop.nsteps) == (jprop.dt, jprop.nsteps) and prop.nsteps == 17


def _coupled_case(nscal):
    """tests/test_stepper.py::test_adjoint_consistency: a (3, 2) channel at
    order 5, nu = 0.01, dt = 5e-3, tolerances 1e-13; with nscal = 1 a
    Boussinesq buoyancy and a stratification-like source."""
    mesh = box_mesh((3, 2), ((0, 2 * np.pi), (-1, 1)), CHANNEL_BC, order=5, device="cpu")
    kw = dict(nscal=1, conductivity=(0.02,)) if nscal else {}
    fc = ns.FlowConfig(viscosity=0.01, dt=5e-3, vtol=1e-13, ptol=1e-13, ttol=1e-13, **kw)
    lin_f = (lambda m, u, th: torch.stack([torch.zeros_like(th[0]), th[0]])) if nscal else None
    lin_s = (lambda m, u, th: u[1:2]) if nscal else None
    cfg = lin.LinConfig(flow=fc, lin_forcing_fn=lin_f, lin_source_fn=lin_s)
    y = mesh.x[1]
    shape = tuple(mesh.bm1.shape)
    return mesh, cfg, torch.stack([1 - y**2, 0 * y]), (0.5 * y).expand((nscal,) + shape)


@pytest.mark.parametrize("nscal", [0, 1])
def test_adjoint_identity(nscal):
    """<M u, v>_B = <u, M* v>_B on the conforming (C0, masked) subspace."""
    mesh, cfg, base_u, base_th = _coupled_case(nscal)
    shape = tuple(mesh.bm1.shape)
    rng = np.random.default_rng(30 + nscal)

    def conforming():
        u = mesh.vmask * sem.dsavg(mesh, t(rng.standard_normal((2,) + shape)))
        th = mesh.tmask * sem.dsavg(mesh, t(rng.standard_normal((nscal,) + shape)))
        return u, th

    (u0, t0), (v0, s0) = conforming(), conforming()
    nsteps = 7
    mu, mth = lin.propagate(mesh, cfg, base_u, base_th, u0, t0, nsteps)
    adj = lin.make_adjoint_propagator(mesh, cfg, base_u, base_th, nsteps)
    au, ath = adj(v0, s0)
    lhs = float(sem.mass_dot(mesh, mu, v0) + sem.mass_dot(mesh, mth, s0))
    rhs = float(sem.mass_dot(mesh, u0, au) + sem.mass_dot(mesh, t0, ath))
    assert abs(lhs - rhs) / abs(lhs) < 1e-9, (lhs, rhs)
    assert adj.tape_bytes is None  # measured on the card only
    if nscal:
        assert float(ath.abs().max()) > 0  # the scalar's adjoint is driven


# ---------------------------------------------------------------------------
# dense Krylov: svds and adjoint eigs
# ---------------------------------------------------------------------------


def _dense_ops(a):
    aj, at_ = jnp.asarray(a), t(a)
    jop = JFunctionOperator(matvec=lambda x: aj @ x, rmatvec=lambda x: aj.T @ x)
    op = FunctionOperator(matvec=lambda x: {"x": at_ @ x["x"]},
                          rmatvec=lambda x: {"x": at_.T @ x["x"]})
    space = VectorSpace(dot_fn=lambda x, y: (x["x"] * y["x"]).sum(-1))
    return jop, euclidean_space(rand_template=jnp.zeros(a.shape[0])), op, space


def test_svds_dense_matches_reference():
    """tests/test_krylov.py::test_svds_dense, both packages from one start."""
    m = 90
    rng = np.random.default_rng(1)
    a = rng.standard_normal((m, m))
    v0 = rng.standard_normal(m)
    jop, jspace, op, space = _dense_ops(a)
    ref = jsvds(jop, jspace, nsv=5, kdim=60, tol=1e-10, v0=jnp.asarray(v0))
    res = svds(op, space, nsv=5, kdim=60, tol=1e-10, v0={"x": t(v0)})
    assert res.n_matvec == ref.n_matvec
    assert np.max(np.abs(res.s - ref.s) / ref.s) < 1e-10
    want = np.linalg.svd(a, compute_uv=False)[:5]
    assert np.max(np.abs(res.s - want) / want) < 1e-8
    for s, u, v in zip(res.s, res.left_vectors(), res.right_vectors()):
        assert np.linalg.norm(a @ to_np(v["x"]) - s * to_np(u["x"])) < 1e-6 * s


def test_eigs_adjoint_dense_matches_reference():
    """tests/test_krylov.py::test_eigs_adjoint: the adjoint's spectrum is the
    direct one; the port's adjoint eigs matches the reference's."""
    n = 80
    rng = np.random.default_rng(3)
    a = rng.standard_normal((n, n)) / np.sqrt(n)
    v0 = rng.standard_normal(n)
    jop, jspace, op, space = _dense_ops(a)
    kw = dict(nev=3, kdim=40, tol=1e-8, maxiter=50)
    ref = jeigs(jop, jspace, adjoint=True, v0=jnp.asarray(v0), **kw)
    adj = eigs(op, space, adjoint=True, v0={"x": t(v0)}, **kw)
    direct = eigs(op, space, v0={"x": t(v0)}, **kw)
    assert np.max(np.abs(np.sort_complex(adj.eigvals) - np.sort_complex(ref.eigvals))) < 1e-8
    assert np.max(np.abs(np.sort_complex(adj.eigvals) - np.sort_complex(direct.eigvals))) < 1e-6
    # AdjointOperator swaps the two applications
    x = {"x": t(v0)}
    assert torch.equal(AdjointOperator(op).matvec(x)["x"], op.rmatvec(x)["x"])


# ---------------------------------------------------------------------------
# the transient-growth driver
# ---------------------------------------------------------------------------


def _spectrum_file(path):
    """[(index, sigma, residual)] of a singular_spectrum.dat, each line
    checked against the format `i sigma(.12e) residual(.3e)`."""
    rows = []
    for line in path.read_text().splitlines():
        assert re.fullmatch(r"\d+ \d\.\d{12}e[+-]\d\d \d\.\d{3}e[+-]\d\d", line), line
        i, s, r = line.split()
        rows.append((int(i), float(s), float(r)))
    return rows


def test_transient_growth_matches_reference(poiseuille, tmp_path):
    """kdim 12, nsv 2 as tests/test_stability.py::test_transient_growth; the
    port's space draws the reference's own start vector (the reference's
    rand of PRNGKey(1234), the driver's seed)."""
    jmesh, mesh, jprop, prop, _ = poiseuille
    kw = dict(kdim=12, nsv=2, tol=1e-7)
    jspace = jspace_of(jmesh, 0)
    ref = janalysis.transient_growth_analysis_fixed_point(jprop, jspace, outdir=str(tmp_path / "ref"),
                                                          **kw)
    jv0 = {k: t(v) for k, v in jspace.rand(jax.random.PRNGKey(1234)).items()}
    space = VectorSpace(dot_fn=flow_vector_space(mesh, 0).dot_fn,
                        rand_fn=lambda seed: jv0 if seed == 1234 else None)
    res = transient_growth_analysis_fixed_point(prop, space, outdir=str(tmp_path / "port"), **kw)
    assert res.n_matvec == ref.n_matvec
    np.testing.assert_allclose(res.sigma, ref.sigma, rtol=1e-8)
    # triplet identity: M v1 = sigma1 u1
    mv = prop.matvec(res.optimal_inputs[0])
    diff = {k: mv[k] - float(res.sigma[0]) * res.optimal_outputs[0][k] for k in mv}
    assert space.norm(diff) < 1e-5 * res.sigma[0]
    mu1 = np.exp(-(1 / RE) * (np.pi / 2) ** 2 * prop.tau)
    assert res.sigma[0] > mu1 * 1.001  # non-normal growth above the spectral bound
    got = _spectrum_file(tmp_path / "port" / "singular_spectrum.dat")
    want = _spectrum_file(tmp_path / "ref" / "singular_spectrum.dat")
    assert [r[0] for r in got] == [r[0] for r in want] == [1, 2]
    np.testing.assert_allclose([r[1] for r in got], [r[1] for r in want], rtol=1e-8)
    np.testing.assert_allclose([r[2] for r in got], [r[2] for r in want], rtol=1e-2, atol=1e-12)


@pytest.mark.slow
def test_poiseuille_adjoint_spectrum_port(poiseuille, tmp_path):
    """The port's tests/test_stability.py::test_poiseuille_adjoint_spectrum."""
    _, mesh, _, prop, _ = poiseuille
    res = linear_stability_analysis_fixed_point(prop, flow_vector_space(mesh, 0), kdim=30, nev=2,
                                                tol=1e-5, maxiter=12, adjoint=True,
                                                outdir=str(tmp_path))
    assert abs(res.eigvals[0] - (-(1 / RE) * (np.pi / 2) ** 2)) < 1e-4
    assert abs(res.eigvals[1] - (-(1 / RE) * np.pi**2)) < 1e-4
    assert (tmp_path / "adj_eigenspectrum.npy").exists()
