"""Port parity: Nek5000's residual projection (`recycle=`) of the pressure
solves, `eigs(which=)` and `bfs_inflow(dtype=)`.

Inputs are numpy-seeded and go through both packages, f64 on the CPU.
Cases and tolerances:

  * tests/test_stepper.py::test_recycled_solves_match_plain's channel (6 x 5
    elements at order 5, nu 2e-3, dt 5e-3, vtol 1e-12, ptol 1e-10, 30 steps):
    `propagate(recycle=6)` and `advance(recycle=6)` within 1e-7 of the
    output's max of the reference's recycle=6 and of the port's recycle=0
    (the reference test's own bound); the post-ramp pressure iterations,
    recycled against plain, are printed and may not grow. The same on a
    pure-Neumann walled box and on a channel with an outflow, both with
    the two-level preconditioner, whose exact E blocks run the pressure CG
    (and so the basis) in the element-first layout, 12 steps each;
  * a run no longer than the BDF ramp recycles nothing: recycle=6 gives
    recycle=0's output bit for bit;
  * tests/test_torch_newton.py's forced channel (tau 0.2 at dt 0.025: 6
    steps past the ramp): `FixedPointSystem(recycle=4)`'s response and its
    frozen and exact Jacobians' matvec and the exact one's rmatvec within
    1e-9 of the reference's recycle=4, the exact rmatvec twice from one
    recorded tape;
  * `ExponentialPropagator(recycle=4)`: <M u, v>_B = <u, M* v>_B with the
    recycled matvec and the recycle-free adjoint, to 1e-8 (the solvers'
    tolerance);
  * the basis carries no gradient and no tangent (`detach` drops the
    forward-mode tangent), and `advance` with a dual dt and recycle > 0
    raises;
  * `eigs(which="lr")` against the reference's on a dense non-normal matrix
    whose largest-modulus eigenvalue has a negative real part, to 1e-10;
    the checkpoint's fingerprint names `which`, and the reference resumes
    the port's file;
  * `bfs_inflow(mesh, dtype=)` against the reference's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.autograd.forward_ad as fwAD

from neklab_tpu.krylov import FunctionOperator as JFunctionOperator
from neklab_tpu.krylov import eigs as jeigs
from neklab_tpu.krylov import euclidean_space as jeuclidean_space
from neklab_tpu.mesh import bfs as jbfs
from neklab_tpu.mesh.box import box_mesh as jbox_mesh
from neklab_tpu.models import navier_stokes as jns
from neklab_tpu.models.linearized import LinConfig as JLinConfig
from neklab_tpu.models.linearized import propagate as jpropagate
from neklab_tpu.models.precond import build_e_preconditioner as jbuild_pc
from neklab_tpu.ops import sem as jsem
from neklab_tpu.systems.fixed_point import FixedPointSystem as JFixedPointSystem
from neklab_tpu_torch.krylov.eigs import eigs
from neklab_tpu_torch.krylov.linop import FunctionOperator
from neklab_tpu_torch.krylov.space import VectorSpace
from neklab_tpu_torch.linops.exponential_propagator import ExponentialPropagator
from neklab_tpu_torch.mesh import bfs
from neklab_tpu_torch.mesh.box import box_mesh
from neklab_tpu_torch.models import navier_stokes as ns
from neklab_tpu_torch.models.linearized import LinConfig, propagate
from neklab_tpu_torch.models.precond import build_e_preconditioner
from neklab_tpu_torch.ops import sem
from neklab_tpu_torch.systems.fixed_point import FixedPointSystem
from neklab_tpu_torch.vectors import flow_vector_space
from torch_port_helpers import CHANNEL_BC, WALLED_BC, absdiff, t, to_np

FLOW = dict(viscosity=2e-3, dt=5e-3, vtol=1e-12, ptol=1e-10)
# (box, boundary conditions, with the two-level preconditioner, steps): the
# reference test's channel (matrix-free E, element-last), a walled box and
# a channel with an outflow (E's exact blocks: element-first), each long
# enough for the 6 slots to roll over
CASES = {
    "channel": (((6, 5), ((0, 2 * np.pi), (-1, 1))), CHANNEL_BC, False, 30),
    "walled": (((4, 4), ((0, 1.0), (0, 1.0))), WALLED_BC, True, 12),
    "outflow": (((5, 3), ((0, 3.0), (-1, 1))),
                {"x-": "v", "x+": "O", "y-": "W", "y+": "W"}, True, 12),
}


def _c0(jmesh, a):
    return np.asarray(jmesh.vmask * jsem.dsavg(jmesh, jnp.asarray(a)))


def _case(name):
    (nels, lims), bc, pc, _ = CASES[name]
    jmesh = jbox_mesh(nels, lims, bc, order=5)
    mesh = box_mesh(nels, lims, bc, order=5, device="cpu")
    y = np.asarray(jmesh.x[1])
    base = np.stack([1 - y**2, 0 * y]) if name != "walled" else 0.0 * np.stack([y, y])
    rng = np.random.default_rng(0)
    u0 = _c0(jmesh, rng.standard_normal(base.shape))
    un = _c0(jmesh, base + 0.3 * rng.standard_normal(base.shape))
    dtg = FLOW["dt"] / (11 / 6)
    pcs = (jbuild_pc(jmesh, dtg), build_e_preconditioner(mesh, dtg)) if pc else (None, None)
    return jmesh, mesh, base, u0, un, pcs


def _post_ramp(stats):
    return stats["pressure"][2:]


@pytest.mark.parametrize("name", list(CASES))
def test_recycled_propagate_matches_reference(name):
    jmesh, mesh, base, u0, _, (jpc, pc) = _case(name)
    nsteps = CASES[name][3]
    jcfg, cfg = JLinConfig(flow=jns.FlowConfig(**FLOW)), LinConfig(flow=ns.FlowConfig(**FLOW))
    jth, th = jnp.zeros((0,) + jmesh.bm1.shape), torch.zeros((0,) + tuple(mesh.bm1.shape),
                                                            dtype=torch.float64)
    ref, _ = jpropagate(jmesh, jcfg, jnp.asarray(base), jth, jnp.asarray(u0), jth, nsteps,
                        pc_e=jpc, recycle=6)
    ref = np.asarray(ref)
    if pc is not None:
        assert pc.eb_w is not None  # the pressure CG runs element-first
    orders = ns.bdf_orders(cfg.flow, nsteps)
    psolves = ns.pressure_solvers(mesh, cfg.flow, orders, pc)
    out, stats = {}, {}
    for k in (0, 6):
        stats[k] = {}
        out[k], _ = propagate(mesh, cfg, t(base), th, t(u0), th, nsteps, pc_e=pc,
                              psolves=psolves, stats=stats[k], recycle=k)
    scale = np.abs(ref).max()
    assert absdiff(out[6], ref) <= 1e-7 * scale
    assert absdiff(out[6], out[0]) <= 1e-7 * scale
    plain, recycled = sum(_post_ramp(stats[0])), sum(_post_ramp(stats[6]))
    print(f"{name} propagate: post-ramp pressure iterations {plain} plain, {recycled} recycled")
    assert recycled <= plain


@pytest.mark.parametrize("name", ["channel", "outflow"])
def test_recycled_advance_matches_reference(name):
    jmesh, mesh, base, _, un, (jpc, pc) = _case(name)
    nsteps = CASES[name][3]
    jfc, fc = jns.FlowConfig(**FLOW), ns.FlowConfig(**FLOW)
    ub = t(base) if name == "outflow" else None  # the inflow's lift
    jub = jnp.asarray(base) if name == "outflow" else None
    ref = jns.advance(jmesh, jfc, jns.initial_state(jmesh, jfc, u=jnp.asarray(un)), nsteps,
                      ub=jub, pc_e=jpc, recycle=6)
    ref = np.asarray(ref.u)
    out, stats = {}, {}
    for k in (0, 6):
        stats[k] = {}
        out[k] = ns.advance(mesh, fc, ns.initial_state(mesh, fc, u=t(un)), nsteps, ub=ub,
                            pc_e=pc, stats=stats[k], recycle=k).u
    scale = np.abs(ref).max()
    assert absdiff(out[6], ref) <= 1e-7 * scale
    assert absdiff(out[6], out[0]) <= 1e-7 * scale
    plain, recycled = sum(_post_ramp(stats[0])), sum(_post_ramp(stats[6]))
    print(f"{name} advance: post-ramp pressure iterations {plain} plain, {recycled} recycled")
    assert recycled <= plain


def test_a_run_inside_the_ramp_recycles_nothing():
    _, mesh, base, u0, un, _ = _case("channel")
    cfg = LinConfig(flow=ns.FlowConfig(**FLOW))
    th = torch.zeros((0,) + tuple(mesh.bm1.shape), dtype=torch.float64)
    a, _ = propagate(mesh, cfg, t(base), th, t(u0), th, 2)
    b, _ = propagate(mesh, cfg, t(base), th, t(u0), th, 2, recycle=6)
    assert torch.equal(a, b)
    st = ns.initial_state(mesh, cfg.flow, u=t(un))
    assert torch.equal(ns.advance(mesh, cfg.flow, st, 2).u,
                       ns.advance(mesh, cfg.flow, st, 2, recycle=6).u)


# ---------------------------------------------------------------------------
# the fixed-point system and the propagator
# ---------------------------------------------------------------------------

NU = 0.1
NEWTON_MESH = dict(nels=(3, 2), lims=((0, 2.0), (-1, 1)), bc=CHANNEL_BC, order=5)
NEWTON_FLOW = dict(viscosity=NU, dt=0.02, vtol=1e-12, ptol=1e-12)


def _forcing_j(m, t_, u, th):
    return jnp.zeros((2,) + m.bm1.shape, m.bm1.dtype).at[0].set(2.0 * NU)


def _forcing(m, t_, u, th):
    f = torch.zeros((2,) + tuple(m.bm1.shape), dtype=m.dtype, device=m.device)
    f[0] = 2.0 * NU
    return f


@pytest.fixture(scope="module")
def forced():
    jmesh, mesh = jbox_mesh(**NEWTON_MESH), box_mesh(**NEWTON_MESH, device="cpu")
    jcfg = JLinConfig(flow=jns.FlowConfig(**NEWTON_FLOW, forcing_fn=_forcing_j))
    cfg = LinConfig(flow=ns.FlowConfig(**NEWTON_FLOW, forcing_fn=_forcing))
    y = np.asarray(jmesh.x[1])
    rng = np.random.default_rng(1)
    shape = (2,) + y.shape
    guess = _c0(jmesh, np.stack([0.7 * (1 - y**2), 0 * y]) + 0.05 * rng.standard_normal(shape))
    du, w = (_c0(jmesh, rng.standard_normal(shape)) for _ in range(2))
    return jmesh, mesh, jcfg, cfg, guess, du, w


@pytest.mark.parametrize("exact", [False, True], ids=["frozen", "exact"])
def test_recycled_fixed_point_system_matches_reference(forced, exact):
    jmesh, mesh, jcfg, cfg, guess, du, w = forced
    kw = dict(tau=0.2, dt=0.025, exact_jacobian=exact, recycle=4)  # 6 steps past the ramp
    jsys, sys_ = JFixedPointSystem(jmesh, jcfg, **kw), FixedPointSystem(mesh, cfg, **kw)
    th = np.zeros((0,) + guess.shape[1:])
    jvec = lambda u: {"u": jnp.asarray(u), "theta": jnp.asarray(th)}
    vec = lambda u: {"u": t(u), "theta": t(th)}
    assert sys_.recycle == 4
    assert absdiff(sys_.response(vec(guess))["u"], jsys.response(jvec(guess))["u"]) <= 1e-9
    jjac, jac = jsys.jacobian(jvec(guess)), sys_.jacobian(vec(guess))
    assert absdiff(jac.matvec(vec(du))["u"], jjac.matvec(jvec(du))["u"]) <= 1e-9
    if not exact:
        return  # the frozen rmatvec is recycle-free (tests/test_torch_newton.py)
    want = jjac.rmatvec(jvec(w))["u"]
    first = jac.rmatvec(vec(w))["u"]
    assert absdiff(first, want) <= 1e-9
    # the exact rmatvec replays its recorded tape: a basis that the tape
    # saved and a later step wrote in place would fail autograd's check
    assert torch.equal(jac.rmatvec(vec(w))["u"], first)


def test_recycled_propagator_keeps_the_adjoint_identity():
    _, mesh, base, u0, _, _ = _case("channel")
    cfg = LinConfig(flow=ns.FlowConfig(**FLOW))
    prop = ExponentialPropagator(mesh, cfg, t(base), tau=0.15, dt=FLOW["dt"], recycle=4)
    assert prop.nsteps == 30 and prop.recycle == 4
    th = torch.zeros((0,) + tuple(mesh.bm1.shape), dtype=torch.float64)
    v0 = mesh.vmask * sem.dsavg(mesh, t(np.random.default_rng(5).standard_normal(u0.shape)))
    x, v = {"u": t(u0), "theta": th}, {"u": v0, "theta": th}
    stats = {}
    mx, mtv = prop.matvec(x, stats=stats), prop.rmatvec(v)
    space = flow_vector_space(mesh, 0)
    lhs, rhs = space.dot(mx, v), space.dot(x, mtv)
    assert abs(lhs - rhs) <= 1e-8 * abs(lhs), (lhs, rhs)
    plain = ExponentialPropagator(mesh, cfg, t(base), tau=0.15, dt=FLOW["dt"])
    assert absdiff(plain.matvec(x)["u"], mx["u"]) <= 1e-7 * float(mx["u"].abs().max())


def test_basis_carries_no_gradient_and_no_tangent():
    """The update detaches the increment: under forward mode `detach` drops
    the tangent, so the basis has none, while the projection maps the
    right-hand side's tangent with the fixed basis."""
    mesh = box_mesh(**NEWTON_MESH, device="cpu")
    rng = np.random.default_rng(4)
    shape = tuple(mesh.bm2.shape)
    basis = ns.init_projection_basis(mesh, 3)
    assert basis[0].shape == (3,) + shape and int(basis[2]) == 0
    vals = [t(rng.standard_normal(shape)) for _ in range(4)]
    with fwAD.dual_level():
        for i in range(3):
            delta = fwAD.make_dual(vals[i], vals[i + 1])
            assert fwAD.unpack_dual(delta.detach()).tangent is None
            basis = ns._basis_update(basis, delta, 3.0 * delta, 1e-12)
            assert all(fwAD.unpack_dual(b).tangent is None for b in basis)
        rhs = fwAD.make_dual(vals[3], vals[0])
        xbar, rest = ns._basis_project(basis, rhs)
        tangent = fwAD.unpack_dual(xbar).tangent
    X = basis[0].reshape(3, -1)
    want = ((X @ vals[0].reshape(-1)) @ X).view(shape)
    assert absdiff(tangent, want) <= 1e-14 * float(want.abs().max())
    assert int(basis[2]) == 3
    # A-orthonormal in the stored pairs: <x_i, A x_j> = delta_ij
    gram = X @ basis[1].reshape(3, -1).T
    assert absdiff(gram, torch.eye(3, dtype=torch.float64)) <= 1e-12
    g = t(rng.standard_normal(shape)).requires_grad_(True)
    with torch.enable_grad():
        after = ns._basis_update(basis, g, 3.0 * g, 1e-12)
    assert not any(b.requires_grad for b in after)
    assert int(after[2]) == 4  # slot 3 % 3 = 0 was written, the others kept
    assert not torch.equal(after[0][0], basis[0][0]) and torch.equal(after[0][1:], basis[0][1:])


def test_recycling_with_a_dt_tangent_raises():
    mesh = box_mesh(**NEWTON_MESH, device="cpu")
    fc = ns.FlowConfig(**NEWTON_FLOW)
    st = ns.initial_state(mesh, fc)
    with fwAD.dual_level():
        dt = fwAD.make_dual(torch.tensor(fc.dt, dtype=torch.float64),
                            torch.tensor(1.0, dtype=torch.float64))
        with pytest.raises(ValueError, match="recycle"):
            ns.advance(mesh, fc, st, 4, dt=dt, recycle=2)


# ---------------------------------------------------------------------------
# eigs(which=) and bfs_inflow(dtype=)
# ---------------------------------------------------------------------------


def _non_normal(n=40, seed=7):
    """V D V^-1 with an eigenvalue -3 of the largest modulus and the others
    in |z| < 1: "lm" wants -3 first, "lr" the rightmost."""
    rng = np.random.default_rng(seed)
    lam = 0.9 * rng.uniform(0, 1, n) * np.exp(2j * np.pi * rng.uniform(0, 1, n))
    d = np.zeros((n, n))
    i = 0
    while i < n - 1:  # real 2x2 blocks of conjugate pairs
        a, b = lam[i].real, lam[i].imag
        d[i:i + 2, i:i + 2] = [[a, b], [-b, a]]
        i += 2
    d[0:2, 0:2] = [[-3.0, 0.0], [0.0, 0.95]]
    v = np.eye(n) + 0.3 * rng.standard_normal((n, n))
    return v @ d @ np.linalg.inv(v), rng.standard_normal(n)


def _ops(a):
    aj, at_ = jnp.asarray(a), t(a)
    jop = JFunctionOperator(matvec=lambda x: aj @ x, rmatvec=lambda x: aj.T @ x)
    op = FunctionOperator(matvec=lambda x: {"x": at_ @ x["x"]},
                          rmatvec=lambda x: {"x": at_.T @ x["x"]})
    space = VectorSpace(dot_fn=lambda x, y: (x["x"] * y["x"]).sum(-1))
    return jop, jeuclidean_space(rand_template=jnp.zeros(a.shape[0])), op, space


def test_eigs_largest_real_part_matches_reference(tmp_path):
    a, v0 = _non_normal()
    jop, jspace, op, space = _ops(a)
    kw = dict(nev=2, kdim=20, tol=1e-10, maxiter=30)
    ref = jeigs(jop, jspace, which="lr", v0=jnp.asarray(v0), **kw)
    res = eigs(op, space, which="lr", v0={"x": t(v0)}, **kw)
    lm = eigs(op, space, v0={"x": t(v0)}, **kw)
    assert res.converged.all() and ref.converged.all()
    assert np.max(np.abs(res.eigvals - ref.eigvals)) < 1e-10
    want = np.linalg.eigvals(a)
    want = want[np.argsort(-want.real)][:2]
    assert np.max(np.abs(res.eigvals - want)) < 1e-8
    assert abs(lm.eigvals[0] + 3.0) < 1e-8  # "lm" and "lr" differ here
    with pytest.raises(ValueError, match="which"):
        eigs(op, space, which="sm", v0={"x": t(v0)}, **kw)
    # an unconverged solve keeps its checkpoint; its fingerprint names
    # `which`, and the reference resumes the port's file
    path = str(tmp_path / "lr.npz")
    part = eigs(op, space, nev=2, kdim=8, tol=1e-14, maxiter=1, which="lr", v0={"x": t(v0)},
                checkpoint=path)
    with np.load(path) as z:
        assert str(z["fingerprint"]) == "eigs;kdim=8;nev=2;which=lr;seed=0;tag="
    # from another start vector: only the resumed factorization gives part's
    back = jeigs(jop, jspace, nev=2, kdim=8, tol=1e-14, maxiter=1, which="lr",
                 v0=jnp.ones(a.shape[0]), checkpoint=path)
    assert np.max(np.abs(back.eigvals - part.eigvals)) < 1e-12
    with pytest.raises(ValueError, match="fingerprint"):
        eigs(op, space, nev=2, kdim=8, tol=1e-14, maxiter=1, v0={"x": t(v0)}, checkpoint=path)


def test_bfs_inflow_takes_a_dtype():
    kw = dict(li=2, lo=8, nel_li=2, nel_lo=6, nel_y_in=2, nel_y_step=2, order=5)
    jmesh, mesh = jbfs.bfs_mesh(**kw), bfs.bfs_mesh(**kw, device="cpu")
    ref = jbfs.bfs_inflow(jmesh, dtype=jnp.float64)
    got = bfs.bfs_inflow(mesh, dtype=torch.float64)
    assert got.dtype == torch.float64 and absdiff(got, ref) <= 1e-15
    f32 = bfs.bfs_inflow(mesh, dtype=torch.float32)
    assert f32.dtype == torch.float32
    assert np.abs(to_np(f32) - np.asarray(ref)).max() <= 1e-6
    assert bfs.bfs_inflow(mesh).dtype == mesh.dtype


def test_krylov_basis_vectors_and_adjoint_map_dtype():
    """The reference's `KrylovBasis.vectors()` and
    `adjoint_explicit_lin_map(..., dtype)`, which the port now takes too."""
    from neklab_tpu_torch.krylov.space import KrylovBasis
    from neklab_tpu_torch.models.linearized import adjoint_explicit_lin_map
    from neklab_tpu_torch.ops import sem as tsem

    rng = np.random.default_rng(6)
    space = VectorSpace(dot_fn=lambda x, y: (x["x"] * y["x"]).sum(-1))
    V = KrylovBasis(space, {"x": t(rng.standard_normal(5))}, 4)
    for _ in range(3):
        V.append({"x": t(rng.standard_normal(5))})
    assert [torch.equal(v["x"], V[j]["x"]) for j, v in enumerate(V.vectors())] == [True] * 3
    mesh = box_mesh(**NEWTON_MESH, device="cpu")
    y = mesh.x[1]
    cache = tsem.lin_convect_cache(mesh, torch.stack([1 - y**2, 0 * y]), None)
    cfg = LinConfig(flow=ns.FlowConfig(**NEWTON_FLOW))
    th = (0,) + tuple(mesh.bm1.shape)
    v = t(rng.standard_normal((2,) + tuple(mesh.bm1.shape)))
    psi = torch.zeros(th, dtype=torch.float64)
    a = adjoint_explicit_lin_map(mesh, cfg, cache, th)(v, psi)[0]
    b = adjoint_explicit_lin_map(mesh, cfg, cache, th, torch.float64)(v, psi)[0]
    assert torch.equal(a, b) and float(a.abs().max()) > 0
