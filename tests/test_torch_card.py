"""The port's code that runs only on the card: the CUDA kernel against its
plain torch twin, its run counter in device memory, the CG iterations
captured as CUDA graphs against the same CG on CPU tensors, the backward
passes of the exact discrete adjoint (the kernel's, the solves', the
recorded propagator's) and the forward mode of the kernel and the solves
(with a dt tangent too) against the same on CPU tensors, one nonlinear step
with an inflow lift, one forced linearized step, and element-partitioned
runs on the card: two gloo ranks sharing it (their results, and their peak
memory against one process's), and a one-rank NCCL group whose CGs capture
their all-reduces, also under forward mode; and Nek5000's residual
projection (`recycle=`) around the graphed pressure CG: a recycled
propagator, the recycled exact Jacobian of a fixed-point system, and
recycled steps of a one-rank NCCL group; and the Boussinesq family (nscal = 1):
a forced scalar `advance`, `propagate` and its adjoint with both linear
couplings, the B-adjoint identity, and `advance_adaptive` with its rebuilds,
then in 3-D: `propagate` (traced) and its adjoint, and the Rayleigh-Benard
onset of a periodic layer against the 2-D box's;
and the spans of a traced call (`stats=`): CUDA events inside the wall time,
no program range in a profile of the device's activity alone.

Every test here is marked `cuda` and skips where `torch.cuda.is_available()`
is False. The file imports no jax, so it also runs on a machine that has
none (skipping the jax-only conftest):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_card.py -q

Tolerances: kernel f64 to rel 1e-12 (the two differ only in summation
order), f32 to rel 2e-5 (float32 summation order over ~2n terms per point).
The graphed CGs on the card and the eager ones on the CPU run the same
arithmetic in another summation order: same iteration count, rel 1e-10 in
f64.
"""

import dataclasses
import time

import numpy as np
import pytest
import torch

from neklab_tpu_torch.mesh.box import box_mesh
from neklab_tpu_torch.models import navier_stokes as ns
from neklab_tpu_torch.models import stokes
from neklab_tpu_torch.models.precond import build_e_preconditioner
from neklab_tpu_torch.models.solvers import PCG
from neklab_tpu_torch.ops import helmholtz_kernel, sem
from torch_port_helpers import CHANNEL_BC, WALLED_BC, cg_counts, rel, wavy

pytestmark = pytest.mark.cuda

TOL = {torch.float64: 1e-12, torch.float32: 2e-5}
CHANNEL = ((4, 5), ((0, 2 * np.pi), (-1, 1)), CHANNEL_BC)
DT = 1e-2
H1, H2 = 1.0 / 500, (11.0 / 6.0) / DT


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: CUDA kernels and graphs have no CPU mode")
    return torch.device("cuda", 0)


def random_args(n, nel, lead, dtype, device, seed=0):
    """Kernel inputs from a numpy seed: u [*lead, n, n, nel], D, a positive
    diagonal metric with a cross term, the mass, h1 and h2."""
    rng = np.random.default_rng(seed)
    cast = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    geo = (n, n, nel)
    return (cast(rng.standard_normal(lead + geo)), cast(rng.standard_normal((n, n))),
            cast(1 + rng.random(geo)), cast(0.3 * rng.standard_normal(geo)),
            cast(1 + rng.random(geo)), cast(rng.random(geo)), 0.01, 3.7)


# (n, nel, lead): the velocity CG and the probe of the main path, a ragged
# last tile (nel = 15, 121), the smallest and largest n, batches of 1 and 81,
# and the velocity CGs of the resolvent channel and the periodic-orbit annulus
EDGE_CASES = [(9, 120, (2,)), (9, 120, (81,)), (6, 15, (2,)), (9, 121, (1,)),
              (2, 15, (2,)), (12, 121, (2,)), (12, 15, (81,)), (8, 1024, ()),
              (7, 48, (2,)), (6, 126, (2,))]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("n, nel, lead", EDGE_CASES)
def test_helmholtz2d_kernel_matches_plain(card, n, nel, lead, dtype):
    args = random_args(n, nel, lead, dtype, card)
    helmholtz_kernel.reset_launches(card)
    out = helmholtz_kernel.helmholtz2d(*args)
    assert helmholtz_kernel.launches(card) == 1
    assert rel(out, helmholtz_kernel.helmholtz2d_plain(*args)) <= TOL[dtype]


# (n, nel, lead) -> the (elements, leading entries) per block the launcher
# picks on a 132-SM H100: both tile widths, the whole batch in a block, and
# chunks of the batch with a ragged last chunk and a ragged last tile
TILE_SHAPES = {(4, 1): (9, 120, (2,)), (4, 3): (12, 15, (81,)), (4, 6): (9, 121, (81,)),
               (8, 1): (9, 4097, ()), (8, 2): (8, 1024, (2,)), (8, 5): (9, 2001, (5,)),
               (8, 8): (8, 1024, (64,))}


@pytest.mark.parametrize("tile", list(TILE_SHAPES), ids=str)
def test_helmholtz2d_every_tile_matches_plain(card, tile):
    """A shape for each (elements, leading entries) per block the launcher
    picks; on another card the same shapes may take other tiles."""
    n, nel, lead = TILE_SHAPES[tile]
    args = random_args(n, nel, lead, torch.float64, card)
    out = helmholtz_kernel.helmholtz2d(*args)
    assert rel(out, helmholtz_kernel.helmholtz2d_plain(*args)) <= 1e-12


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_helmholtz2d_on_a_curved_mesh(card, dtype):
    mesh = box_mesh((5, 3), ((0.0, 2.0), (-1.0, 1.0)), WALLED_BC, order=5, deform=wavy,
                    dtype=dtype, device=card)
    g = mesh.g
    u = np.random.default_rng(4).standard_normal((2,) + tuple(mesh.bm1.shape))
    u = torch.as_tensor(u, dtype=dtype, device=card)
    args = (mesh.d, g[0, 0], g[0, 1], g[1, 1], mesh.bm1, 0.01, 3.7)
    assert rel(helmholtz_kernel.helmholtz2d(u, *args),
               helmholtz_kernel.helmholtz2d_plain(u, *args)) <= TOL[dtype]


def test_helmholtz2d_rejects_what_the_kernel_does_not_take(card):
    mesh = box_mesh((5, 3), ((0.0, 2.0), (-1.0, 1.0)), WALLED_BC, order=5, device=card)
    g = mesh.g
    args = (mesh.d, g[0, 0], g[0, 1], g[1, 1], mesh.bm1, 0.01, 3.7)
    u = torch.randn((2,) + tuple(mesh.bm1.shape), dtype=torch.float64, device=card)
    with pytest.raises(ValueError):  # same shape, not contiguous
        helmholtz_kernel.helmholtz2d(u.transpose(0, 1).contiguous().transpose(0, 1), *args)
    with pytest.raises(ValueError):  # dtype mismatch with the geometry
        helmholtz_kernel.helmholtz2d(u.float(), *args)
    with pytest.raises(ValueError):  # u's points do not match D's
        helmholtz_kernel.helmholtz2d(u[:, :5, :5].contiguous(), *args)


def test_run_counter_counts_graph_replays(card):
    """k replays of a captured velocity-CG iteration advance the device
    counter by exactly k; a solve of the built-once velocity solver by its
    iterations plus the right-hand side's apply."""
    mesh = box_mesh(*CHANNEL, order=6, device=card)
    diag = ns.helmholtz_diag(mesh, H1, H2, mesh.vmask)
    sqw = mesh.vmult.sqrt()

    def op(y):
        t = sem.dssum(mesh, sqw * y)
        hv = sem.dssum(mesh, sem.helmholtz_local(mesh, mesh.vmask * t, H1, H2))
        return y + sqw * mesh.vmask * (hv - t)

    b = np.random.default_rng(5).standard_normal((2,) + tuple(mesh.bm1.shape))
    b = mesh.vmask * torch.as_tensor(b, device=card)
    cg = PCG(op, b, precond=lambda r: r / diag)  # warm-up and capture run the kernel once
    before = helmholtz_kernel.launches(card)
    _, k, _ = cg.solve(b, tol=0.0, maxiter=7)  # every iteration a replay
    assert k == 7 and helmholtz_kernel.launches(card) - before == 7

    solve = ns.make_helmholtz_solver(mesh, H1, H2, mesh.vmask, diag, 1e-10, 500)
    stats = {}
    before = helmholtz_kernel.launches(card)
    solve(b, torch.zeros_like(b), stats=stats)
    assert helmholtz_kernel.launches(card) - before == stats["helmholtz"][0] + 1 > 4


def test_graphed_velocity_cg_matches_cpu(card):
    """The built-once velocity solver, on the card (its CG a graph replay)
    and on CPU tensors (eager), over two right-hand sides."""
    meshes = {dev: box_mesh(*CHANNEL, order=6, device=dev) for dev in (card, "cpu")}
    solves = {dev: ns.make_helmholtz_solver(m, H1, H2, m.vmask,
                                            ns.helmholtz_diag(m, H1, H2, m.vmask), 1e-10, 500)
              for dev, m in meshes.items()}
    rng = np.random.default_rng(0)
    for _ in range(2):
        rhs = rng.standard_normal((2,) + tuple(meshes["cpu"].bm1.shape))
        out, stats = {}, {}
        for dev, solve in solves.items():
            stats[dev] = {}
            out[dev] = solve(torch.as_tensor(rhs, device=dev), torch.zeros(rhs.shape, device=dev,
                                                                           dtype=torch.float64),
                             stats=stats[dev])
        assert cg_counts(stats[card]) == cg_counts(stats["cpu"])
        assert stats["cpu"]["helmholtz"][0] > 3
        assert rel(out[card], out["cpu"]) <= 1e-10


def test_graphed_pressure_cg_matches_cpu(card):
    """The pressure solver (E CG with the two-level preconditioner), on the
    card (graph replays) and on CPU tensors, over two right-hand sides."""
    cfg = ns.FlowConfig(viscosity=H1, dt=DT, ptol=1e-10, pmaxit=500)
    solves = {}
    for dev in (card, "cpu"):
        m = box_mesh((8, 4), ((0, 2 * np.pi), (-1, 1)), CHANNEL_BC, order=6, device=dev)
        solves[dev] = (m, ns.make_pressure_solver(m, cfg, DT / (11 / 6), pc=build_e_preconditioner(m)))
    rng = np.random.default_rng(1)
    for _ in range(2):
        u = rng.standard_normal((2,) + tuple(solves["cpu"][0].bm1.shape))
        out, stats = {}, {}
        for dev, (m, solve) in solves.items():
            stats[dev] = {}
            rhs = -stokes.div_weak(m, torch.as_tensor(u, device=dev))
            out[dev] = solve(rhs, stats=stats[dev])
        assert cg_counts(stats[card]) == cg_counts(stats["cpu"])
        assert stats["cpu"]["pressure"][0] > 3
        assert rel(out[card], out["cpu"]) <= 1e-10


# ---------------------------------------------------------------------------
# the exact discrete adjoint: backward passes on the card
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("n, nel, lead", EDGE_CASES)
def test_helmholtz2d_backward_is_the_kernel(card, n, nel, lead, dtype):
    """On a CUDA tensor that requires grad the kernel's output has a
    grad_fn, and its backward launches the kernel once on the cotangent:
    against the twin's autograd backward on the same inputs."""
    u, *args = random_args(n, nel, lead, dtype, card)
    g = random_args(n, nel, lead, dtype, card, seed=1)[0]
    u.requires_grad_(True)
    out = helmholtz_kernel.helmholtz2d(u, *args)
    assert out.grad_fn is not None
    helmholtz_kernel.reset_launches(card)
    (vjp,) = torch.autograd.grad(out, u, g)
    assert helmholtz_kernel.launches(card) == 1
    (ref,) = torch.autograd.grad(helmholtz_kernel.helmholtz2d_plain(u, *args), u, g)
    assert rel(vjp, ref) <= TOL[dtype]


def test_helmholtz2d_rejects_geometry_that_requires_grad(card):
    u, d, *rest = random_args(9, 120, (2,), torch.float64, card)
    with pytest.raises(ValueError):
        helmholtz_kernel.helmholtz2d(u, d.requires_grad_(True), *rest)


def _solve_of(which, m):
    """(the solver's right-hand-side shape, a linear map rhs -> solution
    taking a stats dict) of the velocity or pressure solver on mesh m."""
    if which == "velocity":
        solve = ns.make_helmholtz_solver(m, H1, H2, m.vmask, ns.helmholtz_diag(m, H1, H2, m.vmask),
                                         1e-10, 500)
        shape = (2,) + tuple(m.bm1.shape)
        return shape, lambda r, stats: solve(r, torch.zeros_like(r), stats=stats)
    cfg = ns.FlowConfig(viscosity=H1, dt=DT, ptol=1e-10, pmaxit=500)
    solve = ns.make_pressure_solver(m, cfg, DT / (11 / 6), pc=build_e_preconditioner(m))
    return tuple(m.bm2.shape), lambda r, stats: solve(r, stats=stats)


@pytest.mark.parametrize("which", ["velocity", "pressure"])
def test_solve_backward_matches_cpu(card, which):
    """The solves' backward (a re-solve with the built-once CG: a graph
    replay on the card) against the same backward on CPU tensors."""
    rng = np.random.default_rng(8)
    out, stats, data = {}, {}, None
    for dev in (card, "cpu"):
        m = box_mesh((8, 4), ((0, 2 * np.pi), (-1, 1)), CHANNEL_BC, order=6, device=dev)
        shape, fn = _solve_of(which, m)
        if data is None:
            data = rng.standard_normal(shape), rng.standard_normal(shape)
        r = torch.as_tensor(data[0], device=dev).requires_grad_(True)
        stats[dev] = {}
        (out[dev],) = torch.autograd.grad(fn(r, stats[dev]), r, torch.as_tensor(data[1], device=dev))
    counts = next(iter(cg_counts(stats["cpu"]).values()))
    assert cg_counts(stats[card]) == cg_counts(stats["cpu"])
    assert len(counts) == 2 and min(counts) > 3
    assert rel(out[card], out["cpu"]) <= 1e-10


def test_rmatvec_matches_cpu(card):
    """The adjoint propagator on the card (kernel, graphed CGs, the recorded
    tape) against the CPU, f64: the Poiseuille Re=500 case of chip_smoke
    phase 3. The kernel runs once per transposed velocity CG iteration."""
    from neklab_tpu_torch.linops.exponential_propagator import ExponentialPropagator
    from neklab_tpu_torch.models.linearized import LinConfig

    props = {}
    for dev in (card, "cpu"):
        m = box_mesh((4, 5), ((0, 2 * np.pi), (-1, 1)), CHANNEL_BC, order=6, device=dev)
        cfg = LinConfig(flow=ns.FlowConfig(viscosity=1 / 500, dt=1e-2, vtol=1e-12, ptol=1e-12))
        y = m.x[1]
        props[dev] = (m, ExponentialPropagator(m, cfg, torch.stack([1 - y**2, 0 * y]), tau=0.5))
    m = props["cpu"][0]
    u = np.random.default_rng(11).standard_normal((2,) + tuple(m.bm1.shape))
    u = m.vmask * sem.dsavg(m, torch.as_tensor(u))
    u = u / sem.mass_dot(m, u, u).sqrt()
    th = torch.zeros((0,) + tuple(m.bm1.shape), dtype=torch.float64)
    out, stats = {}, {}
    for dev, (_, prop) in props.items():
        prop.adjoint  # build and record outside the count
        helmholtz_kernel.reset_launches(card)
        stats[dev] = {}
        out[dev] = prop.rmatvec({"u": u.to(dev), "theta": th.to(dev)}, stats=stats[dev])["u"]
        if dev == card:
            assert helmholtz_kernel.launches(card) == sum(stats[dev]["helmholtz"])
    assert props[card][1].adjoint.tape_bytes > 0
    assert float((out[card].cpu() - out["cpu"]).abs().max()) <= 1e-9


# ---------------------------------------------------------------------------
# forward mode and the nonlinear step on the card
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("n, nel, lead", EDGE_CASES)
def test_helmholtz2d_jvp_is_the_kernel(card, n, nel, lead, dtype):
    """Under forward mode the kernel's tangent is the kernel on the tangent
    (H is linear in u): one more run on the device counter per tangent,
    against the twin's forward-mode derivative on the same inputs."""
    import torch.autograd.forward_ad as fwAD

    u, *args = random_args(n, nel, lead, dtype, card)
    tan = random_args(n, nel, lead, dtype, card, seed=1)[0]
    helmholtz_kernel.reset_launches(card)
    with fwAD.dual_level():
        out = helmholtz_kernel.helmholtz2d(fwAD.make_dual(u, tan), *args)
        primal, tangent = fwAD.unpack_dual(out)
        assert helmholtz_kernel.launches(card) == 2
        ref = fwAD.unpack_dual(helmholtz_kernel.helmholtz2d_plain(fwAD.make_dual(u, tan), *args))
    assert rel(primal, ref.primal) <= TOL[dtype]
    assert rel(tangent, ref.tangent) <= TOL[dtype]


@pytest.mark.parametrize("which", ["velocity", "pressure"])
def test_solve_jvp_matches_cpu(card, which):
    """The solves' forward mode (the tangent re-solved with the built-once
    CG: a graph replay on the card) against the same on CPU tensors."""
    import torch.autograd.forward_ad as fwAD

    rng = np.random.default_rng(9)
    out, stats, data = {}, {}, None
    for dev in (card, "cpu"):
        m = box_mesh((8, 4), ((0, 2 * np.pi), (-1, 1)), CHANNEL_BC, order=6, device=dev)
        shape, fn = _solve_of(which, m)
        if data is None:
            data = rng.standard_normal(shape), rng.standard_normal(shape)
        if which == "pressure":  # a right-hand side in E's range, as div_weak makes
            data = tuple(d - d.mean() for d in data)
        stats[dev] = {}
        with fwAD.dual_level():
            r = fwAD.make_dual(torch.as_tensor(data[0], device=dev),
                               torch.as_tensor(data[1], device=dev))
            out[dev] = fwAD.unpack_dual(fn(r, stats[dev])).tangent
    counts = next(iter(cg_counts(stats["cpu"]).values()))
    assert cg_counts(stats[card]) == cg_counts(stats["cpu"])
    assert len(counts) == 2 and min(counts) > 3
    assert rel(out[card], out["cpu"]) <= 1e-10


def test_step_matches_cpu(card):
    """One nonlinear BDF3 step on a cylinder annulus with an inflow-outflow
    outer boundary (the pressure pinned at the outflow, the free stream as
    a non-zero lift through the kernel), on the card and on the CPU, f64;
    the kernel runs once per velocity CG iteration, once for the lift and
    once for the warm start's operator apply."""
    from neklab_tpu_torch.mesh.cylinder import annulus_mesh

    rng = np.random.default_rng(12)
    out, stats, data = {}, {}, None
    for dev in (card, "cpu"):
        m = annulus_mesh(3, 8, r_in=0.5, r_out=4.0, order=5, grading=1.3, outer_bc="vO",
                         shift=0.2, device=dev)
        cfg = ns.FlowConfig(viscosity=0.02, dt=1e-2, vtol=1e-12, ptol=1e-12)
        r = torch.sqrt(m.x[0] ** 2 + m.x[1] ** 2)
        free = (r > 0.5 + 1e-8).to(m.dtype)
        ub = torch.stack([free, 0 * free])
        if data is None:
            shape = tuple(m.bm1.shape)
            data = [rng.standard_normal(s) for s in ((2,) + shape, tuple(m.bm2.shape),
                                                      (2, 2) + shape, (2, 2) + shape)]
        u, p, ulag, nlag = (torch.as_tensor(d, device=dev) for d in data)
        st = ns.initial_state(m, cfg, u=sem.dsavg(m, u), p=p)
        st = dataclasses.replace(st, ulag=sem.dsavg(m, ulag), nlag=0.1 * nlag)
        vdiag, tdiags = ns.bdf3_diags(m, cfg)
        (vsolve, tsolves), = ns.velocity_solvers(m, cfg, [3], vdiag, tdiags).values()
        (psolve,) = ns.pressure_solvers(m, cfg, [3], pc_e=build_e_preconditioner(m)).values()
        stats[dev] = {}
        helmholtz_kernel.reset_launches(card)
        out[dev] = ns.step(m, cfg, st, 3, psolve, vsolve, tsolves, ub=ub, stats=stats[dev])
        if dev == card:
            assert helmholtz_kernel.launches(card) == stats[dev]["helmholtz"][0] + 2
    assert cg_counts(stats[card]) == cg_counts(stats["cpu"])
    for k in ("u", "p"):
        assert rel(getattr(out[card], k), getattr(out["cpu"], k)) <= 1e-10, k
    assert float((out["cpu"].u[0] * (1 - m.vmask[0]) * (m.x[0] < -1)).max()) == 1.0


# ---------------------------------------------------------------------------
# forward mode with a dt tangent, and a forced linearized step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("which", ["velocity", "pressure"])
def test_solve_dt_jvp_matches_cpu(card, which):
    """A solve whose dt carries a forward-mode tangent (the period of a
    periodic orbit): the operator's own tangent joins the right-hand side's
    and the warm start's (and, for the velocity, the Dirichlet lift's) in
    one re-solve with the built-once CG; card against CPU, f64."""
    import torch.autograd.forward_ad as fwAD

    rng = np.random.default_rng(14)
    out, stats, data = {}, {}, None
    for dev in (card, "cpu"):
        m = box_mesh((8, 4), ((0, 2 * np.pi), (-1, 1)), CHANNEL_BC, order=6, device=dev)
        if which == "velocity":
            solve = ns.make_helmholtz_solver(m, H1, H2, m.vmask,
                                             ns.helmholtz_diag(m, H1, H2, m.vmask), 1e-10, 500)
            shape = (2,) + tuple(m.bm1.shape)
        else:
            cfg = ns.FlowConfig(viscosity=H1, dt=DT, ptol=1e-10, pmaxit=500)
            solve = ns.make_pressure_solver(m, cfg, DT / (11 / 6), pc=build_e_preconditioner(m))
            shape = tuple(m.bm2.shape)
        if data is None:
            data = [rng.standard_normal(shape) for _ in range(4)]
            if which == "pressure":  # in E's range, as div_weak makes it
                data = [d - d.mean() for d in data]
        r, tr, x0, bc = (torch.as_tensor(d, device=dev) for d in data)
        stats[dev] = {}
        with fwAD.dual_level():
            ddt = torch.tensor(1.0, dtype=torch.float64, device=dev)
            dt = fwAD.make_dual(torch.tensor(DT, dtype=torch.float64, device=dev), ddt)
            rhs = fwAD.make_dual(r, tr)
            if which == "velocity":
                res = solve(rhs, bc, stats=stats[dev], x0=sem.dsavg(m, x0),
                            h2_now=(11 / 6) / dt)
            else:
                res = solve(rhs, x0=x0, stats=stats[dev], dt_over_g0_now=dt / (11 / 6))
            out[dev] = fwAD.unpack_dual(res)
    counts = next(iter(cg_counts(stats["cpu"]).values()))
    assert cg_counts(stats[card]) == cg_counts(stats["cpu"])
    assert len(counts) == 2 and min(counts) > 3
    assert rel(out[card].primal, out["cpu"].primal) <= 1e-10
    assert rel(out[card].tangent, out["cpu"].tangent) <= 1e-10


def test_forced_linearized_step_matches_cpu(card):
    """One BDF3 linearized step with a body force (the resolvent's forcing
    hook, OTD's rank coupling) on the card and on the CPU, f64."""
    from neklab_tpu_torch.models.linearized import LinConfig, pert_initial, step_lin

    rng = np.random.default_rng(15)
    out, data = {}, None
    for dev in (card, "cpu"):
        m = box_mesh((8, 6), ((0, 2 * np.pi), (-1, 1)), CHANNEL_BC, order=6, device=dev)
        fc = ns.FlowConfig(viscosity=1 / 60, dt=0.02, vtol=1e-12, ptol=1e-12)
        y = m.x[1]
        if data is None:
            shape = (2,) + tuple(m.bm1.shape)
            data = [rng.standard_normal(s) for s in (shape, shape, (2,) + shape)]
        u, f, ulag = (torch.as_tensor(d, device=dev) for d in data)
        st = pert_initial(m, LinConfig(flow=fc), m.vmask * sem.dsavg(m, u))
        st = dataclasses.replace(st, ulag=m.vmask * sem.dsavg(m, ulag))
        vdiag, tdiags = ns.bdf3_diags(m, fc)
        (vsolve, tsolves), = ns.velocity_solvers(m, fc, [3], vdiag, tdiags).values()
        (psolve,) = ns.pressure_solvers(m, fc, [3], pc_e=build_e_preconditioner(m)).values()
        th = torch.zeros((0,) + tuple(m.bm1.shape), dtype=torch.float64, device=dev)
        out[dev] = step_lin(m, LinConfig(flow=fc), st, torch.stack([1 - y**2, 0 * y]), th, 3,
                            psolve, vsolve, tsolves, force=m.vmask * f)
    for k in ("u", "p"):
        assert rel(getattr(out[card], k), getattr(out["cpu"], k)) <= 1e-10, k


# ---------------------------------------------------------------------------
# the native library, the kernel at the new meshes' shapes, and the pressure
# preconditioner at any mesh size with the matrix-free E
# ---------------------------------------------------------------------------

BFS_SMALL = dict(li=2, lo=8, nel_li=2, nel_lo=6, nel_y_in=2, nel_y_step=2, order=4)


def test_native_library_builds(card):
    """g++ builds the colouring and RCB library at first use (the card's
    machine measures the native path)."""
    import os

    from neklab_tpu_torch import native

    assert native.available() and os.path.exists(native.library_path())
    counts = np.bincount(native.rcb_partition(np.random.default_rng(0).random((1000, 2)), 16))
    assert len(counts) == 16 and counts.max() - counts.min() <= 1


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("n, nel, lead", [(4, 21609, (2,)), (4, 21609, (16,)), (7, 62, (2,)),
                                          (7, 62, (49,))])
def test_helmholtz2d_at_the_new_meshes_shapes(card, n, nel, lead, dtype):
    """The 21,609-element box at order 3 (the largest nel launched) and the
    backward-facing step at order 6, velocity CG and probe shapes."""
    args = random_args(n, nel, lead, dtype, card, seed=3)
    assert rel(helmholtz_kernel.helmholtz2d(*args),
               helmholtz_kernel.helmholtz2d_plain(*args)) <= TOL[dtype]


PRECONDITIONERS = {"bj_const": dict(local="bj", coarse="const"),
                   "rcb": dict(coarse_max_dense=8), "oas_q1": dict()}


@pytest.mark.parametrize("case", sorted(PRECONDITIONERS))
def test_preconditioner_built_on_the_card_matches_cpu(card, case, monkeypatch):
    """Each preconditioner built on the card (probing there) and on the CPU
    from the same backward-facing step, f64: the stored arrays and `apply`
    to 1e-11 (the probes differ in summation order, and the host inverts
    them: rounding times the blocks' condition)."""
    from neklab_tpu_torch.mesh.bfs import bfs_mesh

    monkeypatch.setenv("NEKLAB_PRECOND_CACHE", "0")  # two independent builds
    meshes = {dev: bfs_mesh(**BFS_SMALL, device=dev) for dev in (card, "cpu")}
    pcs = {dev: build_e_preconditioner(m, 1e-2, **PRECONDITIONERS[case])
           for dev, m in meshes.items()}
    for f in dataclasses.fields(pcs["cpu"]):
        a, b = getattr(pcs[card], f.name), getattr(pcs["cpu"], f.name)
        assert (a is None) == (b is None), f.name
        if b is not None:
            assert a.device.type == "cuda" and rel(a.cpu().double(), b.double()) <= 1e-11, f.name
    r = np.random.default_rng(2).standard_normal(tuple(meshes["cpu"].bm2.shape))
    out = {dev: pcs[dev].apply(torch.as_tensor(r, device=dev)) for dev in (card, "cpu")}
    assert rel(out[card], out["cpu"]) <= 1e-11


@pytest.mark.parametrize("where", ["walled", "bfs"])
def test_graphed_matrix_free_pressure_cg_matches_cpu(card, where, monkeypatch):
    """The pressure CG with block Jacobi and constants and no exact blocks
    runs the matrix-free E, captured as a CUDA graph on the card: the solve
    (warm-started) and its backward against the same on CPU tensors, f64,
    with a pure-Neumann pressure (walled box) and with an outflow."""
    from neklab_tpu_torch.mesh.bfs import bfs_mesh

    monkeypatch.setenv("NEKLAB_PRECOND_CACHE", "0")
    cfg = ns.FlowConfig(viscosity=H1, dt=DT, ptol=1e-10, pmaxit=500)
    rng = np.random.default_rng(12)
    out, grads, stats, data = {}, {}, {}, None
    for dev in (card, "cpu"):
        if where == "walled":
            m = box_mesh((10, 8), ((0, 1), (0, 1)), WALLED_BC, order=4, device=dev)
        else:
            m = bfs_mesh(**BFS_SMALL, device=dev)
        pc = build_e_preconditioner(m, local="bj", coarse="const", exact_blocks=False)
        assert pc.eb_w is None
        solve = ns.make_pressure_solver(m, cfg, DT / (11 / 6), pc=pc)
        if data is None:
            data = [rng.standard_normal(tuple(m.bm2.shape)) for _ in range(3)]
        r, x0, g = (torch.as_tensor(d, device=dev) for d in data)
        r.requires_grad_(True)
        stats[dev] = {}
        out[dev] = solve(r, x0=x0, stats=stats[dev])
        (grads[dev],) = torch.autograd.grad(out[dev], r, g)
    counts = stats["cpu"]["pressure"]
    assert cg_counts(stats[card]) == cg_counts(stats["cpu"])
    assert len(counts) == 2 and min(counts) > 3
    assert rel(out[card], out["cpu"].detach()) <= 1e-10
    assert rel(grads[card], grads["cpu"]) <= 1e-10


# ---------------------------------------------------------------------------
# the 3-D path: the plain chain on the card
# ---------------------------------------------------------------------------

WALLED3 = {f: "W" for f in ("x-", "x+", "y-", "y+", "z-", "z+")}
BOX3D = ((12, 12, 12), ((0.0, 4.0), (-1.0, 1.0), (-1.0, 1.0)),
         {"x-": "P", "x+": "P", "y-": "W", "y+": "W", "z-": "W", "z+": "W"})


def _walled3(device, dtype=torch.float64):
    return box_mesh((3, 2, 2), ((0.0, 1.5), (0.0, 1.0), (0.0, 1.0)), WALLED3, order=4,
                    dtype=dtype, device=device)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_helmholtz_local_3d_matches_cpu(card, dtype):
    """3-D helmholtz_local on the card (the plain chain through
    `tensor.linear`, never the 2-D kernel) against the same on CPU tensors,
    with its backward."""
    meshes = {dev: _walled3(dev, dtype) for dev in (card, "cpu")}
    rng = np.random.default_rng(3)
    u, g = (rng.standard_normal((3,) + tuple(meshes["cpu"].bm1.shape)) for _ in range(2))
    before = helmholtz_kernel.launches(card)
    out, grad = {}, {}
    for dev, m in meshes.items():
        x = torch.as_tensor(u, dtype=dtype, device=dev).requires_grad_(True)
        out[dev] = sem.helmholtz_local(m, x, H1, H2)
        (grad[dev],) = torch.autograd.grad(out[dev], x, torch.as_tensor(g, dtype=dtype,
                                                                        device=dev))
    assert helmholtz_kernel.launches(card) == before
    assert rel(out[card].detach(), out["cpu"].detach()) <= TOL[dtype]
    assert rel(grad[card], grad["cpu"]) <= TOL[dtype]


def test_apply_3d_is_one_launch_and_captures(card):
    """Each 3-D per-axis apply on a contiguous field is one kernel on the
    card (the profiler's device events), and the 3-D Helmholtz apply
    replays from a CUDA graph to the eager result."""
    from torch.profiler import ProfilerActivity, profile

    from neklab_tpu_torch.ops.tensor import apply_r, apply_s, apply_t

    d = torch.randn(6, 6, dtype=torch.float32, device=card)
    u = torch.randn(3, 6, 6, 6, 1728, dtype=torch.float32, device=card)
    for fn in (apply_r, apply_s, apply_t):
        fn(d, u)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn(d, u)
            torch.cuda.synchronize()
        kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        assert len(kernels) == 1, (fn.__name__, [e.name for e in kernels])
    mesh = _walled3(card, torch.float32)
    x = torch.randn((3,) + tuple(mesh.bm1.shape), dtype=torch.float32, device=card)
    eager = sem.helmholtz_local(mesh, x, H1, H2)
    side = torch.cuda.Stream(card)
    side.wait_stream(torch.cuda.current_stream(card))
    with torch.cuda.stream(side):
        sem.helmholtz_local(mesh, x, H1, H2)
    torch.cuda.current_stream(card).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = sem.helmholtz_local(mesh, x, H1, H2)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(captured, eager)


def test_graphed_velocity_cg_3d_matches_cpu(card):
    """The built-once 3-D velocity solver, its CG a graph replay of the
    plain chain on the card, against the same on CPU tensors."""
    meshes = {dev: _walled3(dev) for dev in (card, "cpu")}
    solves = {dev: ns.make_helmholtz_solver(m, H1, H2, m.vmask,
                                            ns.helmholtz_diag(m, H1, H2, m.vmask), 1e-11, 500)
              for dev, m in meshes.items()}
    rng = np.random.default_rng(4)
    rhs = rng.standard_normal((3,) + tuple(meshes["cpu"].bm1.shape))
    out, stats = {}, {}
    for dev, solve in solves.items():
        stats[dev] = {}
        out[dev] = solve(torch.as_tensor(rhs, device=dev),
                         torch.zeros(rhs.shape, dtype=torch.float64, device=dev),
                         stats=stats[dev])
    assert cg_counts(stats[card]) == cg_counts(stats["cpu"]) and stats["cpu"]["helmholtz"][0] > 3
    assert rel(out[card], out["cpu"]) <= 1e-10


def test_local_diagonal_chunked_at_box3d_shape(card, monkeypatch):
    """The Jacobi diagonal at box3d's element shape (216 nodes, 1,728
    elements), f64: probed in chunks under about 1 GB of device memory,
    against the whole probe at once, which takes several GB."""
    from neklab_tpu_torch.models import solvers

    mesh = box_mesh(*BOX3D, order=5, dtype=torch.float64, device=card)
    h2 = (11 / 6) / 2e-3
    peaks = {}
    for name, budget in (("chunked", solvers._PROBE_BYTES), ("whole", 2**40)):
        monkeypatch.setattr(solvers, "_PROBE_BYTES", budget)
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated(card)
        torch.cuda.reset_peak_memory_stats(card)
        diag = ns.helmholtz_diag(mesh, 1e-3, h2, mesh.vmask)
        torch.cuda.synchronize()
        peaks[name] = (torch.cuda.max_memory_allocated(card) - before, diag)
    assert peaks["chunked"][0] <= 1.5e9 < peaks["whole"][0], {k: v[0] for k, v in peaks.items()}
    assert rel(peaks["chunked"][1], peaks["whole"][1]) <= 1e-13


# ---------------------------------------------------------------------------
# element-partitioned runs on the card (ranks: tests/torch_shard_workers.py)
# ---------------------------------------------------------------------------


def test_split_propagate_gloo_ranks_share_the_card(card, tmp_path, monkeypatch):
    """Two gloo ranks on the one card (their CUDA all-reduces staged through
    the host, their CGs eager): `propagate` and its adjoint on the channel
    box against one process on the card, f64, 1e-11/1e-10 solves."""
    import torch_shard_workers as W
    from neklab_tpu_torch.models import linearized as lin

    monkeypatch.setenv("NEKLAB_PRECOND_CACHE", "0")
    mesh = box_mesh(**W.STEP_BOX, dtype=torch.float64, device=card)
    gen = torch.Generator(device=card)
    gen.manual_seed(5)
    c0 = lambda: mesh.vmask * sem.dsavg(mesh, torch.randn(
        (2,) + tuple(mesh.bm1.shape), generator=gen, dtype=mesh.dtype, device=card))
    u0, v0 = c0(), c0()
    y = mesh.x[1]
    base = torch.stack([1 - y**2, 0 * y])
    fc = dict(viscosity=0.02, dt=5e-3, vtol=1e-11, ptol=1e-10, vmaxit=200, pmaxit=400)
    args = dict(box="step", cfg=fc, cfg_adj=fc, dt_over_g0=fc["dt"] / (11 / 6), pc={},
                nsteps=3, device="cuda:0")
    host = lambda a: a.cpu().numpy()
    out = W.run_ranks("propagate", 2, str(tmp_path), args,
                      dict(base=host(base), u0=host(u0), v0=host(v0)), timeout=300)
    cfg = lin.LinConfig(flow=ns.FlowConfig(**fc))
    pc = build_e_preconditioner(mesh, args["dt_over_g0"])
    th = torch.zeros((0,) + tuple(mesh.bm1.shape), dtype=mesh.dtype, device=card)
    mu, _ = lin.propagate(mesh, cfg, base, th, u0, th, 3, pc_e=pc)
    av, _ = lin.make_adjoint_propagator(mesh, cfg, base, th, 3, pc_e=pc)(v0, th)
    assert np.abs(out["mu"] - host(mu)).max() < 1e-7
    assert np.abs(out["adj"] - host(av)).max() < 1e-7


def test_split_rank_peak_memory_scales_with_its_block(card, tmp_path, monkeypatch):
    """Two gloo ranks sharing the card, on a 32 x 8 box at order 7 (OAS +
    Q1 + exact blocks, whose patch inverses dominate the memory): each
    rank's peak device memory through the preconditioner's build,
    `propagate` and its adjoint stays under 3/4 of one process's peak for
    the same run (half of it, plus what is replicated: the coarse inverse
    and one gathered block). The one process is the same job on one rank,
    in a process of its own like each of the two, so that both peaks count
    what every process allocates once (cuBLAS's workspace) and the same
    eager CGs. The global mesh and the preconditioner's build stay on the
    host."""
    import torch_shard_workers as W

    monkeypatch.setenv("NEKLAB_PRECOND_CACHE", "0")
    box_kw = dict(nels=(32, 8), order=7)
    mesh = box_mesh(**dict(W.STEP_BOX, **box_kw), dtype=torch.float64, device="cpu")
    y = mesh.x[1]
    base = torch.stack([1 - y**2, 0 * y])
    u0 = mesh.vmask * torch.stack([0 * y, 0.1 * torch.sin(mesh.x[0]) * (1 - y**2)])
    fc = dict(viscosity=1e-3, dt=2e-3, vtol=1e-8, ptol=1e-8, vmaxit=200, pmaxit=400)
    args = dict(box="step", box_kw=box_kw, cfg=fc, cfg_adj=fc, dt_over_g0=fc["dt"] / (11 / 6),
                pc={}, nsteps=2, device="cuda:0")
    inputs = dict(base=base.numpy(), u0=u0.numpy(), v0=u0.numpy())
    peaks = {size: W.run_ranks("propagate", size, str(tmp_path / str(size)), args, inputs,
                               timeout=600) for size in (2, 1)}
    two = [int(peaks[2][f"rank{r}"]["peak_bytes"]) for r in range(2)]
    one = int(peaks[1]["rank0"]["peak_bytes"])
    print(f"peak bytes: ranks {two}, one process {one}, ratio {max(two) / one:.4f} (bound 0.75)")
    assert np.abs(peaks[2]["mu"] - peaks[1]["mu"]).max() <= 1e-10
    assert 0 < max(two) < 0.75 * one, (two, one)


def test_one_rank_nccl_group_graphs_its_all_reduces(card, tmp_path):
    """A one-rank NCCL group: both CGs capture their all-reduces in CUDA
    graphs (`PCG.graphed`), every replay is logged, and 3 nonlinear steps
    match the unsplit run's at tests/test_sharding.py's bounds."""
    import torch_shard_workers as W

    mesh = box_mesh(**W.STEP_BOX, dtype=torch.float64, device="cpu")
    y = mesh.x[1]
    u0 = (mesh.vmask * torch.stack([1 - y**2, 0.1 * torch.sin(mesh.x[0])])).numpy()
    cfg = dict(viscosity=1e-3, dt=2e-3, vtol=1e-10, ptol=1e-10, vmaxit=40, pmaxit=80)
    out = W.run_ranks("nccl", 1, str(tmp_path), dict(cfg=cfg, backend="nccl", device="cuda:0"),
                      dict(u0=u0), timeout=300)
    assert out["split_graphed"].all() and out["one_graphed"].all()
    assert int(out["split_calls"]) > 0 and int(out["one_calls"]) == 0
    assert np.abs(out["split_u"] - out["one_u"]).max() <= 1e-10
    assert np.abs(out["split_p"] - out["one_p"]).max() <= 1e-8


def test_one_rank_nccl_group_forward_mode_matches_cpu(card, tmp_path):
    """Forward mode through a one-rank NCCL group's `advance` (the exact
    Jacobian's matvec of tests/test_torch_newton.py's forced channel, 4 x 2
    elements at order 4, 2 steps, 1e-12 solves) with every CG graphed,
    against the same matvec on CPU tensors in one process: rel 1e-10."""
    import torch_shard_workers as W
    from neklab_tpu_torch.models.linearized import LinConfig
    from neklab_tpu_torch.systems.fixed_point import FixedPointSystem
    from neklab_tpu_torch.vectors import flow_vector

    mesh = box_mesh(**W.FORCED_BOX, dtype=torch.float64, device="cpu")
    y = mesh.x[1]
    gen = torch.Generator()
    gen.manual_seed(9)
    noise = lambda: torch.randn((2,) + tuple(mesh.bm1.shape), generator=gen, dtype=mesh.dtype)
    guess = mesh.vmask * sem.dsavg(mesh, torch.stack([0.7 * (1 - y**2), 0 * y]) + 0.05 * noise())
    du = mesh.vmask * sem.dsavg(mesh, noise())
    cfg = dict(viscosity=W.FORCED_NU, dt=0.05, vtol=1e-12, ptol=1e-12)
    system = dict(tau=0.1, dt=0.05)
    out = W.run_ranks("nccl_jvp", 1, str(tmp_path), dict(cfg=cfg, system=system,
                                                         backend="nccl", device="cuda:0"),
                      dict(guess=guess.numpy(), du=du.numpy()), timeout=300)
    assert out["graphed"].all() and len(out["graphed"]) == 4
    one = FixedPointSystem(mesh, LinConfig(flow=ns.FlowConfig(**cfg, forcing_fn=W.body_force)),
                           exact_jacobian=True, **system)
    want = one.jacobian(flow_vector(mesh, 0, u=guess)).matvec(flow_vector(mesh, 0, u=du))["u"]
    assert float(want.abs().max()) > 1e-3
    assert rel(torch.as_tensor(out["jvp"]), want) <= 1e-10



# ---------------------------------------------------------------------------
# recycling (Nek5000's residual projection) around the graphed pressure CG
# ---------------------------------------------------------------------------


def test_recycled_propagate_matches_cpu(card):
    """`ExponentialPropagator(recycle=8)` on the card (graphed CGs, the
    basis on the device in the element-first layout of E's exact blocks)
    against the CPU, f64, 20 steps of the Poiseuille Re=500 channel: rel
    1e-10, and within the solvers' tolerance of recycle=0 on the card."""
    from neklab_tpu_torch.linops.exponential_propagator import ExponentialPropagator
    from neklab_tpu_torch.models.linearized import LinConfig

    out, props = {}, {}
    u = None
    for dev in (card, "cpu"):
        m = box_mesh((4, 5), ((0, 2 * np.pi), (-1, 1)), CHANNEL_BC, order=6, device=dev)
        cfg = LinConfig(flow=ns.FlowConfig(viscosity=1 / 500, dt=1e-2, vtol=1e-12, ptol=1e-12))
        y = m.x[1]
        props[dev] = ExponentialPropagator(m, cfg, torch.stack([1 - y**2, 0 * y]), tau=0.2,
                                           dt=1e-2, recycle=8)
        if u is None:
            u = np.random.default_rng(13).standard_normal((2,) + tuple(m.bm1.shape))
        x = {"u": m.vmask * sem.dsavg(m, torch.as_tensor(u, device=dev)),
             "theta": torch.zeros((0,) + tuple(m.bm1.shape), dtype=m.dtype, device=dev)}
        out[dev] = props[dev].matvec(x)["u"]
        if dev == card:
            assert props[dev].pc_e.eb_w is not None
            assert all(s.cg.graphed for s in props[dev].psolves.values())
            props[dev].recycle = 0
            plain = props[dev].matvec(x)["u"]
    assert rel(out[card].cpu(), out["cpu"]) <= 1e-10
    assert rel(plain, out[card]) <= 1e-8


def test_recycled_exact_jacobian_matches_cpu(card):
    """`FixedPointSystem(recycle=4, exact_jacobian=True)` on the forced
    channel (4 x 2 elements at order 4, tau 0.2 at dt 0.025: 6 steps past
    the ramp, 1e-12 solves): the matvec (forward mode through the recycled
    `advance`) and the rmatvec (its recorded backward), card against CPU,
    rel 1e-10."""
    import torch_shard_workers as W
    from neklab_tpu_torch.models.linearized import LinConfig
    from neklab_tpu_torch.systems.fixed_point import FixedPointSystem
    from neklab_tpu_torch.vectors import flow_vector

    mesh = box_mesh(**W.FORCED_BOX, dtype=torch.float64, device="cpu")
    y = mesh.x[1]
    gen = torch.Generator()
    gen.manual_seed(10)
    noise = lambda: torch.randn((2,) + tuple(mesh.bm1.shape), generator=gen, dtype=mesh.dtype)
    guess = mesh.vmask * sem.dsavg(mesh, torch.stack([0.7 * (1 - y**2), 0 * y]) + 0.05 * noise())
    du, w = (mesh.vmask * sem.dsavg(mesh, noise()) for _ in range(2))
    cfg = LinConfig(flow=ns.FlowConfig(viscosity=W.FORCED_NU, dt=0.025, vtol=1e-12, ptol=1e-12,
                                       forcing_fn=W.body_force))
    out = {}
    for dev in (card, "cpu"):
        m = mesh.to(dev)
        system = FixedPointSystem(m, cfg, tau=0.2, dt=0.025, exact_jacobian=True, recycle=4)
        vec = lambda a: flow_vector(m, 0, u=a.to(dev))
        jac = system.jacobian(vec(guess))
        out[dev] = (jac.matvec(vec(du))["u"], jac.rmatvec(vec(w))["u"])
    for got, want in zip(out[card], out["cpu"]):
        assert float(want.abs().max()) > 1e-3
        assert rel(got.cpu(), want) <= 1e-10


def test_one_rank_nccl_group_recycled_steps_match_unsplit(card, tmp_path):
    """8 nonlinear steps with recycle=4 on a one-rank NCCL group (graphed
    CGs, the basis's sums all-reduced eagerly around them) against the
    same steps unsplit, at the bounds of the plain case above."""
    import torch_shard_workers as W

    mesh = box_mesh(**W.STEP_BOX, dtype=torch.float64, device="cpu")
    y = mesh.x[1]
    u0 = (mesh.vmask * torch.stack([1 - y**2, 0.1 * torch.sin(mesh.x[0])])).numpy()
    cfg = dict(viscosity=1e-3, dt=2e-3, vtol=1e-10, ptol=1e-10, vmaxit=40, pmaxit=80)
    out = W.run_ranks("nccl", 1, str(tmp_path), dict(cfg=cfg, backend="nccl", device="cuda:0",
                                                      nsteps=8, recycle=4),
                      dict(u0=u0), timeout=300)
    assert out["split_graphed"].all() and out["one_graphed"].all()
    assert int(out["split_calls"]) > 0 and int(out["one_calls"]) == 0
    assert np.abs(out["split_u"] - out["one_u"]).max() <= 1e-10
    assert np.abs(out["split_p"] - out["one_p"]).max() <= 1e-8


def test_recycling_basis_makes_no_host_read(card):
    """The projection and the update of a recycling basis on the card run
    under `torch.cuda.set_sync_debug_mode("error")`: ok, the slot and the
    count stay on the device, so no step of them reads back to the host."""
    mesh = box_mesh(*CHANNEL, order=6, device=card)
    gen = torch.Generator(device=card)
    gen.manual_seed(14)
    rand = lambda: torch.randn(tuple(mesh.bm2.shape), generator=gen, dtype=mesh.dtype,
                               device=card)
    basis = ns.init_projection_basis(mesh, 3)
    vals = [rand() for _ in range(5)]
    torch.cuda.synchronize(card)
    torch.cuda.set_sync_debug_mode("error")
    try:
        for v in vals[:4]:  # the fourth rolls over onto slot 0
            xbar, rest = ns._basis_project(basis, v)
            basis = ns._basis_update(basis, v, 2.0 * v, 1e-12)
        xbar, rest = ns._basis_project(basis, vals[4])
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert int(basis[2]) == 4
    assert bool(torch.isfinite(xbar).all()) and bool(torch.isfinite(rest).all())


# ---------------------------------------------------------------------------
# the Boussinesq family (nscal = 1): the scalar's graphed CGs, its Jacobi
# diagonal, its lift, the scalar part of the adjoint's tape, and
# advance_adaptive's rebuilds
# ---------------------------------------------------------------------------

# a channel walled in y with the temperature fixed on both walls
SCALAR_BOX = dict(nels=(4, 3), lims=((0, 2 * np.pi), (-1, 1)), bc=CHANNEL_BC, order=5,
                  bc_temp={"y-": "t", "y+": "t"})
SCALAR_FLOW = dict(viscosity=0.02, dt=5e-3, nscal=1, conductivity=(0.03,), vtol=1e-12,
                   ptol=1e-12, ttol=1e-12)


def _buoyancy(m, t_, u, th):
    return torch.stack([0.1 * torch.ones_like(th[0]), 2.0 * th[0]])


def _source(m, t_, u, th):
    return (0.5 * u[1] + 0.1 * th[0] ** 2)[None]


def test_forced_scalar_advance_matches_cpu(card):
    """10 nonlinear steps with nscal = 1 (a buoyancy `forcing_fn`, a
    nonlinear `source_fn`, the wall temperature as the scalar's lift) on the
    card and on the CPU, f64: the same CG iterations, rel 1e-10. On the card
    the kernel runs once per velocity and scalar CG iteration and twice per
    solve (the lift, the warm start's operator apply)."""
    rng = np.random.default_rng(16)
    out, stats, data, nsteps = {}, {}, None, 10
    for dev in (card, "cpu"):
        m = box_mesh(**SCALAR_BOX, device=dev)
        cfg = ns.FlowConfig(**SCALAR_FLOW, forcing_fn=_buoyancy, source_fn=_source)
        y = m.x[1]
        tb = torch.stack([0.5 * (1 - y)])
        if data is None:
            data = [rng.standard_normal(s) for s in ((2,) + tuple(m.bm1.shape),
                                                     (1,) + tuple(m.bm1.shape))]
        u, th = (torch.as_tensor(d, device=dev) for d in data)
        st = ns.initial_state(m, cfg, u=0.1 * m.vmask * sem.dsavg(m, u),
                              theta=tb + 0.1 * m.tmask * sem.dsavg(m, th))
        orders = ns.bdf_orders(cfg, nsteps)
        psolves = ns.pressure_solvers(m, cfg, orders, pc_e=build_e_preconditioner(m))
        vsolves = ns.velocity_solvers(m, cfg, orders, *ns.bdf3_diags(m, cfg))
        if dev == card:
            assert all(s.cg.graphed for _, ts in vsolves.values() for s in ts)
        stats[dev] = {}
        helmholtz_kernel.reset_launches(card)
        out[dev] = ns.advance(m, cfg, st, nsteps, tb=tb, psolves=psolves, vsolves=vsolves,
                              stats=stats[dev])
        if dev == card:
            s = stats[dev]
            assert helmholtz_kernel.launches(card) == \
                sum(s["helmholtz"]) + sum(s["scalar"]) + 4 * nsteps
    assert cg_counts(stats[card]) == cg_counts(stats["cpu"]) and min(stats["cpu"]["scalar"]) > 0
    for k in ("u", "p", "theta"):
        assert rel(getattr(out[card], k), getattr(out["cpu"], k)) <= 1e-10, k


def _coupled(dev):
    """tests/test_torch_adjoint.py::_coupled_case's coupling (a buoyancy
    `lin_forcing_fn`, a stratification-like `lin_source_fn`) on SCALAR_BOX,
    about a sheared base flow and a linear base temperature."""
    from neklab_tpu_torch.models.linearized import LinConfig

    m = box_mesh(**SCALAR_BOX, device=dev)
    cfg = LinConfig(flow=ns.FlowConfig(**SCALAR_FLOW),
                    lin_forcing_fn=lambda m_, u, th: torch.stack([torch.zeros_like(th[0]), th[0]]),
                    lin_source_fn=lambda m_, u, th: u[1:2])
    y = m.x[1]
    return m, cfg, torch.stack([1 - y**2, 0 * y]), torch.stack([0.5 * (1 - y)])


def _conforming_pairs(m, seed):
    """Two (u, theta) pairs of C0 fields that vanish where the masks do."""
    rng = np.random.default_rng(seed)
    shape = tuple(m.bm1.shape)
    out = []
    for _ in range(2):
        u = torch.as_tensor(rng.standard_normal((2,) + shape), device=m.device)
        th = torch.as_tensor(rng.standard_normal((1,) + shape), device=m.device)
        out.append((m.vmask * sem.dsavg(m, u), m.tmask * sem.dsavg(m, th)))
    return out


def test_scalar_propagate_and_adjoint_match_cpu(card):
    """`propagate` (7 steps) and its recorded adjoint with nscal = 1 and both
    linear couplings, on the card (graphed scalar CGs, the scalar part of
    the tape) and on the CPU, f64: rel 1e-10 forward, 1e-9 absolute through
    the adjoint (as test_rmatvec_matches_cpu); the same solves, each within
    one CG iteration of the CPU's (the unpreconditioned pressure CG's ~180
    iterations to 1e-12 end a step apart where the residual meets the
    tolerance in another summation order)."""
    from neklab_tpu_torch.models.linearized import make_adjoint_propagator, propagate

    out, stats = {}, {}
    for dev in (card, "cpu"):
        m, cfg, bu, bth = _coupled(dev)
        (u0, t0), (v0, s0) = _conforming_pairs(m, 17)
        stats[dev] = {}
        mu, mth = propagate(m, cfg, bu, bth, u0, t0, 7, stats=stats[dev])
        adj = make_adjoint_propagator(m, cfg, bu, bth, 7)
        au, ath = adj(v0, s0)
        out[dev] = (mu, mth, au, ath)
        if dev == card:
            assert adj.tape_bytes > 0
    for k, (got, want) in enumerate(zip(out[card], out["cpu"])):
        assert float(want.abs().max()) > 1e-3, k  # the scalar's adjoint is driven too
        if k < 2:
            assert rel(got, want) <= 1e-10, k
        else:
            assert float((got.cpu() - want).abs().max()) <= 1e-9, k
    assert sorted(cg_counts(stats[card])) == sorted(cg_counts(stats["cpu"])) == [
        "helmholtz", "pressure", "scalar"]
    for key, counts in cg_counts(stats["cpu"]).items():
        assert len(stats[card][key]) == len(counts) and min(counts) > 0, key
        assert max(abs(a - b) for a, b in zip(stats[card][key], counts)) <= 1, key


def test_scalar_b_adjoint_identity_on_the_card(card):
    """<M u, v>_B = <u, M* v>_B on continuous fields (`sem.dsavg`, masked)
    on the card, nscal = 1 with both couplings: rel 1e-9, the bound of the
    CPU test (tests/test_torch_adjoint.py::test_adjoint_identity)."""
    from neklab_tpu_torch.models.linearized import make_adjoint_propagator, propagate

    m, cfg, bu, bth = _coupled(card)
    (u0, t0), (v0, s0) = _conforming_pairs(m, 18)
    mu, mth = propagate(m, cfg, bu, bth, u0, t0, 7)
    au, ath = make_adjoint_propagator(m, cfg, bu, bth, 7)(v0, s0)
    lhs = float(sem.mass_dot(m, mu, v0) + sem.mass_dot(m, mth, s0))
    rhs = float(sem.mass_dot(m, u0, au) + sem.mass_dot(m, t0, ath))
    assert abs(lhs - rhs) / abs(lhs) < 1e-9, (lhs, rhs)


def test_advance_adaptive_matches_cpu_and_frees_its_solvers(card):
    """`advance_adaptive` with nscal = 1 (the forced channel of
    tests/test_torch_stepper.py::test_advance_adaptive_matches_reference,
    walled for the scalar, to t = 0.6 in chunks of 3 steps) on the card and
    on the CPU: the same dt at each rebuild (rel 1e-12), the state to rel
    1e-10. Each rebuild builds and captures a new solver set and drops the
    last one: the device memory left after the run (the state it returns)
    stays below what one solver set holds while it lives, where a leak of
    one set, or of a cuBLAS workspace per rebuild, would exceed it. A set
    is built and dropped once first, for what the process allocates once."""
    import gc

    kw = dict(SCALAR_BOX, nels=(3, 4), order=4)
    nu = 0.05
    cfg = ns.FlowConfig(viscosity=nu, dt=0.02, nscal=1, conductivity=(0.05,), vtol=1e-12,
                        ptol=1e-12, ttol=1e-12,
                        forcing_fn=lambda m, tm, u, th: torch.stack(
                            [2 * nu * torch.ones_like(th[0]), th[0]]))

    def allocated():
        gc.collect()
        torch.cuda.synchronize(card)
        return torch.cuda.memory_allocated(card)

    out, builds, mem = {}, {}, {}
    for dev in (card, "cpu"):
        m = box_mesh(**kw, device=dev)
        y = m.x[1]
        tb = torch.stack([0.5 * (1 - y)])
        st = ns.initial_state(m, cfg, u=m.vmask * torch.stack([0.5 * (1 - y**2), 0 * y]),
                              theta=tb)
        pc = build_e_preconditioner(m)
        if dev == card:
            one_set = lambda: (ns.velocity_solvers(m, cfg, [1, 2, 3], *ns.bdf3_diags(m, cfg)),
                               ns.pressure_solvers(m, cfg, [1, 2, 3], pc))
            one_set()  # built and dropped: what the process allocates once
            base = allocated()
            held = one_set()
            mem["one_set"] = allocated() - base
            del held
            base = allocated()
        stats = {}
        out[dev] = ns.advance_adaptive(m, cfg, st, endtime=0.6, cfl=0.4, tb=tb, pc_e=pc,
                                       chunk=3, stats=stats)
        builds[dev] = stats["solver_builds"]
        if dev == card:
            mem["after"] = allocated() - base
    assert len(builds[card]) == len(builds["cpu"]) > 2, builds
    np.testing.assert_allclose(builds[card], builds["cpu"], rtol=1e-12)
    assert abs(out[card].time - 0.6) < 1e-12
    for k in ("u", "p", "theta"):
        assert rel(getattr(out[card], k), getattr(out["cpu"], k)) <= 1e-10, k
    assert 0 < mem["after"] < mem["one_set"], (mem, len(builds[card]))


# the Boussinesq family in 3-D: neklab's rayBen (Ra 1900, Pr 1, thermal units)
# in a laterally periodic layer, the temperature held on both walls
RB_RA = 1900.0
RB_LC = 2 * np.pi / 3.11632  # one critical wavelength, k_c = 3.11632
RB_BC = {"x-": "P", "x+": "P", "y-": "W", "y+": "W", "z-": "P", "z+": "P"}
RB_TEMP = {"y-": "t", "y+": "t"}


def _rb_config(ndim, tol):
    from neklab_tpu_torch.models.linearized import LinConfig

    def buoyancy(m, u, th):
        comps = [torch.zeros_like(th[0])] * ndim
        comps[1] = RB_RA * th[0]
        return torch.stack(comps)

    return LinConfig(flow=ns.FlowConfig(viscosity=1.0, dt=1e-3, nscal=1, conductivity=(1.0,),
                                        vtol=tol, ptol=tol, ttol=tol), lin_forcing_fn=buoyancy)


def test_scalar3d_propagate_and_adjoint_match_cpu(card):
    """A 3-D Boussinesq `propagate` (6 steps, traced) and its recorded
    adjoint on a (2, 2, 2) layer at order 4, about a sheared base flow and a
    temperature varying in x, y and z, on the card (graphed scalar CGs, the
    E kernel pair) and on the CPU, f64: rel 1e-10 forward, 1e-9 absolute
    through the adjoint (as the 2-D test above), the same solves within one
    CG iteration. The traced call on the card fills `neklab.cg.scalar` (one
    `CGTiming` a scalar solve, its iterations those of stats["scalar"]) and
    `neklab.scalar` (one entry a time step, each within its step's)."""
    from neklab_tpu_torch.models.linearized import make_adjoint_propagator, propagate
    from neklab_tpu_torch.models.solvers import CGTiming

    box = dict(nels=(2, 2, 2), lims=((0, 2.0), (0, 1.0), (0, 2.0)), bc=RB_BC, order=4,
               bc_temp=RB_TEMP)
    cfg, nsteps = _rb_config(3, 1e-12), 6
    rng = np.random.default_rng(19)
    out, stats, data = {}, {}, None
    for dev in (card, "cpu"):
        m = box_mesh(**box, device=dev)
        x, y, z = m.x
        bu = torch.stack([4 * y * (1 - y), 0 * y, 0.3 * torch.sin(np.pi * x) * y * (1 - y)])
        bth = (1 - y + 0.1 * torch.sin(np.pi * x) * torch.cos(np.pi * z) * y * (1 - y))[None]
        shape = tuple(m.bm1.shape)
        if data is None:
            data = [rng.standard_normal(s) for s in ((3,) + shape, (1,) + shape) * 2]
        f = [torch.as_tensor(d, device=dev) for d in data]
        u0, t0 = m.vmask * sem.dsavg(m, f[0]), m.tmask * sem.dsavg(m, f[1])
        v0, s0 = m.vmask * sem.dsavg(m, f[2]), m.tmask * sem.dsavg(m, f[3])
        stats[dev] = {}
        mu, mth = propagate(m, cfg, bu, bth, u0, t0, nsteps, stats=stats[dev])
        adj = make_adjoint_propagator(m, cfg, bu, bth, nsteps)
        au, ath = adj(v0, s0)
        out[dev] = (mu, mth, au, ath)
    for k, (got, want) in enumerate(zip(out[card], out["cpu"])):
        assert float(want.abs().max()) > 1e-3, k
        if k < 2:
            assert rel(got, want) <= 1e-10, k
        else:
            assert float((got.cpu() - want).abs().max()) <= 1e-9, k
    for key, counts in cg_counts(stats["cpu"]).items():
        assert len(stats[card][key]) == len(counts) and min(counts) > 0, key
        assert max(abs(a - b) for a, b in zip(stats[card][key], counts)) <= 1, key
    s = stats[card]
    assert all(isinstance(t, CGTiming) for t in s["neklab.cg.scalar"])
    assert [t.iters for t in s["neklab.cg.scalar"]] == s["scalar"]
    assert len(s["neklab.scalar"]) == len(s["neklab.step"]) == nsteps
    assert all(0 <= a <= b for a, b in zip(s["neklab.scalar"], s["neklab.step"]))


def _rb_sigma(dev, ndim, order):
    """The leading growth rate of the conduction state at Ra = RB_RA in a
    box of one critical wavelength a periodic direction, (3, 3[, 3])
    elements, inner solves at 1e-12."""
    from neklab_tpu_torch.analysis import linear_stability_analysis_fixed_point
    from neklab_tpu_torch.linops.exponential_propagator import ExponentialPropagator
    from neklab_tpu_torch.vectors import flow_vector_space

    faces = ("x-", "x+", "y-", "y+", "z-", "z+")[: 2 * ndim]
    lims = ((0, RB_LC), (0, 1.0), (0, RB_LC))[:ndim]
    m = box_mesh(nels=(3,) * ndim, lims=lims, bc={f: RB_BC[f] for f in faces}, order=order,
                 bc_temp=RB_TEMP, device=dev)
    base_u = torch.zeros((ndim,) + tuple(m.bm1.shape), dtype=torch.float64, device=dev)
    prop = ExponentialPropagator(m, _rb_config(ndim, 1e-12), base_u, (1 - m.x[1])[None],
                                 tau=0.02, dt=1e-3)
    res = linear_stability_analysis_fixed_point(prop, flow_vector_space(m, 1), kdim=24, nev=2,
                                                tol=1e-10, maxiter=6, seed=5)
    return complex(res.eigvals[0])


def test_rayleigh_benard_3d_onset_equals_2d(card):
    """The 3-D onset: in a lambda_c x 1 x lambda_c periodic layer at Ra =
    1900 the leading eigenvalue (double: rolls along x and along z) is the
    2-D box's sigma(1900) at the same (3, 3) elements and order in x-y. The
    3-D discretisation restricted to z-independent fields is the 2-D one,
    so they agree to the solvers' and the eigensolve's tolerance: 1e-8
    (the Ritz values' residual tolerance 1e-10 over tau = 0.02)."""
    lam3 = _rb_sigma(card, 3, 6)
    lam2 = _rb_sigma(card, 2, 6)
    assert lam2.real > 0 and abs(lam2.imag) < 1e-8  # supercritical, stationary rolls
    assert abs(lam3 - lam2) <= 1e-8, (lam3, lam2)


# ---------------------------------------------------------------------------
# the spans of a traced call on the card
# ---------------------------------------------------------------------------


def test_traced_spans_fit_the_call_and_stay_out_of_a_device_profile(card):
    """A traced matvec and rmatvec on the card (CUDA events around the
    graphed CGs' iterations, each time step, the backward), on a small
    3-D duct (the benchmark's path, which gives the same bits call after
    call; the 2-D path's E solve does not, at 1e-15, traced or not): the
    outputs equal an untraced call's bit for bit; their event-timed parts,
    the solves' spans and the steps' (the backward's) time outside them,
    sum to no more than the call's wall time between two synchronizes; a
    profile of the device's activity alone holds no event named after a
    program span, and one with the host's activity holds them all."""
    from torch.profiler import ProfilerActivity, profile

    from neklab_tpu_torch.linops.exponential_propagator import ExponentialPropagator
    from neklab_tpu_torch.models.linearized import LinConfig

    duct = {"x-": "P", "x+": "P", "y-": "W", "y+": "W", "z-": "W", "z+": "W"}
    m = box_mesh((3, 2, 2), ((0, 4.0), (-1, 1), (-1, 1)), duct, order=5, device=card)
    cfg = LinConfig(flow=ns.FlowConfig(viscosity=1 / 500, dt=DT, vtol=1e-10, ptol=1e-10))
    base = torch.zeros((3,) + tuple(m.bm1.shape), dtype=m.dtype, device=card)
    base[0] = (1 - m.x[1] ** 2) * (1 - m.x[2] ** 2)
    prop = ExponentialPropagator(m, cfg, base, tau=0.1)
    u = np.random.default_rng(3).standard_normal((3,) + tuple(m.bm1.shape))
    u = m.vmask * sem.dsavg(m, torch.as_tensor(u, device=card))
    x = {"u": u / sem.mass_dot(m, u, u).sqrt(),
         "theta": torch.zeros((0,) + tuple(m.bm1.shape), dtype=m.dtype, device=card)}
    for name, outer in (("matvec", "neklab.step"), ("rmatvec", "neklab.adjoint")):
        fn = getattr(prop, name)
        fn(x)  # both paths once first; the adjoint records its tape at its first call
        fn(x, stats={})
        plain = fn(x)["u"]
        stats = {}
        torch.cuda.synchronize(card)
        t0 = time.perf_counter()
        out = fn(x, stats=stats)["u"]
        torch.cuda.synchronize(card)
        wall = time.perf_counter() - t0
        assert torch.equal(out, plain), name
        solves = sum(s.span_s for k, v in stats.items() if k.startswith("neklab.cg.") for s in v)
        steps = stats[outer]
        other = sum(steps) if name == "matvec" else steps[0] * prop.nsteps
        assert len(steps) == (prop.nsteps if name == "matvec" else 1), name
        assert 0 < solves and 0 <= min(steps) and solves + other <= wall, (name, solves, other)
        spans = {outer, "neklab.cg.helmholtz", "neklab.cg.pressure", "neklab.cg.read"}
        for acts, want in (([ProfilerActivity.CUDA], set()),
                           ([ProfilerActivity.CPU, ProfilerActivity.CUDA], spans)):
            with profile(activities=acts) as prof:
                fn(x, stats={})
            assert {e.name for e in prof.events() if e.name.startswith("neklab.")} == want, (
                name, acts)
