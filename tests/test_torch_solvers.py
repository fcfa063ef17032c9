"""Port parity: the implicit solves and the pressure preconditioner.

Tolerances (f64, CPU):
  * Jacobi diagonal, e_apply vs e_op: rel <= 1e-12 (same arithmetic,
    different summation order);
  * CG solutions: <= 1e-9 absolute at inner tolerances 1e-11 (velocity) and
    1e-10 (pressure), with iteration counts equal or within 1 — the two CGs
    take the same steps and can differ only where a residual crosses the
    threshold within roundoff;
  * preconditioner matrices and apply: rel <= 1e-9. Their dense inverses
    (patch matrices, the Q1 coarse operator) amplify the 1e-15 probing
    differences by the matrices' condition numbers.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neklab_tpu.mesh.box import box_mesh as jbox_mesh
from neklab_tpu.mesh.cylinder import annulus_mesh
from neklab_tpu.models import navier_stokes as jns
from neklab_tpu.models import stokes as jstokes
from neklab_tpu.models.precond import build_e_preconditioner as jbuild
from neklab_tpu.models.solvers import pcg_info as jpcg_info
from neklab_tpu.ops import sem as jsem
from neklab_tpu_torch.mesh.box import box_mesh
from neklab_tpu_torch.models import navier_stokes as ns
from neklab_tpu_torch.models import stokes
from neklab_tpu_torch.models.precond import build_e_preconditioner
from neklab_tpu_torch.models.solvers import pcg_info
from neklab_tpu_torch.ops import sem
from torch_port_helpers import CHANNEL_BC, absdiff, carry_mesh, cg_counts, rel, t, to_np

DT = 1e-2
H1, H2 = 1.0 / 500, (11.0 / 6.0) / DT
S = DT / (11.0 / 6.0)  # dt / g0


@pytest.fixture(scope="module")
def channel():
    kw = dict(nels=(4, 5), lims=((0, 2 * np.pi), (-1, 1)), bc=CHANNEL_BC, order=6)
    return jbox_mesh(**kw), box_mesh(**kw, device="cpu")


def test_helmholtz_diag(channel):
    jmesh, mesh = channel
    ref = jns.helmholtz_diag(jmesh, H1, H2, jmesh.vmask)
    out = ns.helmholtz_diag(mesh, H1, H2, mesh.vmask)
    assert rel(out, ref) <= 1e-12


def _helmholtz_op(pkg_sem, m, mask, sqw):
    def op(y):
        tt = pkg_sem.dssum(m, sqw * y)
        hv = pkg_sem.dssum(m, pkg_sem.helmholtz_local(m, mask * tt, H1, H2))
        return sqw * (mask * (hv - tt)) + y
    return op


def test_helmholtz_solve_and_iterations(channel):
    jmesh, mesh = channel
    rhs = np.random.default_rng(3).standard_normal((2,) + tuple(jmesh.bm1.shape))
    jdiag = jns.helmholtz_diag(jmesh, H1, H2, jmesh.vmask)
    diag = ns.helmholtz_diag(mesh, H1, H2, mesh.vmask)
    zero = np.zeros_like(rhs)
    ref = jns.helmholtz_solve(jmesh, jnp.asarray(rhs), H1, H2, jmesh.vmask, jnp.asarray(zero),
                              1e-11, 500, jdiag)
    out = ns.helmholtz_solve(mesh, t(rhs), H1, H2, mesh.vmask, t(zero), 1e-11, 500, diag)
    assert absdiff(out, ref) <= 1e-9

    # iteration counts on the same assembled RHS
    jsqw, sqw = jnp.sqrt(jmesh.vmult), mesh.vmult.sqrt()
    jb = jmesh.vmask * jsqw * jsem.dssum(jmesh, jmesh.bm1 * jnp.asarray(rhs))
    b = mesh.vmask * sqw * sem.dssum(mesh, mesh.bm1 * t(rhs))
    _, jk, _ = jpcg_info(_helmholtz_op(jsem, jmesh, jmesh.vmask, jsqw), jb,
                         precond=lambda r: r / jdiag, tol=1e-11, maxiter=500)
    x, k, rr = pcg_info(_helmholtz_op(sem, mesh, mesh.vmask, sqw), b,
                        precond=lambda r: r / diag, tol=1e-11, maxiter=500)
    assert k > 3 and abs(k - int(jk)) <= 1, (k, int(jk))
    assert float(rr) <= 1e-22


def test_helmholtz_solve_reports_its_iterations(channel):
    """`stats` records the count of the CG that helmholtz_solve runs: the
    reference's count on the same assembled RHS, within 1."""
    jmesh, mesh = channel
    rhs = np.random.default_rng(7).standard_normal((2,) + tuple(jmesh.bm1.shape))
    jdiag = jns.helmholtz_diag(jmesh, H1, H2, jmesh.vmask)
    diag = ns.helmholtz_diag(mesh, H1, H2, mesh.vmask)
    stats = {}
    ns.helmholtz_solve(mesh, t(rhs), H1, H2, mesh.vmask, t(np.zeros_like(rhs)), 1e-11, 500, diag,
                       stats=stats)
    jsqw = jnp.sqrt(jmesh.vmult)
    jb = jmesh.vmask * jsqw * jsem.dssum(jmesh, jnp.asarray(rhs))
    _, jk, _ = jpcg_info(_helmholtz_op(jsem, jmesh, jmesh.vmask, jsqw), jb,
                         precond=lambda r: r / jdiag, tol=1e-11, maxiter=500)
    assert len(stats["helmholtz"]) == 1
    assert stats["helmholtz"][0] > 3 and abs(stats["helmholtz"][0] - int(jk)) <= 1


@pytest.mark.parametrize("order", [1, 2, 3])
def test_built_once_velocity_solver_matches_fresh_and_reference(channel, order):
    """A velocity solver built once (`make_helmholtz_solver`, as `propagate`
    builds one per BDF order) and run over three successive right-hand sides
    matches a fresh `helmholtz_solve` per call, with the same iteration
    count, and the reference's `helmholtz_solve`."""
    jmesh, mesh = channel
    h2 = ns._BDF[order][0] / DT
    jdiag = jns.helmholtz_diag(jmesh, H1, h2, jmesh.vmask)
    diag = ns.helmholtz_diag(mesh, H1, h2, mesh.vmask)
    solve = ns.make_helmholtz_solver(mesh, H1, h2, mesh.vmask, diag, 1e-11, 500)
    rng = np.random.default_rng(20 + order)
    shape = (2,) + tuple(jmesh.bm1.shape)
    for i in range(3):
        rhs = rng.standard_normal(shape)
        # the second and third carry Dirichlet values (continuous across copies)
        bc = np.asarray(jsem.dsavg(jmesh, jnp.asarray(rng.standard_normal(shape)))) * (i > 0)
        stats, fresh_stats = {}, {}
        out = solve(t(rhs), t(bc), stats=stats)
        fresh = ns.helmholtz_solve(mesh, t(rhs), H1, h2, mesh.vmask, t(bc), 1e-11, 500, diag,
                                   stats=fresh_stats)
        ref = jns.helmholtz_solve(jmesh, jnp.asarray(rhs), H1, h2, jmesh.vmask, jnp.asarray(bc),
                                  1e-11, 500, jdiag)
        assert cg_counts(stats) == cg_counts(fresh_stats) and stats["helmholtz"][0] > 3, (
            stats, fresh_stats)
        assert absdiff(out, fresh) <= 1e-9
        assert absdiff(out, ref) <= 1e-9


def test_helmholtz_solve_takes_any_leading_axes(channel):
    """The one-shot `helmholtz_solve` sizes its solver from the right-hand
    side: one more leading axis, solved jointly, as the reference does."""
    jmesh, mesh = channel
    rng = np.random.default_rng(9)
    rhs = rng.standard_normal((3, 2) + tuple(jmesh.bm1.shape))
    bc = np.zeros_like(rhs)
    jdiag = jns.helmholtz_diag(jmesh, H1, H2, jmesh.vmask)
    diag = ns.helmholtz_diag(mesh, H1, H2, mesh.vmask)
    ref = jns.helmholtz_solve(jmesh, jnp.asarray(rhs), H1, H2, jmesh.vmask, jnp.asarray(bc),
                              1e-11, 500, jdiag)
    out = ns.helmholtz_solve(mesh, t(rhs), H1, H2, mesh.vmask, t(bc), 1e-11, 500, diag)
    assert tuple(out.shape) == rhs.shape
    assert absdiff(out, ref) <= 1e-9


def test_helmholtz_solver_rejects_another_shape(channel):
    _, mesh = channel
    diag = ns.helmholtz_diag(mesh, H1, H2, mesh.vmask)
    solve = ns.make_helmholtz_solver(mesh, H1, H2, mesh.vmask, diag, 1e-11, 500)
    rhs = torch.zeros((3, 2) + tuple(mesh.bm1.shape), dtype=torch.float64)  # one more axis
    with pytest.raises(ValueError):
        solve(rhs, torch.zeros_like(rhs))


def _pc_meshes(name):
    if name == "channel":
        kw = dict(nels=(8, 4), lims=((0, 2 * np.pi), (-1, 1)), bc=CHANNEL_BC, order=6)
        return jbox_mesh(**kw), box_mesh(**kw, device="cpu")
    jmesh = annulus_mesh(3, 8, r_in=0.5, r_out=2.0, order=4, dtype=jnp.float64)
    return jmesh, carry_mesh(jmesh)


@pytest.fixture(scope="module", params=["channel", "annulus"])
def pcs(request):
    jmesh, mesh = _pc_meshes(request.param)
    return jmesh, mesh, jbuild(jmesh, S, compress=False), build_e_preconditioner(mesh)


def _blocks_by_pair(w, nbr):
    """{(element, neighbour): block}, first occurrence (later ones are pads)."""
    out = {}
    for e in range(nbr.shape[0]):
        for m, f in enumerate(nbr[e]):
            out.setdefault((e, int(f)), w[e, m])
    return out


def test_preconditioner_matrices(pcs):
    jmesh, mesh, jpc, pc = pcs
    jw = _blocks_by_pair(np.asarray(jpc.eb_w), np.asarray(jpc.eb_nbr))
    nel, np2 = pc.eb_w.shape[:2]
    # the port stores the row blocks side by side: [nel, np2, K*np2]
    w = to_np(pc.eb_w).reshape(nel, np2, -1, np2).transpose(0, 2, 1, 3)
    w = _blocks_by_pair(w, to_np(pc.eb_nbr))
    assert jw.keys() == w.keys()
    scale = max(np.abs(b).max() for b in jw.values())
    assert max(np.abs(w[k] - jw[k]).max() for k in jw) <= 1e-9 * scale
    # the port folds the reference's in/out patch weights into the inverses
    wslot = np.repeat(np.asarray(jpc.oas_win), np2, axis=1)
    jbinv = wslot[:, :, None] * np.asarray(jpc.oas_binv) * wslot[:, None, :]
    assert rel(pc.oas_binv, jbinv) <= 1e-9
    for name in ("ec_inv", "q1_b4", "q1_vert"):
        assert rel(getattr(pc, name), getattr(jpc, name)) <= 1e-9, name


def test_e_apply_and_apply(pcs):
    jmesh, mesh, jpc, pc = pcs
    rng = np.random.default_rng(5)
    q = rng.standard_normal(tuple(jmesh.bm2.shape))
    qb = rng.standard_normal((3,) + tuple(jmesh.bm2.shape))
    assert rel(pc.e_apply(t(q), S), stokes.e_op(mesh, t(q), S)) <= 1e-12
    assert rel(pc.e_apply(t(qb), S), stokes.e_op(mesh, t(qb), S)) <= 1e-12
    assert rel(pc.apply(t(q)), jpc.apply(jnp.asarray(q))) <= 1e-9


def test_pressure_solve_and_iterations(pcs):
    jmesh, mesh, jpc, pc = pcs
    rng = np.random.default_rng(6)
    u = rng.standard_normal((2,) + tuple(jmesh.bm1.shape))
    x0 = 1e-2 * rng.standard_normal(tuple(jmesh.bm2.shape))
    jcfg = jns.FlowConfig(viscosity=H1, dt=DT, ptol=1e-10, pmaxit=500)
    cfg = ns.FlowConfig(viscosity=H1, dt=DT, ptol=1e-10, pmaxit=500)
    jrhs = -jstokes.div_weak(jmesh, jnp.asarray(u))
    rhs = -stokes.div_weak(mesh, t(u))
    ref = jns.make_pressure_solver(jmesh, jcfg, S, pc=jpc)(jrhs, x0=jnp.asarray(x0))
    out = ns.make_pressure_solver(mesh, cfg, S, pc=pc)(rhs, x0=t(x0))
    assert absdiff(out, ref) <= 1e-9

    jproj = jstokes.project_onto_range if jmesh.p_fixed else (lambda r: r)
    proj = stokes.project_onto_range if mesh.p_fixed else (lambda r: r)
    _, jk, _ = jpcg_info(lambda q: jproj(jpc.e_apply(jproj(q), S)), jproj(jrhs),
                         precond=lambda r: jproj(jpc.apply(jproj(r))), tol=1e-10, maxiter=500)
    _, k, _ = pcg_info(lambda q: proj(pc.e_apply(proj(q), S)), proj(rhs),
                       precond=lambda r: proj(pc.apply(proj(r))), tol=1e-10, maxiter=500)
    assert k > 3 and abs(k - int(jk)) <= 1, (k, int(jk))

    # `stats` records the count of the solver's own (element-first) CG
    stats = {}
    ns.make_pressure_solver(mesh, cfg, S, pc=pc)(rhs, stats=stats)
    assert len(stats["pressure"]) == 1 and abs(stats["pressure"][0] - int(jk)) <= 1
