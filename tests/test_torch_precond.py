"""Port parity: the pressure preconditioner at any mesh size, and the
matrix-free pressure solve it serves.

Each preconditioner of `build_e_preconditioner` is built by both packages
from the same mesh at the same dt/g0, f64 on the CPU: block Jacobi with the
constant coarse space, the RCB-aggregated tier (coarse_max_dense 64 and 32,
with and without the exact neighbour blocks), bfloat16 storage, OAS with the
constant coarse space, the default OAS + Q1 path, a 3-D mesh, and the
on-disk cache. Meshes: a walled box (pure-Neumann pressure) and the
backward-facing step (an outflow). Tolerances: the stored arrays 1e-10
relative (the aggregate map identical); `apply` 1e-12 relative on a
numpy-seeded residual; E-CG iteration counts (tests/test_precond.py's
`_e_iters` protocol) within 1 of the reference's.

bfloat16: the port promotes a stored bfloat16 block to the field's dtype at
the product, where the reference also rounds the residual to bfloat16. So a
compressed block-Jacobi apply is held to the reference's apply with its
bfloat16 blocks promoted the same way; the OAS blocks carry the port's
folded weights before rounding, so OAS with bfloat16 is held to the port's
own float64 apply at bfloat16's rounding (1e-2) and to the reference's
iteration count.
"""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neklab_tpu.mesh.bfs import bfs_mesh as jbfs_mesh
from neklab_tpu.mesh.box import box_mesh as jbox_mesh
from neklab_tpu.models import stokes as jstokes
from neklab_tpu.models.navier_stokes import FlowConfig as JFlowConfig
from neklab_tpu.models.navier_stokes import make_pressure_solver as jmake_pressure_solver
from neklab_tpu.models.precond import build_e_preconditioner as jbuild
from neklab_tpu.models.solvers import pcg_info as jpcg_info
from neklab_tpu_torch.mesh.bfs import bfs_mesh
from neklab_tpu_torch.mesh.box import box_mesh
from neklab_tpu_torch.models import precond, stokes
from neklab_tpu_torch.models.navier_stokes import FlowConfig, make_pressure_solver
from neklab_tpu_torch.models.solvers import pcg_info
from torch_port_helpers import WALLED_BC, rel, t, to_np

S = 1e-2
WALLED3 = dict(WALLED_BC, **{"z-": "W", "z+": "W"})
BFS = dict(li=2, lo=8, nel_li=2, nel_lo=6, nel_y_in=2, nel_y_step=2, order=4)


@pytest.fixture(autouse=True)
def no_cache(monkeypatch):
    monkeypatch.setenv("NEKLAB_PRECOND_CACHE", "0")


@pytest.fixture(scope="module")
def meshes():
    box = dict(nels=(12, 12), lims=((0.0, 1.0), (0.0, 1.0)), bc=WALLED_BC, order=3)
    return {"box": (jbox_mesh(**box), box_mesh(**box, device="cpu")),
            "bfs": (jbfs_mesh(**BFS), bfs_mesh(**BFS, device="cpu"))}


def stored(pc, name):
    """A stored array of either package as float64 numpy (eb_w in the
    reference's [nel, K, np2, np2] layout), or None."""
    a = getattr(pc, name, None)
    if a is None:
        return None
    if isinstance(a, torch.Tensor):
        a = to_np(a.double() if a.dtype == torch.bfloat16 else a)
        if name == "eb_w":
            nel, np2 = a.shape[:2]
            a = a.reshape(nel, np2, -1, np2).transpose(0, 2, 1, 3)
        return a
    return np.asarray(a.astype(jnp.float64) if a.dtype == jnp.bfloat16 else a)


def promoted(jpc):
    """The reference's preconditioner with its bfloat16 local blocks in
    float64: the port's arithmetic on the same stored values."""
    return dataclasses.replace(jpc, **{k: getattr(jpc, k).astype(jnp.float64)
                                       for k in ("blocks_inv", "oas_binv")
                                       if getattr(jpc, k) is not None})


def e_iters(mesh, pc, tol=1e-8):
    """tests/test_precond.py's `_e_iters` for either package's mesh: with a
    pure-Neumann pressure the right-hand side and the preconditioner's
    output are made mean-free."""
    rng = np.random.default_rng(0)
    rhs = rng.standard_normal(tuple(mesh.bm2.shape))
    center = (lambda r: r - r.mean()) if mesh.p_fixed else (lambda r: r)
    if isinstance(mesh.bm2, torch.Tensor):
        pre = None if pc is None else (lambda r: center(pc.apply(r)))
        _, k, _ = pcg_info(lambda q: stokes.e_op(mesh, q, S), t(center(rhs)), precond=pre,
                           tol=tol, maxiter=4000)
        return k
    _, k, _ = jpcg_info(lambda q: jstokes.e_op(mesh, q, S), jnp.asarray(center(rhs)),
                        precond=lambda r: center(pc.apply(r)), tol=tol, maxiter=4000)
    return int(k)


CASES = {
    "bj_const": ("box", dict(local="bj", coarse="const")),
    "rcb_64": ("box", dict(coarse_max_dense=64)),
    "rcb_32": ("box", dict(coarse_max_dense=32)),
    "rcb_32_exact": ("box", dict(coarse_max_dense=32, exact_blocks=True)),
    "bj_compress": ("box", dict(local="bj", coarse="const", compress=True)),
    "oas_const": ("box", dict(local="oas", coarse="const")),
    "default": ("box", dict()),
    "bfs_bj_const": ("bfs", dict(local="bj", coarse="const")),
    "bfs_rcb_8": ("bfs", dict(coarse_max_dense=8)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_preconditioner_matches_reference(meshes, case):
    which, kw = CASES[case]
    jmesh, mesh = meshes[which]
    jpc, pc = jbuild(jmesh, S, **kw), precond.build_e_preconditioner(mesh, S, **kw)
    names = ["ec_inv", "agg_of_el", "q1_vert", "q1_b4", "eb_w", "eb_nbr"]
    if pc.blocks_inv is not None:
        names.append("blocks_inv")  # the port builds them for block Jacobi only
    else:
        assert (kw.get("local") or ("bj" if "rcb" in case else "oas")) == "oas"
    for name in names:
        a, b = stored(jpc, name), stored(pc, name)
        assert (a is None) == (b is None), name
        if a is not None:
            assert a.shape == b.shape, name
            assert np.abs(a - b).max() <= 1e-10 * max(np.abs(a).max(), 1e-300), name
    if "rcb" in case:
        assert pc.agg_of_el is not None and pc.ec_inv.shape[0] == kw["coarse_max_dense"]
    if kw.get("compress"):
        assert pc.blocks_inv.dtype == torch.bfloat16 and pc.ec_inv.dtype == torch.float64
    r = np.random.default_rng(1).standard_normal(tuple(jmesh.bm2.shape))
    assert rel(pc.apply(t(r)), promoted(jpc).apply(jnp.asarray(r))) <= 1e-12
    assert abs(e_iters(mesh, pc) - e_iters(jmesh, jpc)) <= 1


def test_oas_compress(meshes):
    jmesh, mesh = meshes["box"]
    pc = precond.build_e_preconditioner(mesh, S, local="oas", compress=True)
    full = precond.build_e_preconditioner(mesh, S, local="oas")
    assert pc.oas_binv.dtype == torch.bfloat16 and pc.ec_inv.dtype == torch.float64
    r = t(np.random.default_rng(1).standard_normal(tuple(mesh.bm2.shape)))
    assert rel(pc.apply(r), full.apply(r)) <= 1e-2
    jpc = jbuild(jmesh, S, local="oas", compress=True)
    assert abs(e_iters(mesh, pc) - e_iters(jmesh, jpc)) <= 1


def test_q1_coarse_guards():
    mesh3 = box_mesh((2, 2, 2), ((0.0, 1.0),) * 3, WALLED3, order=3, device="cpu")
    with pytest.raises(ValueError):
        precond.build_e_preconditioner(mesh3, S, coarse="q1")
    mesh2 = box_mesh((4, 4), ((0.0, 1.0), (0.0, 1.0)), WALLED_BC, order=3, device="cpu")
    with pytest.raises(ValueError):
        precond.build_e_preconditioner(mesh2, S, coarse="q1", coarse_max_dense=8)


def test_3d_block_jacobi_and_exact_blocks():
    """3-D: the default is block Jacobi with constants; the exact blocks,
    forced, fold the 3-D trailing axes (tests/test_precond.py:95)."""
    box = dict(nels=(3, 2, 2), lims=((0.0, 1.5), (0.0, 1.0), (0.0, 1.0)), bc=WALLED3, order=4)
    jmesh, mesh = jbox_mesh(**box), box_mesh(**box, device="cpu")
    jpc = jbuild(jmesh, S, exact_blocks=True)
    pc = precond.build_e_preconditioner(mesh, S, exact_blocks=True)
    assert pc.oas_binv is None and pc.q1_vert is None and pc.agg_of_el is None
    for name in ("blocks_inv", "ec_inv", "eb_w"):
        a, b = stored(jpc, name), stored(pc, name)
        assert np.abs(a - b).max() <= 1e-10 * np.abs(a).max(), name
    rng = np.random.default_rng(4)
    r = rng.standard_normal(tuple(mesh.bm2.shape))
    assert rel(pc.apply(t(r)), jpc.apply(jnp.asarray(r))) <= 1e-12
    q = t(rng.standard_normal((3,) + tuple(mesh.bm2.shape)))
    assert rel(pc.e_apply(q, S), stokes.e_op(mesh, q, S)) <= 1e-12


def test_preconditioner_cache(meshes, monkeypatch, tmp_path):
    monkeypatch.setenv("NEKLAB_PRECOND_CACHE", "1")
    monkeypatch.setenv("NEKLAB_MESH_CACHE", str(tmp_path))
    _, mesh = meshes["box"]
    built = precond.build_e_preconditioner(mesh, S, coarse_max_dense=32, compress=True)
    (entry,) = os.listdir(tmp_path)
    assert entry.startswith("pc_torch_")
    loaded = precond.build_e_preconditioner(mesh, S, coarse_max_dense=32, compress=True)
    for f in dataclasses.fields(built):
        a, b = getattr(built, f.name), getattr(loaded, f.name)
        assert (a is None) == (b is None), f.name
        if a is not None:
            assert a.dtype == b.dtype and a.device == b.device and torch.equal(a, b), f.name
    moved = loaded.to("cpu")  # every field, the absent ones too
    assert all((getattr(moved, f.name) is None) == (getattr(built, f.name) is None)
               for f in dataclasses.fields(built))
    precond.build_e_preconditioner(mesh, 2 * S, coarse_max_dense=32, compress=True)
    precond.build_e_preconditioner(mesh, S, coarse_max_dense=32)
    assert len(os.listdir(tmp_path)) == 3
    # an entry of another format is rebuilt, not loaded
    np.savez(tmp_path / "foreign.npz", ec_inv=np.eye(2))
    with pytest.raises(KeyError):
        precond._pc_load(str(tmp_path / "foreign.npz"), "cpu")


def test_matrix_free_pressure_solve_matches_reference(meshes):
    """Without exact blocks (block Jacobi and constants) the pressure CG
    runs the matrix-free E: the solve, warm-started, against the
    reference's (ptol 1e-12: 1e-9 relative), and its backward (E^-1 is
    symmetric: the same solve of the cotangent) against jax.vjp."""
    import jax

    jmesh, mesh = meshes["bfs"]
    kw = dict(local="bj", coarse="const", exact_blocks=False)
    jpc, pc = jbuild(jmesh, S, **kw), precond.build_e_preconditioner(mesh, S, **kw)
    assert pc.eb_w is None and not mesh.p_fixed
    jsolve = jmake_pressure_solver(jmesh, JFlowConfig(viscosity=0.01, dt=0.01, ptol=1e-12),
                                   S, pc=jpc)
    solve = make_pressure_solver(mesh, FlowConfig(viscosity=0.01, dt=0.01, ptol=1e-12), S,
                                 pc=pc)
    rng = np.random.default_rng(6)
    rhs, x0, g = (rng.standard_normal(tuple(mesh.bm2.shape)) for _ in range(3))
    stats = {}
    out = solve(t(rhs), x0=t(x0), stats=stats)
    ref = jsolve(jnp.asarray(rhs), x0=jnp.asarray(x0))
    assert rel(out, ref) <= 1e-9
    assert 0 < stats["pressure"][0] < e_iters(mesh, None)
    x = t(rhs).requires_grad_(True)
    (grad,) = torch.autograd.grad(solve(x), x, t(g))
    _, vjp = jax.vjp(lambda r: jsolve(r), jnp.asarray(rhs))
    assert rel(grad, vjp(jnp.asarray(g))[0]) <= 1e-9
