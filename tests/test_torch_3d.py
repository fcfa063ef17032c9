"""Port parity: the 3-D path.

Inputs are numpy-seeded and go through both packages, f64 on the CPU.
Meshes: tests/test_stepper.py's forced channel, (2, 2, 2) elements at order
4, periodic in x and z and walled in y, and tests/test_precond.py's walled
(3, 2, 2) box at order 4 (pure-Neumann pressure); the propagator on
tests/test_torch_3d_propagator.py holds the linearized propagator, its
adjoint and chip_smoke phase 15's mesh and oracle.
Tolerances (relative to the reference's largest entry unless stated):
  * grad, dssum, helmholtz_local, its backward and its forward-mode
    tangent, the chunked Jacobi diagonal, e_op and the exact-block e_apply,
    convect_lin_weak: 1e-10 (the same arithmetic in another order);
  * 10 nonlinear steps with forcing: 1e-10 (inner solves at 1e-12).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.autograd.forward_ad as fwAD

from neklab_tpu.mesh.box import box_mesh as jbox_mesh
from neklab_tpu.models import navier_stokes as jns
from neklab_tpu.models import stokes as jstokes
from neklab_tpu.models.precond import build_e_preconditioner as jbuild
from neklab_tpu.ops import sem as jsem
from neklab_tpu_torch.mesh.box import box_mesh
from neklab_tpu_torch.models import navier_stokes as ns
from neklab_tpu_torch.models import solvers, stokes
from neklab_tpu_torch.models.precond import build_e_preconditioner
from neklab_tpu_torch.ops import sem
from torch_port_helpers import rel, t

CHANNEL3 = dict(nels=(2, 2, 2), lims=((0, 2.0), (-1, 1), (0, 2.0)),
                bc={"x-": "P", "x+": "P", "y-": "W", "y+": "W", "z-": "P", "z+": "P"}, order=4)
WALLED3 = dict(nels=(3, 2, 2), lims=((0.0, 1.5), (0.0, 1.0), (0.0, 1.0)),
               bc={f: "W" for f in ("x-", "x+", "y-", "y+", "z-", "z+")}, order=4)
NU3 = 0.8  # tests/test_stepper.py::test_3d_forced_channel_steady
S = 2e-2 / (11 / 6)
H1, H2 = 0.01, (11 / 6) / 2e-2


@pytest.fixture(autouse=True)
def no_cache(monkeypatch):
    monkeypatch.setenv("NEKLAB_PRECOND_CACHE", "0")


@pytest.fixture(scope="module", params=["channel", "walled"])
def mesh3(request):
    kw = CHANNEL3 if request.param == "channel" else WALLED3
    return request.param, jbox_mesh(**kw), box_mesh(**kw, device="cpu")


# ---------------------------------------------------------------------------
# element operators
# ---------------------------------------------------------------------------


def test_grad_and_dssum_3d(mesh3):
    _, jmesh, mesh = mesh3
    rng = np.random.default_rng(0)
    u = rng.standard_normal(tuple(jmesh.bm1.shape))
    assert rel(sem.grad(mesh, t(u)), jsem.grad(jmesh, jnp.asarray(u))) <= 1e-10
    f = rng.standard_normal((3,) + tuple(jmesh.bm1.shape))
    assert rel(sem.dssum(mesh, t(f)), jsem.dssum(jmesh, jnp.asarray(f))) <= 1e-10


def test_helmholtz_local_3d_and_its_derivatives(mesh3):
    """The value; the backward is the map itself on the cotangent, one node
    on autograd's tape (`tensor.linear`), against jax.vjp; the
    forward-mode tangent against jax.jvp."""
    _, jmesh, mesh = mesh3
    rng = np.random.default_rng(1)
    u, g, du = (rng.standard_normal((3,) + tuple(jmesh.bm1.shape)) for _ in range(3))
    jop = lambda v: jsem.helmholtz_local(jmesh, v, H1, H2)
    op = lambda v: sem.helmholtz_local(mesh, v, H1, H2)
    assert rel(op(t(u)), jop(jnp.asarray(u))) <= 1e-10

    x = t(u).requires_grad_(True)
    y = op(x)
    assert type(y.grad_fn).__name__ == "_LinearBackward"
    (grad,) = torch.autograd.grad(y, x, t(g))
    _, vjp = jax.vjp(jop, jnp.asarray(u))
    assert rel(grad, vjp(jnp.asarray(g))[0]) <= 1e-10

    with fwAD.dual_level():
        tangent = fwAD.unpack_dual(op(fwAD.make_dual(t(u), t(du)))).tangent
    _, jtangent = jax.jvp(jop, (jnp.asarray(u),), (jnp.asarray(du),))
    assert rel(tangent, jtangent) <= 1e-10


def test_apply_t_is_one_contraction():
    """A 3-D per-axis apply on a contiguous field is one batched GEMM: the
    only op that computes is the matmul's (the rest are views)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from neklab_tpu_torch.ops.tensor import apply_s, apply_t

    class Ops(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.names = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.names.append(func.__name__)
            return func(*args, **(kwargs or {}))

    d = torch.randn(5, 5, dtype=torch.float64)
    u = torch.randn(3, 5, 5, 5, 8, dtype=torch.float64)
    views = {"view.default", "expand.default", "_unsafe_view.default", "reshape.default",
             "t.default", "transpose.int", "_reshape_alias.default"}
    for fn in (apply_t, apply_s):
        with Ops() as ops:
            out = fn(d, u)
        assert [n for n in ops.names if n not in views] == ["bmm.default"], ops.names
        ref = torch.einsum("ij,...jsre->...isre", d, u) if fn is apply_t else \
            torch.einsum("ij,...tjre->...tire", d, u)
        assert torch.allclose(out, ref, rtol=1e-13, atol=1e-13)


def test_jacobi_diagonal_chunked_matches_reference(mesh3, monkeypatch):
    """helmholtz_diag with the probe cut into chunks of 7 nodes equals the
    unchunked probe bit for bit and the reference's to 1e-10."""
    _, jmesh, mesh = mesh3
    whole = ns.helmholtz_diag(mesh, H1, H2, mesh.vmask)
    per_node = 8 * mesh.npts * mesh.nel
    monkeypatch.setattr(solvers, "_PROBE_BYTES", 7 * per_node)
    chunked = ns.helmholtz_diag(mesh, H1, H2, mesh.vmask)
    assert torch.equal(chunked, whole)
    assert rel(chunked, jns.helmholtz_diag(jmesh, H1, H2, jmesh.vmask)) <= 1e-10


def test_e_op_and_exact_block_e_apply_3d():
    """tests/test_precond.py:117-127: the exact blocks, forced, fold the
    3-D trailing axes; both E applies against the reference's."""
    jmesh, mesh = jbox_mesh(**WALLED3), box_mesh(**WALLED3, device="cpu")
    rng = np.random.default_rng(2)
    q = rng.standard_normal(tuple(jmesh.bm2.shape))
    ref = jstokes.e_op(jmesh, jnp.asarray(q), S)
    assert rel(stokes.e_op(mesh, t(q), S), ref) <= 1e-10
    jpc, pc = jbuild(jmesh, S, exact_blocks=True), build_e_preconditioner(mesh, S,
                                                                          exact_blocks=True)
    assert pc.eb_w is not None and pc.blocks_inv is not None
    assert rel(pc.e_apply(t(q), S), jpc.e_apply(jnp.asarray(q), S)) <= 1e-10
    assert rel(pc.e_apply(t(q), S), ref) <= 1e-10


def test_convect_lin_weak_3d(mesh3):
    _, jmesh, mesh = mesh3
    rng = np.random.default_rng(3)
    shape = tuple(jmesh.bm1.shape)
    base_u, u = rng.standard_normal((3,) + shape), rng.standard_normal((3,) + shape)
    base_th, th = rng.standard_normal((1,) + shape), rng.standard_normal((1,) + shape)
    jcache = jsem.lin_convect_cache(jmesh, jnp.asarray(base_u), jnp.asarray(base_th))
    want_u, want_t = jsem.convect_lin_weak(jmesh, jnp.asarray(u), jnp.asarray(th), jcache)
    cache = sem.lin_convect_cache(mesh, t(base_u), t(base_th))
    got_u, got_t = sem.convect_lin_weak(mesh, t(u), t(th), cache)
    assert rel(got_u, want_u) <= 1e-10 and rel(got_t, want_t) <= 1e-10


# ---------------------------------------------------------------------------
# the nonlinear stepper
# ---------------------------------------------------------------------------


def test_advance_forced_channel_3d():
    """tests/test_stepper.py:179-199's forced channel, 10 of its 460 steps
    (the rest is the reference's slow test), every field of the state."""
    jmesh, mesh = jbox_mesh(**CHANNEL3), box_mesh(**CHANNEL3, device="cpu")
    kw = dict(viscosity=NU3, dt=2e-2, vtol=1e-12, ptol=1e-12)
    jforce = lambda m, tm, u, th: jnp.zeros((3,) + m.bm1.shape, m.bm1.dtype).at[0].set(2 * NU3)

    def force(m, tm, u, th):
        f = torch.zeros((3,) + tuple(m.bm1.shape), dtype=m.dtype, device=m.device)
        f[0] = 2 * NU3
        return f

    jcfg = jns.FlowConfig(**kw, forcing_fn=jforce)
    cfg = ns.FlowConfig(**kw, forcing_fn=force)
    want = jns.advance(jmesh, jcfg, jns.initial_state(jmesh, jcfg), 10,
                       pc_e=jbuild(jmesh, S))
    stats = {}
    got = ns.advance(mesh, cfg, ns.initial_state(mesh, cfg), 10,
                     pc_e=build_e_preconditioner(mesh, S), stats=stats)
    for k in ("u", "p", "ulag", "nlag", "plag"):
        assert rel(getattr(got, k), getattr(want, k)) <= 1e-10, k
    assert len(stats["helmholtz"]) == len(stats["pressure"]) == 10
    # toward the Poiseuille profile 1 - y^2 (reached at 460 steps)
    assert float(got.u[0].max()) > 0.1 and float(stokes.div_weak(mesh, got.u).abs().max()) < 1e-9
