"""Port parity on the cylinder wake's own mesh: the `medium` annulus of
examples/cylinder_stability.py (8 x 20 elements at order 6, r_out 20,
grading 1.5, 'vO', shift 0.25), the mesh of chip_smoke.py phase 8, at
Re = 50 and dt = 5e-3, f64 on the CPU.

Phase 8 reads |mu_1| about 7e-4 above the reference's oracle (obtained on
a finer mesh). These tests show that the port computes what the reference
computes on this mesh, along the pipeline cut short: the mesh itself, 20
steps of the nonlinear spin-up from the example's start with the inflow
lift, and at the state they reach the fixed-point system's response and
its frozen Jacobian's matvec (the operator Newton's GMRES and, as
exp(tau A), the eigensolve apply), over tau = 0.05. Tolerances:
  * every mesh field: <= 1e-13 absolute;
  * `advance`: <= 1e-10 relative (inner solves at 1e-12);
  * the response and the Jacobian matvec: <= 1e-9 absolute.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from neklab_tpu.mesh.cylinder import annulus_mesh as jannulus_mesh
from neklab_tpu.models import navier_stokes as jns
from neklab_tpu.models.linearized import LinConfig as JLinConfig
from neklab_tpu.models.precond import build_e_preconditioner as jbuild
from neklab_tpu.ops import sem as jsem
from neklab_tpu.systems.fixed_point import FixedPointSystem as JFixedPointSystem
from neklab_tpu_torch.mesh.core import MESH_FIELDS
from neklab_tpu_torch.mesh.cylinder import annulus_mesh
from neklab_tpu_torch.models import navier_stokes as ns
from neklab_tpu_torch.models.linearized import LinConfig
from neklab_tpu_torch.models.precond import build_e_preconditioner
from neklab_tpu_torch.systems.fixed_point import FixedPointSystem
from torch_port_helpers import absdiff, rel, t, to_np

MEDIUM = dict(nel_r=8, nel_t=20, r_in=0.5, r_out=20.0, order=6, grading=1.5, outer_bc="vO",
              shift=0.25)
FLOW = dict(viscosity=1 / 50, dt=5e-3, vtol=1e-12, ptol=1e-12)


@pytest.fixture(scope="module")
def medium():
    """Both meshes, the example's lift and start, and both packages' state
    after 20 steps of the spin-up."""
    jmesh = jannulus_mesh(**MEDIUM, dtype=jnp.float64)
    mesh = annulus_mesh(**MEDIUM, device="cpu")
    x = np.asarray(jmesh.x)
    r = np.sqrt(x[0] ** 2 + x[1] ** 2)
    free = (r > 0.5 + 1e-8).astype(np.float64)
    ub = np.stack([free, np.zeros_like(free)])
    ramp = 1 - np.exp(-3.0 * (r - 0.5))
    vmask = np.asarray(jmesh.vmask)
    u0 = vmask * np.stack([ramp, 0 * ramp]) + (1 - vmask) * ub
    jfc, fc = jns.FlowConfig(**FLOW), ns.FlowConfig(**FLOW)
    want = jns.advance(jmesh, jfc, jns.initial_state(jmesh, jfc, u=jnp.asarray(u0)), 20,
                       ub=jnp.asarray(ub), pc_e=jbuild(jmesh, fc.dt / (11 / 6)))
    got = ns.advance(mesh, fc, ns.initial_state(mesh, fc, u=t(u0)), 20, ub=t(ub),
                     pc_e=build_e_preconditioner(mesh))
    return jmesh, mesh, ub, want, got


def test_medium_annulus_matches_reference(medium):
    jmesh, mesh, *_ = medium
    assert (mesh.nel, mesh.nglob, mesh.basis.n) == (jmesh.nel, jmesh.nglob, jmesh.basis.n) == (
        160, jmesh.nglob, 7)
    assert not mesh.p_fixed
    for k in MESH_FIELDS:
        want = np.asarray(getattr(jmesh, k))
        assert np.abs(to_np(getattr(mesh, k)) - want).max(initial=0.0) <= 1e-13, k


def test_medium_spinup_matches_reference(medium):
    *_, want, got = medium
    for k in ("u", "p"):
        assert rel(getattr(got, k), getattr(want, k)) <= 1e-10, k
    assert got.time == pytest.approx(float(want.time), abs=1e-14)


def test_medium_response_and_jacobian_match_reference(medium):
    jmesh, mesh, ub, want, _ = medium
    jsys = JFixedPointSystem(jmesh, JLinConfig(flow=jns.FlowConfig(**FLOW)), tau=0.05,
                             ub=jnp.asarray(ub), dt=FLOW["dt"])
    sys_ = FixedPointSystem(mesh, LinConfig(flow=ns.FlowConfig(**FLOW)), tau=0.05, ub=t(ub),
                            dt=FLOW["dt"])
    u = np.asarray(want.u)
    th = np.zeros((0,) + u.shape[1:])
    jx = {"u": jnp.asarray(u), "theta": jnp.asarray(th)}
    x = {"u": t(u), "theta": t(th)}
    assert absdiff(sys_.response(x)["u"], jsys.response(jx)["u"]) <= 1e-9
    rng = np.random.default_rng(5)
    du = np.asarray(jmesh.vmask * jsem.dsavg(jmesh, jnp.asarray(rng.standard_normal(u.shape))))
    got = sys_.jacobian(x).matvec({"u": t(du), "theta": t(th)})["u"]
    ref = jsys.jacobian(jx).matvec({"u": jnp.asarray(du), "theta": jnp.asarray(th)})["u"]
    assert absdiff(got, ref) <= 1e-9
