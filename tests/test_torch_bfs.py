"""Port parity: the backward-facing-step transient-growth pipeline
(examples/bfs_transient_growth.py at tests/test_bfs.py's size, cut).

bfs_mesh (28 elements, order 5) -> build_e_preconditioner -> advance from
the parabolic inflow (20 spin-up steps, Re 200, dt 0.02, the inflow as the
Dirichlet lift) -> ExponentialPropagator (tau = 0.2) ->
transient_growth_analysis_fixed_point (kdim 8, nsv 2), both packages, f64
on the CPU; the port's svds starts from the reference's own start vector.
Tolerances: the spun-up state 1e-10 relative (inner solves at 1e-11 and
1e-10 over 20 steps); sigma 1e-8 relative; the triplet identity 1e-6
sigma_1 (tests/test_bfs.py's bound).
"""

import jax
import numpy as np
import pytest

from neklab_tpu import analysis as janalysis
from neklab_tpu.linops.exponential_propagator import ExponentialPropagator as JExpProp
from neklab_tpu.mesh.bfs import bfs_inflow as jbfs_inflow
from neklab_tpu.mesh.bfs import bfs_mesh as jbfs_mesh
from neklab_tpu.models import navier_stokes as jns
from neklab_tpu.models.linearized import LinConfig as JLinConfig
from neklab_tpu.models.precond import build_e_preconditioner as jbuild
from neklab_tpu.vectors import flow_vector_space as jflow_vector_space
from neklab_tpu_torch.analysis import transient_growth_analysis_fixed_point
from neklab_tpu_torch.krylov.space import VectorSpace
from neklab_tpu_torch.linops.exponential_propagator import ExponentialPropagator
from neklab_tpu_torch.mesh.bfs import bfs_inflow, bfs_mesh
from neklab_tpu_torch.models import navier_stokes as ns
from neklab_tpu_torch.models.linearized import LinConfig
from neklab_tpu_torch.models.precond import build_e_preconditioner
from neklab_tpu_torch.vectors import flow_vector_space
from torch_port_helpers import rel, t

MESH = dict(li=2, lo=8, nel_li=2, nel_lo=6, nel_y_in=2, nel_y_step=2, order=5)
RE, DT, NSPIN, TAU = 200.0, 0.02, 20, 0.2
TOLS = dict(vtol=1e-11, ptol=1e-10)


@pytest.fixture(scope="module")
def spun_up():
    jmesh, mesh = jbfs_mesh(**MESH), bfs_mesh(**MESH, device="cpu")
    jfc = jns.FlowConfig(viscosity=1 / RE, dt=DT, **TOLS)
    fc = ns.FlowConfig(viscosity=1 / RE, dt=DT, **TOLS)
    jub, ub = jbfs_inflow(jmesh), bfs_inflow(mesh)
    jst = jns.advance(jmesh, jfc, jns.initial_state(jmesh, jfc, u=jub), NSPIN, ub=jub,
                      pc_e=jbuild(jmesh, DT / (11 / 6)))
    stats = {}
    st = ns.advance(mesh, fc, ns.initial_state(mesh, fc, u=ub), NSPIN, ub=ub,
                    pc_e=build_e_preconditioner(mesh, DT / (11 / 6)), stats=stats)
    return jmesh, mesh, jst, st, stats


def test_spin_up_matches_reference(spun_up):
    jmesh, mesh, jst, st, stats = spun_up
    assert len(stats["pressure"]) == NSPIN
    assert rel(st.u, jst.u) <= 1e-10
    assert rel(st.p, jst.p) <= 1e-10


def test_transient_growth_matches_reference(spun_up):
    jmesh, mesh, jst, st, _ = spun_up
    kw = dict(kdim=8, nsv=2, tol=1e-8)
    jprop = JExpProp(jmesh, JLinConfig(flow=jns.FlowConfig(viscosity=1 / RE, dt=DT, **TOLS)),
                     jst.u, tau=TAU, dt=DT)
    prop = ExponentialPropagator(mesh, LinConfig(flow=ns.FlowConfig(viscosity=1 / RE, dt=DT,
                                                                    **TOLS)),
                                 st.u, tau=TAU, dt=DT)
    assert prop.nsteps == jprop.nsteps == 10
    jspace = jflow_vector_space(jmesh, 0)
    ref = janalysis.transient_growth_analysis_fixed_point(jprop, jspace, **kw)
    jv0 = {k: t(v) for k, v in jspace.rand(jax.random.PRNGKey(1234)).items()}
    space = VectorSpace(dot_fn=flow_vector_space(mesh, 0).dot_fn,
                        rand_fn=lambda seed: jv0 if seed == 1234 else None)
    res = transient_growth_analysis_fixed_point(prop, space, **kw)
    assert res.n_matvec == ref.n_matvec
    np.testing.assert_allclose(res.sigma, ref.sigma, rtol=1e-8)
    assert res.sigma[0] > 1.0 and res.sigma[0] >= res.sigma[1] > 0
    mv = prop.matvec(res.optimal_inputs[0])
    diff = {k: mv[k] - float(res.sigma[0]) * res.optimal_outputs[0][k] for k in mv}
    assert space.norm(diff) < 1e-6 * res.sigma[0]
