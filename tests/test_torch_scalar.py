"""Port parity: the scalar-coupled (Boussinesq) cases, f64 on the CPU.

Thermosyphon (tests/test_thermosyphon.py:30-50's annulus, buoyancy
f_y = Pr Ra theta, the wall temperature 0.5 (1 + tanh(-20 y)) as the
scalar's Dirichlet lift; Pr = 0.2, Ra = 510), cut from 400 to 20 spin-up
steps and from tau = 0.3 to 0.05: the spin-up, then about the spun-up
state the `FixedPointSystem` response and the frozen and exact
Jacobians' matvec. Rayleigh-Benard (tests/test_rayleigh_benard.py:25-50
at Ra = 1900, kdim 30 -> 12, tau 0.05 -> 0.02): the leading eigenvalue of
the conduction state from the reference's own start vector. Tolerance:
1e-9 (absolute on fields of order one; on the eigenvalue).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neklab_tpu import analysis as janalysis
from neklab_tpu.linops.exponential_propagator import ExponentialPropagator as JExpProp
from neklab_tpu.mesh.box import box_mesh as jbox_mesh
from neklab_tpu.mesh.cylinder import annulus_mesh as jannulus_mesh
from neklab_tpu.models import navier_stokes as jns
from neklab_tpu.models.linearized import LinConfig as JLinConfig
from neklab_tpu.models.precond import build_e_preconditioner as jbuild
from neklab_tpu.systems.fixed_point import FixedPointSystem as JFixedPointSystem
from neklab_tpu.vectors import flow_vector_space as jflow_vector_space
from neklab_tpu_torch.analysis import linear_stability_analysis_fixed_point
from neklab_tpu_torch.krylov.space import VectorSpace
from neklab_tpu_torch.linops.exponential_propagator import ExponentialPropagator
from neklab_tpu_torch.mesh.box import box_mesh
from neklab_tpu_torch.mesh.cylinder import annulus_mesh
from neklab_tpu_torch.models import navier_stokes as ns
from neklab_tpu_torch.models.linearized import LinConfig
from neklab_tpu_torch.models.precond import build_e_preconditioner
from neklab_tpu_torch.systems.fixed_point import FixedPointSystem
from neklab_tpu_torch.vectors import flow_vector, flow_vector_space
from torch_port_helpers import absdiff, t

PR, RA = 0.2, 510.0
NSPIN, TAU = 20, 0.05
ANNULUS = dict(nel_r=3, nel_t=12, r_in=0.6, r_out=1.0, order=4, grading=1.0, outer_bc="W",
               bc_temp=("t", "t"))
FLOW = dict(viscosity=PR, dt=5e-3, nscal=1, conductivity=(1.0,), vtol=1e-11, ptol=1e-10,
            ttol=1e-11)


def _jbuoyancy(m, u, th):
    return jnp.stack([jnp.zeros_like(th[0]), PR * RA * th[0]])


def _buoyancy(m, u, th):
    return torch.stack([torch.zeros_like(th[0]), PR * RA * th[0]])


@pytest.fixture(scope="module")
def thermosyphon():
    jmesh = jannulus_mesh(**ANNULUS)
    mesh = annulus_mesh(**ANNULUS, device="cpu")
    jfc = jns.FlowConfig(**FLOW, forcing_fn=lambda m, t_, u, th: _jbuoyancy(m, u, th))
    fc = ns.FlowConfig(**FLOW, forcing_fn=lambda m, t_, u, th: _buoyancy(m, u, th))
    jcfg = JLinConfig(flow=jfc, lin_forcing_fn=_jbuoyancy)
    cfg = LinConfig(flow=fc, lin_forcing_fn=_buoyancy)
    jtb = jnp.stack([0.5 * (1.0 + jnp.tanh(-20.0 * jmesh.x[1]))])
    tb = torch.stack([0.5 * (1.0 + torch.tanh(-20.0 * mesh.x[1]))])
    jst = jns.advance(jmesh, jfc, jns.initial_state(jmesh, jfc, theta=jtb), NSPIN, tb=jtb,
                      pc_e=jbuild(jmesh, jfc.dt / (11 / 6)))
    st = ns.advance(mesh, fc, ns.initial_state(mesh, fc, theta=tb), NSPIN, tb=tb,
                    pc_e=build_e_preconditioner(mesh, fc.dt / (11 / 6)))
    rng = np.random.default_rng(41)
    du = np.asarray(jmesh.vmask) * rng.standard_normal((2,) + tuple(jmesh.bm1.shape))
    dth = np.asarray(jmesh.tmask) * rng.standard_normal((1,) + tuple(jmesh.bm1.shape))
    return jmesh, mesh, jcfg, cfg, jtb, tb, jst, st, du, dth


def test_thermosyphon_spin_up_matches_reference(thermosyphon):
    *_, jst, st, _, _ = thermosyphon
    assert float(st.u.abs().max()) > 1e-3  # buoyancy has started a circulation
    assert absdiff(st.u, jst.u) <= 1e-9
    assert absdiff(st.theta, jst.theta) <= 1e-9


@pytest.mark.parametrize("exact", [False, True], ids=["frozen", "exact"])
def test_thermosyphon_fixed_point_matches_reference(thermosyphon, exact):
    from neklab_tpu.ops import sem as jsem

    jmesh, mesh, jcfg, cfg, jtb, tb, jst, st, du, dth = thermosyphon
    kw = dict(tau=TAU, dt=FLOW["dt"], exact_jacobian=exact)
    jsys = JFixedPointSystem(jmesh, jcfg, tb=jtb, **kw)
    sys_ = FixedPointSystem(mesh, cfg, tb=tb, **kw)
    jx = {"u": jst.u, "theta": jst.theta}
    x = flow_vector(mesh, 1, u=t(jst.u), theta=t(jst.theta))
    ref, out = jsys.response(jx), sys_.response(x)
    for k in ("u", "theta"):
        assert absdiff(out[k], ref[k]) <= 1e-9, k
    # a conforming direction that vanishes where the masks do
    jdx = {"u": jmesh.vmask * jsem.dsavg(jmesh, jnp.asarray(du)),
           "theta": jmesh.tmask * jsem.dsavg(jmesh, jnp.asarray(dth))}
    ref = jsys.jacobian(jx).matvec(jdx)
    out = sys_.jacobian(x).matvec({k: t(v) for k, v in jdx.items()})
    assert float(np.abs(np.asarray(ref["theta"])).max()) > 1e-2
    for k in ("u", "theta"):
        assert absdiff(out[k], ref[k]) <= 1e-9, k


def test_rayleigh_benard_leading_eigenvalue_matches_reference():
    ra, kc = 1900.0, 3.11632
    box = dict(nels=(3, 3), lims=((0, 2 * np.pi / kc), (0, 1.0)),
               bc={"x-": "P", "x+": "P", "y-": "W", "y+": "W"}, order=6,
               bc_temp={"y-": "t", "y+": "t"})
    flow = dict(viscosity=1.0, dt=1e-3, nscal=1, conductivity=(1.0,), vtol=1e-12, ptol=1e-12,
                ttol=1e-12)
    jmesh, mesh = jbox_mesh(**box), box_mesh(**box, device="cpu")
    jbuoy = lambda m, u, th: jnp.concatenate([jnp.zeros_like(th[0])[None],
                                              (ra * th[0])[None]])
    buoy = lambda m, u, th: torch.stack([torch.zeros_like(th[0]), ra * th[0]])
    jprop = JExpProp(jmesh, JLinConfig(flow=jns.FlowConfig(**flow), lin_forcing_fn=jbuoy),
                     jnp.zeros((2,) + jmesh.bm1.shape), jnp.stack([1.0 - jmesh.x[1]]),
                     tau=0.02, dt=1e-3)
    prop = ExponentialPropagator(mesh, LinConfig(flow=ns.FlowConfig(**flow),
                                                 lin_forcing_fn=buoy),
                                 torch.zeros((2,) + tuple(mesh.bm1.shape), dtype=torch.float64),
                                 torch.stack([1.0 - mesh.x[1]]), tau=0.02, dt=1e-3)
    kw = dict(kdim=12, nev=1, tol=1e-8, maxiter=4)
    jspace = jflow_vector_space(jmesh, 1)
    ref = janalysis.linear_stability_analysis_fixed_point(jprop, jspace, **kw)
    jv0 = {k: t(v) for k, v in jspace.rand(jax.random.PRNGKey(1234)).items()}
    space = VectorSpace(dot_fn=flow_vector_space(mesh, 1).dot_fn,
                        rand_fn=lambda seed: jv0 if seed == 1234 else None)
    res = linear_stability_analysis_fixed_point(prop, space, **kw)
    assert res.n_matvec == ref.n_matvec
    lam, jlam = complex(res.eigvals[0]), complex(ref.eigvals[0])
    assert lam.real > 0  # supercritical: Ra = 1900 > Ra_c = 1707.76
    assert abs(lam - jlam) <= 1e-9, (lam, jlam)
