"""Port parity: the Boussinesq family (nscal = 1) on a 3-D mesh, f64 on the CPU.

A (2, 2, 2) box at order 4, periodic in x and z, walled in y with the
temperature held on both walls (`bc_temp` 't'), Pr = 1 and the buoyancy
Ra Pr theta along y at Ra = 1900, as in neklab's rayBen carried to 3-D.
The base state is not the conduction state alone: a shear (U, 0, W) and a
temperature Theta that varies in x, y and z, so that every term of the
linearized convection of the velocity and of the scalar (the `gradthd`
row of each direction) is non-zero. Inputs are numpy-seeded and go
through both packages. Tolerances:
  * `propagate` over 6 steps (the BDF1/2 ramp and four BDF3 steps) and
    the exact discrete adjoint: 1e-10 relative on the velocity and on the
    temperature (inner solves at 1e-12, the adjoint's at 1e-13);
  * the B-adjoint identity <M x, y>_B = <x, M* y>_B over both fields:
    1e-9 relative, as in the 2-D tests.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from neklab_tpu.mesh.box import box_mesh as jbox_mesh
from neklab_tpu.models import linearized as jlin
from neklab_tpu.models import navier_stokes as jns
from neklab_tpu.models.precond import build_e_preconditioner as jbuild
from neklab_tpu_torch.mesh.box import box_mesh
from neklab_tpu_torch.models import linearized as lin
from neklab_tpu_torch.models import navier_stokes as ns
from neklab_tpu_torch.models.precond import build_e_preconditioner
from neklab_tpu_torch.ops import sem
from torch_port_helpers import rel, t

RA, PR = 1900.0, 1.0
BOX = dict(nels=(2, 2, 2), lims=((0, 2.0), (0, 1.0), (0, 2.0)),
           bc={"x-": "P", "x+": "P", "y-": "W", "y+": "W", "z-": "P", "z+": "P"}, order=4,
           bc_temp={"y-": "t", "y+": "t"})
FLOW = dict(viscosity=PR, dt=1e-3, nscal=1, conductivity=(1.0,), vtol=1e-12, ptol=1e-12,
            ttol=1e-12)
NSTEPS = 6


@pytest.fixture(autouse=True)
def no_cache(monkeypatch):
    monkeypatch.setenv("NEKLAB_PRECOND_CACHE", "0")


def _jbuoyancy(m, u, th):
    return jnp.stack([jnp.zeros_like(th[0]), RA * PR * th[0], jnp.zeros_like(th[0])])


def _buoyancy(m, u, th):
    import torch

    return torch.stack([torch.zeros_like(th[0]), RA * PR * th[0], torch.zeros_like(th[0])])


@pytest.fixture(scope="module")
def boussinesq3d():
    """Both packages' meshes and configurations (the adjoint's at 1e-13),
    the base state, the E preconditioners and two conforming (u, theta)
    directions."""
    jmesh, mesh = jbox_mesh(**BOX), box_mesh(**BOX, device="cpu")
    x, y, z = (np.asarray(c) for c in jmesh.x)
    base_u = np.stack([4 * y * (1 - y), 0 * y, 0.3 * np.sin(np.pi * x) * y * (1 - y)])
    base_t = np.stack([1 - y + 0.1 * np.sin(np.pi * x) * np.cos(np.pi * z) * y * (1 - y)])
    cfgs = {}
    for name, tol in (("fwd", 1e-12), ("adj", 1e-13)):
        kw = {**FLOW, "vtol": tol, "ptol": tol, "ttol": tol}
        cfgs[name] = (jlin.LinConfig(flow=jns.FlowConfig(**kw), lin_forcing_fn=_jbuoyancy),
                      lin.LinConfig(flow=ns.FlowConfig(**kw), lin_forcing_fn=_buoyancy))
    rng = np.random.default_rng(16)
    shape = tuple(jmesh.bm1.shape)

    def direction():
        u = sem.dsavg(mesh, t(rng.standard_normal((3,) + shape))) * mesh.vmask
        th = sem.dsavg(mesh, t(rng.standard_normal((1,) + shape))) * mesh.tmask
        return u.numpy(), th.numpy()

    return (jmesh, mesh, cfgs, base_u, base_t, jbuild(jmesh, 1.0), build_e_preconditioner(mesh),
            direction(), direction())


def test_temperature_mask_is_the_reference_one(boussinesq3d):
    """`bc_temp` in 3-D: the temperature is held on the y faces alone."""
    jmesh, mesh = boussinesq3d[:2]
    assert np.array_equal(np.asarray(jmesh.tmask), mesh.tmask.numpy())
    y = mesh.x[1]
    on_wall = (y == 0) | (y == 1)
    assert bool((mesh.tmask[on_wall] == 0).all()) and bool((mesh.tmask[~on_wall] == 1).all())


def test_propagate_and_adjoint_boussinesq3d(boussinesq3d):
    """propagate (6 steps) and the exact discrete B-adjoint against the
    reference's (`jax.linear_transpose` there), both fields; then the
    B-adjoint identity over both fields."""
    jmesh, mesh, cfgs, base_u, base_t, jpc, pc, (u0, th0), (v0, ph0) = boussinesq3d
    (jcfg, cfg), (jcfg_a, cfg_a) = cfgs["fwd"], cfgs["adj"]
    ja = lambda a: jnp.asarray(a)
    want = jlin.propagate(jmesh, jcfg, ja(base_u), ja(base_t), ja(u0), ja(th0), NSTEPS, pc_e=jpc)
    stats = {}
    got = lin.propagate(mesh, cfg, t(base_u), t(base_t), t(u0), t(th0), NSTEPS, pc_e=pc,
                        stats=stats)
    assert float(np.abs(np.asarray(want[1])).max()) > 1e-2
    for g, w in zip(got, want):
        assert rel(g, w) <= 1e-10
    assert len(stats["scalar"]) == NSTEPS and min(stats["scalar"]) > 0

    jadj = jlin.make_adjoint_propagator(jmesh, jcfg_a, ja(base_u), ja(base_t), NSTEPS, pc_e=jpc)
    adj = lin.make_adjoint_propagator(mesh, cfg_a, t(base_u), t(base_t), NSTEPS, pc_e=pc)
    want_a = jadj(ja(v0), ja(ph0))
    got_a = adj(t(v0), t(ph0))
    assert float(np.abs(np.asarray(want_a[1])).max()) > 1e-2
    for g, w in zip(got_a, want_a):
        assert rel(g, w) <= 1e-10

    mu, mt = lin.propagate(mesh, cfg_a, t(base_u), t(base_t), t(u0), t(th0), NSTEPS, pc_e=pc)
    lhs = float(sem.mass_dot(mesh, mu, t(v0)) + sem.mass_dot(mesh, mt, t(ph0)))
    rhs = float(sem.mass_dot(mesh, t(u0), got_a[0]) + sem.mass_dot(mesh, t(th0), got_a[1]))
    assert abs(lhs - rhs) / abs(lhs) < 1e-9, (lhs, rhs)

