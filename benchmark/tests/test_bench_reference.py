"""The plain reference against the program, the base flows and the fixed
arithmetic of the yardstick."""

import numpy as np
import pytest
import torch

from conftest import TINY
from reference import baseflows, flow, krylov, yardstick
from reference.baseflows import duct_poiseuille
from reference import mesh as refmesh

import harness


def _mesh_args(cfg):
    m = cfg["mesh"]
    return tuple(m["nels"]), m["lims"], m["bc"], m["order"]


@pytest.mark.parametrize("config", sorted(TINY))
def test_reference_against_the_port(config):
    """At a small size of each configuration, on the CPU: the mesh fields,
    dt and the step count, the matvec and the exact adjoint's rmatvec of
    the plain reference equal the port's to rounding."""
    from neklab_tpu_torch import ExponentialPropagator, FlowConfig, LinConfig, box_mesh

    cfg = {**harness.load_json(f"{harness.HERE}/configs/{config}.json"), **TINY[config]}
    args = _mesh_args(cfg)
    host = refmesh.host_fields(*args)
    base = baseflows.evaluate(cfg["base_flow"], host["x"])
    mesh = box_mesh(args[0], args[1], args[2], order=args[3], dtype=torch.float64, device="cpu")
    rmesh = refmesh.box_mesh(*args)
    for name in ("x", "bm1", "g", "rx", "rxd", "bmd", "bm2", "binv", "vmult", "vmask", "gidx"):
        assert torch.equal(getattr(mesh, name), getattr(rmesh, name)), name
    fc = FlowConfig(viscosity=cfg["viscosity"], dt=cfg["tau"], vtol=cfg["vtol"],
                    ptol=cfg["ptol"], vmaxit=cfg["vmaxit"], pmaxit=cfg["pmaxit"])
    op = ExponentialPropagator(mesh, LinConfig(flow=fc), torch.as_tensor(base), tau=cfg["tau"],
                               cfl=cfg["cfl"])
    ref = flow.Propagator(rmesh, base, cfg["viscosity"], cfg["tau"], cfg["vtol"], cfg["ptol"],
                          cfg["vmaxit"], cfg["pmaxit"])
    assert (op.dt, op.nsteps) == (ref.dt, ref.nsteps)
    v = torch.as_tensor(harness.start_vector(7, host))
    th = torch.zeros((0,) + tuple(mesh.bm1.shape), dtype=torch.float64)
    rel = lambda a, b: float(krylov.bnorm(rmesh.bm1, a - b) / krylov.bnorm(rmesh.bm1, b))
    stats = {}
    assert rel(op.matvec({"u": v, "theta": th}, stats=stats)["u"], ref.matvec(v)) < 1e-10
    assert stats["pressure"] == ref.log["pressure"]
    assert stats["helmholtz"] == ref.log["helmholtz"]
    assert rel(op.rmatvec({"u": v, "theta": th})["u"], ref.rmatvec(v)) < 1e-10


def test_duct_profile_solves_the_poisson_problem():
    """The duct's series: lap u = const (4th-order differences on a fine
    grid), u = 0 on the walls to the truncation, u(0, 0) = 1, symmetric."""
    h = 1e-2
    g = np.arange(-1.0, 1.0 + h / 2, h)
    y, z = np.meshgrid(g, g, indexing="ij")
    u = duct_poiseuille.duct_profile(y, z, terms=400)
    assert abs(duct_poiseuille.duct_profile(np.zeros(1), np.zeros(1))[0] - 1.0) < 1e-14
    assert np.abs(u - u.T).max() < 1e-12
    assert max(np.abs(u[0]).max(), np.abs(u[-1]).max(), np.abs(u[:, 0]).max()) < 1e-6
    c = (-u[4:, 2:-2] + 16 * u[3:-1, 2:-2] - 30 * u[2:-2, 2:-2] + 16 * u[1:-3, 2:-2]
         - u[:-4, 2:-2]) / (12 * h * h)
    c += (-u[2:-2, 4:] + 16 * u[2:-2, 3:-1] - 30 * u[2:-2, 2:-2] + 16 * u[2:-2, 1:-3]
          - u[2:-2, :-4]) / (12 * h * h)
    # lap w = -1 and u = w / w(0, 0): lap u = -1 / w(0, 0) = -3.3935... everywhere
    want = -1.0 / duct_poiseuille._duct_w(np.zeros(1), np.zeros(1), 400)[0]
    assert np.abs(c[5:-5, 5:-5] - want).max() < 1e-5 * abs(want)


def test_channel_profile():
    x = np.zeros((3, 4))
    x[1] = [-1.0, -0.5, 0.0, 1.0]
    u = baseflows.evaluate({"kind": "channel_poiseuille"}, x)
    assert np.allclose(u[0], [0.0, 0.75, 1.0, 0.0]) and not u[1:].any()


def test_roofline_counts_by_hand():
    """n = 8, one element, one field, 8-byte words: gradient and transposed
    gradient 6 contractions of 8^3 outputs x 8 terms x 2 = 6 * 8192; the
    metric 15 and the scaling, mass and sum 6 flops a point; bytes: the
    field in and out, six metric factors and the mass, and D."""
    flops, nbytes = yardstick.helmholtz3d_counts(8, 1, 1, 8)
    assert flops == 12 * 4096 + 21 * 512 == 59904
    assert nbytes == ((2 + 7) * 512 + 64) * 8 == 37376
    f3, b3 = yardstick.helmholtz3d_counts(8, 720, 3, 8)
    assert f3 == 3 * 720 * 59904 and b3 == ((6 + 7) * 512 * 720 + 64) * 8
    # bandwidth-bound at this intensity on the H100
    assert yardstick.bound_seconds(f3, b3, "float64") == b3 / yardstick.HBM_BYTES_PER_S


def test_trace_arithmetic():
    assert yardstick.union_length([(0, 2), (1, 3), (5, 6), (5.5, 5.7)]) == 4
    gaps = yardstick.idle_gaps([(1, 2), (4, 5)], (0, 6),
                               [(0, 6, "outer"), (2, 4, "inner"), (5.5, 5.9, "late")])
    # 0-1 under "outer", 2-4 under "inner", 5-6 under "outer" (the gap starts at 5)
    assert gaps == [["outer", 2e-6], ["inner", 2e-6]]
