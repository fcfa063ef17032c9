"""The benchmark's Boussinesq cell, `rayben3d-ra1900.boussinesq-eigs`, on
the CPU at a small size: its plain reference against the port, the fold
of its operator, its mesh builder's temperature mask, its three metric
readers, and what its new files import. Imports no JAX. (The float32
control and a whole traced run at this size are
`benchmark/tests/test_bench_rayben.py`, run by hand.)

The small size: the configuration with a (2, 2, 2) mesh at order 4 over
one critical wavelength (the walls, faces and physics of the cell's own),
tau = 5 dt (the BDF1/2 ramp and three BDF3 steps). Bounds:
  * reference against port, inner solves at 1e-12: 1e-10 relative in the
    B-norm over the four fields, as the benchmark's test of the other
    configurations' reference (both compute the same arithmetic in f64;
    what is left is the solves' stop at 1e-12 absolute, and rounding);
    the CG iteration counts equal, solve by solve;
  * the fold: bit for bit.
"""

import ast
import math
import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(ROOT, "benchmark")
CELL = "rayben3d-ra1900.boussinesq-eigs"
LC = 2 * math.pi / 3.11632  # one critical wavelength
SMALL = {
    "mesh": {"builder": "box_thermal", "nels": [2, 2, 2], "lims": [[0.0, LC], [0.0, 1.0],
                                                                   [0.0, LC]],
             "bc": {"x-": "P", "x+": "P", "y-": "W", "y+": "W", "z-": "P", "z+": "P"},
             "bc_temp": {"y-": "t", "y+": "t"}, "order": 4},
    "tau": 0.005,
}
TIGHT = {**SMALL, "vtol": 1e-12, "ptol": 1e-12, "ttol": 1e-12}


@pytest.fixture(autouse=True)
def no_cache(monkeypatch):
    monkeypatch.setenv("NEKLAB_PRECOND_CACHE", "0")


@pytest.fixture(scope="module")
def bench():
    """The harness, imported as `python3 benchmark/run.py` does (benchmark/
    on sys.path), and the plug-ins of the cell."""
    if BENCH not in sys.path:
        sys.path.append(BENCH)
    import harness

    spec = harness.resolve(CELL, ROOT)
    return harness, harness.plugin("operators", "boussinesq"), harness.plugin(
        "meshes", "box_thermal"), spec


def _setup(bench, over):
    harness, operator, meshes, spec = bench
    from reference import baseflows

    cfg = {**spec["config"], **over}
    host = meshes.host(cfg["mesh"])
    base = baseflows.evaluate(cfg["base_flow"], host["x"])
    mesh = meshes.program(cfg["mesh"], torch.float64, "cpu")
    return cfg, host, base, mesh


def test_host_fields_carry_the_program_masks(bench):
    """`host()["vmask"]`: the program's velocity mask, then its temperature
    mask (held on the walls alone), and the reference's mesh is the plain
    one at the same nodes."""
    cfg, host, base, mesh = _setup(bench, SMALL)
    meshes = bench[2]
    assert host["vmask"].shape[0] == 4
    assert np.array_equal(host["vmask"][:3], mesh.vmask.numpy())
    assert np.array_equal(host["vmask"][3], mesh.tmask.numpy())
    y = host["x"][1]
    assert ((host["vmask"][3] == 0) == ((y == 0) | (y == 1))).all()
    rmesh = meshes.reference(cfg["mesh"])
    for name in ("x", "bm1", "vmask", "vmult", "gidx"):
        assert torch.equal(getattr(mesh, name), getattr(rmesh, name)), name
    assert np.array_equal(base[:3], np.zeros_like(base[:3]))
    assert np.array_equal(base[3], 1.0 - host["x"][1])


class _Echo:
    """A stand-in for the program's propagator: its matvec returns what it
    was given, and keeps it."""

    tau, nsteps, dt = 0.05, 50, 1e-3

    def __init__(self, mesh):
        self.mesh = mesh

    def matvec(self, x, stats=None):
        self.seen = x
        return x


def test_fold_round_trips_exactly(bench):
    """The fold: the program sees the velocity's and the temperature's
    slices of "u" (views, no copy), and its answer comes back as one "u"
    bit for bit, the empty "theta" kept; the real propagator leaves its
    input as it was."""
    operator = bench[1]
    cfg, host, base, mesh = _setup(bench, SMALL)
    u = torch.as_tensor(bench[0].start_vector(3, host))
    th = operator.theta(mesh, torch.float64, "cpu")
    echo = _Echo(mesh)
    out = operator.Fold(echo).matvec({"u": u, "theta": th})
    assert torch.equal(echo.seen["u"], u[:3]) and torch.equal(echo.seen["theta"], u[3:])
    assert echo.seen["u"].data_ptr() == u.data_ptr()
    assert torch.equal(out["u"], u) and out["theta"] is th and th.shape[0] == 0
    op = operator.program(mesh, cfg, torch.as_tensor(base), {})
    before = u.clone()
    y = op.matvec({"u": u, "theta": th})
    assert torch.equal(u, before) and y["u"].shape == u.shape
    assert (op.tau, op.nsteps, op.dt) == (0.005, 5, 0.001)


def test_reference_against_the_port(bench):
    """The plain Boussinesq reference against the port's propagator through
    the fold, inner solves at 1e-12: the step, the solves' counts."""
    harness, operator, meshes, _ = bench
    cfg, host, base, mesh = _setup(bench, TIGHT)
    op = operator.program(mesh, cfg, torch.as_tensor(base), {})
    ref = operator.reference(meshes.reference(cfg["mesh"]), base, cfg)
    assert (op.dt, op.nsteps) == (ref.dt, ref.nsteps)
    from reference import krylov

    v = torch.as_tensor(harness.start_vector(7, host))
    stats = {}
    got = op.matvec({"u": v, "theta": operator.theta(mesh, torch.float64, "cpu")},
                    stats=stats)["u"]
    want = ref.matvec(v)
    assert float(krylov.bnorm(ref.m.bm1, want[3])) > 1e-2 * float(krylov.bnorm(ref.m.bm1, v[3]))
    assert float(krylov.bnorm(ref.m.bm1, got - want) / krylov.bnorm(ref.m.bm1, want)) < 1e-10
    for key in ("helmholtz", "pressure", "scalar"):
        assert stats[key] == ref.log[key], key


def test_scalar_metric_readers(bench):
    """The three readers on a synthetic record: the counts over the time
    steps, the medians of the iterations' and the blocks' device time; and
    nothing from a record without them."""
    from neklab_tpu_torch.models.solvers import CGTiming

    harness = bench[0]
    rec = {"counters": {
        "scalar": [20, 30, 40], "helmholtz": [5, 5, 5], "time_steps": 4,
        "neklab.cg.scalar": [CGTiming(20, 2e-3, 1e-4, 3e-3, 1e-4),
                             CGTiming(30, 6e-3, 1e-4, 7e-3, 1e-4),
                             CGTiming(0, 0.0, 0.0, 1e-4, 0.0),
                             CGTiming(40, 4e-3, 1e-4, 5e-3, 1e-4)],
        "neklab.scalar": [1e-4, 3e-4, 2e-4, 9e-4]}}
    assert harness.reader("scalar_iters_per_step")(rec) == 90 / 4
    assert harness.reader("scalar_iter_us")(rec) == pytest.approx(100.0)
    assert harness.reader("scalar_other_ms")(rec) == pytest.approx(0.25)
    bare = {"counters": {"pressure": [12], "helmholtz": [4], "time_steps": 1}}
    for name in ("scalar_iters_per_step", "scalar_iter_us", "scalar_other_ms"):
        assert harness.reader(name)(bare) is None


NEW_FILES = ("reference/boussinesq.py", "reference/baseflows/conduction.py",
             "operators/boussinesq.py", "meshes/box_thermal.py", "metrics/scalar_iters_per_step.py",
             "metrics/scalar_iter_us.py", "metrics/scalar_other_ms.py")


@pytest.mark.parametrize("path", NEW_FILES)
def test_new_files_import_no_jax(path):
    """No JAX and no JAX package anywhere; the reference, its base flow
    and the readers nothing of the program either (the operator and the
    mesh builder call the program inside their `program`)."""
    tree = ast.parse(open(os.path.join(BENCH, path)).read())
    tops = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            tops.add(node.module.split(".")[0])
    assert not tops & {"jax", "jaxlib", "neklab_tpu"}, tops
    if not path.startswith(("operators/", "meshes/")):
        assert "neklab_tpu_torch" not in tops, tops
