"""The port's spans of a traced call (`stats=`), on the CPU.

A call is traced when its caller passes a `stats=` dict: each CG solve then
appends a `solvers.CGTiming` under "neklab.cg.<kind>", each time step of
`propagate` its time outside its solves under "neklab.step", and each
exact-adjoint call its time outside its transposed solves, per time step,
under "neklab.adjoint"; while a profiler records, each is a named range.
These tests hold that a traced call computes the same bits as an untraced
one, that an untraced call (the exact adjoint's always-on log included)
stamps nothing and opens no range, that the entries match the iteration
counts beside them, which stay integer counts, that under a profiler the
ranges nest step -> solve -> read and no stamp is taken, and that the
timers' report keeps its layout. On the CPU
the stamps are the host's clock; on the card (tests/test_torch_card.py)
CUDA events.
"""

import math
import re

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from neklab_tpu_torch.linops.exponential_propagator import ExponentialPropagator
from neklab_tpu_torch.mesh.box import box_mesh
from neklab_tpu_torch.models import linearized as lin
from neklab_tpu_torch.models import navier_stokes as ns
from neklab_tpu_torch.models.solvers import CGTiming
from neklab_tpu_torch.utils import timers
from torch_port_helpers import CHANNEL_BC, cg_counts

MESH = dict(nels=(3, 2), lims=((0, 2 * np.pi), (-1, 1)), bc=CHANNEL_BC, order=5)
FLOW = dict(viscosity=0.02, dt=0.02, vtol=1e-10, ptol=1e-10, ttol=1e-10, nscal=1,
            conductivity=(0.03,))
NSTEPS = 4
KINDS = ("helmholtz", "pressure", "scalar")


@pytest.fixture(scope="module")
def setup():
    mesh = box_mesh(**MESH, device="cpu")
    y = mesh.x[1]
    base = torch.stack([1 - y**2, 0 * y])
    rng = np.random.default_rng(5)
    shape = tuple(mesh.bm1.shape)
    u = torch.as_tensor(rng.standard_normal((2,) + shape)) * mesh.vmask
    th = torch.as_tensor(rng.standard_normal((1,) + shape)) * mesh.tmask
    return mesh, base, u, th


def _solver(mesh, kind):
    """One solver of each kind at BDF3 and a right-hand side for it."""
    fc = ns.FlowConfig(**FLOW)
    vdiag, tdiags = ns.bdf3_diags(mesh, fc)
    if kind == "pressure":
        solve = ns.pressure_solvers(mesh, fc, [3])[3]
        rhs = torch.as_tensor(np.random.default_rng(1).standard_normal(tuple(mesh.bm2.shape)))
        return lambda stats: solve(rhs - rhs.mean(), stats=stats)
    vsolve, tsolves = ns.velocity_solvers(mesh, fc, [3], vdiag, tdiags)[3]
    solve = vsolve if kind == "helmholtz" else tsolves[0]
    lead = (2,) if kind == "helmholtz" else ()
    rhs = torch.as_tensor(np.random.default_rng(2).standard_normal(lead + tuple(mesh.bm1.shape)))
    return lambda stats: solve(rhs, torch.zeros_like(rhs), stats=stats)


def _propagate(mesh, base, u, th, order):
    """`propagate` through the ramp up to a last step at BDF `order`."""
    cfg = lin.LinConfig(flow=ns.FlowConfig(**FLOW))
    bth = torch.zeros_like(th)
    return lambda stats: lin.propagate(mesh, cfg, base, bth, u, th, order, stats=stats)


def _adjoint(mesh, base, u, th):
    cfg = lin.LinConfig(flow=ns.FlowConfig(**FLOW))
    prop = ExponentialPropagator(mesh, cfg, base, tau=NSTEPS * FLOW["dt"], dt=FLOW["dt"])
    x = {"u": u, "theta": th}
    return prop, lambda stats: prop.rmatvec(x, stats=stats)


CALLS = [f"solve-{k}" for k in KINDS] + [f"propagate-{o}" for o in (1, 2, 3)] + ["rmatvec"]


def _call(setup, name):
    mesh, base, u, th = setup
    if name.startswith("solve-"):
        return None, _solver(mesh, name[6:])
    if name.startswith("propagate-"):
        return None, _propagate(mesh, base, u, th, int(name[10:]))
    return _adjoint(mesh, base, u, th)


def _tensors(out):
    if isinstance(out, dict):
        return [out["u"], out["theta"]]
    return list(out) if isinstance(out, tuple) else [out]


def _neklab_events(prof):
    return [e for e in prof.events() if e.name.startswith("neklab.")]


@pytest.mark.parametrize("name", CALLS)
def test_traced_call_computes_the_same_bits(setup, name):
    _, fn = _call(setup, name)
    plain = _tensors(fn(None))
    stats = {}
    traced = _tensors(fn(stats))
    assert any(k.startswith("neklab.") for k in stats)
    assert len(plain) == len(traced)
    for a, b in zip(plain, traced):
        assert torch.equal(a, b)


@pytest.mark.parametrize("name", CALLS)
def test_untraced_call_stamps_nothing_and_opens_no_range(setup, name, monkeypatch):
    prop, fn = _call(setup, name)
    fn(None)  # the adjoint records its tape at its first call

    def refuse(self):
        raise AssertionError("an untraced call took a stamp")

    monkeypatch.setattr(timers.Clock, "stamp", refuse)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn(None)
    assert _neklab_events(prof) == []
    if prop is not None:
        # the exact adjoint's log, which its recorded solves always report to
        log = prop.adjoint._log
        assert log.traced is False and log and set(log) <= {"helmholtz", "pressure", "scalar"}
        assert prop.adjoint._clock is None


@pytest.mark.parametrize("name", CALLS)
def test_traced_call_appends_an_entry_per_solve_and_step(setup, name):
    prop, fn = _call(setup, name)
    stats = {}
    fn(stats)
    kinds = [k for k in KINDS if k in stats]
    assert kinds
    for kind in kinds:
        entries = stats["neklab.cg." + kind]
        assert all(isinstance(t, CGTiming) for t in entries)
        # one entry per solve, each with the iterations its count logs
        assert [t.iters for t in entries] == stats[kind]
        for t in entries:
            assert all(math.isfinite(v) and v >= 0 for v in t[1:])
            assert t.iter_s + t.gap_s <= t.span_s and t.read_s <= t.span_s
    extra = set(stats) - set(kinds) - {"neklab.cg." + k for k in kinds}
    if name.startswith("solve-"):
        assert extra == set() and len(stats[kinds[0]]) == 1
    elif name.startswith("propagate-"):
        nsteps = int(name[10:])
        assert extra == {"neklab.step", "neklab.scalar"}
        assert len(stats["neklab.step"]) == len(stats["neklab.scalar"]) == nsteps
        assert all(len(stats[k]) == nsteps for k in kinds)
        # the scalar block is a part of its step, its solve a part of the step's
        assert all(a <= b for a, b in zip(stats["neklab.scalar"], stats["neklab.step"]))
    else:
        assert extra == {"neklab.adjoint"} and len(stats["neklab.adjoint"]) == 1
        assert all(len(stats[k]) == prop.nsteps for k in kinds)
    assert all(v >= 0 for k in extra for v in stats[k])


@pytest.mark.parametrize("name", CALLS)
def test_counts_stay_integer_and_unchanged(setup, name):
    """The count lists of a traced dict equal those of a dict that records
    counts alone (`timers.Counts`, untraced), and are ints."""
    _, fn = _call(setup, name)
    fn(None)
    plain = timers.Counts()
    fn(plain)
    assert not any(k.startswith("neklab.") for k in plain)
    stats = {}
    fn(stats)
    assert cg_counts(stats) == dict(plain)
    assert all(type(k) is int for v in plain.values() for k in v)


def _inside(inner, outer):
    return (outer.time_range.start <= inner.time_range.start
            and inner.time_range.end <= outer.time_range.end)


@pytest.mark.parametrize("name", ["propagate-3", "rmatvec"])
def test_profiler_ranges_nest_step_solve_read(setup, name):
    _, fn = _call(setup, name)
    fn(None)
    stats = {}
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn(stats)
    # the profile times a call made under it: the counts, and no stamp
    assert stats and not any(k.startswith("neklab.") for k in stats)
    ev = _neklab_events(prof)
    by = {}
    for e in ev:
        by.setdefault(e.name, []).append(e)
    outer = "neklab.step" if name.startswith("propagate") else "neklab.adjoint"
    assert len(by[outer]) == (3 if outer == "neklab.step" else 1)
    solves = [e for k in KINDS for e in by.get("neklab.cg." + k, [])]
    assert {"neklab.cg.helmholtz", "neklab.cg.pressure", "neklab.cg.scalar"} <= set(by)
    assert all(any(_inside(s, o) for o in by[outer]) for s in solves)
    assert by["neklab.cg.read"]
    assert all(any(_inside(r, s) for s in solves) for r in by["neklab.cg.read"])
    if outer == "neklab.step":
        # each step's scalar block, around its scalar solve
        assert len(by["neklab.scalar"]) == 3
        assert all(any(_inside(b, o) for o in by[outer]) for b in by["neklab.scalar"])
        assert all(any(_inside(s, b) for b in by["neklab.scalar"])
                   for s in by["neklab.cg.scalar"])


BOX3 = dict(nels=(2, 2, 2), lims=((0, 2.0), (0, 1.0), (0, 2.0)),
            bc={"x-": "P", "x+": "P", "y-": "W", "y+": "W", "z-": "P", "z+": "P"}, order=3,
            bc_temp={"y-": "t", "y+": "t"})


def test_traced_3d_scalar_propagate_times_its_scalar_block(monkeypatch):
    """A 3-D Boussinesq `propagate` (nscal 1, the buoyancy, the temperature
    held on the walls): traced, one "neklab.scalar" entry a time step, each
    within its step's; untraced, the same bits and no stamp."""
    mesh = box_mesh(**BOX3, device="cpu")
    shape = tuple(mesh.bm1.shape)
    cfg = lin.LinConfig(flow=ns.FlowConfig(viscosity=1.0, dt=1e-3, nscal=1, conductivity=(1.0,),
                                           vtol=1e-10, ptol=1e-10, ttol=1e-10),
                        lin_forcing_fn=lambda m, u, th: torch.stack(
                            [0 * th[0], 1900.0 * th[0], 0 * th[0]]))
    rng = np.random.default_rng(6)
    u = torch.as_tensor(rng.standard_normal((3,) + shape)) * mesh.vmask
    th = torch.as_tensor(rng.standard_normal((1,) + shape)) * mesh.tmask
    base_u, base_t = torch.zeros((3,) + shape, dtype=torch.float64), (1 - mesh.x[1])[None]
    run = lambda stats: lin.propagate(mesh, cfg, base_u, base_t, u, th, 4, stats=stats)
    stats = {}
    traced = run(stats)
    assert len(stats["neklab.scalar"]) == len(stats["neklab.step"]) == 4
    assert len(stats["neklab.cg.scalar"]) == 4
    assert all(0 <= a <= b for a, b in zip(stats["neklab.scalar"], stats["neklab.step"]))

    def refuse(self):
        raise AssertionError("an untraced call took a stamp")

    monkeypatch.setattr(timers.Clock, "stamp", refuse)
    plain = run(None)
    for a, b in zip(plain, traced):
        assert torch.equal(a, b)


def test_timers_scope_is_a_range_and_the_report_keeps_its_layout():
    """A `Timers` scope is the range `neklab.<scope>` while a profiler
    records, none without; the report (timers.log) has the same lines
    either way, in the reference's format."""

    def drive(t):
        with t("outer"):
            with t("inner"):
                torch.ones(3).sum()
        return [re.sub(r"[0-9.]+s", "Ts", line) for line in t.report().splitlines()]

    plain, profiled = timers.Timers(), timers.Timers()
    with profile(activities=[ProfilerActivity.CPU]) as none:
        pass
    lines = drive(plain)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert drive(profiled) == lines
    assert _neklab_events(none) == []
    names = {e.name for e in _neklab_events(prof)}
    assert names == {"neklab.outer", "neklab.outer/inner"}
    assert lines[0] == "--- timers ---" and len(lines) == 3
    assert [re.fullmatch(r"( *)(\w+) +Ts  x1", line).group(1, 2) for line in lines[1:]] == [
        ("", "outer"), ("  ", "inner")]
