"""Smoke run of neklab_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Builds the CUDA kernels from the sources in this checkout, checks each
against its plain torch twin, and drives the port's main paths through the
user entry points: the direct modal-stability eigensolve (box_mesh ->
ExponentialPropagator -> flow_vector_space ->
linear_stability_analysis_fixed_point), transient growth, whose Lanczos
SVD runs the exact discrete adjoint (... ->
transient_growth_analysis_fixed_point), the cylinder-wake pipeline (a
nonlinear spin-up, a Newton-Krylov base flow and its eigensolve:
annulus_mesh -> advance -> FixedPointSystem ->
newton_fixed_point_iteration -> ExponentialPropagator ->
linear_stability_analysis_fixed_point), the wavenumber-projected
eigensolve (ProjectedPropagator), a resolvent sweep (Resolvent), a
periodic orbit with its Floquet multipliers (PeriodicOrbitSystem ->
newton_fixed_point_iteration -> MonodromyOperator -> eigs) and OTD modes
(otd_analysis). Phases:

  0 device   the card, its power limit, TF32 off
  1 build    nvcc -> neklab_tpu_torch/build/
  2 kernel   helmholtz2d vs helmholtz2d_plain at every later phase's shapes
             and the tiling's edges; device times beside the bound
  3 parity   matvec and rmatvec on the card (kernel, graphed CGs, the
             adjoint's recorded tape) vs on the CPU (plain), f64; the
             B-adjoint identity on the card; the kernel's device counter vs
             the CG counts of both
  3n nonlinear  the nonlinear step on the card vs the CPU, f64, on a small
             cylinder annulus: `advance`; the exact Jacobian's matvec vs a
             central difference of it; the frozen Jacobian's matvec
  3r parity  this slice's operators card vs CPU, f64, small meshes:
             `propagate_forced`, the resolvent, the projected propagator,
             the periodic orbit's Jacobian (dT != 0), dPhi/dT, the
             monodromy, `otd_chunk`; the kernel's counter vs the CG counts
  4 oracle   Poiseuille Re=500 direct and adjoint eigenvalues vs
             Orr-Sommerfeld, f64; the projected alpha = 1 eigensolve
  5 box2d    box2d 131k propagator, f32: ms/step sustained and floor, and
             the adjoint's ms/step and tape bytes
  6 re7500   Poiseuille Re=7500 `medium` eigensolve, f32 (the direct path)
  7 growth   Poiseuille Re=7500 `medium` transient growth, f32 (the
             adjoint path): s per matvec and per rmatvec, the triplet
             identity
  8 cylinder the cylinder wake at Re=50, `medium` (examples/
             cylinder_stability.py), f32: 8000 spin-up steps, Newton to
             |F| < 2e-4, the eigensolve at tau = 1; |mu_1| beside the
             reference's oracle 1.0156 +- 1e-4
  9 resolvent  examples/resolvent_sweep.py at its full mesh, f32: the
             sweep's two end frequencies, the Hermitian identity; the
             Stokes oracle, f64
  10 upo     the Re=180 periodic orbit of examples/cylinder_upo.py, f64,
             from the reference's orbit: |F|, Newton at iterate 0, the
             Floquet multipliers
  11 otd     examples/poiseuille_otd.py's Re=500 run, f32, 17,670 steps:
             eig(Lr) vs the analytic shear rates

After phases 0-5 the main process starts one process per group of SIDE
(this script with `--side oracle,cylinder`, ...) and runs MAIN_THEN beside
them: the solves are bound by the host's launch rate, one core each, and
leave the card idle most of the time. `--only a,b,...` runs the named
phases one after another in this process (to time them alone). The
script uses one card: it makes only the first visible card visible to
itself. Every phase asserts; any failure raises and the exit code is
non-zero. The last line on success is {"ok": true, "device": {...}}; the
line before it lists the kernels. Without a CUDA card it fails at once.

The kernel counts its own runs in device memory (`helmholtz_kernel.launches`),
so the velocity and pressure CGs, whose iterations replay CUDA graphs, are
counted too.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
CHANNEL = {"x-": "P", "x+": "P", "y-": "W", "y+": "W"}
WALLED = {"x-": "W", "x+": "W", "y-": "W", "y+": "W"}


def phase(title: str, t0: float, **numbers) -> None:
    print(f"phase {title}: {time.time() - t0:.2f} s {json.dumps(numbers, default=float)}",
          flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def ptxas_report(log: str) -> dict:
    """{"<dtype> n=<n>": "<registers> regs, <spill stores>/<spill loads> B
    spilled, <bytes> B static smem"} for each helmholtz2d instantiation, from
    nvcc's -Xptxas -v output."""
    out = {}
    for block in log.split("Compiling entry function")[1:]:
        m = re.search(r"helmholtz2d_kernelI([fd])Li(\d+)E", block)
        regs = re.search(r"Used (\d+) registers", block)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", block)
        smem = re.search(r"(\d+) bytes smem", block)
        if m and regs:
            key = f"{'f32' if m.group(1) == 'f' else 'f64'} n={m.group(2)}"
            out[key] = (f"{regs.group(1)} regs, "
                        f"{spill.group(1) + '/' + spill.group(2) if spill else '?'} B spilled, "
                        f"{smem.group(1) if smem else 0} B static smem")
    return out


def rel(a, b) -> float:
    return float((a - b).abs().max() / b.abs().max())


def device_ms(fn, calls: int = 100) -> float:
    """Device time per call (ms): `calls` calls queued behind a sleep kernel
    long enough for the host to enqueue them all, so they run back to back
    and CUDA events around them time the device, not the host's launches."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(500_000_000)  # ~0.25 s of GPU clock cycles
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / calls


def wavy(x):
    x = np.array(x)
    x[1] = x[1] + 0.1 * np.sin(np.pi * x[0]) * (1 - x[1] ** 2)
    x[0] = x[0] + 0.05 * np.sin(np.pi * x[1])
    return x


def channel(dev, dtype, nels, order):
    """The periodic channel [0, 2 pi] x [-1, 1] of the Poiseuille and box2d cases."""
    from neklab_tpu_torch.mesh.box import box_mesh

    return box_mesh(nels, ((0.0, 2 * np.pi), (-1.0, 1.0)), CHANNEL, order=order, dtype=dtype,
                    device=dev)


def poiseuille(dev, dtype, nels, order, re, tol):
    from neklab_tpu_torch.linops.exponential_propagator import ExponentialPropagator
    from neklab_tpu_torch.models.linearized import LinConfig
    from neklab_tpu_torch.models.navier_stokes import FlowConfig

    mesh = channel(dev, dtype, nels, order)
    cfg = LinConfig(flow=FlowConfig(viscosity=1 / re, dt=1e-2, vtol=tol, ptol=tol))
    y = mesh.x[1]
    return mesh, ExponentialPropagator(mesh, cfg, torch.stack([1 - y**2, 0 * y]), tau=0.5, cfl=0.5)


# device ms per call of the kernel's first design (one thread per element), from
# PERF.md's kernel table
EARLIER_MS = {"[2, 9, 9, 120] f32": 0.016281, "[2, 8, 8, 1024] f32": 0.011761}
# H100 SXM peaks from the data sheet: HBM bytes/s, non-tensor flop/s
HBM_BYTES_PER_S = 3.35e12
FLOPS_PER_S = {torch.float32: 67e12, torch.float64: 34e12}
SHORT = {torch.float32: "f32", torch.float64: "f64"}


def bound_ms(n: int, nel: int, batch: int, dtype) -> tuple[float, str]:
    """Least device time of one helmholtz2d call and what sets it: u and out
    ([batch, n, n, nel]) and g00, g01, g11, bm1 ([n, n, nel]) and D moved
    once, against (8n + 10) flops per point and leading entry."""
    words = (2 * batch + 4) * n * n * nel + n * n
    t_bytes = words * torch.finfo(dtype).bits / 8 / HBM_BYTES_PER_S
    t_ops = (8 * n + 10) * batch * n * n * nel / FLOPS_PER_S[dtype]
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def random_args(dev, n, nel, lead, dtype, seed):
    """Kernel inputs from a numpy seed: u, D, a positive metric with a cross
    term, the mass, h1 and h2."""
    rng = np.random.default_rng(seed)
    cast = lambda a: torch.as_tensor(a, dtype=dtype, device=dev)
    geo = (n, n, nel)
    return (cast(rng.standard_normal(lead + geo)), cast(rng.standard_normal((n, n))),
            cast(1 + rng.random(geo)), cast(0.3 * rng.standard_normal(geo)),
            cast(1 + rng.random(geo)), cast(rng.random(geo)), 0.01, 3.7)


def kernel_phase(dev):
    """Phase 2: the kernel against its plain twin on the same CUDA inputs, at
    every shape the later phases give it (a leading axis of 2 is a velocity
    CG iteration, one of n*n the Jacobi-diagonal probe, helmholtz_diag),
    each on its phase's mesh and coefficients, and at the edges of its
    tiling: nel not a multiple of the tile (15, 121), n = 2 and n = 12, a
    batch of 1 and of 81. Times it against the plain chain at the CG shapes
    of the direct path (phase 6), of the cylinder (phase 8) and of box2d,
    and alone at their probe shapes."""
    from neklab_tpu_torch.mesh.box import box_mesh
    from neklab_tpu_torch.ops import helmholtz_kernel as hk

    t0 = time.time()
    re7500 = channel(dev, torch.float32, (12, 10), 8)  # phase 6, the main path
    box2d = channel(dev, torch.float32, (64, 16), 7)  # phase 5
    cyl = cylinder_mesh(dev, torch.float32)  # phase 8: curved, graded, 160 elements

    def mesh_args(m, lead, nu_dt=None):
        """h1, h2 of a BDF3 velocity solve at (nu, dt): phase 8's on the
        cylinder, nu_dt when given, else the channels' (nu = 1e-3, dt = 2e-3)."""
        g = m.g
        u = torch.randn(lead + tuple(m.bm1.shape), generator=gen, dtype=m.dtype, device=dev)
        nu, dt = (1 / 50, 5e-3) if m is cyl else nu_dt or (1e-3, 2e-3)
        return (u, m.d, g[0, 0], g[0, 1], g[1, 1], m.bm1, nu, (11 / 6) / dt)

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    cases = [(f"re7500/{lead}", mesh_args(re7500, lead)) for lead in ((2,), (81,))]
    re500 = channel(dev, torch.float64, (4, 5), 6)  # phases 3 and 4
    cases += [(f"re500/{lead}", mesh_args(re500, lead)) for lead in ((2,), (49,))]
    cases += [(f"cylinder/{lead}", mesh_args(cyl, lead)) for lead in ((2,), (49,))]
    small = small_annulus(dev)  # phase 3n, f64
    cases += [(f"annulus_3n/{lead}", mesh_args(small, lead)) for lead in ((2,), (36,))]
    # this slice's meshes, f32 and f64: the resolvent sweep's channel, the
    # periodic orbit's annulus, the OTD channel
    slice_meshes = {}
    for dtype in (torch.float32, torch.float64):
        name = str(dtype)[6:]
        for key, m, nu_dt, probe in (
                ("resolvent", channel(dev, dtype, (8, 6), 6), (1 / 60, 0.02), (49,)),
                ("upo", upo_mesh(dev, dtype), (1 / 180, 0.01), (36,)),
                ("otd", channel(dev, dtype, (4, 6), 6), (1 / 500, 0.0113), (49,))):
            slice_meshes[key, dtype] = m, nu_dt
            cases += [(f"{key}/{name}/{lead}", mesh_args(m, lead, nu_dt))
                      for lead in ((2,), probe)]
    box2d64 = channel(dev, torch.float64, (64, 16), 7)
    for m in (box2d, box2d64):
        cases += [(f"box2d_131k/{str(m.dtype)[6:]}/{lead}", mesh_args(m, lead))
                  for lead in ((), (2,), (64,))]
    # nel = 15: the ragged tile, the deformation g01 != 0
    deformed = box_mesh((5, 3), ((0.0, 2.0), (-1.0, 1.0)), WALLED, order=5, deform=wavy,
                        dtype=torch.float64, device=dev)
    cases.append(("deformed_5x3", mesh_args(deformed, ())))
    for dtype in (torch.float32, torch.float64):
        for i, (n, nel, lead) in enumerate(((9, 121, (1,)), (2, 15, (2,)), (12, 121, (2,)),
                                            (12, 15, (81,)), (6, 15, (81,)))):
            cases.append((f"random/n{n}/nel{nel}/{lead}/{str(dtype)[6:]}",
                          random_args(dev, n, nel, lead, dtype, i)))

    errs, max_abs = {}, 0.0
    for key, args in cases:
        out = hk.helmholtz2d(*args)
        torch.cuda.synchronize()
        ref = hk.helmholtz2d_plain(*args)
        errs[key] = rel(out, ref)
        max_abs = max(max_abs, float((out - ref).abs().max()))
        # f32: float32 summation order over ~2n terms per point
        assert errs[key] <= (1e-12 if args[0].dtype == torch.float64 else 2e-5), (key, errs[key])

    times, probes = {}, {}
    for m, lead in ((re7500, (81,)), (cyl, (49,)), (box2d, (64,))):  # the Jacobi probe
        args = mesh_args(m, lead)
        probes[f"{list(args[0].shape)} f32"] = device_ms(lambda: hk.helmholtz2d(*args))
    # the velocity-CG shapes of the direct path, the cylinder, box2d, the
    # resolvent sweep (f32) and the periodic orbit (f64)
    timed = [(m, None) for m in (re7500, cyl, box2d)]
    timed += [slice_meshes["resolvent", torch.float32], slice_meshes["upo", torch.float64]]
    for m, nu_dt in timed:
        args = mesh_args(m, (2,), nu_dt)
        key = f"{list(args[0].shape)} {SHORT[m.dtype]}"
        kern, plain = [], []
        for _ in range(3):  # in turns: plain, kernel, kernel, plain, ...
            plain.append(device_ms(lambda: hk.helmholtz2d_plain(*args)))
            kern.append(device_ms(lambda: hk.helmholtz2d(*args)))
            kern.append(device_ms(lambda: hk.helmholtz2d(*args)))
            plain.append(device_ms(lambda: hk.helmholtz2d_plain(*args)))
        bound, by = bound_ms(m.basis.n, m.nel, 2, m.dtype)
        med = statistics.median(kern)
        times[key] = {"kernel_device_ms": kern, "plain_device_ms": plain, "bound_ms": bound,
                      "bound_by": by, "share_of_bound": bound / med,
                      "earlier_design_ms": EARLIER_MS.get(key)}
    phase("kernel", t0, rel_err=errs, max_abs_err=max_abs, times=times, probe_device_ms=probes,
          library="none: no single PyTorch call computes the fused apply")
    n = re7500.basis.n
    main = times[f"[2, {n}, {n}, {re7500.nel}] f32"]
    return {"max_abs_err": max_abs, "ms": statistics.median(main["kernel_device_ms"]),
            "plain_ms": statistics.median(main["plain_device_ms"]), "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"], "library_ms": None,
            "by_shape": {k: {"ms": statistics.median(v["kernel_device_ms"]),
                             "plain_ms": statistics.median(v["plain_device_ms"]),
                             "bound_ms": v["bound_ms"]} for k, v in times.items()}}


def parity_phase(dev):
    """Phase 3: one matvec and one rmatvec on the card (kernel, graphed CGs,
    the adjoint's recorded tape) and on the CPU (plain, eager), f64, and
    the B-adjoint identity <Mu, v>_B = <u, M*v>_B on the card. The kernel's
    device counter must rise by exactly the runs the card's `stats` imply:
    in a matvec one per velocity CG iteration (graph replays) and one per
    solve for its right-hand side; in an rmatvec one per transposed velocity
    CG iteration and nothing else, because the right-hand side's apply acts
    on the zero Dirichlet lift, a constant of the recorded tape, not on the
    cotangent. The propagator built every solver and capture, and its
    adjoint its solvers, captures and tape, before the windows."""
    from neklab_tpu_torch.ops import helmholtz_kernel as hk
    from neklab_tpu_torch.ops import sem

    t0 = time.time()
    _, prop_c = poiseuille(dev, torch.float64, (4, 5), 6, 500.0, 1e-12)
    mesh_h, prop_h = poiseuille("cpu", torch.float64, (4, 5), 6, 500.0, 1e-12)
    assert (prop_c.dt, prop_c.nsteps) == (prop_h.dt, prop_h.nsteps)
    rng = np.random.default_rng(11)
    th = torch.zeros((0,) + tuple(mesh_h.bm1.shape), dtype=torch.float64)

    def conforming():
        u = rng.standard_normal((2,) + tuple(mesh_h.bm1.shape))
        u = mesh_h.vmask * sem.dsavg(mesh_h, torch.as_tensor(u))
        return u / sem.mass_dot(mesh_h, u, u).sqrt()

    uh, vh = conforming(), conforming()
    prop_c.adjoint  # builds the adjoint's solvers and records its tape
    out, runs, implied, stats = {}, {}, {}, {}
    for name, x, extra in (("matvec", uh, 1), ("rmatvec", vh, 0)):
        stats[name] = {"card": {}, "cpu": {}}
        n0 = hk.launches(dev)
        out_c = getattr(prop_c, name)({"u": x.to(dev), "theta": th.to(dev)},
                                      stats=stats[name]["card"])["u"]
        runs[name] = hk.launches(dev) - n0
        out_h = getattr(prop_h, name)({"u": x, "theta": th}, stats=stats[name]["cpu"])["u"]
        out[name] = (out_c, float((out_c.cpu() - out_h).abs().max()))
        velocity = stats[name]["card"]["helmholtz"]
        implied[name] = sum(velocity) + extra * len(velocity)
        assert runs[name] == implied[name], (name, runs[name], implied[name])
        # the inner solves run to 1e-12 (matvec) and 1e-13 (rmatvec) on both
        assert out[name][1] <= 1e-9, (name, out[name][1])
    mesh_c = prop_c.mesh
    lhs = float(sem.mass_dot(mesh_c, out["matvec"][0], vh.to(dev)))
    rhs = float(sem.mass_dot(mesh_c, uh.to(dev), out["rmatvec"][0]))
    identity = abs(lhs - rhs) / abs(lhs)
    assert identity <= 1e-9, (lhs, rhs)
    phase("parity", t0, max_abs_diff={k: v[1] for k, v in out.items()}, kernel_runs=runs,
          runs_implied_by_stats=implied, b_adjoint_identity_rel=identity, lhs=lhs, rhs=rhs,
          tape_bytes=prop_c.adjoint.tape_bytes, nsteps=prop_c.nsteps, cg_iters=stats)


def cylinder_mesh(dev, dtype):
    """The `medium` annulus of examples/cylinder_stability.py (phase 8)."""
    from neklab_tpu_torch.mesh.cylinder import annulus_mesh

    return annulus_mesh(8, 20, r_in=0.5, r_out=20.0, order=6, grading=1.5, outer_bc="vO",
                        shift=0.25, dtype=dtype, device=dev)


def upo_mesh(dev, dtype):
    """The Re=180 periodic-orbit annulus of examples/cylinder_upo.py."""
    from neklab_tpu_torch.mesh.cylinder import annulus_mesh

    return annulus_mesh(7, 18, r_in=0.5, r_out=15.0, order=5, grading=1.5, outer_bc="vO",
                        shift=0.25, dtype=dtype, device=dev)


def small_annulus(dev):
    """Phase 3n's 24-element 'vO' annulus, f64."""
    from neklab_tpu_torch.mesh.cylinder import annulus_mesh

    return annulus_mesh(3, 8, r_in=0.5, r_out=4.0, order=5, grading=1.3, outer_bc="vO",
                        shift=0.2, device=dev)


def cylinder_lift(mesh):
    """The free stream (1, 0) outside the cylinder r = 0.5: the masks keep it
    on the inflow boundary (examples/cylinder_stability.py)."""
    r = torch.sqrt(mesh.x[0] ** 2 + mesh.x[1] ** 2)
    free = (r > 0.5 + 1e-8).to(mesh.dtype)
    return torch.stack([free, torch.zeros_like(free)]), r


def nonlinear_phase(dev):
    """Phase 3n: the nonlinear stepper on the card against the CPU, f64, on a
    small cylinder annulus with an inflow-outflow outer boundary (the lift
    applied through the kernel, the pressure pinned at the outflow):
    20 steps of `advance` (rel <= 1e-12); the exact Jacobian's matvec of a
    FixedPointSystem (forward mode through `advance`: every linear piece,
    the kernel and the graphed CGs included, maps the tangent with itself)
    against a central difference of `advance` on the card; the frozen
    Jacobian's matvec card vs CPU. The kernel's device counter must rise
    by the velocity CG iterations the stats report plus two per step, the
    lift and the warm start's operator apply; in the forward-mode matvec
    the tangent's solves count beside the primal's, and so does the warm
    start's apply to the tangent, while the lift is a constant with no
    tangent (three per step)."""
    from neklab_tpu_torch.krylov.space import tree_axpby
    from neklab_tpu_torch.models.linearized import LinConfig
    from neklab_tpu_torch.models import navier_stokes as ns
    from neklab_tpu_torch.models.precond import build_e_preconditioner
    from neklab_tpu_torch.ops import helmholtz_kernel as hk
    from neklab_tpu_torch.ops import sem
    from neklab_tpu_torch.systems.fixed_point import FixedPointSystem

    t0 = time.time()
    fc = ns.FlowConfig(viscosity=1 / 50, dt=1e-2, vtol=1e-12, ptol=1e-12)
    nsteps = 20
    out, runs, stats, systems = {}, {}, {}, {}
    for d in (dev, "cpu"):
        mesh = small_annulus(d)
        ub, r = cylinder_lift(mesh)
        ramp = 1 - torch.exp(-3.0 * (r - 0.5))
        u0 = mesh.vmask * torch.stack([ramp, 0 * ramp]) + (1 - mesh.vmask) * ub
        # the solvers (and their captures, which run the kernel) before the window
        orders = ns.bdf_orders(fc, nsteps)
        psolves = ns.pressure_solvers(mesh, fc, orders, build_e_preconditioner(mesh))
        vsolves = ns.velocity_solvers(mesh, fc, orders, *ns.bdf3_diags(mesh, fc))
        stats[d] = {}
        n0 = hk.launches(dev)
        out[d] = ns.advance(mesh, fc, ns.initial_state(mesh, fc, u=u0), nsteps, ub=ub,
                            psolves=psolves, vsolves=vsolves, stats=stats[d])
        runs[d] = hk.launches(dev) - n0
        systems[d] = (mesh, FixedPointSystem(mesh, LinConfig(flow=fc), tau=0.1, ub=ub, dt=fc.dt,
                                             exact_jacobian=True),
                      FixedPointSystem(mesh, LinConfig(flow=fc), tau=0.1, ub=ub, dt=fc.dt))
    adv_rel = {k: rel(getattr(out[dev], k).cpu(), getattr(out["cpu"], k)) for k in ("u", "p")}
    assert stats[dev] == stats["cpu"], (stats[dev], stats["cpu"])
    assert max(adv_rel.values()) <= 1e-12, adv_rel
    assert runs[dev] == sum(stats[dev]["helmholtz"]) + 2 * nsteps, (runs[dev], stats[dev])

    # the Jacobians about the advanced state, on a B-normalized conforming dx
    mesh_h = systems["cpu"][0]
    rng = np.random.default_rng(13)
    du = mesh_h.vmask * sem.dsavg(mesh_h, torch.as_tensor(
        rng.standard_normal((2,) + tuple(mesh_h.bm1.shape))))
    du = du / sem.mass_dot(mesh_h, du, du).sqrt()
    th = torch.zeros((0,) + tuple(mesh_h.bm1.shape), dtype=torch.float64)
    x = {d: {"u": out["cpu"].u.to(d), "theta": th.to(d)} for d in (dev, "cpu")}
    dx = {d: {"u": du.to(d), "theta": th.to(d)} for d in (dev, "cpu")}
    exact = systems[dev][1]
    jac = exact.jacobian(x[dev])
    jacobian_nsteps = next(iter(exact.derived.values())).nsteps
    ex_stats = {}
    n0 = hk.launches(dev)
    jv = jac.matvec(dx[dev], stats=ex_stats)["u"] + dx[dev]["u"]
    jv_runs = hk.launches(dev) - n0
    eps = 1e-4
    plus = exact.advance_map(tree_axpby(1.0, x[dev], eps, dx[dev]))["u"]
    minus = exact.advance_map(tree_axpby(1.0, x[dev], -eps, dx[dev]))["u"]
    fd = (plus - minus) / (2 * eps)
    jv_fd_rel = rel(jv, fd)
    assert jv_fd_rel <= 1e-6, jv_fd_rel
    assert jv_runs == sum(ex_stats["helmholtz"]) + 3 * jacobian_nsteps, (jv_runs, ex_stats)
    fz = {d: systems[d][2].jacobian(x[d]).matvec(dx[d])["u"] for d in (dev, "cpu")}
    frozen_diff = float((fz[dev].cpu() - fz["cpu"]).abs().max())
    assert frozen_diff <= 1e-9, frozen_diff
    phase("parity_nonlinear", t0, advance_rel=adv_rel, advance_kernel_runs=runs[dev],
          advance_cg_iters=stats[dev], exact_jvp_vs_central_difference_rel=jv_fd_rel,
          exact_jvp_kernel_runs=jv_runs, exact_jvp_cg_iters=ex_stats,
          frozen_matvec_max_abs_diff=frozen_diff, nsteps=nsteps, jacobian_nsteps=jacobian_nsteps)


def small_upo(dev):
    """tests/test_systems.py's forced channel at order 4 with its UPO system
    (T = 0.3, 10 steps), f64."""
    from neklab_tpu_torch.mesh.box import box_mesh
    from neklab_tpu_torch.models.linearized import LinConfig
    from neklab_tpu_torch.models.navier_stokes import FlowConfig
    from neklab_tpu_torch.systems.periodic_orbit import PeriodicOrbitSystem

    nu = 0.1

    def forcing(m, t, u, th):
        f = torch.zeros((2,) + tuple(m.bm1.shape), dtype=m.dtype, device=m.device)
        f[0] = 2.0 * nu
        return f

    mesh = box_mesh((3, 2), ((0.0, 2.0), (-1.0, 1.0)), CHANNEL, order=4, device=dev)
    fc = FlowConfig(viscosity=nu, dt=0.02, vtol=1e-12, ptol=1e-12, forcing_fn=forcing)
    return mesh, PeriodicOrbitSystem(mesh, LinConfig(flow=fc), t_guess=0.3, nsteps=10)


def parity_r_phase(dev):
    """Phase 3r: this slice's operators on the card against the CPU, f64, on
    small meshes (numpy-seeded inputs): `propagate_forced`; the resolvent's
    matvec and rmatvec; the projected propagator's matvec; the periodic
    orbit's bordered Jacobian, matvec with dT != 0 and rmatvec, the period
    direction dPhi/dT (forward mode with a dt tangent) and the monodromy's
    matvec; `otd_chunk`
    (the base, the modes and Lr). The kernel's device counter against the CG
    counts: in the forced propagation and in the Jacobian's matvec (the
    linearized steps about the recorded orbit) one run per velocity CG
    iteration and one per solve (the zero lift), as in `propagate`; in
    dPhi/dT (forward mode with the tangent on T) one per iteration, the
    primal's and the tangent's, and three per step (the lift, the warm
    start's apply and its tangent) but two in the first step, whose warm
    start carries no tangent yet."""
    from neklab_tpu_torch.linops.projected import ProjectedPropagator
    from neklab_tpu_torch.linops.resolvent import Resolvent
    from neklab_tpu_torch.mesh.box import box_mesh
    from neklab_tpu_torch.models import navier_stokes as ns
    from neklab_tpu_torch.models.linearized import LinConfig, propagate_forced
    from neklab_tpu_torch.models.precond import build_e_preconditioner
    from neklab_tpu_torch.ops import helmholtz_kernel as hk
    from neklab_tpu_torch.ops import sem
    from neklab_tpu_torch.models.linearized import pert_initial
    from neklab_tpu_torch.otd import OtdOpts, _stack, orthonormalize_states, otd_chunk
    from neklab_tpu_torch.systems.periodic_orbit import MonodromyOperator
    from neklab_tpu_torch.vectors import ext_flow_vector

    t0 = time.time()
    rng = np.random.default_rng(21)
    diffs, runs, implied, stats = {}, {}, {}, {}

    def conforming(m, lead=2):
        u = rng.standard_normal((lead,) + tuple(m.bm1.shape))
        return m.vmask * sem.dsavg(m, torch.as_tensor(u))

    def diff(key, card, cpu):
        diffs[key] = float((card.cpu() - cpu).abs().max())

    # -- propagate_forced: the Re=500 channel of phase 3, 20 steps ----------
    fc = ns.FlowConfig(viscosity=1 / 500, dt=1e-2, vtol=1e-12, ptol=1e-12)
    meshes = {d: channel(d, torch.float64, (4, 5), 6) for d in (dev, "cpu")}
    m_h = meshes["cpu"]
    f_re, f_im = conforming(m_h), conforming(m_h)
    out = {}
    for d, m in meshes.items():
        y = m.x[1]
        th = torch.zeros((0,) + tuple(m.bm1.shape), dtype=torch.float64, device=d)
        orders = ns.bdf_orders(fc, 20)
        vdiag, _ = ns.bdf3_diags(m, fc)
        kw = dict(vdiag=vdiag,
                  psolves=ns.pressure_solvers(m, fc, orders, build_e_preconditioner(m)),
                  vsolves=ns.velocity_solvers(m, fc, orders, vdiag, None))
        st = stats[f"forced/{d}"] = {}
        n0 = hk.launches(dev)
        out[d] = propagate_forced(m, LinConfig(flow=fc), torch.stack([1 - y**2, 0 * y]), th,
                                  torch.zeros_like(f_re, device=d), th, f_re.to(d), f_im.to(d),
                                  1.3, 20, stats=st, **kw)[0]
        if d == dev:
            runs["forced"] = hk.launches(dev) - n0
            implied["forced"] = sum(st["helmholtz"]) + len(st["helmholtz"])
    diff("propagate_forced", out[dev], out["cpu"])

    # -- the resolvent: nu = 0.2, omega = 4, 32 steps -----------------------
    res = {}
    for d in (dev, "cpu"):
        m = box_mesh((3, 2), ((0.0, 2 * np.pi), (-1.0, 1.0)), CHANNEL, order=5, device=d)
        cfg = LinConfig(flow=ns.FlowConfig(viscosity=0.2, dt=1.0, vtol=1e-12, ptol=1e-12))
        y = m.x[1]
        res[d] = Resolvent(m, cfg, torch.stack([1 - y**2, 0 * y]), omega=4.0, dt=0.05,
                           gmres_rtol=1e-10)
    m_h = res["cpu"].mesh
    th = torch.zeros((0,) + tuple(m_h.bm1.shape), dtype=torch.float64)
    f, g = ({p: {"u": conforming(m_h), "theta": th} for p in ("re", "im")} for _ in range(2))
    to = lambda pair, d: {p: {k: v.to(d) for k, v in x.items()} for p, x in pair.items()}
    for name, arg in (("matvec", f), ("rmatvec", g)):
        outs = {d: getattr(res[d], name)(to(arg, d)) for d in (dev, "cpu")}
        for p in ("re", "im"):
            diff(f"resolvent_{name}_{p}", outs[dev][p]["u"], outs["cpu"][p]["u"])
    gmres_matvecs = res[dev].last_gmres_matvecs

    # -- the projected propagator: phase 3's Re=500 propagators, alpha = 1 --
    props = {d: poiseuille(d, torch.float64, (4, 5), 6, 500.0, 1e-12) for d in (dev, "cpu")}
    m_h = props["cpu"][0]
    u = conforming(m_h)
    u = u / sem.mass_dot(m_h, u, u).sqrt()
    th = torch.zeros((0,) + tuple(m_h.bm1.shape), dtype=torch.float64)
    outs = {d: ProjectedPropagator(p, 1.0).matvec({"u": u.to(d), "theta": th.to(d)})["u"]
            for d, (_, p) in props.items()}
    diff("projected_matvec", outs[dev], outs["cpu"])

    # -- the periodic orbit's bordered Jacobian -----------------------------
    systems = {d: small_upo(d) for d in (dev, "cpu")}
    m_h = systems["cpu"][0]
    y = m_h.x[1]
    xu = m_h.vmask * sem.dsavg(m_h, torch.stack([0.9 * (1 - y**2), 0.02 * torch.sin(np.pi * y)]))
    du, dv = conforming(m_h), conforming(m_h)
    outs = {}
    for d, (m, system) in systems.items():
        th = torch.zeros((0,) + tuple(m.bm1.shape), dtype=torch.float64, device=d)
        x = ext_flow_vector(m, 0, u=xu.to(d), T=0.3)
        dx = ext_flow_vector(m, 0, u=du.to(d), T=0.7)
        v = ext_flow_vector(m, 0, u=dv.to(d), T=-0.4)
        jac = system.jacobian(x)
        # outside the counts: one step at T/nsteps, and the orbit the
        # linearized steps follow
        jac.phase_dir()
        jac._phi.orbit()
        stats[f"period_dir/{d}"], stats[f"jacobian/{d}"] = {}, {}
        n0 = hk.launches(dev)
        b = jac.period_dir(stats=stats[f"period_dir/{d}"])["u"]
        n1 = hk.launches(dev)
        mv = jac.matvec(dx, stats=stats[f"jacobian/{d}"])
        n2 = hk.launches(dev)
        outs[d] = (b, mv, jac.rmatvec(v), MonodromyOperator(system, x).matvec(dx)["u"])
        if d == dev:
            nsteps = system.nsteps
            runs["period_dir"] = n1 - n0
            implied["period_dir"] = sum(stats[f"period_dir/{d}"]["helmholtz"]) + 3 * nsteps - 1
            runs["jacobian_matvec"] = n2 - n1
            implied["jacobian_matvec"] = sum(stats[f"jacobian/{d}"]["helmholtz"]) + nsteps
    diff("upo_period_dir", outs[dev][0], outs["cpu"][0])
    diff("upo_matvec", outs[dev][1]["u"], outs["cpu"][1]["u"])
    diff("upo_matvec_T", outs[dev][1]["T"], outs["cpu"][1]["T"])
    diff("upo_rmatvec", outs[dev][2]["u"], outs["cpu"][2]["u"])
    diff("upo_rmatvec_T", outs[dev][2]["T"], outs["cpu"][2]["T"])
    diff("monodromy_matvec", outs[dev][3], outs["cpu"][3])

    # -- otd_chunk: tests/test_otd.py's Re=100 channel, 20 steps ------------
    fc = ns.FlowConfig(viscosity=1 / 100, dt=0.06, vtol=1e-11, ptol=1e-11)
    outs = {}
    modes = None
    for d in (dev, "cpu"):
        m = box_mesh((3, 4), ((0.0, 2 * np.pi), (-1.0, 1.0)), CHANNEL, order=4, device=d)
        cfg = LinConfig(flow=fc)
        if modes is None:
            m_cpu = box_mesh((3, 4), ((0.0, 2 * np.pi), (-1.0, 1.0)), CHANNEL, order=4,
                             device="cpu")
            modes = [conforming(m_cpu) for _ in range(2)]
        perts = orthonormalize_states(m, _stack([pert_initial(m, cfg, u.to(d)) for u in modes]))
        y = m.x[1]
        base = ns.initial_state(m, fc, u=torch.stack([1 - y**2, 0 * y]))
        outs[d] = otd_chunk(m, cfg, OtdOpts(r=2), base, perts, 20, ramp=True, ortho_every=5,
                            pc_e=build_e_preconditioner(m))
    diff("otd_base", outs[dev][0].u, outs["cpu"][0].u)
    diff("otd_modes", outs[dev][1].u, outs["cpu"][1].u)
    diff("otd_lr", outs[dev][2], outs["cpu"][2])

    phase("parity_r", t0, max_abs_diff=diffs, kernel_runs=runs, runs_implied_by_stats=implied,
          resolvent_gmres_matvecs=gmres_matvecs,
          cg_iters=stats)
    for key, value in runs.items():
        assert value == implied[key], (key, value, implied[key])
    for key, value in diffs.items():
        # inner solves at 1e-11 to 1e-12 over 10 to 50 steps; GMRES at 1e-10
        assert value <= 1e-9, (key, value)


def oracle_phase(dev) -> dict:
    """Phase 4: Poiseuille Re=500 eigenvalues on the card, f64 (nev =
    NEV_RE500), against the Orr-Sommerfeld/shear-mode oracle, then the
    adjoint's two leading ones
    against the shear modes -nu (pi/2)^2 and -nu pi^2, then the
    wavenumber-projected propagator at alpha = 1 about the same propagator:
    its leading eigenvalue on the Orr-Sommerfeld alpha = 1 branch within
    2e-4 and the alpha = 0 shear mode absent (tests/test_stability.py
    thresholds). Returns the kernel runs of the projected eigensolve."""
    from neklab_tpu_torch.analysis import linear_stability_analysis_fixed_point
    from neklab_tpu_torch.linops.projected import ProjectedPropagator
    from neklab_tpu_torch.ops import helmholtz_kernel as hk
    from neklab_tpu_torch.utils.orr_sommerfeld import orr_sommerfeld_spectrum, shear_mode_eigenvalues
    from neklab_tpu_torch.vectors import flow_vector_space

    t0 = time.time()
    re = 500.0
    mesh, prop = poiseuille(dev, torch.float64, (4, 5), 6, re, 1e-12)
    res = linear_stability_analysis_fixed_point(prop, flow_vector_space(mesh, 0), kdim=40,
                                                nev=NEV_RE500, tol=2e-6, maxiter=12)
    cand = list(shear_mode_eigenvalues(re, 6).astype(complex))
    for a in (1.0, 2.0):
        lam = orr_sommerfeld_spectrum(re, a, 96)[:6]
        cand.extend(lam)
        cand.extend(np.conj(lam))
    cand = np.array(cand)
    dists = [float(np.min(np.abs(cand - lam))) for lam in res.eigvals]
    lead_err = float(abs(res.eigvals[0] - (-(1 / re) * (np.pi / 2) ** 2)))
    assert res.residuals.max() < 2e-6, res.residuals
    assert max(dists) < 2e-4, dists
    assert lead_err < 1e-5, lead_err
    adj = linear_stability_analysis_fixed_point(prop, flow_vector_space(mesh, 0), kdim=30,
                                                nev=2, tol=1e-5, maxiter=12, adjoint=True)
    adj_err = [float(abs(adj.eigvals[0] - (-(1 / re) * (np.pi / 2) ** 2))),
               float(abs(adj.eigvals[1] - (-(1 / re) * np.pi**2)))]
    phase("oracle", t0, eigvals=[[v.real, v.imag] for v in res.eigvals],
          residuals=res.residuals.tolist(), oracle_dist=dists, lead_err=lead_err,
          n_matvec=res.n_matvec, seconds=res.elapsed,
          adjoint_eigvals=[[v.real, v.imag] for v in adj.eigvals], adjoint_err=adj_err,
          adjoint_n_matvec=adj.n_matvec, adjoint_seconds=adj.elapsed)
    assert max(adj_err) < 1e-4, adj_err

    t0 = time.time()
    hk.reset_launches(dev)
    proj = linear_stability_analysis_fixed_point(ProjectedPropagator(prop, 1.0),
                                                 flow_vector_space(mesh, 0), kdim=30, nev=2,
                                                 tol=1e-7, maxiter=10)
    launches = hk.launches(dev)
    lam = complex(proj.eigvals[0])
    os_a1 = complex(orr_sommerfeld_spectrum(re, 1.0, 96)[0])
    shear = -(1 / re) * (np.pi / 2) ** 2
    phase("projected", t0, alpha=1.0, eigvals=[[v.real, v.imag] for v in proj.eigvals],
          residuals=proj.residuals.tolist(), oracle=[os_a1.real, os_a1.imag],
          err=[abs(lam.real - os_a1.real), abs(abs(lam.imag) - abs(os_a1.imag))],
          shear_mode_distance=abs(lam.real - shear), n_matvec=proj.n_matvec,
          seconds=proj.elapsed, kernel_runs=launches)
    assert abs(lam.real - os_a1.real) < 2e-4 and abs(abs(lam.imag) - abs(os_a1.imag)) < 2e-4
    assert abs(lam.real - shear) > 1e-2, lam
    return {"projected": launches}


def box2d_phase(dev):
    """Phase 5: the box2d 131k propagator (bench.py:109-139), f32, with the
    sustained protocol of bench.py:73-106 and its floor; then its exact
    adjoint at ExponentialPropagator's adjoint tolerances (10x tighter),
    sustained, in turns with the direct map, and the bytes its recorded tape
    holds on the card."""
    from neklab_tpu_torch.models import navier_stokes as ns
    from neklab_tpu_torch.models.linearized import LinConfig, make_adjoint_propagator, propagate
    from neklab_tpu_torch.models.navier_stokes import FlowConfig, helmholtz_diag
    from neklab_tpu_torch.models.precond import build_e_preconditioner
    from neklab_tpu_torch.ops import helmholtz_kernel as hk
    from neklab_tpu_torch.ops import sem

    t0 = time.time()
    mesh = channel(dev, torch.float32, (64, 16), 7)
    fc = FlowConfig(viscosity=1e-3, dt=2e-3, vtol=1e-5, ptol=1e-5, vmaxit=50, pmaxit=120)
    cfg = LinConfig(flow=fc)
    y = mesh.x[1]
    base_u = torch.stack([1 - y**2, 0 * y])
    th = torch.zeros((0,) + tuple(mesh.bm1.shape), dtype=torch.float32, device=dev)
    g0 = 11 / 6
    t_pc = time.time()
    pc = build_e_preconditioner(mesh)
    torch.cuda.synchronize()
    t_pc = time.time() - t_pc
    vdiag = helmholtz_diag(mesh, fc.viscosity, g0 / fc.dt, mesh.vmask)
    nsteps, dof = 100, 2 * mesh.nel * mesh.npts
    # once, as ExponentialPropagator builds them
    orders = ns.bdf_orders(fc, nsteps)
    psolves = ns.pressure_solvers(mesh, fc, orders, pc)
    vsolves = ns.velocity_solvers(mesh, fc, orders, vdiag, None)

    def prop(u, nst=nsteps, stats=None):
        return propagate(mesh, cfg, base_u, th, u, th, nst, pc_e=pc, vdiag=vdiag,
                         psolves=psolves, vsolves=vsolves, stats=stats)[0]

    def bnorm(u):
        # at the floor the inner solves exit at once and the map returns
        # zero, which stays zero (0/0 would feed NaN to the next call)
        return u / sem.mass_dot(mesh, u, u).sqrt().clamp_min(torch.finfo(u.dtype).tiny)

    def timed(state, scale, reps=3, fn=prop):
        """-> (s per call, kernel runs per step from the device counter,
        mean CG iterations per step {helmholtz, pressure}, last state)."""
        state = scale * bnorm(fn(state))  # warm-up
        stats = {}
        n0 = hk.launches(dev)  # synchronizes
        t1 = time.time()
        for _ in range(reps):
            state = scale * bnorm(fn(state, stats=stats))
        torch.cuda.synchronize()
        seconds = (time.time() - t1) / reps
        iters = {k: statistics.mean(v) for k, v in stats.items()}
        return seconds, (hk.launches(dev) - n0) / (reps * nsteps), iters, state

    gen = torch.Generator(device=dev)
    gen.manual_seed(42)

    def fresh():
        return bnorm(mesh.vmask * sem.dsavg(mesh, torch.randn(
            (2,) + tuple(mesh.bm1.shape), generator=gen, dtype=torch.float32, device=dev)))

    s_sus, launches_per_step, iters_sus, state = timed(fresh(), 1.0)
    assert bool(torch.isfinite(state).all()) and launches_per_step > 0
    s_floor, _, iters_floor, _ = timed(1e-8 * state, 1e-8)
    # the first step's CG counts from a fresh random field (BDF1, the ramp)
    first = {}
    prop(fresh(), nst=1, stats=first)

    cfg_adj = LinConfig(flow=dataclasses.replace(fc, vtol=0.1 * fc.vtol, ptol=0.1 * fc.ptol))
    t_rec = time.time()
    adj = make_adjoint_propagator(mesh, cfg_adj, base_u, th, nsteps, pc_e=pc, vdiag=vdiag)
    torch.cuda.synchronize()
    t_rec = time.time() - t_rec
    s_adj, adj_runs_per_step, adj_iters, adj_state = timed(
        fresh(), 1.0, fn=lambda u, stats=None: adj(u, th, stats=stats)[0])
    s_dir2, _, _, _ = timed(fresh(), 1.0)
    assert bool(torch.isfinite(adj_state).all()) and adj.tape_bytes > 0
    phase("box2d", t0, dof=dof, nsteps=nsteps, ms_per_step=1e3 * s_sus / nsteps,
          ms_per_step_floor=1e3 * s_floor / nsteps, dof_steps_per_s=dof * nsteps / s_sus,
          cg_iters_per_step=iters_sus, cg_iters_per_step_floor=iters_floor,
          cg_iters_first_step_fresh=first, pc_build_s=t_pc,
          kernel_runs_per_step=launches_per_step,
          adjoint_ms_per_step=1e3 * s_adj / nsteps,
          direct_ms_per_step_after_adjoint=1e3 * s_dir2 / nsteps,
          adjoint_over_direct=2 * s_adj / (s_sus + s_dir2),
          adjoint_cg_iters_per_step=adj_iters, adjoint_kernel_runs_per_step=adj_runs_per_step,
          adjoint_build_s=t_rec, tape_bytes=adj.tape_bytes)


# depth cuts that keep the whole run inside its limit (PERF.md section 4):
# the examples ask for 10 eigenvalues at Re=7500, 4 at Re=500 and 4 on the
# cylinder; the phases assert the TS mode, the two shear modes and the
# shedding mode
NEV_RE7500, NEV_RE500, NEV_CYLINDER = 2, 2, 2


def main_path_phase(dev) -> tuple[int, complex]:
    """Phase 6: Poiseuille Re=7500 `medium` (examples/poiseuille_stability.py:
    51-75, at nev = NEV_RE7500), f32, through the user entry points. Returns
    the kernel runs it made, graph replays included, from the device counter
    set to zero just before, and the leading multiplier mu_1."""
    from neklab_tpu_torch.analysis import linear_stability_analysis_fixed_point
    from neklab_tpu_torch.ops import helmholtz_kernel as hk
    from neklab_tpu_torch.utils.orr_sommerfeld import orr_sommerfeld_spectrum
    from neklab_tpu_torch.vectors import flow_vector_space

    t0 = time.time()
    re = 7500.0
    hk.reset_launches(dev)
    mesh, expA = poiseuille(dev, torch.float32, (12, 10), 8, re, 1e-7)
    res = linear_stability_analysis_fixed_point(expA, flow_vector_space(mesh, 0), kdim=96,
                                                nev=NEV_RE7500, tol=1e-6, maxiter=10)
    launches = hk.launches(dev)
    assert launches > 0
    assert np.all(np.isfinite(res.eigvals))
    os_lead = orr_sommerfeld_spectrum(re, 1.0, 128)[0]
    dist = np.minimum(np.abs(res.eigvals - os_lead), np.abs(res.eigvals - np.conj(os_lead)))
    i = int(np.argmin(dist))
    nearest = res.eigvals[i]
    phase("re7500", t0, eigvals=[[v.real, v.imag] for v in res.eigvals],
          residuals=res.residuals.tolist(), lambda1=[res.eigvals[0].real, res.eigvals[0].imag],
          nearest=[nearest.real, nearest.imag], oracle=[os_lead.real, os_lead.imag],
          dist=float(dist[i]), nearest_residual=float(res.residuals[i]),
          unstable=bool(nearest.real > 0), n_matvec=res.n_matvec, nsteps=expA.nsteps,
          dt=expA.dt, seconds=res.elapsed, launches=launches)
    assert dist[i] < 2e-3, (nearest, os_lead, dist[i])
    assert res.residuals[i] < 1e-5, res.residuals[i]
    return launches, complex(res.multipliers[0])


class Counted:
    """A propagator seen through its matvec and rmatvec, each timed on the
    host and its kernel runs read from the device counter around it (the
    reads synchronize the card; every call already ends in host reads)."""

    def __init__(self, op, dev):
        self.op, self.dev, self.tau = op, dev, getattr(op, "tau", None)
        self.seconds = {"matvec": [], "rmatvec": []}
        self.runs = {"matvec": [], "rmatvec": []}

    def _call(self, name, x):
        from neklab_tpu_torch.ops import helmholtz_kernel as hk

        n0 = hk.launches(self.dev)
        t0 = time.perf_counter()
        y = getattr(self.op, name)(x)
        n1 = hk.launches(self.dev)
        self.seconds[name].append(time.perf_counter() - t0)
        self.runs[name].append(n1 - n0)
        return y

    def matvec(self, x):
        return self._call("matvec", x)

    def rmatvec(self, x):
        return self._call("rmatvec", x)


def growth_phase(dev, mu1: complex) -> tuple[int, int]:
    """Phase 7: transient growth of Poiseuille Re=7500 `medium`, f32 (the
    phase-6 configuration), through the user entry points: every Lanczos
    iteration one matvec and one rmatvec, both running the kernel inside
    graphed CGs. The first rmatvec builds the adjoint (its solvers, captures
    and tape). Asserts the triplet identity ||M v1 - sigma1 u1||_B <= 1e-3
    sigma1 and non-normal growth sigma1 > 1.001 |mu_1|; prints the f32
    B-adjoint identity. Returns the kernel runs of the phase, from the
    device counter set to zero just before, and those of its rmatvecs."""
    from neklab_tpu_torch.analysis import transient_growth_analysis_fixed_point
    from neklab_tpu_torch.ops import helmholtz_kernel as hk
    from neklab_tpu_torch.ops import sem
    from neklab_tpu_torch.vectors import flow_vector_space

    t0 = time.time()
    hk.reset_launches(dev)
    mesh, expA = poiseuille(dev, torch.float32, (12, 10), 8, 7500.0, 1e-7)
    space = flow_vector_space(mesh, 0)
    op = Counted(expA, dev)
    res = transient_growth_analysis_fixed_point(op, space, kdim=32, nsv=2)
    launches = hk.launches(dev)
    mv = expA.matvec(res.optimal_inputs[0])
    diff = {k: mv[k] - float(res.sigma[0]) * res.optimal_outputs[0][k] for k in mv}
    triplet = space.norm(diff) / float(res.sigma[0])
    # the f32 B-adjoint identity on conforming random vectors
    u, v = space.rand(1), space.rand(2)
    lhs = space.dot(expA.matvec(u), v)
    rhs = space.dot(u, expA.rmatvec(v))
    med = {k: statistics.median(v[1:]) for k, v in op.seconds.items()}
    phase("growth", t0, sigma=res.sigma.tolist(), residuals=res.residuals.tolist(),
          n_matvec=res.n_matvec, seconds=res.elapsed, nsteps=expA.nsteps,
          triplet_rel=triplet, mu1_abs=abs(mu1), sigma1_over_mu1=float(res.sigma[0]) / abs(mu1),
          s_per_matvec_median=med["matvec"], s_per_rmatvec_median=med["rmatvec"],
          rmatvec_over_matvec=med["rmatvec"] / med["matvec"],
          first_rmatvec_s=op.seconds["rmatvec"][0], kernel_runs_per_matvec=op.runs["matvec"],
          kernel_runs_per_rmatvec=op.runs["rmatvec"], launches=launches,
          b_adjoint_identity_rel=abs(lhs - rhs) / abs(lhs), lhs=lhs, rhs=rhs,
          tape_bytes=expA.adjoint.tape_bytes)
    assert np.all(np.isfinite(res.sigma))
    assert triplet <= 1e-3, triplet
    assert res.sigma[0] > 1.001 * abs(mu1), (res.sigma[0], mu1)
    return launches, sum(op.runs["rmatvec"])


ORACLE_MU1, ORACLE_BAND = 1.0156, 1e-4  # the reference's cylinder Re=50 oracle (BASELINE.md)


def cylinder_phase(dev, dtype=torch.float32, nspin: int = 8000, kdim: int = 64,
                   maxiter: int = 12) -> dict:
    """Phase 8: the cylinder wake at Re=50, `medium` preset
    (examples/cylinder_stability.py:56-99), in dtype (f32; `python3
    chip_smoke.py --cylinder float64` runs it alone in f64, which separates
    the mesh's distance from the oracle from float32's), through the user entry
    points: `annulus_mesh` (160 elements, order 6, 'vO'), `advance` from the
    example's smooth start with the free stream as the inflow lift (nspin
    steps), `FixedPointSystem` (tau = 0.5) and `newton_fixed_point_iteration`
    (tol 2e-4, GMRES kdim 30), then `ExponentialPropagator` (tau = 1.0) about
    the Newton base flow and `linear_stability_analysis_fixed_point`
    (nev = NEV_CYLINDER, tol 1e-5). Asserts Newton's convergence, an
    unstable leading mode and a shedding frequency 0.6 < omega < 0.9;
    prints |mu_1| beside the oracle band (f32 on this mesh is not expected
    to reach it). Returns the kernel runs of each part, from the device
    counter set to zero before it."""
    from neklab_tpu_torch.analysis import (linear_stability_analysis_fixed_point,
                                           newton_fixed_point_iteration)
    from neklab_tpu_torch.linops.exponential_propagator import ExponentialPropagator
    from neklab_tpu_torch.models.linearized import LinConfig
    from neklab_tpu_torch.models.navier_stokes import FlowConfig, advance, initial_state
    from neklab_tpu_torch.models.precond import build_e_preconditioner
    from neklab_tpu_torch.ops import helmholtz_kernel as hk
    from neklab_tpu_torch.systems.fixed_point import FixedPointSystem
    from neklab_tpu_torch.vectors import flow_vector, flow_vector_space

    t0 = time.time()
    mesh = cylinder_mesh(dev, dtype)
    dt = 5e-3
    fc = FlowConfig(viscosity=1 / 50, dt=dt, vtol=3e-6, ptol=3e-6)
    cfg = LinConfig(flow=fc)
    ub, r = cylinder_lift(mesh)
    ramp = 1 - torch.exp(-3.0 * (r - 0.5))
    st = initial_state(mesh, fc, u=mesh.vmask * torch.stack([ramp, 0 * ramp]) + (1 - mesh.vmask) * ub)
    space = flow_vector_space(mesh, 0)
    runs, seconds = {}, {}

    hk.reset_launches(dev)
    t1 = time.time()
    spin_stats = {}
    st = advance(mesh, fc, st, nspin, ub=ub, pc_e=build_e_preconditioner(mesh), stats=spin_stats)
    runs["spin-up"] = hk.launches(dev)  # synchronizes
    seconds["spin-up"] = time.time() - t1
    assert bool(torch.isfinite(st.u).all())

    hk.reset_launches(dev)
    t1 = time.time()
    system = FixedPointSystem(mesh, cfg, tau=0.5, ub=ub, dt=dt)
    nres = newton_fixed_point_iteration(system, flow_vector(mesh, 0, u=st.u), space, tol=2e-4,
                                        maxiter=15, gmres_kdim=30)
    runs["newton"] = hk.launches(dev)
    seconds["newton"] = time.time() - t1

    hk.reset_launches(dev)
    t1 = time.time()
    expA = ExponentialPropagator(mesh, cfg, nres.x["u"], tau=1.0, dt=dt)
    eres = linear_stability_analysis_fixed_point(expA, space, kdim=kdim, nev=NEV_CYLINDER,
                                                 tol=1e-5, maxiter=maxiter)
    runs["eigensolve"] = hk.launches(dev)
    seconds["eigensolve"] = time.time() - t1

    mu1 = complex(eres.multipliers[0])
    lam1 = complex(eres.eigvals[0])
    omega = abs(lam1.imag)
    phase("cylinder", t0, nel=mesh.nel, order=mesh.basis.n - 1, dt=dt, nspin=nspin,
          spinup_s=seconds["spin-up"], spinup_ms_per_step=1e3 * seconds["spin-up"] / nspin,
          spinup_cg_iters_per_step={k: statistics.mean(v) for k, v in spin_stats.items()},
          newton_converged=nres.converged, newton_iterations=nres.iterations,
          newton_history=nres.history, gmres_matvecs=nres.matvecs, newton_s=seconds["newton"],
          newton_nsteps=next(iter(system.derived.values())).nsteps,
          newton_solver_sets=len(system.derived), eig_nsteps=expA.nsteps,
          eig_n_matvec=eres.n_matvec, eig_s=seconds["eigensolve"],
          eigvals=[[v.real, v.imag] for v in eres.eigvals], residuals=eres.residuals.tolist(),
          mu1=[mu1.real, mu1.imag], mu1_abs=abs(mu1), sigma=lam1.real, omega=omega,
          oracle_mu1_abs=ORACLE_MU1, oracle_band=ORACLE_BAND,
          in_oracle_band=abs(abs(mu1) - ORACLE_MU1) <= ORACLE_BAND, kernel_runs=runs)
    assert nres.converged, nres.history
    assert len(system.derived) == 1  # one solver set: the fixed dt
    assert abs(mu1) > 1.0, mu1
    assert 0.6 < omega < 0.9, lam1
    return runs


# the example sweeps 0.6, 0.8, 1.0 and 1.2; the two ends keep the run inside
# its limit (PERF.md section 4)
RESOLVENT_OMEGAS = (0.6, 1.2)


def resolvent_phase(dev, omegas=RESOLVENT_OMEGAS) -> dict:
    """The resolvent sweep of examples/resolvent_sweep.py at its full mesh
    (at the frequencies `omegas`), f32:
    the plane channel of 8 x 6 elements at order 6, Re = 60, dt = 0.02,
    vtol = ptol = 1e-7, GMRES rtol 1e-6, the Gaussian actuator (x, y) =
    (1, -0.4) and sensor (4, 0.4), one E preconditioner for the sweep.
    Prints the sensor amplitude, the GMRES matvecs and the seconds of every
    omega, then the Hermitian identity Re<Rf, g> = Re<f, R*g> at the last
    omega (f the actuator, g a random pair), then, in f64, the closed-form
    Stokes resolvent (i w - A)^-1 f = f / (i w + nu k^2) of
    tests/test_resolvent.py:23 (assert 2e-4 relative). Returns the kernel
    runs of the sweep and the identity, and of the Stokes check."""
    from neklab_tpu_torch.linops.resolvent import Resolvent, complex_pair_space
    from neklab_tpu_torch.mesh.box import box_mesh
    from neklab_tpu_torch.models.linearized import LinConfig
    from neklab_tpu_torch.models.navier_stokes import FlowConfig
    from neklab_tpu_torch.models.precond import build_e_preconditioner
    from neklab_tpu_torch.ops import helmholtz_kernel as hk
    from neklab_tpu_torch.ops import sem

    t0 = time.time()
    runs = {}
    hk.reset_launches(dev)
    mesh = channel(dev, torch.float32, (8, 6), 6)
    cfg = LinConfig(flow=FlowConfig(viscosity=1 / 60, dt=1.0, vtol=1e-7, ptol=1e-7))
    y = mesh.x[1]
    base = torch.stack([1 - y**2, 0 * y])
    gauss = lambda x0, y0: torch.exp(-((mesh.x[0] - x0) ** 2 + (mesh.x[1] - y0) ** 2) / 0.1)
    f_re = mesh.vmask * torch.stack([0 * y, gauss(1.0, -0.4)])
    sensor = gauss(4.0, 0.4)
    snorm = float(sem.mass_dot(mesh, sensor, sensor))
    th = torch.zeros((0,) + tuple(mesh.bm1.shape), dtype=torch.float32, device=dev)
    f = {"re": {"u": f_re, "theta": th}, "im": {"u": 0 * f_re, "theta": th}}
    pc = build_e_preconditioner(mesh)
    rows = []
    for omega in omegas:
        t1 = time.time()
        R = Resolvent(mesh, cfg, base, omega=omega, dt=0.02, gmres_rtol=1e-6, pc_e=pc)
        x = R.matvec(f)
        a_re = float(sem.mass_dot(mesh, sensor, x["re"]["u"][1]))
        a_im = float(sem.mass_dot(mesh, sensor, x["im"]["u"][1]))
        energy = float(torch.sqrt(sem.mass_dot(mesh, x["re"]["u"], x["re"]["u"])
                                  + sem.mass_dot(mesh, x["im"]["u"], x["im"]["u"])))
        rows.append({"omega": omega, "nsteps": R.nsteps, "amplitude": float(np.hypot(a_re, a_im)
                     / np.sqrt(snorm)), "energy": energy, "gmres_matvecs": R.last_gmres_matvecs,
                     "seconds": time.time() - t1})
        print("resolvent " + json.dumps(rows[-1]), flush=True)
        assert np.isfinite(energy) and energy > 0, rows[-1]
    space = complex_pair_space(mesh, 0)
    g = space.rand(5)
    t1 = time.time()
    rg = R.rmatvec(g)
    rmatvec_s, rmatvec_gmres = time.time() - t1, R.last_gmres_matvecs
    lhs, rhs = space.dot(x, g), space.dot(f, rg)
    identity = abs(lhs - rhs) / abs(lhs)
    runs["sweep"] = hk.launches(dev)

    hk.reset_launches(dev)
    t1 = time.time()
    stokes = box_mesh((3, 3), ((0.0, 2 * np.pi), (0.0, 2 * np.pi)),
                      {"x-": "P", "x+": "P", "y-": "P", "y+": "P"}, order=6, device=dev)
    nu, omega = 0.1, 1.3
    R = Resolvent(stokes, LinConfig(flow=FlowConfig(viscosity=nu, dt=1.0, vtol=1e-12,
                                                    ptol=1e-12)),
                  torch.zeros((2,) + tuple(stokes.bm1.shape), dtype=torch.float64, device=dev),
                  omega=omega, dt=0.02, gmres_rtol=1e-10)
    x, y = stokes.x[0], stokes.x[1]
    fmode = torch.stack([torch.sin(x) * torch.cos(y), -torch.cos(x) * torch.sin(y)])
    zero = torch.zeros((0,) + tuple(stokes.bm1.shape), dtype=torch.float64, device=dev)
    xhat = R.matvec({"re": {"u": fmode, "theta": zero}, "im": {"u": 0 * fmode, "theta": zero}})
    nrm = float(sem.mass_dot(stokes, fmode, fmode))
    got = complex(float(sem.mass_dot(stokes, xhat["re"]["u"], fmode)) / nrm,
                  float(sem.mass_dot(stokes, xhat["im"]["u"], fmode)) / nrm)
    expect = 1.0 / (1j * omega + nu * 2.0)
    stokes_rel = abs(got - expect) / abs(expect)
    runs["stokes"] = hk.launches(dev)
    phase("resolvent", t0, nel=mesh.nel, order=mesh.basis.n - 1, rows=rows,
          hermitian_identity_rel=identity, lhs=lhs, rhs=rhs, rmatvec_s=rmatvec_s,
          rmatvec_gmres_matvecs=rmatvec_gmres,
          stokes=[got.real, got.imag], stokes_expect=[expect.real, expect.imag],
          stokes_rel=stokes_rel, stokes_nsteps=R.nsteps, stokes_gmres_matvecs=R.last_gmres_matvecs,
          stokes_s=time.time() - t1, kernel_runs=runs)
    assert identity <= 1e-3, (lhs, rhs)
    assert stokes_rel <= 2e-4, (got, expect)
    return runs


UPO_MU = (1.0000108728713846, 0.9123051165132466)  # UPO_r05.json: |mu| neutral, leading
UPO_F = 2.2165970612221577e-07  # UPO_r05.json: the reference's |F| at this orbit


# the Floquet eigensolve: the example's Krylov dimension and f64 tolerance
UPO_KDIM, UPO_TOL = 32, 1e-7


def upo_phase(dev, kdim: int = UPO_KDIM) -> dict:
    """The periodic orbit of the cylinder wake at Re = 180 and its Floquet
    multipliers (examples/cylinder_upo.py's --init-state refinement path),
    f64: the annulus of 7 x 18 elements at order 5, r_out 15, grading 1.5,
    shift 0.25, dt 0.01, vtol 1e-10, ptol 1e-9, from the reference's
    converged orbit artifacts/upo_f64.npz. `newton_fixed_point_iteration`
    on `PeriodicOrbitSystem` to 1e-6 stops at iterate 0 (asserts |F| < 1e-6,
    printed beside the reference's 2.2166e-7); then `eigs` over
    `MonodromyOperator` (kdim, nev 3, tol UPO_TOL): the neutral multiplier
    within 1e-4 of 1 and the leading non-neutral |mu| within 1e-3 of
    UPO_r05.json's 0.91231. Returns the kernel runs of Newton and of the
    Floquet eigensolve."""
    from neklab_tpu_torch.analysis import newton_fixed_point_iteration
    from neklab_tpu_torch.krylov.eigs import eigs
    from neklab_tpu_torch.models.linearized import LinConfig
    from neklab_tpu_torch.models.navier_stokes import FlowConfig
    from neklab_tpu_torch.ops import helmholtz_kernel as hk
    from neklab_tpu_torch.systems.periodic_orbit import MonodromyOperator, PeriodicOrbitSystem
    from neklab_tpu_torch.vectors import ext_flow_vector, ext_flow_vector_space, flow_vector_space

    t0 = time.time()
    runs, seconds = {}, {}
    mesh = upo_mesh(dev, torch.float64)
    fc = FlowConfig(viscosity=1 / 180, dt=0.01, vtol=1e-10, ptol=1e-9)
    ub, _ = cylinder_lift(mesh)
    with np.load(os.path.join(ROOT, "artifacts", "upo_f64.npz")) as z:
        u0, period0 = torch.as_tensor(z["u"], dtype=torch.float64, device=dev), float(z["T"])

    hk.reset_launches(dev)
    t1 = time.time()
    system = PeriodicOrbitSystem(mesh, LinConfig(flow=fc), t_guess=period0, ub=ub)
    nres = newton_fixed_point_iteration(system, ext_flow_vector(mesh, 0, u=u0, T=period0),
                                        ext_flow_vector_space(mesh, 0), tol=1e-6, maxiter=4,
                                        gmres_kdim=40)
    runs["newton"] = hk.launches(dev)
    seconds["newton"] = time.time() - t1
    print("upo " + json.dumps({"F": nres.history[0], "reference_F": UPO_F, "T": float(nres.x["T"]),
                               "nsteps": system.nsteps, "newton_s": seconds["newton"]}),
          flush=True)

    hk.reset_launches(dev)
    t1 = time.time()
    mono = Counted(MonodromyOperator(system, nres.x), dev)
    eres = eigs(mono, flow_vector_space(mesh, 0), nev=3, kdim=kdim, tol=UPO_TOL, maxiter=4)
    runs["floquet"] = hk.launches(dev)
    seconds["floquet"] = time.time() - t1
    mus = eres.eigvals
    mod = np.abs(mus)
    neutral = float(np.min(np.abs(mod - 1.0)))
    others = mod[np.abs(mod - 1.0) > 1e-3]
    lead = float(others.max()) if others.size else float("nan")
    phase("upo", t0, nel=mesh.nel, order=mesh.basis.n - 1, nsteps=system.nsteps,
          dt=float(nres.x["T"]) / system.nsteps, F=nres.history[0], reference_F=UPO_F,
          T=float(nres.x["T"]), newton_iterations=nres.iterations,
          newton_converged=nres.converged, newton_s=seconds["newton"],
          floquet_mus=[[m.real, m.imag] for m in mus], floquet_abs=mod.tolist(),
          reference_abs=list(UPO_MU), neutral_dev=neutral, leading_nonneutral=lead,
          residuals=eres.residuals.tolist(), floquet_matvecs=eres.n_matvec,
          floquet_s=seconds["floquet"],
          s_per_monodromy_matvec=statistics.median(mono.seconds["matvec"]),
          kernel_runs_per_monodromy_matvec=statistics.median(mono.runs["matvec"]),
          solver_sets=len(system.derived), kernel_runs=runs)
    assert nres.converged and nres.iterations == 0 and nres.history[0] < 1e-6, nres.history
    assert neutral <= 1e-4, mod
    assert abs(lead - UPO_MU[1]) <= 1e-3, (lead, mod)
    return runs


OTD_ANALYTIC = (-(1 / 500) * (np.pi / 2) ** 2, -(1 / 500) * np.pi**2)


def reference_normal(seed: int, shape) -> np.ndarray:
    """The float32 draw of `jax.random.normal(jax.random.PRNGKey(seed), shape)`
    (threefry2x32 with partitionable bits, the reference's default), in
    numpy: the initial OTD modes of the run recorded in
    artifacts/OTD_r05_re500.json. Its erfinv is scipy's, so a value may
    differ from the reference's in the last bit."""
    from scipy.special import erfinv

    def rotl(x, d):
        return (x << np.uint32(d)) | (x >> np.uint32(32 - d))

    k0, k1 = np.uint32(0), np.uint32(seed)
    ks = (k0, k1, k0 ^ k1 ^ np.uint32(0x1BD11BDA))
    idx = np.arange(int(np.prod(shape)), dtype=np.uint64)
    x = [(idx >> np.uint64(32)).astype(np.uint32) + ks[0], idx.astype(np.uint32) + ks[1]]
    rotations = ((13, 15, 26, 6), (17, 29, 16, 24))
    for i in range(5):
        for r in rotations[i % 2]:
            x[0] = x[0] + x[1]
            x[1] = x[0] ^ rotl(x[1], r)
        x[0] = x[0] + ks[(i + 1) % 3]
        x[1] = x[1] + ks[(i + 2) % 3] + np.uint32(i + 1)
    bits = (x[0] ^ x[1]) >> np.uint32(9) | np.uint32(0x3F800000)
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
    u = np.maximum(lo, (bits.view(np.float32) - np.float32(1.0)) * (np.float32(1.0) - lo) + lo)
    return (np.float32(np.sqrt(2)) * erfinv(u.astype(np.float64)).astype(np.float32)).reshape(shape)


def otd_phase(dev, endtime: float = 200.0) -> dict:
    """OTD modes on the frozen Poiseuille base at Re = 500
    (examples/poiseuille_otd.py as recorded in artifacts/OTD_r05_re500.json),
    f32: a 4 x 6 box at order 6, r = 2, dt from CFL 0.4 (17,670 steps to
    t = 200), vtol = ptol = 3e-7, the reference's cadences (printstep 5,
    orthostep 10, iostep 500, iorststep 500), its files written under
    .scratch/ and removed. The initial modes are the recorded run's (its
    seed 7, `reference_normal`), entered as OTDIC files (`ic_paths`): at
    t = 200 the slower mode's Rayleigh quotient still carries the initial
    modes' decaying part, so the recorded run's error (2.7e-6) holds for
    its own start. Asserts eig(Lr) within 1e-5 of the analytic shear rates
    -nu (pi/2)^2 and -nu pi^2. Returns the kernel runs."""
    import shutil

    from neklab_tpu_torch.models.linearized import LinConfig
    from neklab_tpu_torch.models.navier_stokes import FlowConfig, initial_state
    from neklab_tpu_torch.models.precond import build_e_preconditioner
    from neklab_tpu_torch.ops import helmholtz_kernel as hk
    from neklab_tpu_torch.otd import OtdOpts, otd_analysis
    from neklab_tpu_torch.utils.timestep import cfl_dt

    t0 = time.time()
    hk.reset_launches(dev)
    mesh = channel(dev, torch.float32, (4, 6), 6)
    y = mesh.x[1]
    base_u = torch.stack([1 - y**2, 0 * y])
    dt = cfl_dt(mesh, base_u, cfl=0.4)
    nsteps = int(round(endtime / dt))
    fc = FlowConfig(viscosity=1 / 500, dt=dt, vtol=3e-7, ptol=3e-7)
    opts = OtdOpts(r=2, startstep=1, printstep=5, orthostep=10, iostep=500, iorststep=500)
    outdir = os.path.join(ROOT, ".scratch", "otd_smoke")
    shutil.rmtree(outdir, ignore_errors=True)
    os.makedirs(outdir)
    ics = []
    for i, u in enumerate(reference_normal(7, (2, 2) + tuple(mesh.bm1.shape))):
        ics.append(os.path.join(outdir, f"OTDIC_{i + 1:02d}.npz"))
        np.savez(ics[-1], u=u)
    stats = {}
    t1 = time.time()
    try:
        res = otd_analysis(mesh, LinConfig(flow=fc), opts, initial_state(mesh, fc, u=base_u),
                           nsteps, pc_e=build_e_preconditioner(mesh), outdir=outdir,
                           ic_paths=ics, stats=stats)
        seconds = time.time() - t1
        files = sorted(os.listdir(outdir))
        with open(os.path.join(outdir, "Lr.dat")) as fh:
            lr_rows = sum(1 for _ in fh)
    finally:
        shutil.rmtree(outdir, ignore_errors=True)
    launches = hk.launches(dev)
    lam = np.sort(res.eigvals_lr.real)[::-1]
    err = [float(abs(a - b)) for a, b in zip(lam, OTD_ANALYTIC)]
    per_step = {k: len(v) / nsteps for k, v in stats.items()}
    phase("otd", t0, nel=mesh.nel, dt=dt, nsteps=nsteps, eig_lr=lam.tolist(),
          analytic=list(OTD_ANALYTIC), err=err, seconds=seconds,
          ms_per_step=1e3 * seconds / nsteps, solves_per_step=per_step,
          cg_iters_per_step={k: sum(v) / nsteps for k, v in stats.items()},
          lr_rows=lr_rows, mode_files=sum(f.startswith("m0") for f in files),
          reference_eig_lr=[-0.004934970755130053, -0.01974191516637802],
          restart_files=sum(f.startswith("rst") for f in files),
          kernel_runs=launches, kernel_runs_per_step=launches / nsteps)
    assert max(err) <= 1e-5, (lam, OTD_ANALYTIC)
    assert lr_rows == -(-nsteps // 5)
    return {"otd": launches}


# the schedule: the main process runs MAIN_FIRST, then starts one process
# per group of SIDE (`--side a,b`: those phases one after another) and runs
# MAIN_THEN beside them
MAIN_FIRST = ("kernel", "parity", "nonlinear", "parity_r", "box2d")
SIDE = ("oracle,cylinder", "otd,resolvent", "upo")
MAIN_THEN = ("re7500", "growth")


def run_phase(name: str, dev, state: dict):
    """Runs one named phase; returns the kernel runs of its paths (a dict)
    or None. state carries phase 6's mu_1 to phase 7."""
    if name == "kernel":
        state["kernel"] = kernel_phase(dev)
    elif name == "parity":
        parity_phase(dev)
    elif name == "nonlinear":
        nonlinear_phase(dev)
    elif name == "parity_r":
        parity_r_phase(dev)
    elif name == "box2d":
        box2d_phase(dev)
    elif name == "re7500":
        launches, state["mu1"] = main_path_phase(dev)
        return {"direct eigensolve (phase 6)": launches}
    elif name == "growth":
        launches, state["adjoint_launches"] = growth_phase(dev, state["mu1"])
        return {"transient growth (phase 7)": launches}
    elif name == "oracle":
        return {"projected eigensolve (phase 4)": oracle_phase(dev)["projected"]}
    elif name == "cylinder":
        runs = cylinder_phase(dev)
        return {"cylinder spin-up (phase 8)": runs["spin-up"],
                "cylinder Newton + eigensolve (phase 8)": runs["newton"] + runs["eigensolve"]}
    elif name == "resolvent":
        runs = resolvent_phase(dev)
        return {"resolvent sweep and adjoint (phase 9)": runs["sweep"],
                "resolvent Stokes check (phase 9)": runs["stokes"]}
    elif name == "upo":
        runs = upo_phase(dev)
        return {"periodic-orbit Newton (phase 10)": runs["newton"],
                "Floquet eigensolve (phase 10)": runs["floquet"]}
    elif name == "otd":
        return {"OTD (phase 11)": otd_phase(dev)["otd"]}
    else:
        raise SystemExit(f"chip_smoke: no phase {name!r}")
    return None


def main() -> None:
    # one card: the first visible one (before CUDA starts, so the count below
    # is the number of cards this run uses)
    os.environ["CUDA_VISIBLE_DEVICES"] = os.environ.get("CUDA_VISIBLE_DEVICES", "0").split(",")[0]
    t_start = time.time()
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() is False)")
    import neklab_tpu_torch  # noqa: F401  (sets the TF32 switches)
    from neklab_tpu_torch.ops import _build

    dev = torch.device("cuda", 0)
    assert torch.cuda.device_count() == 1
    args = sys.argv[1:]
    if args[:1] == ["--cylinder"] and args[1:]:
        cylinder_phase(dev, getattr(torch, args[1]))
        return
    if args[:1] == ["--side"]:
        runs: dict = {}
        for name in args[1].split(","):
            runs.update(run_phase(name, dev, {}) or {})
        print("launches " + json.dumps(runs), flush=True)
        return
    if args[:1] == ["--only"]:
        # the named phases alone, one after another in this process
        _build.build()
        state: dict = {}
        for name in args[1].split(","):
            print(f"launches {name} " + json.dumps(run_phase(name, dev, state)), flush=True)
        print(f"chip_smoke: {time.time() - t_start:.1f} s in all", flush=True)
        return

    # ---- 0: device ----
    t0 = time.time()
    smi = nvidia_smi()
    print(smi, flush=True)
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    phase("device", t0, name=torch.cuda.get_device_name(0), smi=smi, torch=torch.__version__,
          cuda=torch.version.cuda)

    # ---- 1: build ----
    t0 = time.time()
    _build.build()
    phase("build", t0, seconds=_build.last_build["seconds"],
          ptxas=ptxas_report(_build.last_build["log"]))

    state: dict = {}
    for name in MAIN_FIRST:
        run_phase(name, dev, state)

    # each side process writes to a file of its own (under .scratch/, which
    # git ignores), so what it printed survives its being stopped
    logdir = os.path.join(ROOT, ".scratch")
    os.makedirs(logdir, exist_ok=True)
    logs = {group: open(os.path.join(logdir, f"side_{i}.log"), "w+")
            for i, group in enumerate(SIDE)}
    side = {group: subprocess.Popen([sys.executable, os.path.abspath(__file__), "--side", group],
                                    stdout=logs[group], text=True)
            for group in SIDE}
    by_path = {}
    try:
        for name in MAIN_THEN:
            by_path.update(run_phase(name, dev, state) or {})
        for proc in side.values():
            # the whole run stays inside 1200 s
            try:
                proc.wait(timeout=max(1.0, t_start + 1150 - time.time()))
            except subprocess.TimeoutExpired:
                pass
    finally:
        for proc in side.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        outs = {}
        for group, log in logs.items():
            log.seek(0)
            outs[group] = log.read()
            log.close()
            print(outs[group], end="", flush=True)
    for group, proc in side.items():
        if proc.returncode != 0:
            raise SystemExit(f"chip_smoke: phases {group} failed (exit {proc.returncode})")
        (line,) = [ln for ln in outs[group].splitlines() if ln.startswith("launches ")]
        by_path.update(json.loads(line[len("launches "):]))

    print(f"chip_smoke: {time.time() - t_start:.1f} s in all", flush=True)
    print(nvidia_smi(), flush=True)
    print(json.dumps({"kernels": [{
        "name": "helmholtz2d",
        "route": "cuda",
        "source": "neklab_tpu_torch/csrc/helmholtz2d.cu",
        "replaces": "neklab_tpu/ops/pallas_kernels.py:54",
        "launches": sum(by_path.values()),
        "launches_by_path": by_path,
        "adjoint_launches": state["adjoint_launches"],
        **state["kernel"],
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                              "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
