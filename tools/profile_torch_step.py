"""Where the time of one step goes on a CUDA card, for the port
(neklab_tpu_torch), f32 (the thermosyphon cases f64).

    python3 tools/profile_torch_step.py [--cases re7500,box2d,re7500-adjoint,box2d-adjoint,
                                                 cyl50-nonlinear,otd500-otd,box3d,
                                                 thermosyphon-nonlinear,thermosyphon-linearized]
                                        [--nsteps 20] [--recycle 0,8]

Cases: `re7500` is the Poiseuille Re=7500 `medium` propagator of
chip_smoke.py phases 6 and 7 (the main paths; dt as ExponentialPropagator
derives it), `box2d` the box2d 131k propagator of phase 5, `box3d` the
3-D duct of phase 14 (bench.py:312-345: 12 x 12 x 12 elements at order 5,
1,119,744 velocity DOF, the default 3-D preconditioner at dt/(11/6)). A
case with
`-adjoint` profiles the same propagator's exact adjoint instead (an
`AdjointPropagator` recorded over the window's `nsteps` steps, at
ExponentialPropagator's adjoint tolerances, 10x tighter); its "step" is one
step of the backward pass. `cyl50-nonlinear` is the nonlinear step of the
cylinder wake at Re=50 (`medium`, phase 8: 160 elements at order 6, dt =
5e-3, the free stream as the inflow lift), continuing from 200 steps of the
example's smooth start. `otd500-otd` is the OTD run of chip_smoke.py's
phase 11 (r = 2 modes on the frozen Poiseuille base at Re = 500, a 4 x 6
box at order 6, dt from CFL 0.4, vtol = ptol = 3e-7): `otd_chunk` in
chunks of 5 steps, as `otd_analysis` runs it at the reference's cadences,
each chunk ending in an orthonormalization and Lr read on the host; its
"step" advances both modes. `thermosyphon-nonlinear` and
`thermosyphon-linearized` are chip_smoke.py phase 18's scalar-coupled
steps (nscal = 1), f64: the heated `medium` annulus (80 elements at order
6, Pr 0.2, Ra 510, dt 2.5e-3, the wall temperature as the scalar's lift),
continuing from 400 spin-up steps: the Boussinesq step itself, and the
linearized step of a (u, theta) perturbation about the spun-up state (its
velocity, pressure and scalar solves; B-normalized per call). For each,
from a B-normalized state (the
sustained protocol; the nonlinear and OTD cases from their own states):
  * host ms/step of three unprofiled windows of `nsteps` steps;
  * velocity (Helmholtz), pressure (E) and scalar CG iterations per step,
    as the solvers report them (`propagate(..., stats=)`,
    `advance(..., stats=)`);
  * helmholtz2d kernel runs per step, from the kernel's device counter
    (graph replays included);
  * one `torch.profiler` window: the host's launch calls per step
    (`cudaLaunchKernel` and `cudaGraphLaunch` events of its CPU trace; unlike
    ms/step, this count does not move with the host's load), device-busy
    ms/step (summed kernel and copy times) and its share of the profiled
    wall time, device operations per step, and the top operations by device
    time;
  * on a 3-D mesh, the device ms of one 3-D Helmholtz apply at the velocity
    CG's shape (CUDA events, calls queued behind a sleep) and the share of
    the step's device-busy time that one apply per velocity CG iteration
    and one per solve's right-hand side take.
`--recycle K1,K2,...` profiles each direct and nonlinear case once per K
with `recycle=K` (Nek5000's residual projection of the pressure solves;
0, the default, is the plain path), one line each, in that order: the
propagator recycles after each call's BDF ramp, the nonlinear case over
each whole call (it continues at the scheme's order). The adjoint and OTD
cases have no recycling and run once. One JSON line per case and K.
Needs a CUDA card; imports no jax.
"""

import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

CHANNEL = {"x-": "P", "x+": "P", "y-": "W", "y+": "W"}
DUCT = {"x-": "P", "x+": "P", "y-": "W", "y+": "W", "z-": "W", "z+": "W"}
# the runtime calls by which the host puts work on the card
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cudaGraphLaunch")


def build_case(name, dev):
    """-> (mesh, cfg, cfg_adj, base_u, pc_e, vdiag, psolves, vsolves) for
    `propagate` and `make_adjoint_propagator`."""
    from neklab_tpu_torch.linops.exponential_propagator import ExponentialPropagator
    from neklab_tpu_torch.mesh.box import box_mesh
    from neklab_tpu_torch.models import navier_stokes as ns
    from neklab_tpu_torch.models.linearized import LinConfig
    from neklab_tpu_torch.models.navier_stokes import FlowConfig, helmholtz_diag
    from neklab_tpu_torch.models.precond import build_e_preconditioner

    lims = ((0.0, 2 * np.pi), (-1.0, 1.0))
    if name == "re7500":
        mesh = box_mesh((12, 10), lims, CHANNEL, order=8, dtype=torch.float32, device=dev)
        fc = FlowConfig(viscosity=1 / 7500, dt=1e-2, vtol=1e-7, ptol=1e-7)
    elif name == "box2d":
        mesh = box_mesh((64, 16), lims, CHANNEL, order=7, dtype=torch.float32, device=dev)
        fc = FlowConfig(viscosity=1e-3, dt=2e-3, vtol=1e-5, ptol=1e-5, vmaxit=50, pmaxit=120)
    elif name == "box3d":
        mesh = box_mesh((12, 12, 12), ((0.0, 4.0), (-1.0, 1.0), (-1.0, 1.0)), DUCT, order=5,
                        dtype=torch.float32, device=dev)
        fc = FlowConfig(viscosity=1e-3, dt=2e-3, vtol=1e-5, ptol=1e-5, vmaxit=60, pmaxit=150)
    else:
        raise SystemExit(f"unknown case {name!r}")
    y = mesh.x[1]
    if mesh.ndim == 3:
        base_u = torch.stack([(1 - y**2) * (1 - mesh.x[2] ** 2), 0 * y, 0 * y])
    else:
        base_u = torch.stack([1 - y**2, 0 * y])
    if name == "re7500":  # the main path's propagator: dt from the CFL target
        op = ExponentialPropagator(mesh, LinConfig(flow=fc), base_u, tau=0.5, cfl=0.5)
        return mesh, op.cfg, op.cfg_adj, base_u, op.pc_e, op.vdiag, op.psolves, op.vsolves
    # box2d, box3d: bench.py's fixed dt, set up as ExponentialPropagator would
    # (box3d's preconditioner at bench.py's dt/(11/6))
    cfg = LinConfig(flow=fc)
    cfg_adj = LinConfig(flow=dataclasses.replace(fc, vtol=0.1 * fc.vtol, ptol=0.1 * fc.ptol))
    pc = build_e_preconditioner(mesh, fc.dt / (11 / 6) if mesh.ndim == 3 else 1.0)
    vdiag = helmholtz_diag(mesh, fc.viscosity, (11 / 6) / fc.dt, mesh.vmask)
    orders = ns.bdf_orders(fc, 3)
    return (mesh, cfg, cfg_adj, base_u, pc, vdiag, ns.pressure_solvers(mesh, fc, orders, pc),
            ns.velocity_solvers(mesh, fc, orders, vdiag, None))


def nonlinear_case(dev, nsteps, recycle=0):
    """-> (mesh, dt, run, state) for the cylinder's nonlinear step: run(state,
    stats) advances nsteps at the scheme's order with solvers built once."""
    from neklab_tpu_torch.mesh.cylinder import annulus_mesh
    from neklab_tpu_torch.models import navier_stokes as ns
    from neklab_tpu_torch.models.precond import build_e_preconditioner

    mesh = annulus_mesh(8, 20, r_in=0.5, r_out=20.0, order=6, grading=1.5, outer_bc="vO",
                        shift=0.25, dtype=torch.float32, device=dev)
    fc = ns.FlowConfig(viscosity=1 / 50, dt=5e-3, vtol=3e-6, ptol=3e-6)
    r = torch.sqrt(mesh.x[0] ** 2 + mesh.x[1] ** 2)
    free = (r > 0.5 + 1e-8).to(mesh.dtype)
    ub = torch.stack([free, torch.zeros_like(free)])
    ramp = 1 - torch.exp(-3.0 * (r - 0.5))
    state = ns.initial_state(mesh, fc, u=mesh.vmask * torch.stack([ramp, 0 * ramp])
                             + (1 - mesh.vmask) * ub)
    orders = ns.bdf_orders(fc, 3)
    psolves = ns.pressure_solvers(mesh, fc, orders, build_e_preconditioner(mesh))
    vsolves = ns.velocity_solvers(mesh, fc, orders, *ns.bdf3_diags(mesh, fc))
    state = ns.advance(mesh, fc, state, 200, ub=ub, psolves=psolves, vsolves=vsolves)

    def run(st, stats=None):
        return ns.advance(mesh, fc, st, nsteps, ub=ub, ramp=False, psolves=psolves,
                          vsolves=vsolves, stats=stats, recycle=recycle)

    return mesh, fc.dt, run, state


def otd_case(dev, nsteps):
    """-> (mesh, dt, run, state) for the OTD step: run(state, stats) evolves
    (base, modes) nsteps in chunks of 5 steps with solvers built once."""
    from neklab_tpu_torch.mesh.box import box_mesh
    from neklab_tpu_torch.models import navier_stokes as ns
    from neklab_tpu_torch.models.linearized import LinConfig, pert_initial
    from neklab_tpu_torch.models.precond import build_e_preconditioner
    from neklab_tpu_torch.otd import (OtdOpts, _stack, orthonormalize_states, otd_chunk,
                                      otd_solvers)
    from neklab_tpu_torch.ops import sem
    from neklab_tpu_torch.utils.timestep import cfl_dt

    mesh = box_mesh((4, 6), ((0.0, 2 * np.pi), (-1.0, 1.0)), CHANNEL, order=6,
                    dtype=torch.float32, device=dev)
    y = mesh.x[1]
    base_u = torch.stack([1 - y**2, 0 * y])
    fc = ns.FlowConfig(viscosity=1 / 500, dt=cfl_dt(mesh, base_u, cfl=0.4), vtol=3e-7,
                       ptol=3e-7)
    cfg, opts = LinConfig(flow=fc), OtdOpts(r=2, printstep=5, orthostep=10)
    solvers = otd_solvers(mesh, cfg, build_e_preconditioner(mesh))
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    modes = [mesh.vmask * sem.dsavg(mesh, torch.randn((2,) + tuple(mesh.bm1.shape),
                                                      generator=gen, dtype=mesh.dtype,
                                                      device=dev)) for _ in range(2)]
    perts = orthonormalize_states(mesh, _stack([pert_initial(mesh, cfg, m) for m in modes]))
    state = (ns.initial_state(mesh, fc, u=base_u), perts)

    def run(st, stats=None, ramp=False):
        base, perts = st
        for _ in range(nsteps // 5):
            base, perts, lr = otd_chunk(mesh, cfg, opts, base, perts, 5, ramp=ramp,
                                        ortho_every=opts.orthostep, solvers=solvers,
                                        stats=stats)
            lr.cpu()
            ramp = False
        return base, perts

    return mesh, fc.dt, run, run(state, ramp=True)


def thermosyphon_case(dev, nsteps, kind, recycle=0):
    """-> (mesh, dt, run, state) for chip_smoke.py phase 18's scalar-coupled
    steps at its `medium` width, f64, after 400 spin-up steps: kind
    "nonlinear" continues the Boussinesq flow at the scheme's order, kind
    "linearized" propagates a (u, theta) perturbation about the spun-up
    state (B-normalized after each call); solvers built once."""
    import chip_smoke as cs
    from neklab_tpu_torch.models import navier_stokes as ns
    from neklab_tpu_torch.models.linearized import LinConfig, propagate
    from neklab_tpu_torch.models.precond import build_e_preconditioner
    from neklab_tpu_torch.ops import sem

    mesh = cs.thermosyphon_mesh(dev)
    buoy = lambda m, u, th: torch.stack([torch.zeros_like(th[0]), cs.TS_PR * cs.TS_RA * th[0]])
    fc = ns.FlowConfig(**cs.TS_FLOW, forcing_fn=lambda m, t, u, th: buoy(m, u, th))
    cfg = LinConfig(flow=fc, lin_forcing_fn=buoy)
    tb = torch.stack([0.5 * (1.0 + torch.tanh(-20.0 * mesh.x[1]))])
    orders = ns.bdf_orders(fc, 3)
    pc = build_e_preconditioner(mesh, fc.dt / (11 / 6))
    vdiag, tdiags = ns.bdf3_diags(mesh, fc)
    psolves = ns.pressure_solvers(mesh, fc, orders, pc)
    vsolves = ns.velocity_solvers(mesh, fc, orders, vdiag, tdiags)
    state = ns.advance(mesh, fc, ns.initial_state(mesh, fc, theta=tb), 400, tb=tb,
                       psolves=psolves, vsolves=vsolves)
    if kind == "nonlinear":
        def run(st, stats=None):
            return ns.advance(mesh, fc, st, nsteps, tb=tb, ramp=False, psolves=psolves,
                              vsolves=vsolves, stats=stats, recycle=recycle)

        return mesh, fc.dt, run, state

    def run(x, stats=None):
        u, th = propagate(mesh, cfg, state.u, state.theta, *x, nsteps, pc_e=pc, vdiag=vdiag,
                          tdiags=tdiags, psolves=psolves, vsolves=vsolves, stats=stats,
                          recycle=recycle)
        nrm = (sem.mass_dot(mesh, u, u) + sem.mass_dot(mesh, th, th)).sqrt()
        return u / nrm, th / nrm

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    rand = lambda n: sem.dsavg(mesh, torch.randn((n,) + tuple(mesh.bm1.shape), generator=gen,
                                                 dtype=mesh.dtype, device=dev))
    return mesh, fc.dt, run, (mesh.vmask * rand(2), mesh.tmask * rand(1))


def profile_case(name, dev, nsteps, recycle=0):
    from torch.profiler import ProfilerActivity, profile

    from neklab_tpu_torch.models.linearized import make_adjoint_propagator, propagate
    from neklab_tpu_torch.ops import helmholtz_kernel as hk
    from neklab_tpu_torch.ops import sem
    from neklab_tpu_torch.utils.timers import Counts

    base, _, kind = name.partition("-")
    tape_bytes = None
    if base == "thermosyphon":
        mesh, dt, run, u = thermosyphon_case(dev, nsteps, kind, recycle)
    elif kind == "nonlinear":
        mesh, dt, run, u = nonlinear_case(dev, nsteps, recycle)
    elif kind == "otd":
        mesh, dt, run, u = otd_case(dev, nsteps)
    else:
        mesh, cfg, cfg_adj, base_u, pc, vdiag, psolves, vsolves = build_case(base, dev)
        dt = cfg.flow.dt
        th = torch.zeros((0,) + tuple(mesh.bm1.shape), dtype=mesh.dtype, device=dev)
        if kind == "adjoint":
            adj = make_adjoint_propagator(mesh, cfg_adj, base_u, th, nsteps, pc_e=pc, vdiag=vdiag)
            tape_bytes = adj.tape_bytes
            apply = lambda u, stats: adj(u, th, stats=stats)[0]
        else:
            apply = lambda u, stats: propagate(mesh, cfg, base_u, th, u, th, nsteps, pc_e=pc,
                                               vdiag=vdiag, psolves=psolves, vsolves=vsolves,
                                               stats=stats, recycle=recycle)[0]

        def run(u, stats=None):
            u = apply(u, stats)
            return u / sem.mass_dot(mesh, u, u).sqrt()

        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        u = mesh.vmask * sem.dsavg(mesh, torch.randn((mesh.ndim,) + tuple(mesh.bm1.shape),
                                                     generator=gen, dtype=mesh.dtype, device=dev))
        u = u / sem.mass_dot(mesh, u, u).sqrt()
    u = run(u)  # warm-up
    # the counts alone: the timed windows run untraced
    walls, stats, n0 = [], Counts(), hk.launches(dev)  # synchronizes
    for _ in range(3):
        t0 = time.perf_counter()
        u = run(u, stats)
        torch.cuda.synchronize()
        walls.append(1e3 * (time.perf_counter() - t0) / nsteps)
    runs = (hk.launches(dev) - n0) / (3 * nsteps)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run(u)
        torch.cuda.synchronize()
        pwall = time.perf_counter() - t0
    host_launches = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CPU and e.name in LAUNCH_CALLS:
            host_launches[e.name] = host_launches.get(e.name, 0) + 1
    ev = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_us = sum(e.device_time for e in ev)
    by = {}
    for e in ev:
        c, s = by.get(e.name[:60], (0, 0.0))
        by[e.name[:60]] = (c + 1, s + e.device_time)
    top = sorted(by.items(), key=lambda kv: -kv[1][1])[:12]
    apply = {}
    if mesh.ndim == 3:
        ms = apply_device_ms(mesh, cfg.flow)
        per_step = len(stats["helmholtz"]) / (3 * nsteps) + sum(stats["helmholtz"]) / (3 * nsteps)
        apply = {"helmholtz3d_apply_device_ms": ms, "helmholtz3d_applies_per_step": per_step,
                 "helmholtz3d_share_of_device_busy": per_step * ms / (dev_us / 1e3 / nsteps)}
    return {
        "case": name, "recycle": recycle, "nel": mesh.nel, "order": mesh.basis.n - 1, "dt": dt,
        "nsteps": nsteps, "tape_bytes": tape_bytes,
        "ms_per_step": walls,
        "cg_iters_per_step": {k: sum(v) / (3 * nsteps) for k, v in stats.items()},
        "helmholtz2d_runs_per_step": runs,
        "host_launch_calls_per_step": sum(host_launches.values()) / nsteps,
        "host_launch_calls_by_name_per_step": {k: v / nsteps for k, v in host_launches.items()},
        "profiled_ms_per_step": 1e3 * pwall / nsteps,
        "device_busy_ms_per_step": dev_us / 1e3 / nsteps,
        "device_busy_share_of_profiled": dev_us / 1e6 / pwall,
        "device_ops_per_step": len(ev) / nsteps,
        "top": [[k, c / nsteps, s / 1e3 / nsteps] for k, (c, s) in top],
        **apply,
    }


def apply_device_ms(mesh, fc, calls: int = 50) -> float:
    """Device ms of one `helmholtz_local` at the velocity CG's shape [ndim,
    pts..., nel]: `calls` calls queued behind a sleep kernel, so that CUDA
    events time the device and not the host's launches."""
    from neklab_tpu_torch.ops import sem

    u = torch.randn((mesh.ndim,) + tuple(mesh.bm1.shape), dtype=mesh.dtype, device=mesh.device)
    h2 = (11 / 6) / fc.dt
    for _ in range(3):
        sem.helmholtz_local(mesh, u, fc.viscosity, h2)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(500_000_000)
    start.record()
    for _ in range(calls):
        sem.helmholtz_local(mesh, u, fc.viscosity, h2)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / calls


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cases", default="re7500,box2d,re7500-adjoint,box2d-adjoint,"
                                       "cyl50-nonlinear,otd500-otd")
    ap.add_argument("--nsteps", type=int, default=20)
    ap.add_argument("--recycle", default="0")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_step: needs a CUDA card")
    import neklab_tpu_torch  # noqa: F401  (sets the TF32 switches)

    dev = torch.device("cuda", 0)
    recycles = [int(k) for k in args.recycle.split(",")]
    for name in args.cases.split(","):
        plain_only = name.endswith(("-adjoint", "-otd"))
        for k in [0] if plain_only else recycles:
            print(json.dumps(profile_case(name, dev, args.nsteps, k)), flush=True)


if __name__ == "__main__":
    main()
