"""Where the time of one linearized step goes on a CUDA card, for the port
(neklab_tpu_torch), f32.

    python3 tools/profile_torch_step.py [--cases re7500,box2d,re7500-adjoint,box2d-adjoint]
                                        [--nsteps 20]

Cases: `re7500` is the Poiseuille Re=7500 `medium` propagator of
chip_smoke.py phases 6 and 7 (the main paths; dt as ExponentialPropagator
derives it), `box2d` the box2d 131k propagator of phase 5. A case with
`-adjoint` profiles the same propagator's exact adjoint instead (an
`AdjointPropagator` recorded over the window's `nsteps` steps, at
ExponentialPropagator's adjoint tolerances, 10x tighter); its "step" is one
step of the backward pass. For each, from a B-normalized state (the
sustained protocol):
  * host ms/step of three unprofiled windows of `nsteps` steps;
  * velocity (Helmholtz) and pressure (E) CG iterations per step, as the
    solvers of that propagate report them (`propagate(..., stats=)`);
  * helmholtz2d kernel runs per step, from the kernel's device counter
    (graph replays included);
  * one `torch.profiler` window: the host's launch calls per step
    (`cudaLaunchKernel` and `cudaGraphLaunch` events of its CPU trace; unlike
    ms/step, this count does not move with the host's load), device-busy
    ms/step (summed kernel and copy times) and its share of the profiled
    wall time, device operations per step, and the top operations by device
    time.
One JSON line per case. Needs a CUDA card; imports no jax.
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
# the runtime calls by which the host puts work on the card
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cudaGraphLaunch")


def build_case(name, dev):
    """-> (mesh, cfg, cfg_adj, base_u, pc_e, vdiag, psolves, vsolves) for
    `propagate` and `make_adjoint_propagator`."""
    from neklab_tpu_torch.linops.exponential_propagator import ExponentialPropagator
    from neklab_tpu_torch.mesh.box import box_mesh
    from neklab_tpu_torch.models.linearized import LinConfig, pressure_solvers, velocity_solvers
    from neklab_tpu_torch.models.navier_stokes import FlowConfig, helmholtz_diag
    from neklab_tpu_torch.models.precond import build_e_preconditioner

    lims = ((0.0, 2 * np.pi), (-1.0, 1.0))
    if name == "re7500":
        mesh = box_mesh((12, 10), lims, CHANNEL, order=8, dtype=torch.float32, device=dev)
        fc = FlowConfig(viscosity=1 / 7500, dt=1e-2, vtol=1e-7, ptol=1e-7)
    elif name == "box2d":
        mesh = box_mesh((64, 16), lims, CHANNEL, order=7, dtype=torch.float32, device=dev)
        fc = FlowConfig(viscosity=1e-3, dt=2e-3, vtol=1e-5, ptol=1e-5, vmaxit=50, pmaxit=120)
    else:
        raise SystemExit(f"unknown case {name!r}")
    y = mesh.x[1]
    base_u = torch.stack([1 - y**2, 0 * y])
    if name == "re7500":  # the main path's propagator: dt from the CFL target
        op = ExponentialPropagator(mesh, LinConfig(flow=fc), base_u, tau=0.5, cfl=0.5)
        return mesh, op.cfg, op.cfg_adj, base_u, op.pc_e, op.vdiag, op.psolves, op.vsolves
    # box2d: bench.py's fixed dt, set up as ExponentialPropagator would
    cfg = LinConfig(flow=fc)
    cfg_adj = LinConfig(flow=dataclasses.replace(fc, vtol=0.1 * fc.vtol, ptol=0.1 * fc.ptol))
    pc = build_e_preconditioner(mesh)
    vdiag = helmholtz_diag(mesh, fc.viscosity, (11 / 6) / fc.dt, mesh.vmask)
    return (mesh, cfg, cfg_adj, base_u, pc, vdiag, pressure_solvers(mesh, cfg, 3, pc),
            velocity_solvers(mesh, cfg, 3, vdiag, None))


def profile_case(name, dev, nsteps):
    from torch.profiler import ProfilerActivity, profile

    from neklab_tpu_torch.models.linearized import make_adjoint_propagator, propagate
    from neklab_tpu_torch.ops import helmholtz_kernel as hk
    from neklab_tpu_torch.ops import sem

    base, _, kind = name.partition("-")
    mesh, cfg, cfg_adj, base_u, pc, vdiag, psolves, vsolves = build_case(base, dev)
    th = torch.zeros((0,) + tuple(mesh.bm1.shape), dtype=mesh.dtype, device=dev)
    tape_bytes = None
    if kind == "adjoint":
        adj = make_adjoint_propagator(mesh, cfg_adj, base_u, th, nsteps, pc_e=pc, vdiag=vdiag)
        tape_bytes = adj.tape_bytes
        apply = lambda u, stats: adj(u, th, stats=stats)[0]
    else:
        apply = lambda u, stats: propagate(mesh, cfg, base_u, th, u, th, nsteps, pc_e=pc,
                                           vdiag=vdiag, psolves=psolves, vsolves=vsolves,
                                           stats=stats)[0]

    def run(u, stats=None):
        u = apply(u, stats)
        return u / sem.mass_dot(mesh, u, u).sqrt()

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    u = mesh.vmask * sem.dsavg(mesh, torch.randn((2,) + tuple(mesh.bm1.shape), generator=gen,
                                                 dtype=mesh.dtype, device=dev))
    u = run(u / sem.mass_dot(mesh, u, u).sqrt())  # warm-up
    walls, stats, n0 = [], {}, hk.launches(dev)  # synchronizes
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
    return {
        "case": name, "nel": mesh.nel, "order": mesh.basis.n - 1, "dt": cfg.flow.dt,
        "nsteps": nsteps, "tape_bytes": tape_bytes,
        "ms_per_step": walls,
        "cg_iters_per_step": {k: sum(v) / len(v) for k, v in stats.items()},
        "helmholtz2d_runs_per_step": runs,
        "host_launch_calls_per_step": sum(host_launches.values()) / nsteps,
        "host_launch_calls_by_name_per_step": {k: v / nsteps for k, v in host_launches.items()},
        "profiled_ms_per_step": 1e3 * pwall / nsteps,
        "device_busy_ms_per_step": dev_us / 1e3 / nsteps,
        "device_busy_share_of_profiled": dev_us / 1e6 / pwall,
        "device_ops_per_step": len(ev) / nsteps,
        "top": [[k, c / nsteps, s / 1e3 / nsteps] for k, (c, s) in top],
    }


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cases", default="re7500,box2d,re7500-adjoint,box2d-adjoint")
    ap.add_argument("--nsteps", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_step: needs a CUDA card")
    import neklab_tpu_torch  # noqa: F401  (sets the TF32 switches)

    dev = torch.device("cuda", 0)
    for name in args.cases.split(","):
        print(json.dumps(profile_case(name, dev, args.nsteps)), flush=True)


if __name__ == "__main__":
    main()
