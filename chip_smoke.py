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
newton_fixed_point_iteration -> MonodromyOperator -> eigs), OTD modes
(otd_analysis), backward-facing-step transient growth (bfs_mesh ->
build_e_preconditioner -> advance -> ExponentialPropagator ->
transient_growth_analysis_fixed_point), the pressure preconditioner's
aggregated tier with the matrix-free E at 21,609 elements, and the 3-D
path: the box3d duct at 1,119,744 velocity DOF and a 3-D channel
eigensolve (box_mesh -> ExponentialPropagator -> flow_vector_space ->
linear_stability_analysis_fixed_point, with its mode files and timers),
and the Boussinesq family (nscal = 1): Rayleigh-Benard onset (box_mesh
with bc_temp -> ExponentialPropagator with lin_forcing_fn ->
flow_vector_space(mesh, 1) -> linear_stability_analysis_fixed_point) and
the heated-annulus thermosyphon (annulus_mesh with bc_temp -> advance
with forcing_fn and tb -> FixedPointSystem(tb=) ->
newton_fixed_point_iteration -> ExponentialPropagator about (u, theta) ->
linear_stability_analysis_fixed_point, and its adjoint).
Phases:

  0 device   the card, its power limit, TF32 off
  1 build    nvcc -> neklab_tpu_torch/build/; g++ -> the native colouring
             and RCB library beside it
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
  3u parity  meshes from a `.re2` and a `.box` file written to .scratch/ and
             the BFS `coarse` mesh, card vs CPU, f64: `propagate` and its
             adjoint with OAS + Q1, block Jacobi + constants and the RCB
             tier (the last two through the matrix-free E); the counter
  3d parity  the 3-D path card vs CPU, f64, on a (2, 2, 2) channel and a
             walled (3, 2, 2) box at order 4: `helmholtz_local`, 10 forced
             nonlinear steps, `propagate` and its adjoint with block
             Jacobi + constants through the matrix-free E, the B-adjoint
             identity; the 2-D kernel's counter does not move
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
             reference's oracle 1.0156 +- 1e-4; (a) its propagator with
             recycle 0 and 8 (Nek5000's residual projection): ms/step
             sustained and floor, pressure iterations per post-ramp step,
             the outputs' difference
  9 resolvent  examples/resolvent_sweep.py at its full mesh, f32: the
             sweep's two end frequencies, the Hermitian identity; the
             Stokes oracle, f64
  10 upo     the Re=180 periodic orbit of examples/cylinder_upo.py, f64,
             from the reference's orbit: |F|, Newton at iterate 0, the
             Floquet multipliers
  11 otd     examples/poiseuille_otd.py's Re=500 run, f32, 17,670 steps:
             eig(Lr) vs the analytic shear rates
  12 bfs     examples/bfs_transient_growth.py `medium`, f32: 2500 spin-up
             steps, the Lanczos SVD at tau = 4.5 (the example's 9 cut);
             sigma_1 > 1, the triplet identity, 12 power iterations on M*M
  13 box21k  the 21,609-element walled box at order 3: f64, the default
             preconditioner's RCB-aggregated tier and E-CG < 300 iterations
             to 1e-6; f32, 20 linearized steps with `compress` off and on
  14 box3d   bench.py:312-345's 12^3-element duct at order 5, f32: ms/step
             sustained and floor, the adjoint's ms/step and tape bytes, CG
             iterations, the preconditioner's and the Jacobi diagonal's
             build, peak memory; the CGs inside maxit, the B-adjoint identity;
             (b) recycle 0 and 8 as in (a)
  15 channel3d  plane Poiseuille at Re = 500 extruded spanwise, (4, 5, 2) at
             order 6, f64: the two leading eigenvalues vs the analytic
             shear modes -nu (pi/2)^2 (double, reported once) and -nu pi^2,
             the driver's files; (c) one matvec with recycle 0 and 8: s per
             matvec, pressure iterations per step
  16 sharded element-partitioned runs on the one card (this script with
             `--rank JOB RANK SIZE DIR` is one rank): one NCCL rank, box2d
             131k f32, 20 steps with graphed CGs vs unsplit, and (d) the
             same with recycle 8, all-reduces per step; four gloo ranks,
             box2d 131k and box3d, f64, propagate and its adjoint vs one
             process and the B-adjoint identity; four gloo ranks, the
             eigensolve of tests/test_sharding.py:199-245 (dt 0.4, kdim 24,
             from the one-process run's eigenvectors) vs one process; collectives per step, bytes, ms per all-reduce,
             each rank's peak device memory beside one process's;
             16e: phase 8's Newton on one NCCL rank at full width, from
             phase 8's spun-up state, its base flow's unsplit |F|; 16f (in
             16d's four gloo ranks): transient growth, Newton with the exact
             Jacobian, a resolvent frequency, the projected propagator, a
             bordered periodic-orbit Jacobian and OTD, small and f64, each
             against one process on the card
  17 rayleigh  Rayleigh-Benard onset (tests/test_rayleigh_benard.py), f64,
             nscal = 1: sigma at Ra = 1690, 1725, 1900 about the conduction
             state; the secant Ra_c within 3.0 of Chandrasekhar's 1707.762,
             sigma(1900) > 0; the scalar solves' kernel runs
  18 thermosyphon  examples/thermosyphon_baseflow.py `medium`, f64: 1200
             spin-up steps, Newton to |F| < 1e-8, the eigensolve (kdim 40,
             nev 2), sigma_1 and sigma_2 vs the reference's recorded values,
             the discrete-adjoint identity

After phases 0-2 and 5, which time the card alone, the main process starts
one process per group of SIDE (this script with `--side oracle,resolvent`,
...) and runs MAIN_THEN beside them, the card-vs-CPU phases 3-3d first:
most solves are bound by the host's launch rate, one core each, and leave
the card idle most of the time. Phase 7 runs in a side group on phase 6's
mu_1, which the main process writes to .scratch/mu1.json. `--only a,b,...`
runs the named phases one after another in this process (to time them
alone; `growth` after `re7500`); `--eigs-depth channel3d|re7500
kdim:tol:maxiter ...` times phase 15's or phase 6's eigensolve at other
Krylov dimensions (`eigs_depth`). Phase 15 starts once the side groups
have ended (or at MAIN_LAST_BY seconds). The line `timeline {...}` gives
the second, counted from the start, at which each phase ended, in
whichever process it ran. The script uses one card: it makes only the
first visible card visible to itself. Every phase asserts; any failure raises and the exit code is
non-zero. The last line on success is {"ok": true, "device": {...}}; the line
before it lists the kernels. Without a CUDA card it fails at once.

The kernel counts its own runs in device memory (`helmholtz_kernel.launches`),
so the velocity and pressure CGs, whose iterations replay CUDA graphs, are
counted too.
"""

from __future__ import annotations

import dataclasses
import json
import math
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


def counts_only() -> dict:
    """A `stats=` dict that takes the CG iteration counts alone, so that the
    calls given it run untraced (no CUDA event, no timing entry)."""
    from neklab_tpu_torch.utils.timers import Counts

    return Counts()


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
    # ~50 ms of GPU clock cycles: 100 calls of the plain chain (~20 launches
    # each) enqueue in ~10 ms, and phase 2, which times ~130 such windows
    # alone, adds every sleep to the script's end
    torch.cuda._sleep(100_000_000)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / calls


# Nek5000's residual projection (`recycle=`): the slots of the measured runs
RECYCLE = 8


def recycled_propagator(mesh, prop, u0, nsteps: int, tol: float, reps: int = 1) -> dict:
    """A propagator with recycle=0 and recycle=RECYCLE, in one process and
    in turns (0, R, R, 0), with bench.py:73-106's protocol: ms/step
    sustained (the state B-normalized before every call; `reps` calls per
    turn after a warm-up) and at the floor (the state scaled to 1e-8, where
    the solves exit at once), the pressure CG iterations per post-ramp step
    (the ramp's two solves are not recycled), and the relative difference of
    M u0 with each, asserted under 1e3 tol: the bound of
    tests/test_stepper.py::test_recycled_solves_match_plain (1e-7 at ptol
    1e-10) at this run's tolerance tol = max(vtol, ptol). prop(u, recycle,
    stats) -> M u with the solvers built once. Returns the numbers and the
    helmholtz2d runs (device counter) of the recycled calls."""
    from neklab_tpu_torch.ops import helmholtz_kernel as hk
    from neklab_tpu_torch.ops import sem

    def bnorm(u):
        return u / sem.mass_dot(mesh, u, u).sqrt().clamp_min(torch.finfo(u.dtype).tiny)

    mu = {r: prop(u0, r, None) for r in (0, RECYCLE)}  # the warm-up too
    diff = rel(mu[RECYCLE], mu[0])
    out = {"nsteps": nsteps, "rel_diff": diff, "rel_diff_bound": 1e3 * tol}
    runs = 0
    for label, scale in (("sustained", 1.0), ("floor", 1e-8)):
        state = {r: scale * bnorm(mu[r]) for r in mu}
        ms, iters = {r: [] for r in mu}, {r: [] for r in mu}
        for r in (0, RECYCLE, RECYCLE, 0):
            stats = counts_only()
            n0 = hk.launches(mesh.device)  # synchronizes
            t1 = time.time()
            for _ in range(reps):
                state[r] = scale * bnorm(prop(state[r], r, stats))
            torch.cuda.synchronize()
            ms[r].append(1e3 * (time.time() - t1) / (reps * nsteps))
            if r:
                runs += hk.launches(mesh.device) - n0
            p = np.asarray(stats["pressure"]).reshape(reps, nsteps)[:, 2:]
            iters[r].append(float(p.mean()))
        for r in mu:
            out[f"{label}_ms_per_step_recycle{r}"] = ms[r]
            out[f"{label}_pressure_iters_post_ramp_recycle{r}"] = statistics.mean(iters[r])
    assert diff <= 1e3 * tol, (diff, tol)
    assert all(bool(torch.isfinite(m).all()) for m in mu.values())
    return out, runs


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
    batch of 1 and of 81, on each of phase 16's four ranks' blocks of
    box2d, and at the Boussinesq phases' (17, 18) scalar shapes (one field,
    no leading axis) and velocity shapes, in f32 and f64. Times it against
    the plain chain at the CG shapes of the direct path (phase 6), of the
    cylinder (phase 8), of box2d and of a rank's block of it and at the
    thermosyphon's scalar CG, and alone at their probe shapes."""
    from neklab_tpu_torch.mesh.box import box_mesh
    from neklab_tpu_torch.ops import helmholtz_kernel as hk
    from neklab_tpu_torch.parallel import Partition, shard_sem_mesh

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
    # this slice's meshes: the backward-facing step (phase 12), the
    # 21,609-element box (phase 13), both f32, and phase 3u's f64 meshes
    bfs = bfs_medium(dev)
    big = box21k(dev, torch.float32)
    cases += [(f"bfs/{lead}", mesh_args(bfs, lead, (1 / 500, 1e-2))) for lead in ((2,), (49,))]
    cases += [(f"box21k/{lead}", mesh_args(big, lead, (1e-3, 5e-4))) for lead in ((2,), (16,))]
    for name, m in file_meshes(dev).items():
        cases += [(f"parity_u_{name}/{lead}", mesh_args(m, lead, (1 / 50, 1e-2)))
                  for lead in ((2,), (36,))]
    # the Boussinesq phases' meshes, f32 and f64: Rayleigh-Benard's 3 x 3 box
    # (nel 9, fewer elements than a tile) and the thermosyphon's 4 x 20
    # annulus (nel 80); the scalar CG's single field at (conductivity, dt),
    # the velocity CG's pair at (nu, dt), and the two Jacobi probes
    boussinesq = {}
    for dtype in (torch.float32, torch.float64):
        for key, m, nu, dt in (("rayleigh", rb_box(dev, dtype), RB_FLOW["viscosity"], 1e-3),
                               ("thermosyphon", thermosyphon_mesh(dev, dtype), TS_PR, TS_DT)):
            boussinesq[key, dtype] = m
            probe = (m.basis.n ** 2,)
            for what, lead, h1 in (("scalar", (), 1.0), ("scalar_probe", probe, 1.0),
                                   ("velocity", (2,), nu), ("velocity_probe", probe, nu)):
                cases.append((f"{key}/{SHORT[dtype]}/{what}", mesh_args(m, lead, (h1, dt))))
    box2d64 = channel(dev, torch.float64, (64, 16), 7)
    for m in (box2d, box2d64):
        cases += [(f"box2d_131k/{str(m.dtype)[6:]}/{lead}", mesh_args(m, lead))
                  for lead in ((), (2,), (64,))]
    # phase 16's ranks: each of 4 gloo ranks applies it to its own 256
    # elements of box2d 131k in f64 (a velocity CG iteration, the probe)
    blocks = [shard_sem_mesh(box2d64, Partition(rank=r, size=4, device=dev, backend="gloo"))
              for r in range(4)]
    for rank, m in enumerate(blocks):
        cases += [(f"box2d_131k/f64/rank{rank}of4/{lead}", mesh_args(m, lead))
                  for lead in ((2,), (64,))]
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
    # resolvent sweep (f32) and the periodic orbit (f64), and the
    # thermosyphon's scalar CG (f64, one field)
    timed = [(m, None) for m in (re7500, cyl, box2d)]
    timed += [slice_meshes["resolvent", torch.float32], slice_meshes["upo", torch.float64]]
    timed += [(bfs, (1 / 500, 1e-2)), (big, (1e-3, 5e-4)), (blocks[0], None)]
    timed = [(m, nu_dt, (2,)) for m, nu_dt in timed]
    timed.append((boussinesq["thermosyphon", torch.float64], (1.0, TS_DT), ()))
    for m, nu_dt, lead in timed:
        args = mesh_args(m, lead, nu_dt)
        key = f"{list(args[0].shape)} {SHORT[m.dtype]}"
        kern, plain = [], []
        for _ in range(3):  # in turns: plain, kernel, kernel, plain, ...
            plain.append(device_ms(lambda: hk.helmholtz2d_plain(*args)))
            kern.append(device_ms(lambda: hk.helmholtz2d(*args)))
            kern.append(device_ms(lambda: hk.helmholtz2d(*args)))
            plain.append(device_ms(lambda: hk.helmholtz2d_plain(*args)))
        bound, by = bound_ms(m.basis.n, m.nel, math.prod(lead), m.dtype)
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
        stats[name] = {"card": counts_only(), "cpu": counts_only()}
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
        stats[d] = counts_only()
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
    ex_stats = counts_only()
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
        st = stats[f"forced/{d}"] = counts_only()
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
        stats[f"period_dir/{d}"], stats[f"jacobian/{d}"] = counts_only(), counts_only()
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


# the adjoint eigensolve's residual tolerance, cut from 1e-5 to make room
# for phase 15: the phase asserts its eigenvalues to 1e-4, and they read
# 1.5e-7 off at 1e-5 (PERF.md section 6)
ADJ_TOL_RE500 = 1e-4


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
                                                nev=NEV_RE500, tol=2e-6, maxiter=12,
                                                check_every=CHECK_EVERY)
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
                                                nev=2, tol=ADJ_TOL_RE500, maxiter=12,
                                                adjoint=True, check_every=CHECK_EVERY)
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
                                                 tol=1e-7, maxiter=10, check_every=CHECK_EVERY)
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
        stats = counts_only()
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
    first = counts_only()
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
# phase 6's residual tolerance: the example's 1e-6 cut to the 1e-5 that the
# phase asserts of the TS mode, to make room for phase 15
TOL_RE7500 = 1e-5
# the Krylov expansion tests its projected problem every CHECK_EVERY columns
# (the driver's default is 8), so a converged eigensolve stops within one
# matvec of convergence instead of up to seven past it (phases 4, 6, 8, 15
# and 16d, as phase 10's UPO_CHECK; PERF.md section 4)
CHECK_EVERY = 2


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
                                                nev=NEV_RE7500, tol=TOL_RE7500, maxiter=10,
                                                check_every=CHECK_EVERY)
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


# phase 7's Lanczos iterations, cut from 32 to make room for phase 15: the
# triplet identity holds by the bidiagonalization's construction at any
# depth, and sigma_1 exceeds |mu_1| within a few iterations
GROWTH_KDIM = 16


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
    res = transient_growth_analysis_fixed_point(op, space, kdim=GROWTH_KDIM, nsv=2)
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
                   maxiter: int = 12, state: dict | None = None) -> dict:
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
    to reach it). Then (a): the eigensolve's propagator (50 steps per
    call) with recycle 0 and RECYCLE (`recycled_propagator`: ms/step
    sustained and floor, pressure iterations per post-ramp step, the two
    outputs' difference). Returns the kernel runs of each part, from the
    device counter set to zero before it. state: where it leaves the
    spun-up state, the system and the Newton base flow for phase 16e."""
    from neklab_tpu_torch.analysis import (linear_stability_analysis_fixed_point,
                                           newton_fixed_point_iteration)
    from neklab_tpu_torch.linops.exponential_propagator import ExponentialPropagator
    from neklab_tpu_torch.models.linearized import LinConfig, propagate
    from neklab_tpu_torch.models.navier_stokes import FlowConfig, advance, initial_state
    from neklab_tpu_torch.models.precond import build_e_preconditioner
    from neklab_tpu_torch.ops import helmholtz_kernel as hk
    from neklab_tpu_torch.ops import sem
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
    spin_stats = counts_only()
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
    if state is not None:
        state["cylinder"] = dict(u0=st.u, ub=ub, cfg=cfg, system=system, space=space, nres=nres,
                                 newton_s=seconds["newton"])

    hk.reset_launches(dev)
    t1 = time.time()
    expA = ExponentialPropagator(mesh, cfg, nres.x["u"], tau=1.0, dt=dt)
    eres = linear_stability_analysis_fixed_point(expA, space, kdim=kdim, nev=NEV_CYLINDER,
                                                 tol=1e-5, maxiter=maxiter,
                                                 check_every=CHECK_EVERY)
    runs["eigensolve"] = hk.launches(dev)
    seconds["eigensolve"] = time.time() - t1

    # (a) recycling on the eigensolve's propagator at full width, 50 steps
    # per call, from a C0 field of the seed
    th = torch.zeros((0,) + tuple(mesh.bm1.shape), dtype=dtype, device=dev)
    prop = lambda u, r, stats: propagate(
        mesh, expA.cfg, expA.base_u, th, u, th, 50, pc_e=expA.pc_e, vdiag=expA.vdiag,
        psolves=expA.psolves, vsolves=expA.vsolves, stats=stats, recycle=r)[0]
    gen = torch.Generator(device=dev)
    gen.manual_seed(8)
    u0 = mesh.vmask * sem.dsavg(mesh, torch.randn((2,) + tuple(mesh.bm1.shape), generator=gen,
                                                  dtype=dtype, device=dev))
    hk.reset_launches(dev)
    recycled, runs["recycled propagator"] = recycled_propagator(
        mesh, prop, u0, 50, max(fc.vtol, fc.ptol))

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
          in_oracle_band=abs(abs(mu1) - ORACLE_MU1) <= ORACLE_BAND, kernel_runs=runs,
          recycled=recycled)
    assert nres.converged, nres.history
    assert len(system.derived) == 1  # one solver set: the fixed dt
    assert abs(mu1) > 1.0, mu1
    assert 0.6 < omega < 0.9, lam1
    return runs


def cylinder_split_phase(dev, state: dict) -> dict:
    """Phase 16e: phase 8's Newton split, at full width on one NCCL rank
    (the card machine shows one card, and NCCL puts no two ranks of one
    communicator on one card): init_distributed -> shard_sem_mesh (the
    `medium` annulus, 160 elements, order 6, f32) -> FixedPointSystem (tau
    0.5, the example's frozen Jacobian) -> newton_fixed_point_iteration (tol
    2e-4, GMRES kdim 30) from phase 8's spun-up state (it runs after phase 8
    in the same process, which leaves it in `state`). Asserts Newton's
    convergence, |F| < 2e-4 of the gathered base flow through phase 8's
    unsplit system (an independent check of the split answer), every CG
    graphed and the kernel's runs. Prints the iterations beside phase 8's,
    the relative distance to phase 8's base flow, and the all-reduces per
    Newton iteration and per GMRES matvec (`Partition.log`, graph replays
    included)."""
    import shutil

    import torch.distributed as dist

    from neklab_tpu_torch.analysis import newton_fixed_point_iteration
    from neklab_tpu_torch.ops import helmholtz_kernel as hk
    from neklab_tpu_torch.parallel import (gather_field, init_distributed, shard_field,
                                           shard_sem_mesh)
    from neklab_tpu_torch.systems.fixed_point import FixedPointSystem
    from neklab_tpu_torch.vectors import flow_vector, flow_vector_space

    t0 = time.time()
    one = state["cylinder"]
    work = os.path.join(ROOT, ".scratch", "cylinder_split")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    part = init_distributed(backend="nccl", init_method="file://" + os.path.join(work, "rdv"),
                            world_size=1, rank=0, device=dev, timeout=600)
    try:
        mesh = shard_sem_mesh(cylinder_mesh("cpu", torch.float32), part)
        cfg = one["cfg"]
        system = FixedPointSystem(mesh, cfg, tau=0.5, ub=shard_field(one["ub"], part),
                                  dt=cfg.flow.dt)
        part.log.reset()
        hk.reset_launches(dev)
        t1 = time.time()
        x0 = flow_vector(mesh, 0, u=shard_field(one["u0"], part))
        nres = newton_fixed_point_iteration(system, x0, flow_vector_space(mesh, 0), tol=2e-4,
                                            maxiter=15, gmres_kdim=30)
        newton_s = time.time() - t1
        runs = hk.launches(dev)
        newton_calls = part.log.calls
        (d,) = system.derived.values()
        graphed = [d.psolves[o].cg.graphed for o in d.psolves] + \
            [d.vsolves[o][0].cg.graphed for o in d.vsolves]
        jac = system.jacobian(nres.x)
        before = part.log.calls
        jac.matvec(nres.x)  # one GMRES matvec's all-reduces (any direction)
        per_matvec = part.log.calls - before
        base = gather_field(nres.x["u"], part).to(dev)
    finally:
        dist.destroy_process_group()
    ref = one["nres"]
    fnorm = one["space"].norm(one["system"].response(flow_vector(one["system"].mesh, 0, u=base)))
    distance = rel(base, ref.x["u"])
    phase("cylinder_split", t0, nel=mesh.nel, newton_converged=nres.converged,
          newton_iterations=nres.iterations, phase8_iterations=ref.iterations,
          newton_history=nres.history, phase8_history=ref.history, gmres_matvecs=nres.matvecs,
          phase8_gmres_matvecs=ref.matvecs, newton_s=newton_s, phase8_newton_s=one["newton_s"],
          unsplit_residual=fnorm, rel_distance_to_phase8=distance, graphed=graphed,
          allreduces=newton_calls,
          allreduces_per_newton_iteration=newton_calls / max(nres.iterations, 1),
          allreduces_per_gmres_matvec=per_matvec, kernel_runs=runs)
    assert nres.converged, nres.history
    assert fnorm < 2e-4, fnorm
    assert graphed and all(graphed), graphed
    assert runs > 0
    return {"split cylinder Newton, 1 NCCL rank (phase 16e)": runs}


# ---------------------------------------------------------------------------
# the Boussinesq family (nscal = 1): Rayleigh-Benard onset, the thermosyphon
# ---------------------------------------------------------------------------

# examples/rayleigh_benard.py:22-23: the critical wavenumber (rigid-rigid)
# and Chandrasekhar's critical Rayleigh number
RB_KC, RB_RAC = 3.11632, 1707.762
# the secant's bracket (tests/test_rayleigh_benard.py:56) and the example's
# supercriticality check (examples/rayleigh_benard.py:26)
RB_RAS = (1690.0, 1725.0, 1900.0)
RB_FLOW = dict(viscosity=1.0, dt=1e-3, nscal=1, conductivity=(1.0,), vtol=1e-12, ptol=1e-12,
               ttol=1e-12)


def rb_box(dev, dtype=torch.float64):
    """tests/test_rayleigh_benard.py:27-30's box: one critical wavelength
    between rigid walls, 3 x 3 elements at order 6, the temperature fixed on
    both walls."""
    from neklab_tpu_torch.mesh.box import box_mesh

    return box_mesh((3, 3), ((0.0, 2 * np.pi / RB_KC), (0.0, 1.0)), CHANNEL, order=6,
                    bc_temp={"y-": "t", "y+": "t"}, dtype=dtype, device=dev)


def rb_propagator(mesh, ra: float):
    """tests/test_rayleigh_benard.py:31-45 at Ra: the Boussinesq buoyancy
    (0, Ra Pr theta) as the linear forcing, about the conduction state
    u = 0, Theta = 1 - y, tau = 0.05 at dt = 1e-3 (50 steps a matvec)."""
    from neklab_tpu_torch import ExponentialPropagator, FlowConfig, LinConfig

    buoy = lambda m, u, th: torch.stack([torch.zeros_like(th[0]), ra * th[0]])
    cfg = LinConfig(flow=FlowConfig(**RB_FLOW), lin_forcing_fn=buoy)
    y = mesh.x[1]
    return ExponentialPropagator(mesh, cfg, torch.zeros_like(torch.stack([y, y])),
                                 torch.stack([1.0 - y]), tau=0.05, dt=1e-3)


def rayleigh_phase(dev) -> int:
    """Rayleigh-Benard onset (tests/test_rayleigh_benard.py, f64): the leading
    eigenvalue sigma of the conduction state at Ra = 1690, 1725 and 1900
    (ExponentialPropagator -> flow_vector_space(mesh, 1) ->
    linear_stability_analysis_fixed_point, kdim 30, nev 1, tol 1e-8). The
    oracle is Chandrasekhar's: the secant between 1690 and 1725 within 3.0
    of Ra_c = 1707.762 (the reference test's bound), sigma(1690) < 0 <
    sigma(1725) and sigma(1900) > 0, every Ritz residual below 1e-8. One
    more matvec at Ra = 1900 with `stats` shows the scalar solves running
    the kernel: its device count is the velocity and scalar CG iterations
    plus one lift apply per solve. Returns the eigensolves' kernel runs,
    from the device counter set to zero before them."""
    from neklab_tpu_torch import flow_vector_space, linear_stability_analysis_fixed_point
    from neklab_tpu_torch.ops import helmholtz_kernel as hk

    t0 = time.time()
    mesh = rb_box(dev)
    space = flow_vector_space(mesh, 1)
    sigma, out, launches = {}, {}, 0
    for ra in RB_RAS:
        prop = rb_propagator(mesh, ra)
        op = Counted(prop, dev)
        hk.reset_launches(dev)
        res = linear_stability_analysis_fixed_point(op, space, kdim=30, nev=1, tol=1e-8,
                                                    maxiter=10, check_every=CHECK_EVERY)
        runs = hk.launches(dev)
        launches += runs
        sigma[ra] = float(res.eigvals[0].real)
        out[str(ra)] = {"sigma": sigma[ra], "lambda1": [res.eigvals[0].real, res.eigvals[0].imag],
                        "residual": float(res.residuals[0]), "n_matvec": res.n_matvec,
                        "s_per_matvec_median": statistics.median(op.seconds["matvec"]),
                        "seconds": res.elapsed, "kernel_runs": runs}
        assert res.residuals[0] < 1e-8, (ra, res.residuals)
    stats = counts_only()
    hk.reset_launches(dev)
    prop.matvec(space.rand(5), stats=stats)
    one = hk.launches(dev)
    implied = sum(stats["helmholtz"]) + sum(stats["scalar"]) + 2 * prop.nsteps
    lo, hi, sup = RB_RAS
    ra_c = lo + (hi - lo) * (-sigma[lo]) / (sigma[hi] - sigma[lo])
    phase("rayleigh", t0, nel=mesh.nel, nsteps=prop.nsteps, by_ra=out, ra_c=ra_c,
          ra_c_oracle=RB_RAC, ra_c_err=abs(ra_c - RB_RAC), ra_c_bound=3.0,
          matvec_cg_iters={k: sum(v) for k, v in stats.items()}, matvec_kernel_runs=one,
          matvec_kernel_runs_implied=implied, kernel_runs=launches)
    assert sigma[lo] < 0 < sigma[hi], sigma
    assert abs(ra_c - RB_RAC) < 3.0, ra_c
    assert sigma[sup] > 0, sigma
    assert one == implied and sum(stats["scalar"]) > 0, (one, stats)
    return launches


TS_PR, TS_RA = 0.2, 510.0  # examples/thermosyphon_baseflow.py:20, 25
TS_NSPIN, TS_DT, TS_KDIM = 1200, 2.5e-3, 40  # its `medium` preset (:58)
TS_FLOW = dict(viscosity=TS_PR, dt=TS_DT, nscal=1, conductivity=(1.0,), vtol=1e-11, ptol=1e-10,
               ttol=1e-11)
# the reference's sigma_1, sigma_2 and their Ritz residuals for this preset,
# from the JAX package on the CPU:
#   JAX_PLATFORMS=cpu python examples/thermosyphon_baseflow.py --preset medium --f64 --platform cpu
# (its eigvals line: 8 matvecs, Newton |F| 6.7e-15; the residuals of the same
# eigensolve, which the example does not print, from the result of its
# linear_stability_analysis_fixed_point call)
TS_REF_SIGMA = (-11.79569415027629, -46.135177845127274)
TS_REF_RES = (0.0, 3.112166121028129e-08)


def thermosyphon_mesh(dev, dtype=torch.float64):
    """The `medium` heated annulus: 4 x 20 elements at order 6, walls at
    r = 0.6 and 1.0, the temperature fixed on both."""
    from neklab_tpu_torch.mesh.cylinder import annulus_mesh

    return annulus_mesh(4, 20, r_in=0.6, r_out=1.0, order=6, grading=1.0, outer_bc="W",
                        bc_temp=("t", "t"), dtype=dtype, device=dev)


def thermosyphon_phase(dev) -> dict:
    """The thermosyphon pipeline of examples/thermosyphon_baseflow.py at its
    `medium` preset in f64 (--f64: vtol 1e-11, ptol 1e-10, ttol 1e-11), Pr
    0.2, Ra 510, the wall temperature 0.5 (1 + tanh(-20 y)) as the scalar's
    lift: TS_NSPIN `advance` steps with the buoyancy as `forcing_fn`, then
    FixedPointSystem (tau 0.3, tb) -> newton_fixed_point_iteration (tol
    1e-8, GMRES kdim 25), then ExponentialPropagator about the Newton state
    -> linear_stability_analysis_fixed_point (kdim 40, nev 2, tol 1e-6), and
    the discrete-adjoint identity of tests/test_thermosyphon.py:80-86 on
    that propagator. Asserts max|u| > 1e-3 after the spin-up, Newton's
    convergence with |F| < 1e-8, both Ritz residuals and the identity below
    1e-6, sigma_1 within 1e-4 relative of the reference's (TS_REF_SIGMA)
    and sigma_2 within (r_2 + r_2,ref) / (tau |mu_2|) of it, the bound its
    residuals give. The spin-up's kernel runs are its velocity and scalar
    CG iterations plus two applies per solve (the lift, the warm start).
    Returns the kernel runs of the spin-up and of the analyses, from the
    device counter set to zero before each."""
    from neklab_tpu_torch import (ExponentialPropagator, FixedPointSystem, FlowConfig, LinConfig,
                                  advance, build_e_preconditioner, flow_vector, flow_vector_space,
                                  initial_state, linear_stability_analysis_fixed_point,
                                  newton_fixed_point_iteration)
    from neklab_tpu_torch.models import navier_stokes as ns
    from neklab_tpu_torch.ops import helmholtz_kernel as hk

    t0 = time.time()
    mesh = thermosyphon_mesh(dev)
    buoy = lambda m, u, th: torch.stack([torch.zeros_like(th[0]), TS_PR * TS_RA * th[0]])
    fc = FlowConfig(**TS_FLOW, forcing_fn=lambda m, t, u, th: buoy(m, u, th))
    cfg = LinConfig(flow=fc, lin_forcing_fn=buoy)
    tb = torch.stack([0.5 * (1.0 + torch.tanh(-20.0 * mesh.x[1]))])
    space = flow_vector_space(mesh, 1)
    runs, seconds = {}, {}

    # the spin-up, its solvers built first so that the count below is the
    # steps' alone
    orders = ns.bdf_orders(fc, TS_NSPIN)
    psolves = ns.pressure_solvers(mesh, fc, orders, build_e_preconditioner(mesh, TS_DT / (11 / 6)))
    vsolves = ns.velocity_solvers(mesh, fc, orders, *ns.bdf3_diags(mesh, fc))
    st = initial_state(mesh, fc, theta=tb)
    spin = counts_only()
    hk.reset_launches(dev)
    t1 = time.time()
    st = advance(mesh, fc, st, TS_NSPIN, tb=tb, psolves=psolves, vsolves=vsolves, stats=spin)
    runs["spin-up"] = hk.launches(dev)  # synchronizes
    seconds["spin-up"] = time.time() - t1
    umax = float(st.u.abs().max())
    implied = sum(spin["helmholtz"]) + sum(spin["scalar"]) + 4 * TS_NSPIN
    assert bool(torch.isfinite(st.u).all()) and bool(torch.isfinite(st.theta).all())
    assert umax > 1e-3, umax  # buoyancy has started the circulation

    hk.reset_launches(dev)
    t1 = time.time()
    system = FixedPointSystem(mesh, cfg, tau=0.3, tb=tb, dt=TS_DT)
    nres = newton_fixed_point_iteration(system, flow_vector(mesh, 1, u=st.u, theta=st.theta),
                                        space, tol=1e-8, maxiter=12, gmres_kdim=25)
    seconds["newton"] = time.time() - t1
    t1 = time.time()
    expA = ExponentialPropagator(mesh, cfg, nres.x["u"], nres.x["theta"], tau=0.3, dt=TS_DT)
    op = Counted(expA, dev)
    # convergence tested every 8 columns, as in the example (every 2 stops at 4
    # matvecs, where sigma_2's residual, 4e-7 in a CPU rehearsal, leaves it
    # ~1 from the reference's)
    eres = linear_stability_analysis_fixed_point(op, space, kdim=TS_KDIM, nev=2, tol=1e-6,
                                                 maxiter=10)
    seconds["eigensolve"] = time.time() - t1
    # the exact discrete adjoint on the curved, thermally coupled operator
    t1 = time.time()
    v, w = space.rand(3), space.rand(4)
    mv = expA.matvec(v)
    lhs, rhs = space.dot(mv, w), space.dot(v, expA.rmatvec(w))
    identity = abs(lhs - rhs) / (space.norm(mv) * space.norm(w) + 1e-300)
    seconds["adjoint"] = time.time() - t1
    runs["analyses"] = hk.launches(dev)

    sig = [float(v.real) for v in eres.eigvals]
    res = [float(r) for r in eres.residuals]
    mu2 = abs(complex(eres.multipliers[1]))
    bound2 = (res[1] + TS_REF_RES[1]) / (expA.tau * mu2)
    diffs = [abs(s - r) for s, r in zip(sig, TS_REF_SIGMA)]
    phase("thermosyphon", t0, nel=mesh.nel, order=mesh.basis.n - 1, dt=TS_DT, nspin=TS_NSPIN,
          spinup_s=seconds["spin-up"], spinup_ms_per_step=1e3 * seconds["spin-up"] / TS_NSPIN,
          spinup_cg_iters_per_step={k: sum(v) / TS_NSPIN for k, v in spin.items()},
          max_u=umax, newton_converged=nres.converged, newton_iterations=nres.iterations,
          newton_history=nres.history, newton_residual=nres.residual_norm,
          gmres_matvecs=nres.matvecs, newton_s=seconds["newton"],
          newton_nsteps=next(iter(system.derived.values())).nsteps, eig_nsteps=expA.nsteps,
          eig_n_matvec=eres.n_matvec, eig_s=seconds["eigensolve"],
          s_per_matvec_median=statistics.median(op.seconds["matvec"]),
          eigvals=[[v.real, v.imag] for v in eres.eigvals], residuals=res,
          reference_sigma=TS_REF_SIGMA, reference_residuals=TS_REF_RES,
          sigma1_rel_diff=diffs[0] / abs(TS_REF_SIGMA[0]), sigma1_rel_bound=1e-4,
          sigma2_diff=diffs[1], sigma2_bound=bound2, mu2_abs=mu2,
          adjoint_identity_rel=identity, lhs=lhs, rhs=rhs, adjoint_s=seconds["adjoint"],
          tape_bytes=expA.adjoint.tape_bytes, spinup_kernel_runs_implied=implied,
          kernel_runs=runs)
    assert runs["spin-up"] == implied and sum(spin["scalar"]) > 0, (runs, implied)
    assert nres.converged and nres.residual_norm < 1e-8, nres.history
    assert max(res) < 1e-6, res
    assert identity < 1e-6, (lhs, rhs)
    assert diffs[0] <= 1e-4 * abs(TS_REF_SIGMA[0]), (sig, TS_REF_SIGMA)
    assert diffs[1] <= bound2, (sig, TS_REF_SIGMA, bound2)
    assert runs["analyses"] > 0
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


# the Floquet eigensolve: the example's tolerance 1e-7 cut to 1e-6 to make
# room for phase 15 (the phase asserts |mu| to 1e-4 and 1e-3), and a Krylov
# dimension of 48 in place of the example's 32, so that the solve can stop
# at its convergence check without a restart (at 1e-7 it took 52 matvecs
# with the restart at 32 and 53 at 48, PERF.md section 6). The check runs
# after every column: a monodromy matvec is 884 steps, and a check every 8
# (eigs' default) ran up to 7 of them past convergence, one every 2 up to 1
UPO_KDIM, UPO_TOL, UPO_CHECK = 48, 1e-6, 1


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
    eres = eigs(mono, flow_vector_space(mesh, 0), nev=3, kdim=kdim, tol=UPO_TOL, maxiter=4,
                check_every=UPO_CHECK)
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
    stats = counts_only()
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


# ---------------------------------------------------------------------------
# meshes from files, the backward-facing step, the 21k-element box
# ---------------------------------------------------------------------------


def write_re2(path, xc, yc, curves=(), bcs=()):
    """A 2-D #v002 Nek5000 `.re2` file by its public layout (the header,
    the endian tag, per element [group, x(4 corners), y(4 corners)], then
    the curve block and one BC block per field of 8-word records: element,
    side (1-based), 5 parameters, the characters)."""
    import struct

    nel = len(xc)

    def records(items):
        out = [np.array([len(items)], "<f8").tobytes()]
        for iel, iside, params, chars in items:
            w = np.zeros(8, "<f8")
            w[0], w[1] = iel + 1, iside + 1
            w[2:2 + len(params)] = params
            b = bytearray(w.tobytes())
            b[56:] = chars.encode().ljust(8)
            out.append(bytes(b))
        return b"".join(out)

    with open(path, "wb") as f:
        f.write(f"#v002 {nel:9d} 2 {nel:9d} chip_smoke".ljust(80).encode())
        f.write(struct.pack("<f", 6.54321))
        f.write(np.concatenate([np.ones((nel, 1)), xc, yc], axis=1).astype("<f8").tobytes())
        f.write(records(list(curves)))
        for field in bcs:
            f.write(records(list(field)))


BOX_FILE = """\
2
1
Box
-4 3
0.0 2.0 1.3
0.0 0.4 1.1 2.0
P  ,P  ,W  ,W  ,
"""


def file_meshes(dev, dtype=torch.float64) -> dict:
    """Phase 3u's meshes: a `.re2` written to .scratch/ (4 x 3 elements on
    [0, 4] x [0, 3], 'v' inflow on the left, 'O' outflow on the right, 'W'
    below and above the first column, 'P' pairs joining the bottom and top
    of the others, one 'C' arc on the outflow side), a genbox `.box`
    (graded in x, explicit edges in y, periodic in x, walled: a pure-Neumann
    pressure), and the backward-facing step of the `coarse` preset, all at
    order 5."""
    from neklab_tpu_torch.mesh.bfs import bfs_mesh
    from neklab_tpu_torch.mesh.boxfile import mesh_from_box
    from neklab_tpu_torch.mesh.re2 import mesh_from_re2

    outdir = os.path.join(ROOT, ".scratch")
    os.makedirs(outdir, exist_ok=True)
    nx, ny = 4, 3
    i, j = (a.reshape(-1).astype(float) for a in np.meshgrid(np.arange(nx), np.arange(ny)))
    xc, yc = np.stack([i, i + 1, i + 1, i], 1), np.stack([j, j, j + 1, j + 1], 1)
    vel = []
    for e in range(nx * ny):
        c, r = e % nx, e // nx
        vel.append((e, 3, (), "v" if c == 0 else "E"))
        vel.append((e, 1, (), "O" if c == nx - 1 else "E"))
        if r == 0:
            vel.append((e, 0, (), "W") if c == 0 else (e, 0, (e + nx * (ny - 1) + 1, 3), "P"))
        if r == ny - 1:
            vel.append((e, 2, (), "W") if c == 0 else (e, 2, (e - nx * (ny - 1) + 1, 1), "P"))
    re2_path = os.path.join(outdir, "smoke.re2")
    write_re2(re2_path, xc, yc, curves=[(nx - 1, 1, (3.0,), "C")], bcs=[vel])
    box_path = os.path.join(outdir, "smoke.box")
    with open(box_path, "w") as f:
        f.write(BOX_FILE)
    return {"re2": mesh_from_re2(re2_path, order=5, dtype=dtype, cache=False, device=dev),
            "box": mesh_from_box(box_path, order=5, dtype=dtype, device=dev),
            "bfs": bfs_mesh(li=2, lo=10, nel_li=2, nel_lo=8, nel_y_in=2, nel_y_step=2,
                            order=5, dtype=dtype, device=dev)}


def parity_u_phase(dev):
    """Phase 3u: the linearized propagator's matvec (`propagate`, 10 steps)
    and its exact adjoint's rmatvec on the card against the CPU, f64, on
    each of `file_meshes` with each preconditioner: OAS + Q1 with the exact
    neighbour blocks (the default), block Jacobi + constants, and the
    RCB-aggregated tier (forced by a coarse_max_dense of a quarter of the
    elements); the last two run the matrix-free E in the pressure CG.
    Card and CPU each build their own mesh and preconditioner; the inner
    solves run to 1e-14, so both converge well below the bound. Asserts
    <= 1e-12 relative and, on the card, the kernel's device counter against
    the CG counts: per matvec one run per velocity CG iteration and one per
    solve (the zero lift), per rmatvec one per transposed iteration."""
    from neklab_tpu_torch.models import navier_stokes as ns
    from neklab_tpu_torch.models.linearized import LinConfig, make_adjoint_propagator, propagate
    from neklab_tpu_torch.models.precond import build_e_preconditioner
    from neklab_tpu_torch.ops import helmholtz_kernel as hk
    from neklab_tpu_torch.ops import sem

    t0 = time.time()
    meshes = {d: file_meshes(d) for d in (dev, "cpu")}
    # the inner solves run to 1e-14: block Jacobi's E-CG converges slowly,
    # so at 1e-12 the card's and the CPU's solves stop a few iterations
    # apart and differ by their truncation, ~1e-12 (PERF.md section 6)
    fc = ns.FlowConfig(viscosity=1 / 50, dt=1e-2, vtol=1e-14, ptol=1e-14, pmaxit=2000)
    cfg, nsteps = LinConfig(flow=fc), 10
    rng = np.random.default_rng(23)
    errs, runs, implied, iters = {}, {}, {}, {}
    for name, m_h in meshes["cpu"].items():
        th = torch.zeros((0,) + tuple(m_h.bm1.shape), dtype=torch.float64)
        u0, v0 = (m_h.vmask * sem.dsavg(m_h, torch.as_tensor(
            rng.standard_normal((2,) + tuple(m_h.bm1.shape)))) for _ in range(2))
        for pname, kw in (("oas_q1", {}),
                          ("bj_const", dict(local="bj", coarse="const", exact_blocks=False)),
                          ("rcb", dict(coarse_max_dense=max(2, m_h.nel // 4)))):
            key = f"{name}/{pname}"
            outs = {}
            for d in (dev, "cpu"):
                m = meshes[d][name]
                x, y = m.x
                base = torch.stack([1 + 0.2 * torch.sin(x) * torch.cos(y),
                                    0.2 * torch.cos(x) * torch.sin(y)]) * m.vmask
                pc = build_e_preconditioner(m, fc.dt / (11 / 6), **kw)
                assert (pc.eb_w is None) == (pname != "oas_q1"), key
                assert (pc.agg_of_el is not None) == (pname == "rcb"), key
                orders = ns.bdf_orders(fc, nsteps)
                vdiag, _ = ns.bdf3_diags(m, fc)
                psolves = ns.pressure_solvers(m, fc, orders, pc)
                vsolves = ns.velocity_solvers(m, fc, orders, vdiag, None)
                adj = make_adjoint_propagator(m, cfg, base, th.to(d), nsteps, vdiag=vdiag,
                                              psolves=psolves, vsolves=vsolves)
                st_mv, st_rmv = counts_only(), counts_only()
                n0 = hk.launches(dev)
                mv = propagate(m, cfg, base, th.to(d), u0.to(d), th.to(d), nsteps, vdiag=vdiag,
                               psolves=psolves, vsolves=vsolves, stats=st_mv)[0]
                n1 = hk.launches(dev)
                rmv = adj(v0.to(d), th.to(d), stats=st_rmv)[0]
                n2 = hk.launches(dev)
                outs[d] = (mv, rmv)
                if d == dev:
                    runs[key] = (n1 - n0, n2 - n1)
                    implied[key] = (sum(st_mv["helmholtz"]) + len(st_mv["helmholtz"]),
                                    sum(st_rmv["helmholtz"]))
                    iters[key] = {"matvec": {k: sum(v) for k, v in st_mv.items()},
                                  "rmatvec": {k: sum(v) for k, v in st_rmv.items()}}
            errs[key] = [rel(outs[dev][i].cpu(), outs["cpu"][i]) for i in range(2)]
    phase("parity_u", t0, rel_err=errs, kernel_runs=runs, runs_implied_by_stats=implied,
          cg_iters=iters, nel={k: m.nel for k, m in meshes["cpu"].items()}, nsteps=nsteps)
    for key, value in runs.items():
        assert value == implied[key], (key, value, implied[key])
    for key, value in errs.items():
        assert max(value) <= 1e-12, (key, value)


def bfs_medium(dev, dtype=torch.float32):
    """examples/bfs_transient_growth.py's `medium` mesh: 3 + 14 elements
    along the channel, 2 + 2 across, order 6 (62 elements)."""
    from neklab_tpu_torch.mesh.bfs import bfs_mesh

    return bfs_mesh(li=3, lo=16, nel_li=3, nel_lo=14, nel_y_in=2, nel_y_step=2, order=6,
                    dtype=dtype, device=dev)


# the example asks for nsv 4 (PERF.md section 4); its Lanczos stops on
# convergence, at m = 10 for nsv 2 (PERF.md section 6), well inside kdim 32
BFS_KDIM, BFS_NSV = 32, 2
# the horizon: the example's tau = 9 (900 steps per matvec) cut to 4.5 (450
# steps) to make room for phase 16; the oracles hold there as at 9 (PERF.md
# section 6)
BFS_TAU = 4.5


def bfs_phase(dev, kdim: int = BFS_KDIM, nsv: int = BFS_NSV) -> dict:
    """Phase 12: backward-facing-step transient growth, the `medium` preset
    of examples/bfs_transient_growth.py at its full width, f32, through the
    user entry points: `bfs_mesh` (62 elements, order 6) ->
    `build_e_preconditioner` -> `advance` (Re 500, dt 1e-2, 2500 spin-up
    steps from the parabolic inflow, the inflow as the lift) ->
    `ExponentialPropagator` (tau = BFS_TAU, 450 steps) ->
    `transient_growth_analysis_fixed_point` (kdim, nsv, tol 1e-6). Asserts
    tests/test_bfs.py's oracles: sigma_1 > 1 and sigma_1 >= sigma_2 > 0; the
    triplet identity ||M v1 - sigma1 u1||_B <= 1e-3 sigma_1 (phase 7's f32
    bound); sigma_1 within 5e-2 of 12 power iterations on M*M. Returns the
    kernel runs of the spin-up and of the analysis."""
    from neklab_tpu_torch.analysis import transient_growth_analysis_fixed_point
    from neklab_tpu_torch.linops.exponential_propagator import ExponentialPropagator
    from neklab_tpu_torch.mesh.bfs import bfs_inflow
    from neklab_tpu_torch.models.linearized import LinConfig
    from neklab_tpu_torch.models.navier_stokes import FlowConfig, advance, initial_state
    from neklab_tpu_torch.models.precond import build_e_preconditioner
    from neklab_tpu_torch.ops import helmholtz_kernel as hk
    from neklab_tpu_torch.vectors import flow_vector_space

    t0 = time.time()
    runs, seconds = {}, {}
    mesh = bfs_medium(dev)
    dt, nspin, tau = 1e-2, 2500, BFS_TAU
    fc = FlowConfig(viscosity=1 / 500, dt=dt, vtol=1e-6, ptol=1e-6)
    ub = bfs_inflow(mesh)
    hk.reset_launches(dev)
    t1 = time.time()
    spin_stats = counts_only()
    st = advance(mesh, fc, initial_state(mesh, fc, u=ub), nspin, ub=ub,
                 pc_e=build_e_preconditioner(mesh, dt / (11 / 6)), stats=spin_stats)
    runs["spin-up"] = hk.launches(dev)
    seconds["spin-up"] = time.time() - t1
    assert bool(torch.isfinite(st.u).all())

    hk.reset_launches(dev)
    t1 = time.time()
    expA = ExponentialPropagator(mesh, LinConfig(flow=fc), st.u, tau=tau, dt=dt)
    space = flow_vector_space(mesh, 0)
    op = Counted(expA, dev)
    res = transient_growth_analysis_fixed_point(op, space, kdim=kdim, nsv=nsv, tol=1e-6)
    runs["analysis"] = hk.launches(dev)
    seconds["analysis"] = time.time() - t1
    sigma = [float(s) for s in res.sigma]
    mv = expA.matvec(res.optimal_inputs[0])
    triplet = space.norm({k: mv[k] - sigma[0] * res.optimal_outputs[0][k] for k in mv}) / sigma[0]
    t1 = time.time()
    v = space.rand(3)
    for _ in range(12):
        v, _ = space.normalize(v)
        v = expA.rmatvec(expA.matvec(v))
    power = float(np.sqrt(space.norm(v)))
    seconds["power"] = time.time() - t1
    med = {k: statistics.median(v) for k, v in op.seconds.items()}
    phase("bfs", t0, nel=mesh.nel, order=mesh.basis.n - 1, nspin=nspin, tau=tau,
          nsteps=expA.nsteps, kdim=kdim, nsv=nsv, sigma=sigma, gain=[s * s for s in sigma],
          residuals=res.residuals.tolist(), n_matvec=res.n_matvec, triplet_rel=triplet,
          power_sigma1=power, power_rel=abs(power - sigma[0]) / sigma[0],
          spinup_ms_per_step=1e3 * seconds["spin-up"] / nspin,
          spinup_cg_iters_per_step={k: statistics.mean(v) for k, v in spin_stats.items()},
          s_per_matvec_median=med["matvec"], s_per_rmatvec_median=med["rmatvec"],
          kernel_runs_per_matvec=statistics.median(op.runs["matvec"]),
          kernel_runs_per_rmatvec=statistics.median(op.runs["rmatvec"]),
          seconds=seconds, kernel_runs=runs)
    assert sigma[0] > 1.0 and sigma[0] >= sigma[1] > 0, sigma
    assert triplet <= 1e-3, triplet
    assert abs(power - sigma[0]) < 5e-2 * sigma[0], (power, sigma[0])
    return runs


def box21k(dev, dtype):
    """tests/test_precond.py:61-77's box: 147 x 147 walled elements on the
    unit square, order 3 (21,609 elements)."""
    from neklab_tpu_torch.mesh.box import box_mesh

    return box_mesh((147, 147), ((0.0, 1.0), (0.0, 1.0)), WALLED, order=3, dtype=dtype,
                    device=dev)


def box21k_base(mesh):
    """A divergence-free flow that vanishes on the walls: the curl of the
    stream function sin^2(pi x) sin^2(pi y)."""
    x, y = mesh.x
    return torch.stack([np.pi * torch.sin(np.pi * x) ** 2 * torch.sin(2 * np.pi * y),
                        -np.pi * torch.sin(2 * np.pi * x) * torch.sin(np.pi * y) ** 2])


def box21k_phase(dev) -> dict:
    """Phase 13: the pressure preconditioner's aggregated tier and the
    matrix-free E at the reference's own size (tests/test_precond.py:61-77,
    slow there): the 21,609-element walled box at order 3. In f64 the
    default preconditioner takes the RCB-aggregated constant coarse space
    (asserts agg_of_el set, ec_inv at most 4096 square, no exact blocks) and
    the E-CG (the test's protocol: a random mean-free right-hand side, the
    preconditioner's output made mean-free) reaches 1e-6 in fewer than 300
    iterations; the build's seconds and whether the native library ran are
    printed. Then in f32, 20 linearized steps about `box21k_base` with the
    sustained and floor protocol of bench.py:73-106 (the state B-normalized
    before every call), with `compress` off and on, in turns: ms/step, E
    and velocity CG iterations per step, kernel runs per step. Returns the
    kernel runs of the f32 steps."""
    from neklab_tpu_torch import native
    from neklab_tpu_torch.models import navier_stokes as ns
    from neklab_tpu_torch.models import stokes
    from neklab_tpu_torch.models.linearized import LinConfig, propagate
    from neklab_tpu_torch.models.precond import build_e_preconditioner
    from neklab_tpu_torch.models.solvers import pcg_info
    from neklab_tpu_torch.ops import helmholtz_kernel as hk
    from neklab_tpu_torch.ops import sem
    from neklab_tpu_torch.utils.timestep import cfl_dt

    t0 = time.time()
    mesh = box21k(dev, torch.float64)
    t1 = time.time()
    pc = build_e_preconditioner(mesh, 1e-2)
    torch.cuda.synchronize()
    build_s = time.time() - t1
    assert pc.agg_of_el is not None and pc.ec_inv.shape[0] <= 4096 and pc.eb_w is None
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    rhs = torch.randn(tuple(mesh.bm2.shape), generator=gen, dtype=torch.float64, device=dev)
    rhs = rhs - rhs.mean()
    t1 = time.time()
    _, k, rr = pcg_info(lambda q: stokes.e_op(mesh, q, 1e-2), rhs,
                        precond=lambda r: pc.apply(r) - pc.apply(r).mean(), tol=1e-6,
                        maxiter=4000)
    cg_s = time.time() - t1
    assert k < 300, k

    mesh = box21k(dev, torch.float32)
    base = box21k_base(mesh)
    dt = cfl_dt(mesh, base, cfl=0.5)
    nsteps = 20
    fc = ns.FlowConfig(viscosity=1e-3, dt=dt, vtol=1e-5, ptol=1e-5, pmaxit=300)
    cfg = LinConfig(flow=fc)
    th = torch.zeros((0,) + tuple(mesh.bm1.shape), dtype=torch.float32, device=dev)
    orders = ns.bdf_orders(fc, nsteps)
    vdiag, _ = ns.bdf3_diags(mesh, fc)
    vsolves = ns.velocity_solvers(mesh, fc, orders, vdiag, None)
    props, build_f32_s = {}, {}
    for compress in (False, True):
        t1 = time.time()
        pc32 = build_e_preconditioner(mesh, compress=compress)
        torch.cuda.synchronize()
        build_f32_s[str(compress)] = time.time() - t1
        props[compress] = (pc32, ns.pressure_solvers(mesh, fc, orders, pc32))

    def bnorm(u):
        return u / sem.mass_dot(mesh, u, u).sqrt().clamp_min(torch.finfo(u.dtype).tiny)

    def timed(compress, state, scale, reps=3):
        """-> (s per call, kernel runs per step, mean CG iterations per step, state)."""
        psolves = props[compress][1]
        run = lambda u, stats=None: propagate(mesh, cfg, base, th, u, th, nsteps, vdiag=vdiag,
                                              psolves=psolves, vsolves=vsolves, stats=stats)[0]
        state = scale * bnorm(run(state))  # warm-up
        stats = counts_only()
        n0 = hk.launches(dev)
        t2 = time.time()
        for _ in range(reps):
            state = scale * bnorm(run(state, stats))
        torch.cuda.synchronize()
        seconds = (time.time() - t2) / reps
        return (seconds, (hk.launches(dev) - n0) / (reps * nsteps),
                {k: statistics.mean(v) for k, v in stats.items()}, state)

    gen.manual_seed(42)
    fresh = lambda: bnorm(mesh.vmask * sem.dsavg(mesh, torch.randn(
        (2,) + tuple(mesh.bm1.shape), generator=gen, dtype=torch.float32, device=dev)))
    hk.reset_launches(dev)
    rows = {False: [], True: []}
    for compress in (False, True, True, False):  # in turns
        s_sus, runs_step, iters, state = timed(compress, fresh(), 1.0)
        assert bool(torch.isfinite(state).all())
        s_floor, _, iters_floor, _ = timed(compress, 1e-8 * state, 1e-8)
        rows[compress].append({"ms_per_step": 1e3 * s_sus / nsteps,
                               "ms_per_step_floor": 1e3 * s_floor / nsteps,
                               "cg_iters_per_step": iters,
                               "cg_iters_per_step_floor": iters_floor,
                               "kernel_runs_per_step": runs_step})
    launches = hk.launches(dev)
    phase("box21k", t0, nel=mesh.nel, order=mesh.basis.n - 1, native=native.available(),
          pc_build_s_f64=build_s, ec_inv_shape=list(pc.ec_inv.shape), e_cg_iters=k,
          e_cg_rr=float(rr), e_cg_s=cg_s, pc_build_s_f32=build_f32_s, dt=dt, nsteps=nsteps,
          compress_false=rows[False], compress_true=rows[True], kernel_runs=launches)
    return {"21k box steps (phase 13)": launches}


CHANNEL3 = {"x-": "P", "x+": "P", "y-": "W", "y+": "W", "z-": "P", "z+": "P"}
WALLED3 = {f: "W" for f in ("x-", "x+", "y-", "y+", "z-", "z+")}


def small_3d(dev) -> dict:
    """Phase 3d's meshes, f64: tests/test_stepper.py's forced channel, (2, 2,
    2) elements at order 4, periodic in x and z, and tests/test_precond.py's
    walled (3, 2, 2) box at order 4, each with a base flow for the
    linearized map."""
    from neklab_tpu_torch.mesh.box import box_mesh

    channel3 = box_mesh((2, 2, 2), ((0.0, 2.0), (-1.0, 1.0), (0.0, 2.0)), CHANNEL3, order=4,
                        dtype=torch.float64, device=dev)
    walled3 = box_mesh((3, 2, 2), ((0.0, 1.5), (0.0, 1.0), (0.0, 1.0)), WALLED3, order=4,
                       dtype=torch.float64, device=dev)
    y = channel3.x[1]
    x, yw, zw = walled3.x
    bump = torch.sin(np.pi * x / 1.5) * torch.sin(np.pi * yw) * torch.sin(np.pi * zw)
    return {"channel": (channel3, torch.stack([1 - y**2, 0.1 * (1 - y**2), 0 * y])),
            "walled": (walled3, torch.stack([bump, 0.5 * bump, -0.3 * bump]))}


def parity_3d_phase(dev):
    """Phase 3d: the 3-D path on the card against the CPU, f64, on
    `small_3d`'s meshes: `helmholtz_local` (the plain chain through
    `tensor.linear`); the nonlinear `advance`, 10 steps of the forced
    channel (tests/test_stepper.py:179-199); one `ExponentialPropagator`
    matvec and rmatvec (10 steps) with the default 3-D preconditioner,
    block Jacobi + constants through the matrix-free E; the B-adjoint
    identity on the card. The solves run to 1e-14 (phase 3u: at 1e-12 the
    card's and the CPU's slow E-CGs stop a few iterations apart). Asserts
    <= 1e-12 relative, and that the 3-D path never ran the 2-D kernel (its
    device counter does not move)."""
    from neklab_tpu_torch.linops.exponential_propagator import ExponentialPropagator
    from neklab_tpu_torch.models import navier_stokes as ns
    from neklab_tpu_torch.models.linearized import LinConfig
    from neklab_tpu_torch.models.precond import build_e_preconditioner
    from neklab_tpu_torch.ops import helmholtz_kernel as hk
    from neklab_tpu_torch.ops import sem

    t0 = time.time()
    runs0 = hk.launches(dev)
    meshes = {d: small_3d(d) for d in (dev, "cpu")}
    rng = np.random.default_rng(31)
    errs, iters = {}, {}
    for name, (m_h, _) in meshes["cpu"].items():
        u = rng.standard_normal((3,) + tuple(m_h.bm1.shape))
        out = {d: sem.helmholtz_local(meshes[d][name][0], torch.as_tensor(u, device=d), 0.01,
                                      91.7) for d in (dev, "cpu")}
        errs[f"helmholtz_local/{name}"] = rel(out[dev].cpu(), out["cpu"])

    nu = 0.8

    def force(m, t, u, th):
        f = torch.zeros((3,) + tuple(m.bm1.shape), dtype=m.dtype, device=m.device)
        f[0] = 2 * nu
        return f

    fc = ns.FlowConfig(viscosity=nu, dt=2e-2, vtol=1e-14, ptol=1e-14, pmaxit=2000,
                       forcing_fn=force)
    states, iters["advance"] = {}, {}
    for d in (dev, "cpu"):
        m = meshes[d]["channel"][0]
        stats = counts_only()
        states[d] = ns.advance(m, fc, ns.initial_state(m, fc), 10,
                               pc_e=build_e_preconditioner(m, fc.dt / (11 / 6)), stats=stats)
        iters["advance"][str(d)] = {k: sum(v) for k, v in stats.items()}
    for k in ("u", "ulag", "nlag"):
        errs[f"advance/{k}"] = rel(getattr(states[dev], k).cpu(), getattr(states["cpu"], k))
    # the uniform force leaves the pressure at rounding's level: absolute
    errs["advance/p (absolute)"] = float((states[dev].p.cpu() - states["cpu"].p).abs().max())

    identity = {}
    lc = LinConfig(flow=ns.FlowConfig(viscosity=0.01, dt=2e-2, vtol=1e-14, ptol=1e-14,
                                      pmaxit=2000))
    for name, (m_h, _) in meshes["cpu"].items():
        th = torch.zeros((0,) + tuple(m_h.bm1.shape), dtype=torch.float64)
        u0, v0 = (m_h.vmask * sem.dsavg(m_h, torch.as_tensor(
            rng.standard_normal((3,) + tuple(m_h.bm1.shape)))) for _ in range(2))
        outs = {}
        for d in (dev, "cpu"):
            m, base = meshes[d][name]
            prop = ExponentialPropagator(m, lc, base, tau=0.2, dt=0.02, adjoint_tol_factor=1.0)
            assert prop.nsteps == 10 and prop.pc_e.eb_w is None
            assert prop.pc_e.blocks_inv is not None
            st_mv, st_rmv = counts_only(), counts_only()
            mv = prop.matvec({"u": u0.to(d), "theta": th.to(d)}, stats=st_mv)["u"]
            rmv = prop.rmatvec({"u": v0.to(d), "theta": th.to(d)}, stats=st_rmv)["u"]
            outs[d] = (mv, rmv)
            iters[f"{name}/{d}"] = {"matvec": {k: sum(v) for k, v in st_mv.items()},
                                    "rmatvec": {k: sum(v) for k, v in st_rmv.items()}}
        errs[f"matvec/{name}"] = rel(outs[dev][0].cpu(), outs["cpu"][0])
        errs[f"rmatvec/{name}"] = rel(outs[dev][1].cpu(), outs["cpu"][1])
        m = meshes[dev][name][0]
        lhs = float(sem.mass_dot(m, outs[dev][0], v0.to(dev)))
        rhs = float(sem.mass_dot(m, u0.to(dev), outs[dev][1]))
        identity[name] = abs(lhs - rhs) / abs(lhs)
    runs = hk.launches(dev) - runs0
    phase("parity_3d", t0, rel_err=errs, b_adjoint_identity_rel=identity, cg_iters=iters,
          helmholtz2d_runs=runs, nel={k: v[0].nel for k, v in meshes["cpu"].items()})
    assert runs == 0, runs
    for key, value in errs.items():
        assert value <= 1e-12, (key, value)
    for key, value in identity.items():
        assert value <= 1e-10, (key, value)


def box3d_mesh(dev, dtype=torch.float32):
    """bench.py:312-345's duct: 12 x 12 x 12 elements on [0, 4] x [-1, 1]^2,
    periodic in x, walled in y and z, order 5 (1,119,744 velocity DOF)."""
    from neklab_tpu_torch.mesh.box import box_mesh

    return box_mesh((12, 12, 12), ((0.0, 4.0), (-1.0, 1.0), (-1.0, 1.0)),
                    {"x-": "P", "x+": "P", "y-": "W", "y+": "W", "z-": "W", "z+": "W"},
                    order=5, dtype=dtype, device=dev)


def box3d_phase(dev):
    """Phase 14: box3d, the configuration of bench.py:312-345 exactly: the
    duct of `box3d_mesh` in f32, nu = 1e-3, dt = 2e-3, vtol = ptol = 1e-5,
    vmaxit 60, pmaxit 150, the base flow (1 - y^2)(1 - z^2), the default
    preconditioner at dt/(11/6) (block Jacobi + constants, the matrix-free
    E), 20 linearized steps per call with the sustained protocol of
    bench.py:73-106 (the state B-normalized before every call) and its
    floor; then the exact adjoint of the same program (its tolerances, so
    the B-adjoint identity is held to them), sustained, and its tape's
    bytes. Prints ms/step, CG iterations per step, the preconditioner's
    and the Jacobi diagonal's build seconds and the diagonal's peak memory
    above what was allocated before it, and the phase's peak device
    memory. Asserts every output finite, every CG converged inside its
    maxit, and <M u, v>_B = <u, M* v>_B to 1e-3 (f32 solves at 1e-5).
    (b): the same propagator with recycle 0 and RECYCLE
    (`recycled_propagator`)."""
    from neklab_tpu_torch.models import navier_stokes as ns
    from neklab_tpu_torch.models.linearized import LinConfig, make_adjoint_propagator, propagate
    from neklab_tpu_torch.models.precond import build_e_preconditioner
    from neklab_tpu_torch.ops import sem

    t0 = time.time()
    torch.cuda.reset_peak_memory_stats(dev)
    mesh = box3d_mesh(dev)
    fc = ns.FlowConfig(viscosity=1e-3, dt=2e-3, vtol=1e-5, ptol=1e-5, vmaxit=60, pmaxit=150)
    cfg = LinConfig(flow=fc)
    y, z = mesh.x[1], mesh.x[2]
    base_u = torch.stack([(1 - y**2) * (1 - z**2), 0 * y, 0 * y])
    th = torch.zeros((0,) + tuple(mesh.bm1.shape), dtype=torch.float32, device=dev)
    g0 = 11 / 6
    t1 = time.time()
    pc = build_e_preconditioner(mesh, fc.dt / g0)
    torch.cuda.synchronize()
    pc_s = time.time() - t1
    assert pc.eb_w is None and pc.blocks_inv is not None and pc.agg_of_el is None
    before = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    t1 = time.time()
    vdiag = ns.helmholtz_diag(mesh, fc.viscosity, g0 / fc.dt, mesh.vmask)
    torch.cuda.synchronize()
    diag_s = time.time() - t1
    diag_peak = torch.cuda.max_memory_allocated(dev) - before
    assert bool(torch.isfinite(vdiag).all()) and float(vdiag.min()) > 0
    nsteps, dof = 20, 3 * mesh.nel * mesh.npts
    orders = ns.bdf_orders(fc, nsteps)
    psolves = ns.pressure_solvers(mesh, fc, orders, pc)
    vsolves = ns.velocity_solvers(mesh, fc, orders, vdiag, None)

    def prop(u, stats=None):
        return propagate(mesh, cfg, base_u, th, u, th, nsteps, pc_e=pc, vdiag=vdiag,
                         psolves=psolves, vsolves=vsolves, stats=stats)[0]

    def bnorm(u):
        return u / sem.mass_dot(mesh, u, u).sqrt().clamp_min(torch.finfo(u.dtype).tiny)

    every = {"helmholtz": [], "pressure": []}

    def timed(state, scale, fn=prop, reps=3):
        """-> (s per call, mean CG iterations per step, last state)."""
        state = scale * bnorm(fn(state))  # warm-up
        stats = counts_only()
        torch.cuda.synchronize()
        t2 = time.time()
        for _ in range(reps):
            state = scale * bnorm(fn(state, stats=stats))
        torch.cuda.synchronize()
        for k, v in stats.items():
            every[k] += v
        return ((time.time() - t2) / reps, {k: statistics.mean(v) for k, v in stats.items()},
                state)

    gen = torch.Generator(device=dev)
    gen.manual_seed(2)

    def fresh():
        return bnorm(mesh.vmask * sem.dsavg(mesh, torch.randn(
            (3,) + tuple(mesh.bm1.shape), generator=gen, dtype=torch.float32, device=dev)))

    s_sus, iters_sus, state = timed(fresh(), 1.0)
    assert bool(torch.isfinite(state).all())
    s_floor, iters_floor, _ = timed(1e-8 * state, 1e-8)
    # (b) recycling on the same propagator and solvers
    recycled, _ = recycled_propagator(
        mesh, lambda u, r, stats: propagate(mesh, cfg, base_u, th, u, th, nsteps, pc_e=pc,
                                            vdiag=vdiag, psolves=psolves, vsolves=vsolves,
                                            stats=stats, recycle=r)[0],
        fresh(), nsteps, max(fc.vtol, fc.ptol))

    t1 = time.time()
    adj = make_adjoint_propagator(mesh, cfg, base_u, th, nsteps, pc_e=pc, vdiag=vdiag,
                                  psolves=psolves, vsolves=vsolves)
    torch.cuda.synchronize()
    rec_s = time.time() - t1
    s_adj, adj_iters, adj_state = timed(fresh(), 1.0,
                                        fn=lambda u, stats=None: adj(u, th, stats=stats)[0])
    assert bool(torch.isfinite(adj_state).all()) and adj.tape_bytes > 0
    u0, v0 = fresh(), fresh()
    mu, mtv = prop(u0), adj(v0, th)[0]
    assert bool(torch.isfinite(mu).all()) and bool(torch.isfinite(mtv).all())
    lhs, rhs = float(sem.mass_dot(mesh, mu, v0)), float(sem.mass_dot(mesh, u0, mtv))
    identity = abs(lhs - rhs) / abs(lhs)
    peak = torch.cuda.max_memory_allocated(dev)
    phase("box3d", t0, nel=mesh.nel, order=mesh.basis.n - 1, dof=dof, nsteps=nsteps,
          ms_per_step=1e3 * s_sus / nsteps, ms_per_step_floor=1e3 * s_floor / nsteps,
          dof_steps_per_s=dof * nsteps / s_sus, cg_iters_per_step=iters_sus,
          cg_iters_per_step_floor=iters_floor, adjoint_ms_per_step=1e3 * s_adj / nsteps,
          adjoint_cg_iters_per_step=adj_iters, adjoint_build_s=rec_s, tape_bytes=adj.tape_bytes,
          max_cg_iters={k: max(v) for k, v in every.items()}, pc_build_s=pc_s,
          local_diagonal_build_s=diag_s, local_diagonal_peak_bytes=diag_peak,
          peak_device_bytes=peak, b_adjoint_identity_rel=identity, lhs=lhs, rhs=rhs,
          recycled=recycled)
    assert max(every["helmholtz"]) < fc.vmaxit and max(every["pressure"]) < fc.pmaxit, every
    assert identity <= 1e-3, (lhs, rhs)


# the Krylov dimension and residual tolerance of phase 15: the two leading
# modes are shear modes, whose left and right eigenvectors agree, so the
# eigenvalue error is about residual^2 / gap (residuals 1.7e-6 and 3.4e-4
# put both within 1.7e-7 of the oracle). A Krylov dimension the solve
# does not reach converges without a restart: 336 matvecs, against 407 at
# 60 and 464 at 100 (PERF.md section 6)
CHANNEL3D_KDIM, CHANNEL3D_TOL = 400, 5e-4
# the solves' tolerance (vtol = ptol) of phase 15's eigensolve: 1e-10 -> 1e-7
# to make room for phases 17 and 18 (95.3 -> 52.6 E-CG iterations a step,
# one matvec counted on the CPU). The shear modes carry no pressure and the
# eigensolve asks Ritz residuals of 5e-4, so the oracle is met (within
# 6.8e-7, PERF.md section 6), but the eigensolve no longer checks what the
# f64 solves reach beyond float32's (ROADMAP.md); (c) keeps 1e-10, where the
# residual projection has iterations to remove
CHANNEL3D_SOLVE_TOL, CHANNEL3D_RECYCLE_TOL = 1e-7, 1e-10


def channel3d_phase(dev):
    """Phase 15: the main path in 3-D through the user entry points
    (box_mesh -> ExponentialPropagator -> flow_vector_space ->
    linear_stability_analysis_fixed_point): plane Poiseuille at Re = 500
    extruded spanwise, (4, 5, 2) elements at order 6 on [0, 2 pi] x [-1, 1]
    x [0, 2], periodic in x and z, f64, vtol = ptol = CHANNEL3D_SOLVE_TOL,
    tau = 0.5, nev 2, with the driver's files (spectrum, mode files, timers.log)
    written to .scratch/channel3d. The oracle is analytic. The
    spanwise-uniform shear modes cos(pi y / 2) e_x and cos(pi y / 2) e_z
    both have lambda_1 = -nu (pi / 2)^2, a double eigenvalue; the next is
    -nu pi^2 (sin(pi y) e_x and e_z), and every other mode decays faster
    (PERF.md section 4). An eigensolve from one start vector reports a
    double eigenvalue once unless rounding brings in its second direction
    (tests/test_torch_3d_propagator.py, in both packages). Asserts the
    leading eigenvalue within 1e-5 of lambda_1, the second within 1e-5 of
    lambda_1 or of -nu pi^2, and both Ritz residuals below the solve's
    tol. Then (c): one matvec of the same propagator built at vtol = ptol
    = CHANNEL3D_RECYCLE_TOL, with recycle 0 and RECYCLE, from one C0 field
    of the seed: seconds per matvec, pressure iterations per step, the two
    outputs' difference under 1e3 ptol."""
    from neklab_tpu_torch import (ExponentialPropagator, FlowConfig, LinConfig, box_mesh,
                                  flow_vector_space, linear_stability_analysis_fixed_point)
    from neklab_tpu_torch.models.linearized import propagate
    from neklab_tpu_torch.ops import sem

    t0 = time.time()
    mesh = box_mesh((4, 5, 2), ((0.0, 2 * np.pi), (-1.0, 1.0), (0.0, 2.0)), CHANNEL3, order=6,
                    dtype=torch.float64, device=dev)
    y = mesh.x[1]
    re = 500.0
    base = torch.stack([1 - y**2, 0 * y, 0 * y])

    def propagator(tol):
        cfg = LinConfig(flow=FlowConfig(viscosity=1 / re, dt=1e-2, vtol=tol, ptol=tol))
        return ExponentialPropagator(mesh, cfg, base, tau=0.5, cfl=0.5)

    prop = propagator(CHANNEL3D_SOLVE_TOL)
    outdir = os.path.join(ROOT, ".scratch", "channel3d")
    res = linear_stability_analysis_fixed_point(prop, flow_vector_space(mesh, 0),
                                                kdim=CHANNEL3D_KDIM, nev=2, tol=CHANNEL3D_TOL,
                                                maxiter=2, outdir=outdir,
                                                check_every=CHECK_EVERY)
    # (c) one matvec with recycle 0 and RECYCLE from the same start
    prop = propagator(CHANNEL3D_RECYCLE_TOL)
    th = torch.zeros((0,) + tuple(mesh.bm1.shape), dtype=mesh.dtype, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(15)
    u0 = mesh.vmask * sem.dsavg(mesh, torch.randn((3,) + tuple(mesh.bm1.shape), generator=gen,
                                                  dtype=mesh.dtype, device=dev))
    recycled, mv = {}, {}
    for r in (0, RECYCLE):
        stats = counts_only()
        torch.cuda.synchronize()
        t1 = time.time()
        mv[r] = propagate(mesh, prop.cfg, prop.base_u, th, u0, th, prop.nsteps, pc_e=prop.pc_e,
                          vdiag=prop.vdiag, psolves=prop.psolves, vsolves=prop.vsolves,
                          stats=stats, recycle=r)[0]
        torch.cuda.synchronize()
        recycled[f"s_per_matvec_recycle{r}"] = time.time() - t1
        recycled[f"pressure_iters_per_step_recycle{r}"] = statistics.mean(stats["pressure"])
        recycled[f"pressure_iters_post_ramp_recycle{r}"] = statistics.mean(stats["pressure"][2:])
    recycled["rel_diff"] = rel(mv[RECYCLE], mv[0])
    recycled["rel_diff_bound"] = 1e3 * CHANNEL3D_RECYCLE_TOL
    lam1, lam3 = -(1 / re) * np.pi**2 * np.array([0.25, 1.0])
    dist = np.array([abs(res.eigvals[0] - lam1),
                     min(abs(res.eigvals[1] - lam1), abs(res.eigvals[1] - lam3))])
    files = sorted(os.listdir(outdir))
    phase("channel3d", t0, nel=mesh.nel, dt=prop.dt, nsteps=prop.nsteps,
          eigvals=[[v.real, v.imag] for v in res.eigvals], oracle=[lam1, lam3],
          dist=dist.tolist(), residuals=res.residuals.tolist(), n_matvec=res.n_matvec,
          seconds=res.elapsed, s_per_matvec=res.elapsed / res.n_matvec, files=files,
          recycled=recycled)
    assert {"dir_eigenspectrum.npy", "dirmode0.f00001.npz", "dirmode0.f00002.npz",
            "timers.log"} <= set(files), files
    assert np.all(dist <= 1e-5), dist
    assert np.all(res.residuals < CHANNEL3D_TOL), res.residuals
    assert recycled["rel_diff"] <= recycled["rel_diff_bound"], recycled


# ---------------------------------------------------------------------------
# phase 16: element-partitioned runs on the one card
# ---------------------------------------------------------------------------

# the eigensolve of tests/test_sharding.py:199-245 at dt = tau = 0.4 in
# place of its 2e-3: one step per matvec, not 200 (PERF.md section 4):
# four gloo ranks sharing the card take ~3.5 ms per all-reduce, ~240 a step
SHARDED_EIGS_DT = 0.4
# and its Krylov dimension 16 -> 24: at that dt the second pair reaches the
# case's 1e-7 inside 8 cycles of kdim 24 (80 matvecs), not of kdim 16
SHARDED_EIGS_KDIM = 24
# the split eigensolve starts from the one-process run's two eigenvectors
# (their real and imaginary parts summed, B-normalized), which the main
# process writes here (in the ranks' work directory) while the ranks run
# 16b and 16c: a few matvecs, not 80 (PERF.md section 4)
EIGS_START = "eigs_start.npz"
SHARDED_F64 = dict(viscosity=1e-3, dt=2e-3, vtol=1e-10, ptol=1e-10, vmaxit=400, pmaxit=800)
SHARDED_NSTEPS = 3  # the BDF1/2 ramp and one BDF3 step


def sharded_box2d(dev, dtype):
    return channel(dev, dtype, (64, 16), 7)


def sharded_mesh(case: str, dev, dtype):
    """The global mesh of a phase-16 case: box2d 131k, box3d, or the
    eigensolve's box (tests/test_sharding.py:28-38)."""
    if case == "box2d":
        return sharded_box2d(dev, dtype)
    if case == "box3d":
        return box3d_mesh(dev, dtype)
    return channel(dev, dtype, (8, 2), 4)


def sharded_base(mesh):
    y = mesh.x[1]
    if mesh.ndim == 3:
        z = mesh.x[2]
        return torch.stack([(1 - y**2) * (1 - z**2), 0 * y, 0 * y])
    return torch.stack([1 - y**2, 0 * y])


def _c0_pair(mesh, seed):
    """Two C0, velocity-masked fields of the mesh, from a CPU generator."""
    from neklab_tpu_torch.ops import sem

    gen = torch.Generator()
    gen.manual_seed(seed)
    draw = lambda: torch.randn((mesh.ndim,) + tuple(mesh.bm1.shape), generator=gen,
                               dtype=mesh.dtype).to(mesh.device)
    return [mesh.vmask * sem.dsavg(mesh, draw()) for _ in range(2)]


def _log(part) -> dict:
    return {"calls": part.log.calls, "bytes": part.log.bytes,
            "largest_numel": max(part.log.by_numel, default=0)}


def _allreduce_ms(dev, numel: int, reps: int = 200) -> float:
    """Host ms per gloo all-reduce of `numel` float64 on the card, the ranks
    doing nothing else (synchronized)."""
    import torch.distributed as dist

    buf = torch.zeros(max(numel, 1), dtype=torch.float64, device=dev)
    for _ in range(10):
        dist.all_reduce(buf)
    torch.cuda.synchronize(dev)
    t1 = time.time()
    for _ in range(reps):
        dist.all_reduce(buf)
    torch.cuda.synchronize(dev)
    return 1e3 * (time.time() - t1) / reps


def rank_propagate(part, dev, case: str, work: str) -> dict:
    """A gloo rank of phase 16 (b, c): propagate and its adjoint in f64 on
    the rank's block of box2d or box3d."""
    from neklab_tpu_torch.models import navier_stokes as ns
    from neklab_tpu_torch.models.linearized import LinConfig, make_adjoint_propagator, propagate
    from neklab_tpu_torch.models.navier_stokes import FlowConfig
    from neklab_tpu_torch.models.precond import build_e_preconditioner
    from neklab_tpu_torch.ops import helmholtz_kernel as hk
    from neklab_tpu_torch.ops import sem
    from neklab_tpu_torch.parallel import gather_field, shard_field, shard_sem_mesh

    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    start = torch.cuda.memory_allocated(dev)
    t1 = time.time()
    mesh = shard_sem_mesh(sharded_mesh(case, "cpu", torch.float64), part)
    with np.load(os.path.join(work, "in.npz")) as z:
        u0, v0 = (shard_field(z[f"{k}_{case}"], part) for k in ("u0", "v0"))
    cfg = LinConfig(flow=FlowConfig(**SHARDED_F64))
    base = sharded_base(mesh)
    th = torch.zeros((0,) + tuple(mesh.bm1.shape), dtype=mesh.dtype, device=dev)
    pc = build_e_preconditioner(mesh, cfg.flow.dt / (11 / 6))
    orders = ns.bdf_orders(cfg.flow, SHARDED_NSTEPS)
    solvers = dict(psolves=ns.pressure_solvers(mesh, cfg.flow, orders, pc),
                   vsolves=ns.velocity_solvers(mesh, cfg.flow, orders,
                                               *ns.bdf3_diags(mesh, cfg.flow)))
    setup_s = time.time() - t1
    part.log.reset()
    hk.reset_launches(dev)
    stats = counts_only()
    torch.cuda.synchronize(dev)
    t1 = time.time()
    mu, _ = propagate(mesh, cfg, base, th, u0, th, SHARDED_NSTEPS, pc_e=pc, stats=stats,
                      **solvers)
    torch.cuda.synchronize(dev)
    s_dir = time.time() - t1
    log_dir = _log(part)
    runs = hk.launches(dev)
    adj = make_adjoint_propagator(mesh, cfg, base, th, SHARDED_NSTEPS, pc_e=pc, **solvers)
    t1 = time.time()
    av, _ = adj(v0, th)
    torch.cuda.synchronize(dev)
    s_adj = time.time() - t1
    ident = torch.stack([sem.mass_dot(mesh, mu, v0), sem.mass_dot(mesh, u0, av)])
    stats_out = {"peak_bytes": torch.cuda.max_memory_allocated(dev) - start,
                 "setup_s": setup_s, "ms_per_step": 1e3 * s_dir / SHARDED_NSTEPS,
                 "adjoint_ms_per_step": 1e3 * s_adj / SHARDED_NSTEPS,
                 "collectives_per_step": log_dir["calls"] / SHARDED_NSTEPS,
                 "bytes_per_collective": log_dir["bytes"] / max(log_dir["calls"], 1),
                 "largest_numel": log_dir["largest_numel"], "nel": mesh.nel,
                 "cg_iters_per_step": {k: statistics.mean(v) for k, v in stats.items()},
                 "kernel_runs": runs,
                 "graphed": [solvers["psolves"][o].cg.graphed for o in orders]
                 + [solvers["vsolves"][o][0].cg.graphed for o in orders],
                 "ms_per_allreduce_alone": {
                     "8 B": _allreduce_ms(dev, 1),
                     f"{8 * mesh.xch_n * mesh.ndim} B": _allreduce_ms(dev, mesh.xch_n * mesh.ndim)}}
    return {"mu": gather_field(mu, part), "adj": gather_field(av, part),
            "identity": ident, "stats": stats_out}


def eigs_start(work: str, timeout: float = 600.0) -> np.ndarray:
    """Phase 16d's start vector (the velocity of `EIGS_START` under work),
    once the one-process run has written it."""
    path = os.path.join(work, EIGS_START)
    deadline = time.time() + timeout
    while not os.path.exists(path):
        if time.time() > deadline:
            raise TimeoutError(f"phase 16d: no start vector at {path}")
        time.sleep(0.5)
    with np.load(path) as z:
        return z["u"]


def rank_eigs(part, dev, work: str) -> dict:
    """A gloo rank of phase 16 (d): the eigensolve through the driver from
    the one-process run's eigenvectors (`eigs_start`), rank 0 writing its
    files to work/out."""
    from neklab_tpu_torch import (ExponentialPropagator, FlowConfig, LinConfig, flow_vector,
                                  flow_vector_space, linear_stability_analysis_fixed_point)
    from neklab_tpu_torch.ops import helmholtz_kernel as hk
    from neklab_tpu_torch.parallel import shard_field, shard_sem_mesh

    mesh = shard_sem_mesh(sharded_mesh("eigs", "cpu", torch.float64), part)
    v0 = flow_vector(mesh, 0, u=shard_field(eigs_start(work), part))
    y = mesh.x[1]
    fc = FlowConfig(viscosity=0.05, dt=SHARDED_EIGS_DT, vtol=1e-11, ptol=1e-11, vmaxit=60,
                    pmaxit=120)
    prop = ExponentialPropagator(mesh, LinConfig(flow=fc), torch.stack([0.3 * (1 - y**2), 0 * y]),
                                 tau=0.4, dt=fc.dt)
    part.log.reset()
    hk.reset_launches(dev)
    res = linear_stability_analysis_fixed_point(prop, flow_vector_space(mesh, 0),
                                                kdim=SHARDED_EIGS_KDIM, nev=2, tol=1e-7,
                                                maxiter=8, v0=v0, check_every=CHECK_EVERY,
                                                outdir=os.path.join(work, "out"))
    calls = part.log.calls
    steps = res.n_matvec * prop.nsteps
    return {"eigvals": res.multipliers, "residuals": res.residuals,
            "stats": {"n_matvec": res.n_matvec, "seconds": res.elapsed,
                      "ms_per_step": 1e3 * res.elapsed / steps,
                      "collectives_per_step": calls / steps,
                      "kernel_runs": hk.launches(dev)}}


def rank_nccl(part, dev, work: str) -> dict:
    """The one NCCL rank of phase 16 (a): box2d 131k in f32, 20 linearized
    steps through shard_sem_mesh -> propagate with graphed CGs, in turns
    with the same steps unsplit in this process; and (d) the same with
    recycle=RECYCLE, split and unsplit, in turns."""
    from neklab_tpu_torch.models import navier_stokes as ns
    from neklab_tpu_torch.models.linearized import LinConfig, propagate
    from neklab_tpu_torch.models.precond import build_e_preconditioner
    from neklab_tpu_torch.ops import helmholtz_kernel as hk
    from neklab_tpu_torch.parallel import shard_sem_mesh

    gm = sharded_box2d("cpu", torch.float32)
    fc = ns.FlowConfig(viscosity=1e-3, dt=2e-3, vtol=1e-5, ptol=1e-5, vmaxit=50, pmaxit=120)
    cfg, nsteps = LinConfig(flow=fc), 20
    runs = {}
    # the unsplit preconditioner is built first, on the card, into the
    # cache; the split one loads it on the host
    for name, mesh in (("one", gm.to(dev)), ("split", shard_sem_mesh(gm, part))):
        pc = build_e_preconditioner(mesh, fc.dt / (11 / 6))
        orders = ns.bdf_orders(fc, nsteps)
        psolves = ns.pressure_solvers(mesh, fc, orders, pc)
        vsolves = ns.velocity_solvers(mesh, fc, orders, *ns.bdf3_diags(mesh, fc))
        base = sharded_base(mesh)
        th = torch.zeros((0,) + tuple(mesh.bm1.shape), dtype=mesh.dtype, device=dev)
        u0 = _c0_pair(gm, 1)[0].to(dev)
        graphed = [psolves[o].cg.graphed for o in orders] + [vsolves[o][0].cg.graphed
                                                             for o in orders]
        for k in (0, RECYCLE):
            prop = lambda u, m=mesh, pc=pc, ps=psolves, vs=vsolves, b=base, th=th, s=None, k=k: \
                propagate(m, cfg, b, th, u, th, nsteps, pc_e=pc, psolves=ps, vsolves=vs,
                          stats=s, recycle=k)[0]
            runs[name + (f"_r{k}" if k else "")] = dict(prop=prop, u0=u0, graphed=graphed)
    out, times = {}, {name: [] for name in runs}
    # in turns; (d) with recycle=RECYCLE beside
    for order in ("split", "one", "one", "split", "split", "one", f"split_r{RECYCLE}",
                  f"one_r{RECYCLE}", f"one_r{RECYCLE}", f"split_r{RECYCLE}"):
        r = runs[order]
        part.log.reset()
        hk.reset_launches(dev)
        stats = counts_only()
        torch.cuda.synchronize(dev)
        t1 = time.time()
        mu = r["prop"](r["u0"], s=stats)
        torch.cuda.synchronize(dev)
        times[order].append(1e3 * (time.time() - t1) / nsteps)
        out[order] = {"mu": mu, "kernel_runs": hk.launches(dev),
                      "collectives_per_step": part.log.calls / nsteps,
                      "bytes_per_collective": part.log.bytes / max(part.log.calls, 1),
                      "cg_iters_per_step": {k: statistics.mean(v) for k, v in stats.items()}}
    mus = {name: o.pop("mu") for name, o in out.items()}
    return {"mu_split": mus["split"], "mu_one": mus["one"],
            "mu_split_recycled": mus[f"split_r{RECYCLE}"],
            "mu_one_recycled": mus[f"one_r{RECYCLE}"],
            "stats": {"graphed_split": runs["split"]["graphed"],
                      "graphed_one": runs["one"]["graphed"], "ms_per_step": times, **out}}


# phase 16f: small split cases after 16d, in the same four gloo ranks, each
# at minimal depth (PERF.md section 4): one step per matvec at 16d's dt
# where the case allows it (the resolvent's period needs four)
SMALL_F64 = dict(viscosity=0.05, dt=SHARDED_EIGS_DT, vtol=1e-11, ptol=1e-11, vmaxit=60,
                 pmaxit=120)
SMALL_TG = dict(nsv=1, kdim=2, tol=1e-6, seed=3)
SMALL_NU = 0.1  # the forced channel's (tests/test_systems.py), body force 2 nu
SMALL_UPO = dict(T=0.1, nsteps=2)
SMALL_OTD = dict(r=2, printstep=1, orthostep=1, iostep=2, iorststep=2, solve_baseflow=False)
SMALL_FILES = {"tg": ["singular_spectrum.dat", "timers.log"],
               "newton": ["residual.dat", "timers.log"],
               "otd": ["Lr.dat", "Ls.dat", "m01otd0.f00001", "m02otd0.f00001",
                       "rstotd0.f00001.npz"]}


def _small_force(m, t, u, th):
    f = torch.zeros((2,) + tuple(m.bm1.shape), dtype=m.dtype, device=m.device)
    f[0] = 2.0 * SMALL_NU
    return f


def small_cases(dev, part=None, outdir: str | None = None) -> dict:
    """Phase 16f's cases, f64, on rank `part`'s block (four gloo ranks
    sharing the card) or, with part None, in one process on the card: the
    same code, the same inputs (drawn whole on the host). On 16d's 8 x 2
    box at order 4 about 0.3 (1 - y^2) at dt 0.4: transient growth (nsv 1,
    kdim 2, one step per matvec), one resolvent frequency (4 steps per
    period, GMRES rtol 1e-2), the projected propagator's matvec and rmatvec
    (one step); on the forced 4 x 2 channel at order 4
    (tests/test_systems.py's, widened to split over four ranks): one Newton
    iteration with the exact Jacobian (tau = dt = 0.05, GMRES to 1e-2, the
    constant scheduler) and one bordered periodic-orbit Jacobian matvec
    (dT != 0) and rmatvec (T 0.1 over 2 steps); on tests/test_otd.py's 3 x 4
    channel: OTD with r = 2 over 2 steps from random modes. The drivers
    write to outdir/{tg,newton,otd}. -> the gathered results (rank 0's; the
    other ranks' hold None), the seconds of each case and the kernel runs."""
    from neklab_tpu_torch import (ExponentialPropagator, FlowConfig, LinConfig, box_mesh,
                                  flow_vector, flow_vector_space, newton_fixed_point_iteration,
                                  transient_growth_analysis_fixed_point)
    from neklab_tpu_torch import otd
    from neklab_tpu_torch.linops.projected import ProjectedPropagator
    from neklab_tpu_torch.linops.resolvent import Resolvent
    from neklab_tpu_torch.models.navier_stokes import initial_state
    from neklab_tpu_torch.ops import helmholtz_kernel as hk
    from neklab_tpu_torch.ops import sem
    from neklab_tpu_torch.parallel import gather_field, shard_field, shard_sem_mesh
    from neklab_tpu_torch.systems.fixed_point import FixedPointSystem
    from neklab_tpu_torch.systems.periodic_orbit import PeriodicOrbitSystem
    from neklab_tpu_torch.vectors import ext_flow_vector

    split = part is not None
    place = lambda gm: shard_sem_mesh(gm, part) if split else gm.to(dev)
    field = lambda f: shard_field(f, part) if split else f.to(dev)
    whole = lambda f: gather_field(f, part) if split else f.detach().cpu()
    out_of = lambda name: None if outdir is None else os.path.join(outdir, name)
    forced = lambda: box_mesh((4, 2), ((0.0, 2.0), (-1.0, 1.0)), CHANNEL, order=4,
                              device="cpu")

    def draws(gm, seed, n):
        """n C0, velocity-masked fields of the global mesh, drawn on the host."""
        gen = torch.Generator()
        gen.manual_seed(seed)
        return [gm.vmask * sem.dsavg(gm, torch.randn((2,) + tuple(gm.bm1.shape), generator=gen,
                                                     dtype=gm.dtype)) for _ in range(n)]

    out, seconds = {}, {}
    hk.reset_launches(dev)
    gm = channel("cpu", torch.float64, (8, 2), 4)
    mesh = place(gm)
    y = mesh.x[1]
    base = torch.stack([0.3 * (1 - y**2), 0 * y])
    cfg = LinConfig(flow=FlowConfig(**SMALL_F64))
    dt = cfg.flow.dt
    th = torch.zeros((0,) + tuple(mesh.bm1.shape), dtype=mesh.dtype, device=dev)

    t1 = time.time()
    A = ExponentialPropagator(mesh, cfg, base, tau=dt, dt=dt)
    tg = transient_growth_analysis_fixed_point(A, flow_vector_space(mesh, 0), outdir=out_of("tg"),
                                               **SMALL_TG)
    out.update(tg_sigma=tg.sigma, tg_n_matvec=tg.n_matvec)
    seconds["tg"] = time.time() - t1

    t1 = time.time()
    f_re, f_im, pv, pw = draws(gm, 41, 4)
    R = Resolvent(mesh, cfg, base, omega=2 * np.pi / (4 * dt), dt=dt, gmres_rtol=1e-2,
                  gmres_kdim=30)
    rf = R.matvec({"re": {"u": field(f_re), "theta": th}, "im": {"u": field(f_im), "theta": th}})
    out.update(res_re=whole(rf["re"]["u"]), res_im=whole(rf["im"]["u"]),
               res_gmres=R.last_gmres_matvecs, res_nsteps=R.nsteps)
    seconds["resolvent"] = time.time() - t1

    t1 = time.time()
    P = ProjectedPropagator(A, 1.0)
    norm = lambda v: v / float(sem.mass_dot(gm, v, v)) ** 0.5
    out["proj_matvec"] = whole(P.matvec({"u": field(norm(pv)), "theta": th})["u"])
    out["proj_rmatvec"] = whole(P.rmatvec({"u": field(norm(pw)), "theta": th})["u"])
    seconds["projected"] = time.time() - t1

    t1 = time.time()
    gm = forced()
    mesh = place(gm)
    th = torch.zeros((0,) + tuple(mesh.bm1.shape), dtype=mesh.dtype, device=dev)
    fcfg = LinConfig(flow=FlowConfig(viscosity=SMALL_NU, dt=0.05, vtol=1e-12, ptol=1e-12,
                                     forcing_fn=_small_force))
    gy = gm.x[1]
    noise, du, dv = draws(gm, 43, 3)
    guess = gm.vmask * sem.dsavg(gm, torch.stack([0.7 * (1 - gy**2), 0 * gy]) + 0.05 * noise)
    system = FixedPointSystem(mesh, fcfg, tau=0.05, dt=0.05, exact_jacobian=True)
    nres = newton_fixed_point_iteration(system, flow_vector(mesh, 0, u=field(guess)),
                                        flow_vector_space(mesh, 0), tol=1e-2, maxiter=1,
                                        scheduler="constant", gmres_kdim=20,
                                        outdir=out_of("newton"))
    out.update(newton_history=np.asarray(nres.history), newton_matvecs=np.asarray(nres.matvecs))
    seconds["newton"] = time.time() - t1

    t1 = time.time()
    upo = PeriodicOrbitSystem(mesh, fcfg, t_guess=SMALL_UPO["T"], nsteps=SMALL_UPO["nsteps"])
    orbit = gm.vmask * sem.dsavg(gm, torch.stack([0.9 * (1 - gy**2), 0.02 * torch.sin(np.pi * gy)])
                                 + 0.05 * noise)
    ext = lambda u, T: ext_flow_vector(mesh, 0, u=field(u), theta=th, T=T)
    jac = upo.jacobian(ext(orbit, SMALL_UPO["T"]))
    mv, rmv = jac.matvec(ext(du, 0.7)), jac.rmatvec(ext(dv, -0.4))
    out.update(upo_matvec=whole(mv["u"]), upo_matvec_T=float(mv["T"]), upo_rmatvec=whole(rmv["u"]),
               upo_rmatvec_T=float(rmv["T"]))
    seconds["upo"] = time.time() - t1

    t1 = time.time()
    gm = box_mesh((3, 4), ((0.0, 2 * np.pi), (-1.0, 1.0)), CHANNEL, order=4, device="cpu")
    mesh = place(gm)
    ocfg = LinConfig(flow=FlowConfig(viscosity=1 / 100, dt=0.06, vtol=1e-11, ptol=1e-11))
    y = mesh.x[1]
    res = otd.otd_analysis(mesh, ocfg, otd.OtdOpts(**SMALL_OTD),
                           initial_state(mesh, ocfg.flow, u=torch.stack([1 - y**2, 0 * y])), 2,
                           outdir=out_of("otd"), seed=7)
    out["otd_lr"] = np.stack([lr for _, lr in res.lr_history])
    seconds["otd"] = time.time() - t1
    out["kernel_runs"] = hk.launches(dev)
    out["seconds"] = seconds
    return out


def rank_small(part, dev, work: str) -> dict:
    """A gloo rank of phase 16f: `small_cases` on the rank's block, rank 0
    writing the drivers' files under work/small."""
    part.log.reset()
    out = small_cases(dev, part, os.path.join(work, "small"))
    out["stats"] = {"seconds": out.pop("seconds"), "kernel_runs": out.pop("kernel_runs"),
                    "allreduces": part.log.calls}
    return out


def rank_main(argv) -> None:
    """`chip_smoke.py --rank JOB RANK SIZE WORKDIR`: one rank of phase 16,
    JOB "nccl" (16a) or "gloo" (16b, c, d and f, one after another in the
    same ranks). Rank 0 writes each case's gathered fields to
    WORKDIR/out_<case>.npz; every rank writes its numbers to
    WORKDIR/stats<rank>.json."""
    job, rank, size, work = argv[0], int(argv[1]), int(argv[2]), argv[3]
    import torch.distributed as dist

    from neklab_tpu_torch.parallel import init_distributed

    torch.set_num_threads(1)
    dev = torch.device("cuda", 0)
    part = init_distributed(backend="nccl" if job == "nccl" else "gloo",
                            init_method="file://" + os.path.join(work, "rdv"), world_size=size,
                            rank=rank, device=dev, timeout=600)
    try:
        if job == "nccl":
            outs = {"nccl": rank_nccl(part, dev, work)}
        else:
            outs = {case: rank_propagate(part, dev, case, work) for case in ("box2d", "box3d")}
            outs["eigs"] = rank_eigs(part, dev, work)
            outs["small"] = rank_small(part, dev, work)
        stats = {case: out.pop("stats") for case, out in outs.items()}
        with open(os.path.join(work, f"stats{rank}.json"), "w") as f:
            json.dump(stats, f, default=float)
        for case, out in outs.items():
            if rank == 0:
                np.savez(os.path.join(work, f"out_{case}.npz"),
                         **{k: v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
                            for k, v in out.items()})
    finally:
        dist.destroy_process_group()


def start_ranks(job: str, size: int, inputs: dict | None = None):
    """Starts the ranks of a phase-16 job in a fresh .scratch/sharded_<job>."""
    import shutil

    work = os.path.join(ROOT, ".scratch", f"sharded_{job}")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    if inputs is not None:
        np.savez(os.path.join(work, "in.npz"), **inputs)
    log = open(os.path.join(work, "ranks.log"), "w+")
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--rank", job, str(r),
                               str(size), work], stdout=log, stderr=subprocess.STDOUT,
                              env=one_blas_thread())
             for r in range(size)]
    return procs, work, log


def finish_ranks(started, timeout: float):
    """Waits for the ranks (killing all at the limit); any failing rank
    fails the phase. -> ({case: rank 0's out_<case>.npz}, every rank's
    stats {case: numbers})."""
    procs, work, log = started
    deadline = time.time() + timeout
    try:
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.time()))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        log.seek(0)
        text = log.read()
        log.close()
    codes = [p.returncode for p in procs]
    if any(codes):
        print(text[-6000:], flush=True)
        raise AssertionError(f"phase 16 ranks of {os.path.basename(work)} failed: exit {codes}")
    out = {}
    for name in os.listdir(work):
        if name.startswith("out_"):
            with np.load(os.path.join(work, name)) as z:
                out[name[4:-4]] = {k: z[k] for k in z.files}
    stats = []
    for r in range(len(procs)):
        with open(os.path.join(work, f"stats{r}.json")) as f:
            stats.append(json.load(f))
    return out, stats


def sharded_phase(dev) -> dict:
    """Phase 16: the port's element-partitioned path on the one card.
    (a) a one-rank NCCL group: box2d 131k, f32, 20 linearized steps through
    init_distributed -> shard_sem_mesh -> propagate with graphed CGs (every
    CG `graphed`, asserted), in turns with the same steps unsplit; (b, c)
    four gloo ranks sharing the card (their all-reduces staged through the
    host, their CGs eager): propagate and its adjoint on box2d 131k and on
    box3d (bench.py:312-345) in f64 with 1e-10 solves over 3 steps, against
    one process on the card (<= 1e-7 relative) with the B-adjoint identity;
    (d) four gloo ranks: the eigensolve of tests/test_sharding.py:199-245
    (dt cut to SHARDED_EIGS_DT, kdim SHARDED_EIGS_KDIM) through
    linear_stability_analysis_fixed_point, from the one-process run's
    eigenvectors (`EIGS_START`), against that run (from seed 3), |dmu| <
    1e-6, rank 0 alone writing the files; (f) in the same four ranks,
    `small_cases` against the same run in one process on the card: |dsigma|
    <= 1e-9, the Newton |F| history (exact Jacobian) within 1e-9 relative,
    the resolvent's GMRES count and response (1e-8 relative), the projected
    matvec and rmatvec (1e-12), the bordered periodic-orbit Jacobian (1e-9
    relative), OTD's Lr (1e-9), rank 0's files. Prints ms/step, collectives
    per step, bytes per collective, ms per gloo all-reduce on CUDA tensors,
    and the kernel's runs in every rank beside one process's. Returns the
    kernel runs of the split main paths (summed over the ranks)."""
    import shutil

    t0 = time.time()
    numbers, runs = {}, {}
    # this phase's preconditioners, built once here (or by the NCCL rank's
    # first build) and loaded by its ranks from a cache of its own
    cache = os.path.join(ROOT, ".scratch", "sharded_cache")
    shutil.rmtree(cache, ignore_errors=True)
    saved = {k: os.environ.get(k) for k in ("NEKLAB_PRECOND_CACHE", "NEKLAB_MESH_CACHE")}
    os.environ.update(NEKLAB_PRECOND_CACHE="1", NEKLAB_MESH_CACHE=cache)
    try:
        _sharded_cases(dev, numbers, runs)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    phase("sharded", t0, **numbers)
    return runs


def _sharded_cases(dev, numbers: dict, runs: dict) -> None:
    """Phase 16's cases (a-d, f), filling numbers (printed) and runs (the
    kernel runs of the split main paths)."""
    from neklab_tpu_torch import (ExponentialPropagator, FlowConfig, LinConfig,
                                  flow_vector_space, linear_stability_analysis_fixed_point)
    from neklab_tpu_torch.models import navier_stokes as ns
    from neklab_tpu_torch.models.linearized import make_adjoint_propagator, propagate
    from neklab_tpu_torch.models.precond import build_e_preconditioner
    from neklab_tpu_torch.ops import helmholtz_kernel as hk
    from neklab_tpu_torch.ops import sem

    started = start_ranks("nccl", 1)
    outs, stats = finish_ranks(started, 400)
    out, st = outs["nccl"], stats[0]["nccl"]
    err = rel(torch.as_tensor(out["mu_split"]), torch.as_tensor(out["mu_one"]))
    numbers["a_nccl_box2d_f32"] = dict(st, rel_err=err)
    assert all(st["graphed_split"]) and all(st["graphed_one"]), st
    assert err <= 1e-4, err  # f32, 1e-5 solves: the two differ in summation order
    assert st["split"]["kernel_runs"] > 0
    runs["sharded NCCL box2d, 1 rank (phase 16a)"] = st["split"]["kernel_runs"]
    # (d): recycled, split against unsplit (as the plain pair) and against
    # the plain split run (the bound of `recycled_propagator`)
    split_r, one_r = (torch.as_tensor(out[f"mu_{k}_recycled"]) for k in ("split", "one"))
    numbers["d_nccl_box2d_f32_recycled"] = dict(
        rel_err=rel(split_r, one_r), rel_diff_to_plain=rel(split_r, torch.as_tensor(
            out["mu_split"])), rel_diff_bound=1e3 * 1e-5,
        collectives_per_step={k: st[k]["collectives_per_step"]
                              for k in ("split", f"split_r{RECYCLE}")},
        pressure_iters_per_step={k: st[k]["cg_iters_per_step"]["pressure"]
                                 for k in ("split", f"split_r{RECYCLE}")})
    assert rel(split_r, one_r) <= 1e-4, numbers["d_nccl_box2d_f32_recycled"]
    assert rel(split_r, torch.as_tensor(out["mu_split"])) <= 1e3 * 1e-5
    assert st[f"split_r{RECYCLE}"]["kernel_runs"] > 0
    runs["sharded NCCL box2d recycled, 1 rank (phase 16a)"] = \
        st[f"split_r{RECYCLE}"]["kernel_runs"]

    # (b, c, d): one set of four gloo ranks runs the three cases in turn;
    # this process builds the preconditioners first (the ranks load them)
    # and runs the same cases in one process meanwhile
    cfg = LinConfig(flow=FlowConfig(**SHARDED_F64))
    meshes, inputs = {}, {}
    for case in ("box2d", "box3d"):
        meshes[case] = sharded_mesh(case, dev, torch.float64)
        build_e_preconditioner(meshes[case], cfg.flow.dt / (11 / 6))  # into the cache
        u0, v0 = _c0_pair(sharded_mesh(case, "cpu", torch.float64), 2)
        inputs[f"u0_{case}"], inputs[f"v0_{case}"] = u0.numpy(), v0.numpy()
    started = start_ranks("gloo", 4, inputs)
    one = {}
    for case, mesh in meshes.items():
        # the peak above what this process held before the case, its mesh
        # counted as the ranks count theirs
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        start = torch.cuda.memory_allocated(dev) - sum(
            v.numel() * v.element_size() for v in vars(mesh).values()
            if isinstance(v, torch.Tensor) and v.is_cuda)
        pc = build_e_preconditioner(mesh, cfg.flow.dt / (11 / 6))
        u0, v0 = (torch.as_tensor(inputs[f"{k}_{case}"], device=dev) for k in ("u0", "v0"))
        base = sharded_base(mesh)
        th = torch.zeros((0,) + tuple(mesh.bm1.shape), dtype=mesh.dtype, device=dev)
        orders = ns.bdf_orders(cfg.flow, SHARDED_NSTEPS)  # built before the count, as the ranks do
        solvers = dict(psolves=ns.pressure_solvers(mesh, cfg.flow, orders, pc),
                       vsolves=ns.velocity_solvers(mesh, cfg.flow, orders,
                                                   *ns.bdf3_diags(mesh, cfg.flow)))
        hk.reset_launches(dev)
        t1 = time.time()
        mu, _ = propagate(mesh, cfg, base, th, u0, th, SHARDED_NSTEPS, pc_e=pc, **solvers)
        torch.cuda.synchronize(dev)
        ms = 1e3 * (time.time() - t1) / SHARDED_NSTEPS
        one_runs = hk.launches(dev)
        av, _ = make_adjoint_propagator(mesh, cfg, base, th, SHARDED_NSTEPS, pc_e=pc,
                                        **solvers)(v0, th)
        torch.cuda.synchronize(dev)
        one[case] = mu, av, ms, one_runs, torch.cuda.max_memory_allocated(dev) - start
    del meshes, pc
    mesh = sharded_mesh("eigs", dev, torch.float64)
    y = mesh.x[1]
    fc = FlowConfig(viscosity=0.05, dt=SHARDED_EIGS_DT, vtol=1e-11, ptol=1e-11, vmaxit=60,
                    pmaxit=120)
    prop = ExponentialPropagator(mesh, LinConfig(flow=fc), torch.stack([0.3 * (1 - y**2), 0 * y]),
                                 tau=0.4, dt=fc.dt)
    hk.reset_launches(dev)
    ref = linear_stability_analysis_fixed_point(prop, flow_vector_space(mesh, 0),
                                                kdim=SHARDED_EIGS_KDIM, nev=2, tol=1e-7,
                                                maxiter=8, seed=3, check_every=CHECK_EVERY)
    eig_runs = hk.launches(dev)
    host = lambda a: a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    start = torch.as_tensor(sum(np.real(host(v["u"])) + np.imag(host(v["u"]))
                                for v in ref.eigenvectors), device=dev)
    start = start / float(sem.mass_dot(mesh, start, start)) ** 0.5
    work = os.path.join(ROOT, ".scratch", "sharded_gloo")
    np.savez(os.path.join(work, "tmp_" + EIGS_START), u=start.cpu().numpy())
    os.replace(os.path.join(work, "tmp_" + EIGS_START), os.path.join(work, EIGS_START))
    one_small = small_cases(dev, None, os.path.join(ROOT, ".scratch", "sharded_small_one"))
    outs, stats = finish_ranks(started, 900)

    for case, (mu, av, ms, one_runs, peak) in one.items():
        out, st = outs[case], [s[case] for s in stats]
        errs = {"mu": rel(torch.as_tensor(out["mu"], device=dev), mu),
                "adjoint": rel(torch.as_tensor(out["adj"], device=dev), av)}
        lhs, rhs = (float(v) for v in out["identity"])
        numbers[f"{'b' if case == 'box2d' else 'c'}_gloo4_{case}_f64"] = dict(
            rel_err=errs, identity=[lhs, rhs, abs(lhs - rhs) / abs(lhs)],
            one_process_ms_per_step=ms, one_process_kernel_runs=one_runs,
            one_process_peak_bytes=peak, peak_bytes_by_rank=[s["peak_bytes"] for s in st],
            kernel_runs_by_rank=[s["kernel_runs"] for s in st],
            kernel_runs_summed=sum(s["kernel_runs"] for s in st), ranks=st)
        assert max(errs.values()) <= 1e-7, errs
        assert abs(lhs - rhs) <= 1e-7 * abs(lhs), (lhs, rhs)
        if case == "box2d":
            assert all(s["kernel_runs"] > 0 for s in st), st
            runs["sharded gloo box2d, 4 ranks (phase 16b)"] = sum(s["kernel_runs"] for s in st)

    out, st = outs["eigs"], [s["eigs"] for s in stats]
    dmu = np.abs(np.sort_complex(out["eigvals"]) - np.sort_complex(ref.multipliers)).max()
    files = sorted(os.listdir(os.path.join(ROOT, ".scratch", "sharded_gloo", "out")))
    numbers["d_gloo4_eigs_f64"] = dict(
        eigvals=[[v.real, v.imag] for v in out["eigvals"]], dmu=dmu,
        residuals=out["residuals"].tolist(), one_process_n_matvec=ref.n_matvec,
        one_process_seconds=ref.elapsed, one_process_kernel_runs=eig_runs,
        kernel_runs_summed=sum(s["kernel_runs"] for s in st), files=files, ranks=st)
    assert dmu < 1e-6 and out["residuals"].max() < 1e-7, (dmu, out["residuals"])
    assert files == ["dir_eigenspectrum.npy", "dirmode0.f00001.npz", "dirmode0.f00002.npz",
                     "timers.log"], files
    runs["sharded gloo eigensolve, 4 ranks (phase 16d)"] = sum(s["kernel_runs"] for s in st)

    out, st = outs["small"], [s["small"] for s in stats]
    one = one_small
    small = os.path.join(ROOT, ".scratch", "sharded_gloo", "small")
    files = {case: sorted(os.listdir(os.path.join(small, case))) for case in SMALL_FILES}
    errs = {"tg_dsigma": float(np.abs(out["tg_sigma"] - one["tg_sigma"]).max()),
            "newton_history": float(np.max(np.abs(out["newton_history"] - one["newton_history"])
                                           / one["newton_history"])),
            "resolvent": max(rel(torch.as_tensor(out[k]), one[k]) for k in ("res_re", "res_im")),
            "projected": max(float((torch.as_tensor(out[k]) - one[k]).abs().max())
                             for k in ("proj_matvec", "proj_rmatvec")),
            "upo": max(rel(torch.as_tensor(out[k]), one[k]) for k in ("upo_matvec", "upo_rmatvec")),
            "upo_T": max(abs(float(out[k]) - one[k]) / abs(one[k])
                         for k in ("upo_matvec_T", "upo_rmatvec_T")),
            "otd_lr": float(np.abs(out["otd_lr"] - one["otd_lr"]).max())}
    numbers["f_gloo4_small_f64"] = dict(
        errs=errs, tg_sigma=out["tg_sigma"].tolist(), tg_n_matvec=int(out["tg_n_matvec"]),
        newton_history=out["newton_history"].tolist(),
        newton_matvecs=out["newton_matvecs"].tolist(), res_gmres=int(out["res_gmres"]),
        one_process_res_gmres=one["res_gmres"], res_nsteps=int(out["res_nsteps"]),
        otd_lr=out["otd_lr"][-1].tolist(), one_process_seconds=one["seconds"],
        one_process_kernel_runs=one["kernel_runs"], files=files, ranks=st)
    assert errs["tg_dsigma"] <= 1e-9 and int(out["tg_n_matvec"]) == one["tg_n_matvec"], errs
    assert len(out["newton_history"]) == len(one["newton_history"]), errs
    assert errs["newton_history"] <= 1e-9, errs
    assert int(out["res_gmres"]) == one["res_gmres"] and errs["resolvent"] <= 1e-8, errs
    assert errs["projected"] <= 1e-12, errs
    assert errs["upo"] <= 1e-9 and errs["upo_T"] <= 1e-9, errs
    assert errs["otd_lr"] <= 1e-9, errs
    assert files == SMALL_FILES, files
    assert all(s["kernel_runs"] > 0 for s in st), st
    runs["sharded gloo small drivers, 4 ranks (phase 16f)"] = sum(s["kernel_runs"] for s in st)


def eigs_depth(dev, case: str, settings: list[str]) -> None:
    """`--eigs-depth channel3d|re7500 kdim:tol:maxiter ...`: the matvecs and
    seconds of phase 15's or phase 6's eigensolve at other Krylov dimensions
    and tolerances, one JSON line per setting (the evidence for
    CHANNEL3D_KDIM, CHANNEL3D_TOL and TOL_RE7500). channel3d: `eigs` on
    phase 15's propagator, nev 2 from seed 1234, printing each cycle's
    eigenvalues and residuals; re7500: phase 6's eigensolve with the
    distance of the nearest eigenvalue from the Orr-Sommerfeld mode."""
    from neklab_tpu_torch import (ExponentialPropagator, FlowConfig, LinConfig, box_mesh, eigs,
                                  flow_vector_space, linear_stability_analysis_fixed_point)
    from neklab_tpu_torch.utils.orr_sommerfeld import orr_sommerfeld_spectrum

    for setting in settings:
        kdim, tol, maxiter = setting.split(":")
        kdim, tol, maxiter = int(kdim), float(tol), int(maxiter)
        t0 = time.time()
        if case == "channel3d":
            mesh = box_mesh((4, 5, 2), ((0.0, 2 * np.pi), (-1.0, 1.0), (0.0, 2.0)), CHANNEL3,
                            order=6, dtype=torch.float64, device=dev)
            y = mesh.x[1]
            cfg = LinConfig(flow=FlowConfig(viscosity=1 / 500, dt=1e-2, vtol=CHANNEL3D_SOLVE_TOL,
                                            ptol=CHANNEL3D_SOLVE_TOL))
            prop = ExponentialPropagator(mesh, cfg, torch.stack([1 - y**2, 0 * y, 0 * y]),
                                         tau=0.5, cfl=0.5)
            t0 = time.time()

            def cb(c, r, prop=prop, t0=t0):
                lam = np.log(r.eigvals.astype(complex)) / prop.tau
                print("cycle", c, r.n_matvec, [str(v) for v in lam], r.residuals.tolist(),
                      f"{time.time() - t0:.1f}", flush=True)

            res = eigs(prop, flow_vector_space(mesh, 0), nev=2, kdim=kdim, tol=tol,
                       maxiter=maxiter, seed=1234, callback=cb)
            lam = np.log(res.eigvals.astype(complex)) / prop.tau
            out = {"eig": [str(v) for v in lam], "res": res.residuals.tolist(),
                   "mv": res.n_matvec}
        else:
            mesh, prop = poiseuille(dev, torch.float32, (12, 10), 8, 7500.0, 1e-7)
            t0 = time.time()
            res = linear_stability_analysis_fixed_point(prop, flow_vector_space(mesh, 0),
                                                        kdim=kdim, nev=2, tol=tol,
                                                        maxiter=maxiter)
            os_lead = orr_sommerfeld_spectrum(7500.0, 1.0, 128)[0]
            out = {"mv": res.n_matvec, "eig": [str(v) for v in res.eigvals],
                   "res": res.residuals.tolist(),
                   "dist": float(np.min(np.abs(res.eigvals - os_lead)))}
        print(json.dumps({"case": case, "kdim": kdim, "tol": tol, **out,
                          "s": time.time() - t0}), flush=True)


# the schedule: the main process runs MAIN_FIRST (the phases that time the
# card alone), then starts one process per group of SIDE (`--side a,b`:
# those phases one after another) and runs MAIN_THEN beside them, then
# MAIN_LAST. Phase 15 is bound by the device and runs at its own speed only
# alone, so it comes last in the main process, after the groups have ended
# (PERF.md section 6). The groups are packed to end together (phase 10
# alone is the longest); phase 16e follows phase 8 in its process, from
# phase 8's spun-up state
MAIN_FIRST = ("kernel", "box2d")
# phase 7 runs in the group that ends first, on phase 6's mu_1 from the
# main process (MU1_FILE): the main process's chain, phase 15 last, ended
# the script (PERF.md section 6, PR 10)
SIDE = ("upo", "oracle,box21k,box3d", "parity_r,parity_u,cylinder,cylinder_split,growth",
        "sharded,otd", "bfs,resolvent")
# the Boussinesq phases (17, 18) run in the main process before phase 15:
# there x seconds of them delay phase 15's start, of which beside the groups
# it does ~1/7 of its alone speed, so the end moves by ~x/7; in a side group
# they would move the last group's end, and the script's, by ~0.8 x
# (PERF.md section 6)
MAIN_THEN = ("parity", "nonlinear", "parity_3d", "re7500", "rayleigh", "thermosyphon")
# phase 15 waits for the side groups to end (until MAIN_LAST_BY seconds from
# the start): beside a group it barely moves and slows that group's
# host-bound CGs, so the end is the last group's plus its time alone
# (PERF.md section 6)
MAIN_LAST, MAIN_LAST_BY = ("channel3d",), 1000.0
MU1_FILE = os.path.join(ROOT, ".scratch", "mu1.json")


def wait_for(procs, deadline: float) -> None:
    """Wait for every process of procs to exit, or until the time.time()
    deadline."""
    for proc in procs:
        try:
            proc.wait(timeout=max(1.0, deadline - time.time()))
        except subprocess.TimeoutExpired:
            pass


def write_mu1(mu1: complex) -> None:
    """Phase 6's mu_1 for phase 7 in another process (written whole, then
    renamed)."""
    os.makedirs(os.path.dirname(MU1_FILE), exist_ok=True)
    with open(MU1_FILE + ".tmp", "w") as f:
        json.dump([mu1.real, mu1.imag], f)
    os.replace(MU1_FILE + ".tmp", MU1_FILE)


def read_mu1(timeout: float) -> complex:
    """Phase 6's mu_1 from MU1_FILE, waiting up to timeout seconds for the
    main process to write it."""
    deadline = time.time() + timeout
    while not os.path.exists(MU1_FILE):
        if time.time() > deadline:
            raise SystemExit(f"chip_smoke: no {MU1_FILE} (phase 6 did not end) after {timeout} s")
        time.sleep(1.0)
    with open(MU1_FILE) as f:
        re_, im = json.load(f)
    return complex(re_, im)


def one_blas_thread() -> dict:
    """This process's environment for a side process or a rank: their host
    algebra (Hessenberg, Schur, Cholesky: small) on one BLAS thread each,
    so that six processes and four ranks leave the host's cores to the
    launches."""
    return dict(os.environ, OPENBLAS_NUM_THREADS="1", MKL_NUM_THREADS="1", OMP_NUM_THREADS="1")


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
    elif name == "parity_u":
        parity_u_phase(dev)
    elif name == "box2d":
        box2d_phase(dev)
    elif name == "re7500":
        launches, state["mu1"] = main_path_phase(dev)
        write_mu1(state["mu1"])
        return {"direct eigensolve (phase 6)": launches}
    elif name == "growth":
        # phase 6 ran in this process (--only) or runs in the main one (--side)
        mu1 = state["mu1"] if "mu1" in state else read_mu1(timeout=900.0)
        launches, state["adjoint_launches"] = growth_phase(dev, mu1)
        return {"transient growth (phase 7)": launches}
    elif name == "oracle":
        return {"projected eigensolve (phase 4)": oracle_phase(dev)["projected"]}
    elif name == "cylinder":
        runs = cylinder_phase(dev, state=state)
        return {"cylinder spin-up (phase 8)": runs["spin-up"],
                "cylinder Newton + eigensolve (phase 8)": runs["newton"] + runs["eigensolve"],
                "cylinder recycled propagator (phase 8a)": runs["recycled propagator"]}
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
    elif name == "bfs":
        runs = bfs_phase(dev)
        return {"BFS spin-up (phase 12)": runs["spin-up"],
                "BFS transient growth (phase 12)": runs["analysis"]}
    elif name == "box21k":
        return box21k_phase(dev)
    elif name == "parity_3d":
        parity_3d_phase(dev)
    elif name == "box3d":
        box3d_phase(dev)
    elif name == "channel3d":
        channel3d_phase(dev)
    elif name == "sharded":
        return sharded_phase(dev)
    elif name == "cylinder_split":
        return cylinder_split_phase(dev, state)
    elif name == "rayleigh":
        return {"Rayleigh-Benard onset (phase 17)": rayleigh_phase(dev)}
    elif name == "thermosyphon":
        runs = thermosyphon_phase(dev)
        return {"thermosyphon spin-up (phase 18)": runs["spin-up"],
                "thermosyphon Newton, eigensolve, adjoint (phase 18)": runs["analyses"]}
    else:
        raise SystemExit(f"chip_smoke: no phase {name!r}")
    return None


def main() -> None:
    # one card: the first visible one (before CUDA starts, so the count below
    # is the number of cards this run uses)
    os.environ["CUDA_VISIBLE_DEVICES"] = os.environ.get("CUDA_VISIBLE_DEVICES", "0").split(",")[0]
    t_start = time.time()
    if sys.argv[1:2] == ["--rank"]:
        rank_main(sys.argv[2:])
        return
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() is False)")
    # every preconditioner is built, none loaded from an earlier run's cache
    # (the side processes inherit this)
    os.environ["NEKLAB_PRECOND_CACHE"] = "0"
    import neklab_tpu_torch  # noqa: F401  (sets the TF32 switches)
    from neklab_tpu_torch import native
    from neklab_tpu_torch.ops import _build

    dev = torch.device("cuda", 0)
    assert torch.cuda.device_count() == 1
    args = sys.argv[1:]
    if args[:1] == ["--cylinder"] and args[1:]:
        cylinder_phase(dev, getattr(torch, args[1]))
        return
    if args[:1] == ["--eigs-depth"]:
        eigs_depth(dev, args[1], args[2:])
        return
    if args[:1] == ["--side"]:
        # six processes share the host's cores: a group's CPU work (the
        # card-vs-CPU references, host preprocessing) takes two
        torch.set_num_threads(min(torch.get_num_threads(), 2))
        runs, state = {}, {}  # state: what a phase hands a later one of its group
        for name in args[1].split(","):
            runs.update(run_phase(name, dev, state) or {})
            print(f"ended {name} {time.time():.3f}", flush=True)  # for the main's timeline
        print("launches " + json.dumps(runs), flush=True)
        if "adjoint_launches" in state:
            print(f"adjoint_launches {state['adjoint_launches']}", flush=True)
        return
    if args[:1] == ["--only"]:
        # the named phases alone, one after another in this process
        _build.build()
        assert native.available()
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
    nvcc_s = _build.last_build["seconds"]
    t1 = time.time()
    assert native.available(), "g++ did not build the native mesh library"
    phase("build", t0, seconds=nvcc_s, native_gxx_s=time.time() - t1,
          native_library=os.path.basename(native.library_path()),
          ptxas=ptxas_report(_build.last_build["log"]))

    state: dict = {}
    ended = {}  # the timeline: seconds from the start at which each phase ended
    for name in MAIN_FIRST:
        run_phase(name, dev, state)
        ended[name] = time.time() - t_start

    # each side process writes to a file of its own (under .scratch/, which
    # git ignores), so what it printed survives its being stopped
    logdir = os.path.join(ROOT, ".scratch")
    os.makedirs(logdir, exist_ok=True)
    if os.path.exists(MU1_FILE):  # an earlier run's
        os.remove(MU1_FILE)
    logs = {group: open(os.path.join(logdir, f"side_{i}.log"), "w+")
            for i, group in enumerate(SIDE)}
    side = {group: subprocess.Popen([sys.executable, os.path.abspath(__file__), "--side", group],
                                    stdout=logs[group], text=True, env=one_blas_thread())
            for group in SIDE}
    # six processes share the host's cores (the side processes take two)
    torch.set_num_threads(min(torch.get_num_threads(), 4))
    by_path = {}
    try:
        for name in MAIN_THEN:
            by_path.update(run_phase(name, dev, state) or {})
            ended[name] = time.time() - t_start
        wait_for(side.values(), t_start + MAIN_LAST_BY)
        for name in MAIN_LAST:
            by_path.update(run_phase(name, dev, state) or {})
            ended[name] = time.time() - t_start
        wait_for(side.values(), t_start + 1150)  # the whole run stays inside 1200 s
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
        for ln in outs[group].splitlines():
            if ln.startswith("adjoint_launches "):
                state["adjoint_launches"] = int(ln.split()[1])
            if ln.startswith("ended "):
                _, name, at = ln.split()
                ended[name] = float(at) - t_start

    print("timeline " + json.dumps({k: round(v, 1) for k, v in sorted(ended.items(),
                                                                      key=lambda kv: kv[1])}),
          flush=True)
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
