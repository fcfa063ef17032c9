"""Smoke run of neklab_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Builds the CUDA kernels from the sources in this checkout, checks each
against its plain torch twin, and drives the port's main path, the direct
modal-stability eigensolve, through the user entry points (box_mesh ->
ExponentialPropagator -> flow_vector_space ->
linear_stability_analysis_fixed_point). Phases:

  0 device   the card, its power limit, TF32 off
  1 build    nvcc -> neklab_tpu_torch/build/
  2 kernel   helmholtz2d vs helmholtz2d_plain at the main path's shapes and
             the tiling's edges; device times beside the bound
  3 parity   propagate on the card (kernel, graphed CGs) vs on the CPU
             (plain), f64; the kernel's device counter vs the CG counts
  4 oracle   Poiseuille Re=500 eigenvalues vs Orr-Sommerfeld, f64
  5 box2d    box2d 131k propagator, f32: ms/step sustained and floor
  6 re7500   Poiseuille Re=7500 `medium` eigensolve, f32 (the main-path run)

Phase 4 runs in a second process (this script with `--oracle`) beside phase
6: both eigensolves are bound by the host's launch rate, one core each, and
leave the card idle most of the time, so side by side they take the time of
the longer one. Every phase asserts; any failure raises and the exit code is
non-zero. The last line on success is {"ok": true, "device": {...}}; the
line before it lists the kernels. Without a CUDA card it fails at once.

The kernel counts its own runs in device memory (`helmholtz_kernel.launches`),
so the velocity and pressure CGs, whose iterations replay CUDA graphs, are
counted too.
"""

from __future__ import annotations

import json
import os
import re
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

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
    CG iteration, one of n*n the Jacobi-diagonal probe, helmholtz_diag) and
    at the edges of its tiling: nel not a multiple of the tile (15, 121),
    n = 2 and n = 12, a batch of 1 and of 81. Times it against the plain
    chain at the main path's CG shape (phase 6) and at box2d's, and alone at
    their probe shapes."""
    from neklab_tpu_torch.mesh.box import box_mesh
    from neklab_tpu_torch.ops import helmholtz_kernel as hk

    t0 = time.time()
    re7500 = channel(dev, torch.float32, (12, 10), 8)  # phase 6, the main path
    box2d = channel(dev, torch.float32, (64, 16), 7)  # phase 5

    def mesh_args(m, lead):
        g = m.g
        u = torch.randn(lead + tuple(m.bm1.shape), generator=gen, dtype=m.dtype, device=dev)
        return (u, m.d, g[0, 0], g[0, 1], g[1, 1], m.bm1, 1e-3, (11 / 6) / 2e-3)

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    cases = [(f"re7500/{lead}", mesh_args(re7500, lead)) for lead in ((2,), (81,))]
    re500 = channel(dev, torch.float64, (4, 5), 6)  # phases 3 and 4
    cases += [(f"re500/{lead}", mesh_args(re500, lead)) for lead in ((2,), (49,))]
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
    for m, lead in ((re7500, (81,)), (box2d, (64,))):  # the Jacobi probe
        args = mesh_args(m, lead)
        probes[f"{list(args[0].shape)} f32"] = device_ms(lambda: hk.helmholtz2d(*args))
    for m in (re7500, box2d):
        args = mesh_args(m, (2,))
        key = f"{list(args[0].shape)} f32"
        kern, plain = [], []
        for _ in range(3):  # in turns: plain, kernel, kernel, plain, ...
            plain.append(device_ms(lambda: hk.helmholtz2d_plain(*args)))
            kern.append(device_ms(lambda: hk.helmholtz2d(*args)))
            kern.append(device_ms(lambda: hk.helmholtz2d(*args)))
            plain.append(device_ms(lambda: hk.helmholtz2d_plain(*args)))
        bound, by = bound_ms(m.basis.n, m.nel, 2, torch.float32)
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
            "bound_by": main["bound_by"], "library_ms": None}


def parity_phase(dev):
    """Phase 3: one matvec on the card (kernel, graphed CGs) and on the CPU
    (plain, eager), f64. The kernel's device counter must rise by exactly the
    runs the card's `stats` imply: one per velocity CG iteration (graph
    replays) and one per solve for its right-hand side. The propagator
    built every solver, and so every capture, before the window."""
    from neklab_tpu_torch.ops import helmholtz_kernel as hk
    from neklab_tpu_torch.ops import sem

    t0 = time.time()
    _, prop_c = poiseuille(dev, torch.float64, (4, 5), 6, 500.0, 1e-12)
    mesh_h, prop_h = poiseuille("cpu", torch.float64, (4, 5), 6, 500.0, 1e-12)
    assert (prop_c.dt, prop_c.nsteps) == (prop_h.dt, prop_h.nsteps)
    u = np.random.default_rng(11).standard_normal((2,) + tuple(mesh_h.bm1.shape))
    uh = mesh_h.vmask * sem.dsavg(mesh_h, torch.as_tensor(u))
    uh = uh / sem.mass_dot(mesh_h, uh, uh).sqrt()
    th = torch.zeros((0,) + tuple(mesh_h.bm1.shape), dtype=torch.float64)
    x_c = {"u": uh.to(dev), "theta": th.to(dev)}
    stats_c, stats_h = {}, {}
    n0 = hk.launches(dev)
    out_c = prop_c.matvec(x_c, stats=stats_c)["u"]
    runs = hk.launches(dev) - n0
    out_h = prop_h.matvec({"u": uh, "theta": th}, stats=stats_h)["u"]
    diff = float((out_c.cpu() - out_h).abs().max())
    implied = sum(stats_c["helmholtz"]) + len(stats_c["helmholtz"])
    assert runs == implied, (runs, implied)
    assert diff <= 1e-9, diff  # the inner solves run to 1e-12 on both
    phase("parity", t0, max_abs_diff=diff, kernel_runs=runs, runs_implied_by_stats=implied,
          nsteps=prop_c.nsteps, cg_iters_card=stats_c, cg_iters_cpu=stats_h)


def oracle_phase(dev):
    """Phase 4: Poiseuille Re=500 eigenvalues on the card, f64, against the
    Orr-Sommerfeld/shear-mode oracle (tests/test_stability.py thresholds)."""
    from neklab_tpu_torch.analysis import linear_stability_analysis_fixed_point
    from neklab_tpu_torch.utils.orr_sommerfeld import orr_sommerfeld_spectrum, shear_mode_eigenvalues
    from neklab_tpu_torch.vectors import flow_vector_space

    t0 = time.time()
    re = 500.0
    mesh, prop = poiseuille(dev, torch.float64, (4, 5), 6, re, 1e-12)
    res = linear_stability_analysis_fixed_point(prop, flow_vector_space(mesh, 0), kdim=40,
                                                nev=4, tol=2e-6, maxiter=12)
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
    phase("oracle", t0, eigvals=[[v.real, v.imag] for v in res.eigvals],
          residuals=res.residuals.tolist(), oracle_dist=dists, lead_err=lead_err,
          n_matvec=res.n_matvec, seconds=res.elapsed)


def box2d_phase(dev):
    """Phase 5: the box2d 131k propagator (bench.py:109-139), f32, with the
    sustained protocol of bench.py:73-106 and its floor."""
    from neklab_tpu_torch.models.linearized import (LinConfig, pressure_solvers, propagate,
                                                    velocity_solvers)
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
    psolves = pressure_solvers(mesh, cfg, nsteps, pc)
    vsolves = velocity_solvers(mesh, cfg, nsteps, vdiag, None)

    def prop(u, nst=nsteps, stats=None):
        return propagate(mesh, cfg, base_u, th, u, th, nst, pc_e=pc, vdiag=vdiag,
                         psolves=psolves, vsolves=vsolves, stats=stats)[0]

    def bnorm(u):
        return u / sem.mass_dot(mesh, u, u).sqrt()

    def timed(state, scale, reps=3):
        """-> (s per call, kernel runs per step from the device counter,
        mean CG iterations per step {helmholtz, pressure}, last state)."""
        state = scale * bnorm(prop(state))  # warm-up
        stats = {}
        n0 = hk.launches(dev)  # synchronizes
        t1 = time.time()
        for _ in range(reps):
            state = scale * bnorm(prop(state, stats=stats))
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
    phase("box2d", t0, dof=dof, nsteps=nsteps, ms_per_step=1e3 * s_sus / nsteps,
          ms_per_step_floor=1e3 * s_floor / nsteps, dof_steps_per_s=dof * nsteps / s_sus,
          cg_iters_per_step=iters_sus, cg_iters_per_step_floor=iters_floor,
          cg_iters_first_step_fresh=first, pc_build_s=t_pc,
          kernel_runs_per_step=launches_per_step)


def main_path_phase(dev) -> int:
    """Phase 6: Poiseuille Re=7500 `medium` (examples/poiseuille_stability.py:
    51-75), f32, through the user entry points. Returns the kernel runs it
    made, graph replays included, from the device counter set to zero just
    before."""
    from neklab_tpu_torch.analysis import linear_stability_analysis_fixed_point
    from neklab_tpu_torch.ops import helmholtz_kernel as hk
    from neklab_tpu_torch.utils.orr_sommerfeld import orr_sommerfeld_spectrum
    from neklab_tpu_torch.vectors import flow_vector_space

    t0 = time.time()
    re = 7500.0
    hk.reset_launches(dev)
    mesh, expA = poiseuille(dev, torch.float32, (12, 10), 8, re, 1e-7)
    res = linear_stability_analysis_fixed_point(expA, flow_vector_space(mesh, 0), kdim=96,
                                                nev=10, tol=1e-6, maxiter=10)
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
    return launches


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() is False)")
    import neklab_tpu_torch  # noqa: F401  (sets the TF32 switches)
    from neklab_tpu_torch.ops import _build

    dev = torch.device("cuda", 0)
    if sys.argv[1:] == ["--oracle"]:
        oracle_phase(dev)
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

    kernel = kernel_phase(dev)
    parity_phase(dev)
    box2d_phase(dev)

    oracle = subprocess.Popen([sys.executable, os.path.abspath(__file__), "--oracle"],
                              stdout=subprocess.PIPE, text=True)
    try:
        launches = main_path_phase(dev)
        out, _ = oracle.communicate(timeout=1200)
    finally:
        if oracle.poll() is None:
            oracle.kill()
            oracle.wait()
    print(out, end="", flush=True)
    if oracle.returncode != 0:
        raise SystemExit(f"chip_smoke: phase oracle failed (exit {oracle.returncode})")

    print(nvidia_smi(), flush=True)
    print(json.dumps({"kernels": [{
        "name": "helmholtz2d",
        "route": "cuda",
        "source": "neklab_tpu_torch/csrc/helmholtz2d.cu",
        "replaces": "neklab_tpu/ops/pallas_kernels.py:54",
        "launches": launches,
        **kernel,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                              "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
