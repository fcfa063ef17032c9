"""Ranks of the port's element-partitioned tests, and the launcher that runs
them: one process per rank, each running

    python tests/torch_shard_workers.py JOB RANK SIZE WORKDIR

The module imports torch, numpy and the port, never jax, so it runs on a
machine that has no jax (the card tests use it too). A job reads its
arguments (`args.json`) and global inputs (`in.npz`) from WORKDIR, joins a
gloo group (or NCCL, for one rank on a card) through a file rendezvous
there, runs the port on its block of the elements, and rank 0 writes the
gathered results to `out.npz` (`out<rank>.npz` for what each rank writes of
its own: its log of collectives and, on a card, its peak device memory).
Every group is torn down at the end; a collective that waits
longer than the group's timeout fails its rank, and the launcher kills
every rank of a job that outlives its limit.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)

CHANNEL_BC = {"x-": "P", "x+": "P", "y-": "W", "y+": "W"}
# tests/test_sharding.py:28-38's box
STEP_BOX = dict(nels=(8, 2), lims=((0.0, 2 * np.pi), (-1.0, 1.0)), bc=CHANNEL_BC, order=4)
# tests/test_precond.py:117-127's walled box
WALLED3 = dict(nels=(3, 2, 2), lims=((0.0, 1.5), (0.0, 1.0), (0.0, 1.0)),
               bc={"x-": "W", "x+": "W", "y-": "W", "y+": "W", "z-": "W", "z+": "W"}, order=4)


def run_ranks(job: str, size: int, workdir: str, args: dict | None = None,
              inputs: dict | None = None, timeout: float = 120.0, wait: bool = True):
    """Starts the `size` ranks of `job` (args and numpy inputs written to
    workdir first). wait: block until they end (-> `finish`'s result);
    otherwise return the started processes, for `finish`."""
    os.makedirs(workdir, exist_ok=True)
    with open(os.path.join(workdir, "args.json"), "w") as f:
        json.dump(args or {}, f)
    np.savez(os.path.join(workdir, "in.npz"), **(inputs or {}))
    for name in os.listdir(workdir):
        if name == "rdv" or name.startswith("out"):
            os.remove(os.path.join(workdir, name))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([ROOT, HERE]), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), job, str(r), str(size),
                               workdir], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(size)]
    started = (procs, workdir, time.time() + timeout)
    return finish(started) if wait else started


def finish(started) -> dict:
    """Waits for the ranks of `run_ranks(..., wait=False)`; raises with
    their output when one fails or the limit passes (every rank is killed
    then). -> rank 0's `out.npz` as a dict, and each rank's `out<r>.npz`
    under "rank<r>"."""
    procs, workdir, deadline = started
    outs = []
    try:
        for p in procs:
            try:
                outs.append(p.communicate(timeout=max(1.0, deadline - time.time()))[0])
            except subprocess.TimeoutExpired:
                raise RuntimeError(f"ranks of {workdir} still running at their time limit")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    bad = [r for r, p in enumerate(procs) if p.returncode != 0]
    if bad:
        raise RuntimeError(f"ranks {bad} failed:\n" + "\n".join(
            f"--- rank {r} ---\n{outs[r][-4000:]}" for r in bad))
    res = {}
    for name in sorted(os.listdir(workdir)):
        if name.startswith("out") and name.endswith(".npz"):
            with np.load(os.path.join(workdir, name)) as z:
                data = {k: z[k] for k in z.files}
            if name == "out.npz":
                res.update(data)
            else:
                res["rank" + name[3:-4]] = data
    return res


# ---------------------------------------------------------------------------
# the jobs (in the rank processes)
# ---------------------------------------------------------------------------


def _flow_cfg(kw):
    from neklab_tpu_torch.models.navier_stokes import FlowConfig

    return FlowConfig(**kw)


def _log_stats(part) -> dict:
    sizes = sorted(part.log.by_numel)
    return {"calls": np.asarray(part.log.calls), "bytes": np.asarray(part.log.bytes),
            "sizes": np.asarray(sizes, np.int64),
            "counts": np.asarray([part.log.by_numel[s] for s in sizes], np.int64)}


def _per_iteration(part, cg, b) -> int:
    """All-reduces of one iteration of the CG `cg`, set up on b."""
    cg.solve(b, tol=0.0, maxiter=0)
    before = part.log.calls
    cg._step()
    return part.log.calls - before


def job_step(part, args, z, dev):
    """dssum, mass_dot, rand, the CFL step, 3 nonlinear steps with their
    state checkpoint and field file, and one step's all-reduces on the
    channel box of tests/test_sharding.py."""
    from neklab_tpu_torch.mesh.box import box_mesh
    from neklab_tpu_torch.models import navier_stokes as ns
    from neklab_tpu_torch.ops import sem
    from neklab_tpu_torch.parallel import (gather_field, shard_field, shard_flow_state,
                                           shard_sem_mesh)
    from neklab_tpu_torch.utils import io
    from neklab_tpu_torch.utils.timestep import cfl_dt
    from neklab_tpu_torch.vectors import flow_vector_space

    gm = box_mesh(**STEP_BOX, dtype=torch.float64, device="cpu")
    mesh = shard_sem_mesh(gm, part)
    f = shard_field(z["f"], part)
    out = {"dssum": gather_field(sem.dssum(mesh, f), part),
           "mass_dot": sem.mass_dot(mesh, f, f),
           "rand": gather_field(flow_vector_space(mesh, 0).rand(7)["u"], part)}
    cfg = _flow_cfg(args["cfg"])
    u0 = shard_field(z["u0"], part)
    # every rank's value, side by side
    out["cfl_dt"] = gather_field(torch.tensor([cfl_dt(mesh, u0 + 0.3 * f)], dtype=torch.float64),
                                 part)
    # the state made whole and split, as a run restarted from a whole state is
    st0 = shard_flow_state(ns.initial_state(gm, cfg, u=torch.as_tensor(z["u0"])), part)
    st = ns.advance(mesh, cfg, st0, 3)
    out.update(u=gather_field(st.u, part), p=gather_field(st.p, part))
    # the state checkpoint and a field file, written whole by rank 0
    path = os.path.join(args["workdir"], "state.npz")
    io.save_checkpoint(path, st, part=part)
    back = io.load_checkpoint(path, st, part=part)
    out["reloaded"] = np.asarray([float((getattr(back, k) - getattr(st, k)).abs().max())
                                  for k in ("u", "p", "ulag", "nlag", "plag")])
    io.outpost(args["workdir"], {"u": st.u}, mesh=mesh, prefix="spl", time=st.time)

    # one step's all-reduces, and each CG's per iteration
    orders = ns.bdf_orders(cfg, 1)
    psolves = ns.pressure_solvers(mesh, cfg, orders)
    vsolves = ns.velocity_solvers(mesh, cfg, orders, *ns.bdf3_diags(mesh, cfg))
    part.log.reset()
    stats = {}
    ns.advance(mesh, cfg, ns.initial_state(mesh, cfg, u=u0), 1, psolves=psolves,
               vsolves=vsolves, stats=stats)
    out.update({"step_" + k: v for k, v in _log_stats(part).items()})
    out["step_iters"] = np.asarray([stats["helmholtz"][0], stats["pressure"][0]])
    vcg, pcg = vsolves[1][0].cg, psolves[1].cg
    out["per_iter"] = np.asarray([_per_iteration(part, vcg, vcg.r.normal_()),
                                  _per_iteration(part, pcg, pcg.r.normal_())])
    return out


def _re2_mesh(args, part):
    from neklab_tpu_torch.mesh.re2 import mesh_from_re2

    return mesh_from_re2(args["path"], order=args["order"], partition=part.size, cache=False,
                         dtype=torch.float64, device="cpu")


def job_propagate(part, args, z, dev):
    """propagate and its exact adjoint on a rank's block, with the
    preconditioner `args["pc"]` (build_e_preconditioner's keywords), on a
    `.re2` mesh (args["path"], RCB-ordered into the ranks) or a box."""
    from neklab_tpu_torch.mesh.box import box_mesh
    from neklab_tpu_torch.models import linearized as lin
    from neklab_tpu_torch.models.precond import build_e_preconditioner
    from neklab_tpu_torch.ops import sem
    from neklab_tpu_torch.parallel import gather_field, shard_field, shard_sem_mesh

    if "path" in args:
        gm = _re2_mesh(args, part)
    else:
        box = dict(WALLED3 if args["box"] == "walled3" else STEP_BOX, **args.get("box_kw", {}))
        gm = box_mesh(**box, dtype=torch.float64, device="cpu")
    mesh = shard_sem_mesh(gm, part)
    fc = _flow_cfg(args["cfg"])
    cfg, cfg_a = lin.LinConfig(flow=fc), lin.LinConfig(flow=_flow_cfg(args["cfg_adj"]))
    base, u0, v0 = (shard_field(z[k], part) for k in ("base", "u0", "v0"))
    th = torch.zeros((0,) + tuple(mesh.bm1.shape), dtype=mesh.dtype, device=dev)
    pc = build_e_preconditioner(mesh, args["dt_over_g0"], **args["pc"])
    n = args["nsteps"]
    stats = {}
    mu, _ = lin.propagate(mesh, cfg, base, th, u0, th, n, pc_e=pc, stats=stats)
    adj = lin.make_adjoint_propagator(mesh, cfg_a, base, th, n, pc_e=pc)
    av, _ = adj(v0, th)
    mu_a, _ = lin.propagate(mesh, cfg_a, base, th, u0, th, n, pc_e=pc)
    return {"mu": gather_field(mu, part), "adj": gather_field(av, part),
            "identity": torch.stack([sem.mass_dot(mesh, mu_a, v0), sem.mass_dot(mesh, u0, av)]),
            "iters": np.asarray([np.mean(stats["helmholtz"]), np.mean(stats["pressure"])])}


def job_eigs(part, args, z, dev):
    """The direct eigensolve through `linear_stability_analysis_fixed_point`
    (each rank with an output directory of its own: rank 0 alone writes),
    then an unconverged eigs that keeps its checkpoint, and the load of a
    one-process checkpoint."""
    from neklab_tpu_torch.analysis import linear_stability_analysis_fixed_point
    from neklab_tpu_torch.krylov.eigs import _load_krylov_state, eigs
    from neklab_tpu_torch.linops.exponential_propagator import ExponentialPropagator
    from neklab_tpu_torch.mesh.box import box_mesh
    from neklab_tpu_torch.models.linearized import LinConfig
    from neklab_tpu_torch.parallel import gather_field, shard_field, shard_sem_mesh
    from neklab_tpu_torch.vectors import flow_vector, flow_vector_space

    gm = box_mesh(**STEP_BOX, dtype=torch.float64, device="cpu")
    mesh = shard_sem_mesh(gm, part)
    fc = _flow_cfg(args["cfg"])
    base = shard_field(z["base"], part)
    v0 = flow_vector(mesh, 0, u=shard_field(z["v0"], part))
    space = flow_vector_space(mesh, 0)
    A = ExponentialPropagator(mesh, LinConfig(flow=fc), base, tau=args["tau"], dt=fc.dt)
    outdir = os.path.join(args["outdir"], f"rank{part.rank}")
    res = linear_stability_analysis_fixed_point(A, space, kdim=args["kdim"], nev=args["nev"],
                                                tol=args["tol"], maxiter=args["maxiter"],
                                                outdir=outdir, v0=v0)
    out = {"eigvals": res.multipliers, "residuals": res.residuals,
           "n_matvec": np.asarray(res.n_matvec),
           "mode_u": gather_field(res.eigenvectors[0]["u"], part)}
    # a checkpoint written by the ranks (kept: the solve ends unconverged)
    small = dict(nev=2, kdim=args["ck_kdim"], tol=1e-14, maxiter=1, v0=v0)
    eigs(A, space, checkpoint=args["ck_split"], **small)
    # a checkpoint written by one process, loaded by the ranks
    V, H, n_mv = _load_krylov_state(args["ck_one"], space, v0, args["ck_kdim"] + 1,
                                    fingerprint=args["ck_fp"])
    out.update(loaded_u=gather_field(V.stack["u"], part), loaded_k=np.asarray(V.k),
               loaded_h=H)
    return out


def job_nccl(part, args, z, dev):
    """One NCCL rank on a card: the velocity and pressure solves of the
    channel box with graphed CGs, against the same solves unsplit."""
    from neklab_tpu_torch.mesh.box import box_mesh
    from neklab_tpu_torch.models import navier_stokes as ns
    from neklab_tpu_torch.parallel import shard_sem_mesh

    gm = box_mesh(**STEP_BOX, dtype=torch.float64, device="cpu")
    mesh = shard_sem_mesh(gm, part)
    one = gm.to(dev)
    cfg = _flow_cfg(args["cfg"])
    u0 = torch.as_tensor(z["u0"], device=dev)
    out = {}
    for name, m in (("split", mesh), ("one", one)):
        orders = ns.bdf_orders(cfg, 3)
        psolves = ns.pressure_solvers(m, cfg, orders)
        vsolves = ns.velocity_solvers(m, cfg, orders, *ns.bdf3_diags(m, cfg))
        part.log.reset()
        st = ns.advance(m, cfg, ns.initial_state(m, cfg, u=u0), 3, psolves=psolves,
                        vsolves=vsolves)
        out[name + "_u"], out[name + "_p"] = st.u, st.p
        out[name + "_graphed"] = np.asarray([psolves[1].cg.graphed, vsolves[1][0].cg.graphed])
        out[name + "_calls"] = np.asarray(part.log.calls)
    return out


JOBS = {"step": job_step, "propagate": job_propagate, "eigs": job_eigs, "nccl": job_nccl}


def main(argv) -> None:
    job, rank, size, workdir = argv[0], int(argv[1]), int(argv[2]), argv[3]
    torch.set_num_threads(1)
    sys.path.insert(0, ROOT)
    import torch.distributed as dist

    from neklab_tpu_torch.parallel import init_distributed

    with open(os.path.join(workdir, "args.json")) as f:
        args = dict(json.load(f), workdir=workdir)
    with np.load(os.path.join(workdir, "in.npz")) as zf:
        z = {k: zf[k] for k in zf.files}
    dev = torch.device(args.get("device", "cpu"))
    part = init_distributed(backend=args.get("backend", "gloo"),
                            init_method="file://" + os.path.join(workdir, "rdv"),
                            world_size=size, rank=rank, device=dev, timeout=60)
    try:
        out = JOBS[job](part, args, z, dev)
        host = {k: (v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v))
                for k, v in out.items()}
        if rank == 0:
            np.savez(os.path.join(workdir, "out.npz"), **host)
        peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
        np.savez(os.path.join(workdir, f"out{rank}.npz"), peak_bytes=np.asarray(peak),
                 **{"log_" + k: v for k, v in _log_stats(part).items()})
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1:])
