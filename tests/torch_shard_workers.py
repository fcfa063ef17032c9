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
# tests/test_torch_newton.py's forced channel (body force 2 nu, fixed point
# u = 1 - y^2), 4 x 2 elements at order 4: blocks for 2 and 4 ranks
FORCED_NU = 0.1
FORCED_BOX = dict(nels=(4, 2), lims=((0.0, 2.0), (-1.0, 1.0)), bc=CHANNEL_BC, order=4)
# tests/test_torch_otd.py's Poiseuille channel (12 elements)
OTD_BOX = dict(nels=(3, 4), lims=((0.0, 2 * np.pi), (-1.0, 1.0)), bc=CHANNEL_BC, order=4)
# STEP_BOX with the temperature fixed on both walls, and a scalar-coupled
# flow on it: a buoyancy and a source, both of theta
SCALAR_BOX = dict(STEP_BOX, bc_temp={"y-": "t", "y+": "t"})
SCALAR_CFG = dict(viscosity=0.02, dt=5e-3, nscal=1, conductivity=(0.03,), vtol=1e-12,
                  ptol=1e-12, ttol=1e-12)


def body_force(mesh, t, u, theta):
    """The forced channel's constant body force (2 nu, 0)."""
    f = torch.zeros((2,) + tuple(mesh.bm1.shape), dtype=mesh.dtype, device=mesh.device)
    f[0] = 2.0 * FORCED_NU
    return f


def scalar_force(mesh, t, u, theta):
    """Boussinesq buoyancy (0, 2 theta)."""
    return torch.stack([torch.zeros_like(theta[0]), 2.0 * theta[0]])


def scalar_source(mesh, t, u, theta):
    """A source of theta and the vertical velocity."""
    return (0.5 * u[1] + 0.1 * theta[0] ** 2)[None]


def scalar_case(mesh, fields: dict, gather) -> dict:
    """nscal = 1 on SCALAR_BOX: 5 `advance` steps with a theta-coupled force
    and source from fields["u0"], fields["th0"] (the wall temperature
    0.5 (1 - y) as the lift), then `propagate` (3 steps) about the result
    with the same coupling linearized, and its exact adjoint, on
    fields["du"], fields["dth"]. mesh: the whole mesh or a rank's block,
    with fields on it; gather: what makes a field whole (the identity in
    one process)."""
    from neklab_tpu_torch.models import linearized as lin
    from neklab_tpu_torch.models import navier_stokes as ns

    cfg = ns.FlowConfig(**SCALAR_CFG, forcing_fn=scalar_force, source_fn=scalar_source)
    tb = torch.stack([0.5 * (1 - mesh.x[1])])
    st = ns.initial_state(mesh, cfg, u=fields["u0"], theta=tb + fields["th0"])
    st = ns.advance(mesh, cfg, st, 5, tb=tb)
    # the force and the source linearized about st
    lin_source = lambda m, u, th: (0.5 * u[1] + 0.2 * st.theta[0] * th[0])[None]
    lcfg = lin.LinConfig(flow=cfg, lin_forcing_fn=lambda m, u, th: scalar_force(m, 0, u, th),
                         lin_source_fn=lin_source)
    mu, mth = lin.propagate(mesh, lcfg, st.u, st.theta, fields["du"], fields["dth"], 3)
    au, ath = lin.make_adjoint_propagator(mesh, lcfg, st.u, st.theta, 3)(fields["du"],
                                                                         fields["dth"])
    return {k: gather(v) for k, v in dict(u=st.u, p=st.p, theta=st.theta, mu=mu, mth=mth,
                                           au=au, ath=ath).items()}


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
    if args.get("scalar"):  # scalar_case on its inputs (scalar_u0, ...)
        smesh = shard_sem_mesh(box_mesh(**SCALAR_BOX, dtype=torch.float64, device="cpu"), part)
        fields = {k[7:]: shard_field(z[k], part) for k in z if k.startswith("scalar_")}
        out.update({"scalar_" + k: v for k, v in
                    scalar_case(smesh, fields, lambda f: gather_field(f, part)).items()})
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
    channel box with graphed CGs, against the same solves unsplit:
    args["nsteps"] nonlinear steps (3 when not given), recycling as
    args["recycle"] says (0 when not given)."""
    from neklab_tpu_torch.mesh.box import box_mesh
    from neklab_tpu_torch.models import navier_stokes as ns
    from neklab_tpu_torch.parallel import shard_sem_mesh

    gm = box_mesh(**STEP_BOX, dtype=torch.float64, device="cpu")
    mesh = shard_sem_mesh(gm, part)
    one = gm.to(dev)
    cfg = _flow_cfg(args["cfg"])
    u0 = torch.as_tensor(z["u0"], device=dev)
    out = {}
    nsteps, recycle = args.get("nsteps", 3), args.get("recycle", 0)
    for name, m in (("split", mesh), ("one", one)):
        orders = ns.bdf_orders(cfg, nsteps)
        psolves = ns.pressure_solvers(m, cfg, orders)
        vsolves = ns.velocity_solvers(m, cfg, orders, *ns.bdf3_diags(m, cfg))
        part.log.reset()
        st = ns.advance(m, cfg, ns.initial_state(m, cfg, u=u0), nsteps, psolves=psolves,
                        vsolves=vsolves, recycle=recycle)
        out[name + "_u"], out[name + "_p"] = st.u, st.p
        out[name + "_graphed"] = np.asarray([psolves[1].cg.graphed, vsolves[1][0].cg.graphed])
        out[name + "_calls"] = np.asarray(part.log.calls)
    return out


def job_fwd_sum(part, args, z, dev):
    """`Partition.sum` under forward mode: rank r sums row r of z["x"] with
    the tangent row r of z["dx"]."""
    import torch.autograd.forward_ad as fwAD

    x, dx = (torch.as_tensor(z[k][part.rank], device=dev) for k in ("x", "dx"))
    before = part.log.calls
    with fwAD.dual_level():
        primal, tangent = fwAD.unpack_dual(part.sum(fwAD.make_dual(x, dx)))
    return {"sum": primal, "sum_tangent": tangent,
            "sum_calls": np.asarray(part.log.calls - before)}


def _gathered(part, vec: dict) -> dict:
    """Every leaf of a vector whole on rank 0 (a replicated 0-d T as it is)."""
    from neklab_tpu_torch.parallel import gather_field

    return {k: gather_field(v, part) for k, v in vec.items()}


def job_drivers(part, args, z, dev):
    """Forward mode through `Partition.sum`; on the forced channel the
    fixed-point system's response and its frozen and exact Jacobians'
    matvec and rmatvec, and Newton with each (`newton_fixed_point_iteration`,
    rank 0 writing residual.dat and timers.log); recycled `propagate` and
    `advance` (`_recycled`)."""
    from neklab_tpu_torch.analysis import newton_fixed_point_iteration
    from neklab_tpu_torch.mesh.box import box_mesh
    from neklab_tpu_torch.models.linearized import LinConfig
    from neklab_tpu_torch.models.navier_stokes import FlowConfig
    from neklab_tpu_torch.parallel import gather_field, shard_field, shard_sem_mesh
    from neklab_tpu_torch.systems.fixed_point import FixedPointSystem
    from neklab_tpu_torch.vectors import flow_vector, flow_vector_space

    out = job_fwd_sum(part, args, z, dev)
    mesh = shard_sem_mesh(box_mesh(**FORCED_BOX, dtype=torch.float64, device="cpu"), part)
    cfg = LinConfig(flow=FlowConfig(**args["forced_cfg"], forcing_fn=body_force))
    space = flow_vector_space(mesh, 0)
    vec = lambda key: flow_vector(mesh, 0, u=shard_field(z[key], part))
    x, dx, w = vec("guess"), vec("du"), vec("w")
    for name in ("frozen", "exact"):
        sys_ = FixedPointSystem(mesh, cfg, exact_jacobian=name == "exact", **args["system"])
        out[f"{name}_response"] = gather_field(sys_.response(x)["u"], part)
        jac = sys_.jacobian(x)
        before = part.log.calls
        mv = jac.matvec(dx)
        out[f"{name}_matvec_calls"] = np.asarray(part.log.calls - before)
        rmv = jac.rmatvec(w)
        out[f"{name}_matvec"] = gather_field(mv["u"], part)
        out[f"{name}_rmatvec"] = gather_field(rmv["u"], part)
        out[f"{name}_identity"] = np.asarray([space.dot(mv, w), space.dot(dx, rmv)])
        res = newton_fixed_point_iteration(
            sys_, x, space, outdir=os.path.join(args["outdir"], name, f"rank{part.rank}"),
            **args["newton"])
        out[f"{name}_history"] = np.asarray(res.history)
        out[f"{name}_iterations"] = np.asarray(res.iterations)
        out[f"{name}_x"] = gather_field(res.x["u"], part)

    out.update(_recycled(part, mesh, cfg, x, dx, shard_field(z["base"], part), sys_.pc_e,
                         args["recycle"]))
    return out


def _recycled(part, mesh, cfg, x, dx, base, pc, kw) -> dict:
    """`propagate` from dx about base with recycle=0 and recycle=kw["k"],
    and `advance` from x with recycle=kw["k"], over kw["nsteps"] steps at
    solves of kw["tol"] with the preconditioner pc (E's exact blocks: the
    element-first layout), gathered; and the all-reduces that recycling
    adds per recycled solve: the difference of the two propagations' logs
    less the difference of their CG iterations times each CG's all-reduces
    per iteration."""
    import dataclasses

    from neklab_tpu_torch.models import navier_stokes as ns
    from neklab_tpu_torch.models.linearized import LinConfig, propagate
    from neklab_tpu_torch.parallel import gather_field

    fc = dataclasses.replace(cfg.flow, vtol=kw["tol"], ptol=kw["tol"])
    n, k = kw["nsteps"], kw["k"]
    orders = ns.bdf_orders(fc, n)
    psolves = ns.pressure_solvers(mesh, fc, orders, pc)
    vsolves = ns.velocity_solvers(mesh, fc, orders, *ns.bdf3_diags(mesh, fc))
    tmax = orders[-1]
    per_iter = {"pressure": _per_iteration(part, psolves[tmax].cg, psolves[tmax].cg.r.normal_()),
                "helmholtz": _per_iteration(part, vsolves[tmax][0].cg,
                                            vsolves[tmax][0].cg.r.normal_())}
    th = torch.zeros((0,) + tuple(mesh.bm1.shape), dtype=mesh.dtype, device=mesh.device)
    out, calls, iters = {}, {}, {}
    for r in (0, k):
        stats = {}
        part.log.reset()
        mu = propagate(mesh, LinConfig(flow=fc), base, th, dx["u"], th, n, pc_e=pc,
                       psolves=psolves, vsolves=vsolves, stats=stats, recycle=r)[0]
        out[f"recycle{r}_propagate"] = gather_field(mu, part)
        calls[r] = part.log.calls
        iters[r] = {key: sum(v) for key, v in stats.items()}
    cg_diff = sum(per_iter[key] * (iters[k][key] - iters[0][key]) for key in per_iter)
    out["recycle_extra"] = np.asarray((calls[k] - calls[0] - cg_diff) / (n - (len(orders) - 1)))
    out["recycle_iters"] = np.asarray([iters[0]["pressure"], iters[k]["pressure"]])
    st = ns.advance(mesh, fc, ns.initial_state(mesh, fc, u=x["u"]), n, pc_e=pc, psolves=psolves,
                    vsolves=vsolves, recycle=k)
    out[f"recycle{k}_advance"] = gather_field(st.u, part)
    return out


def job_analyses(part, args, z, dev):
    """On the channel box: transient growth
    (`transient_growth_analysis_fixed_point`, rank 0 writing
    singular_spectrum.dat and timers.log) with the triplet identity, the
    resolvent's matvec and rmatvec with their GMRES counts, the projected
    propagator's projection, matvec and rmatvec."""
    from neklab_tpu_torch.analysis import transient_growth_analysis_fixed_point
    from neklab_tpu_torch.krylov.space import tree_axpby
    from neklab_tpu_torch.linops.exponential_propagator import ExponentialPropagator
    from neklab_tpu_torch.linops.projected import ProjectedPropagator
    from neklab_tpu_torch.linops.resolvent import Resolvent, complex_pair_space
    from neklab_tpu_torch.mesh.box import box_mesh
    from neklab_tpu_torch.models.linearized import LinConfig
    from neklab_tpu_torch.models.navier_stokes import FlowConfig
    from neklab_tpu_torch.parallel import gather_field, shard_field, shard_sem_mesh
    from neklab_tpu_torch.vectors import flow_vector_space

    out = {}
    mesh = shard_sem_mesh(box_mesh(**STEP_BOX, dtype=torch.float64, device="cpu"), part)
    cfg = LinConfig(flow=FlowConfig(**args["lin_cfg"]))
    base = shard_field(z["base"], part)
    th = torch.zeros((0,) + tuple(mesh.bm1.shape), dtype=mesh.dtype, device=dev)

    A = ExponentialPropagator(mesh, cfg, base, tau=args["tg_tau"], dt=cfg.flow.dt)
    space = flow_vector_space(mesh, 0)
    res = transient_growth_analysis_fixed_point(
        A, space, outdir=os.path.join(args["outdir"], "tg", f"rank{part.rank}"), **args["tg"])
    v, u = res.optimal_inputs[0], res.optimal_outputs[0]
    s = float(res.sigma[0])
    err = tree_axpby(1.0, A.matvec(v), -s, u)
    out.update(tg_sigma=res.sigma, tg_residuals=res.residuals, tg_n_matvec=np.asarray(res.n_matvec),
               tg_triplet=np.asarray(space.norm(err) / s), tg_in=gather_field(v["u"], part),
               tg_out=gather_field(u["u"], part))

    R = Resolvent(mesh, cfg, base, **args["resolvent"])
    pair = lambda key: {p: {"u": shard_field(z[f"{key}_{p}"], part), "theta": th}
                        for p in ("re", "im")}
    f, g = pair("f"), pair("g")
    rf = R.matvec(f)
    counts = [R.last_gmres_matvecs]
    rg = R.rmatvec(g)
    out["res_gmres"] = np.asarray(counts + [R.last_gmres_matvecs])
    space = complex_pair_space(mesh, 0)
    out["res_identity"] = np.asarray([space.dot(rf, g), space.dot(f, rg)])
    for p in ("re", "im"):
        out[f"res_matvec_{p}"] = gather_field(rf[p]["u"], part)
        out[f"res_rmatvec_{p}"] = gather_field(rg[p]["u"], part)

    A = ExponentialPropagator(mesh, cfg, base, tau=args["proj_tau"], dt=cfg.flow.dt)
    P = ProjectedPropagator(A, args["alpha"])
    v, w = ({"u": shard_field(z[k], part), "theta": th} for k in ("pv", "pw"))
    before = part.log.calls
    pv = P.project(v)["u"]
    out["proj_calls"] = np.asarray(part.log.calls - before)
    out["proj_project"] = gather_field(pv, part)
    out["proj_matvec"] = gather_field(P.matvec(v)["u"], part)
    out["proj_rmatvec"] = gather_field(P.rmatvec(w)["u"], part)
    return out


def job_orbits(part, args, z, dev):
    """On the forced channel the periodic orbit's bordered Jacobian (matvec
    with dT != 0, rmatvec, dPhi/dT) and the monodromy; on tests/test_otd.py's
    channel `otd_analysis` from OTDIC files (rank 0 writing the files, the
    restart loaded again on every rank) and from `_random_modes`."""
    from neklab_tpu_torch import otd
    from neklab_tpu_torch.mesh.box import box_mesh
    from neklab_tpu_torch.models.linearized import LinConfig
    from neklab_tpu_torch.models.navier_stokes import FlowConfig, initial_state
    from neklab_tpu_torch.parallel import gather_field, shard_field, shard_sem_mesh
    from neklab_tpu_torch.systems.periodic_orbit import MonodromyOperator, PeriodicOrbitSystem
    from neklab_tpu_torch.vectors import ext_flow_vector

    out = {}
    mesh = shard_sem_mesh(box_mesh(**FORCED_BOX, dtype=torch.float64, device="cpu"), part)
    fcfg = LinConfig(flow=FlowConfig(**args["forced_cfg"], forcing_fn=body_force))
    sys_ = PeriodicOrbitSystem(mesh, fcfg, t_guess=args["T"], nsteps=args["upo_nsteps"])
    th = torch.zeros((0,) + tuple(mesh.bm1.shape), dtype=mesh.dtype, device=dev)
    ext = lambda key, T: ext_flow_vector(mesh, 0, u=shard_field(z[key], part), theta=th, T=T)
    x, dx, vv = ext("upo_x", args["T"]), ext("upo_du", 0.7), ext("upo_dv", -0.4)
    jac = sys_.jacobian(x)
    out.update({f"upo_matvec_{k}": val for k, val in _gathered(part, jac.matvec(dx)).items()})
    out.update({f"upo_rmatvec_{k}": val for k, val in _gathered(part, jac.rmatvec(vv)).items()})
    out["upo_period_dir"] = gather_field(jac.period_dir()["u"], part)
    mono = MonodromyOperator(sys_, x)
    out["mono_matvec"] = gather_field(mono.matvec(dx)["u"], part)
    out["mono_rmatvec"] = gather_field(mono.rmatvec(vv)["u"], part)

    mesh = shard_sem_mesh(box_mesh(**OTD_BOX, dtype=torch.float64, device="cpu"), part)
    ocfg = LinConfig(flow=FlowConfig(**args["otd_cfg"]))
    y = mesh.x[1]
    obase = initial_state(mesh, ocfg.flow, u=torch.stack([1 - y**2, 0 * y]))
    opts = otd.OtdOpts(**args["otd_opts"])
    outdir = os.path.join(args["outdir"], "otd", f"rank{part.rank}")
    res = otd.otd_analysis(mesh, ocfg, opts, obase, args["otd_nsteps"], outdir=outdir,
                           ic_paths=args["ic_paths"])
    out["otd_files_lr"] = np.stack([lr for _, lr in res.lr_history])
    out["otd_files_u"] = gather_field(res.perts.u, part)
    rst = os.path.join(args["outdir"], "otd", "rank0", "rstotd0.f00001.npz")
    back, _ = otd.load_otd_restart(rst, res.perts, res.base, part)
    out["otd_restart_diff"] = np.asarray(max(float((getattr(back, k) - getattr(res.perts, k))
                                                   .abs().max()) for k in ("u", "p", "ulag")))
    res = otd.otd_analysis(mesh, ocfg, opts, obase, args["otd_nsteps"], seed=args["otd_seed"])
    out["otd_random_lr"] = np.stack([lr for _, lr in res.lr_history])
    out["otd_random_start"] = gather_field(otd._random_modes(mesh, opts.r, args["otd_seed"]), part)
    return out


def job_nccl_jvp(part, args, z, dev):
    """One NCCL rank on a card: the exact Jacobian's matvec on the forced
    channel, forward mode through the split `advance` with every CG
    graphed (the pressure mean's and the range projections' all-reduces
    carry the tangent)."""
    from neklab_tpu_torch.mesh.box import box_mesh
    from neklab_tpu_torch.models.linearized import LinConfig
    from neklab_tpu_torch.models.navier_stokes import FlowConfig
    from neklab_tpu_torch.parallel import gather_field, shard_field, shard_sem_mesh
    from neklab_tpu_torch.systems.fixed_point import FixedPointSystem
    from neklab_tpu_torch.vectors import flow_vector

    mesh = shard_sem_mesh(box_mesh(**FORCED_BOX, dtype=torch.float64, device="cpu"), part)
    cfg = LinConfig(flow=FlowConfig(**args["cfg"], forcing_fn=body_force))
    system = FixedPointSystem(mesh, cfg, exact_jacobian=True, **args["system"])
    x, dx = (flow_vector(mesh, 0, u=shard_field(z[k], part)) for k in ("guess", "du"))
    mv = system.jacobian(x).matvec(dx)
    (d,) = system.derived.values()
    graphed = [d.psolves[o].cg.graphed for o in d.psolves] + \
        [d.vsolves[o][0].cg.graphed for o in d.vsolves]
    return {"jvp": gather_field(mv["u"], part), "graphed": np.asarray(graphed)}


JOBS = {"step": job_step, "propagate": job_propagate, "eigs": job_eigs, "nccl": job_nccl,
        "fwd_sum": job_fwd_sum, "drivers": job_drivers, "analyses": job_analyses,
        "orbits": job_orbits, "nccl_jvp": job_nccl_jvp}


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
