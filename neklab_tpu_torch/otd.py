"""Optimally Time-Dependent (OTD) mode evolution.

Co-evolves r orthonormal perturbations with the (optionally unsteady) base
flow. Per chunk of steps:
  1. base flow: a nonlinear step (if solve_baseflow); the perturbations
     linearize about the current base every step;
  2. perturbations: linearized steps with the rank-coupling force
     f_i = -sum_j (Lr_ji - Phi_ji) u_j refreshed every step;
  3. orthonormalization of the basis (Gram-Cholesky, applied to the whole
     state, pressure and history included);
  4. the reduced operator Lr_ij = <u_i, L u_j> with the frozen-LNS apply_L.

Counterpart of `neklab_tpu/otd.py`, with the same Ls.dat / Lr.dat spectra,
projected-mode field files and restart checkpoints, under the same names
and cadences. The reference runs the r linearized steps under `jax.vmap`,
so every mode's CGs keep their own scalars and their own stopping rule;
here the modes loop through the same solvers one after another, which is
that arithmetic: r times the launches of one linearized step (one joint CG
over the stacked modes would stop on their joint residual instead).
Perturbation batches are `PertState`s whose fields carry a leading mode
axis r.

On a rank's block of a partitioned mesh (`parallel.shard_sem_mesh`) the
Gram matrices are summed over the ranks (one all-reduce of the r x r
matrix), the random start is drawn whole on the host and split, and the
files (Ls.dat, Lr.dat, the mode files, the restarts) are written by rank 0
in the one-process layout.
"""

from __future__ import annotations

import dataclasses
import logging
import os

import numpy as np
import torch

from .mesh.core import SemMesh
from .models import navier_stokes as ns
from .models import stokes
from .models.linearized import (LinConfig, PertState, _explicit_lin_map,
                                adjoint_explicit_lin_map, pert_initial, step_lin)
from .models.navier_stokes import FlowState
from .ops import sem
from .parallel.sharding import gather_field, global_sum, shard_field

logger = logging.getLogger("neklab_tpu_torch.otd")


@dataclasses.dataclass(frozen=True)
class OtdOpts:
    """The reference's otd_opts: startstep (OTD evolution begins at that base
    step), orthostep (re-orthonormalization cadence), printstep (Ls/Lr
    spectral-analysis cadence), iostep (projected-mode outposting cadence),
    iorststep (basis restart-checkpoint cadence), trans (adjoint OTD
    evolution), solve_baseflow (co-evolve the nonlinear base)."""

    r: int = 2  # number of OTD modes (lpert)
    startstep: int = 1
    orthostep: int = 10  # re-orthonormalize every so many steps
    printstep: int = 10  # spectral analysis cadence
    iostep: int = 0  # projected-mode outpost cadence (0 = never)
    iorststep: int = 0  # basis restart-checkpoint cadence (0 = never)
    solve_baseflow: bool = False
    trans: bool = False  # adjoint (transposed) OTD evolution


def _explicit_map(mesh: SemMesh, cfg: LinConfig, base_u, base_theta, trans: bool):
    """The explicit linearized operator about the base, or its transpose."""
    ccache = sem.lin_convect_cache(mesh, base_u, base_theta if cfg.nscal else None)
    th_shape = (cfg.nscal,) + tuple(mesh.bm1.shape)
    if trans:
        return adjoint_explicit_lin_map(mesh, cfg, ccache, th_shape)
    return _explicit_lin_map(mesh, cfg, ccache, th_shape)


def apply_l(mesh: SemMesh, cfg: LinConfig, base_u, base_theta, st: PertState,
            trans: bool = False, emap=None):
    """Frozen-coefficient linearized NS right-hand side L u (strong form) of
    one perturbation:

      L u = Binv vmask dssum( -(v, U.grad u) - (v, u.grad U) - nu (grad v, grad u)
                              + (p, div v) + coupling forces )

    with the perturbation's own pressure. trans=True applies the transpose
    of the convection and coupling part (`adjoint_explicit_lin_map`); the
    viscous term is self-adjoint and the pressure term keeps the input's
    own pressure. emap: the explicit map (`_explicit_map` about this base),
    built here when None."""
    if emap is None:
        emap = _explicit_map(mesh, cfg, base_u, base_theta, trans)
    n_u, _ = emap(st.u, st.theta)
    visc = torch.stack([sem.stiffness_local(mesh, st.u[i]) for i in range(mesh.ndim)])
    gp = stokes.grad_weak_t(mesh, st.p)
    return mesh.vmask * mesh.binv * sem.dssum(mesh, n_u - cfg.flow.viscosity * visc + gp)


def _mass_dots(mesh: SemMesh, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[r, r] Gram matrix sum(a_i * b_j * bm1) of two mode stacks [r, ...],
    summed over every rank's block (one all-reduce of the matrix)."""
    return global_sum(mesh.part, (a * mesh.bm1).flatten(1) @ b.flatten(1).T)


def _mode(states: PertState, i: int) -> PertState:
    return PertState(**{f.name: getattr(states, f.name)[i] for f in dataclasses.fields(states)})


def _stack(modes: list) -> PertState:
    return PertState(**{f.name: torch.stack([getattr(m, f.name) for m in modes])
                        for f in dataclasses.fields(PertState)})


def orthonormalize_states(mesh: SemMesh, states: PertState) -> PertState:
    """Cholesky orthonormalization of the batch (leading axis r) in the
    velocity mass inner product; the whole state is rotated. The r x r
    factorization runs on the host."""
    g = _mass_dots(mesh, states.u, states.u).cpu()
    l = torch.linalg.cholesky(g)
    eye = torch.eye(g.shape[0], dtype=g.dtype)
    linv = torch.linalg.solve_triangular(l, eye, upper=False).to(states.u.device)
    return PertState(**{f.name: torch.einsum("ij,j...->i...", linv, getattr(states, f.name))
                        for f in dataclasses.fields(states)})


def otd_solvers(mesh: SemMesh, cfg: LinConfig, pc_e=None, vdiag=None) -> dict:
    """The pressure and velocity solvers of every BDF order of an OTD run
    (`navier_stokes.pressure_solvers`, `velocity_solvers`), which the modes'
    linearized steps and the base's nonlinear step share."""
    fc = cfg.flow
    orders = ns.bdf_orders(fc, min(fc.torder, 3))
    vdiag, tdiags = ns.bdf3_diags(mesh, fc, vdiag)
    return {"psolves": ns.pressure_solvers(mesh, fc, orders, pc_e),
            "vsolves": ns.velocity_solvers(mesh, fc, orders, vdiag, tdiags)}


def otd_chunk(
    mesh: SemMesh,
    cfg: LinConfig,
    opts: OtdOpts,
    base: FlowState,
    perts: PertState,
    ksteps: int,
    ramp: bool = False,
    ub=None,
    tb=None,
    pc_e=None,
    vdiag=None,
    ortho_every: int = 0,
    solvers: dict | None = None,
    stats: dict | None = None,
):
    """Advance the base and r perturbations ksteps, orthonormalize, and
    return (base, perts, Lr). Set ramp=True for the FIRST chunk: BDF3 with
    cold (zero) history is violently unstable, so the first two steps run
    at orders 1 and 2.

    ortho_every: re-orthonormalize the basis every so many steps inside the
    chunk (the reference's orthostep cadence); 0 = only at the chunk's end.
    opts.trans evolves the adjoint linearized equations and uses the
    transposed frozen-LNS operator for Lr. solvers: `otd_solvers`, built
    here when None (a run builds them once). stats: optional dict, filled
    by every linearized and nonlinear step as `step_lin` fills it."""
    fc = cfg.flow
    tmax = min(fc.torder, 3)
    if solvers is None:
        solvers = otd_solvers(mesh, cfg, pc_e, vdiag)
    psolves, vsolves = solvers["psolves"], solvers["vsolves"]
    modes = [_mode(perts, i) for i in range(perts.u.shape[0])]
    emap = None  # the explicit map about the current base, rebuilt when it moves

    def lr_of(b, modes):
        lu = torch.stack([apply_l(mesh, cfg, b.u, b.theta, m, emap=emap) for m in modes])
        return _mass_dots(mesh, torch.stack([m.u for m in modes]), lu)

    def run(b, modes, order):
        nonlocal emap
        if emap is None:
            emap = _explicit_map(mesh, cfg, b.u, b.theta, opts.trans)
        lr = lr_of(b, modes)
        forces = -torch.einsum("ji,j...->i...", lr, torch.stack([m.u for m in modes]))
        vsolve, tsolves = vsolves[order]
        modes = [step_lin(mesh, cfg, m, b.u, b.theta, order, psolves[order], vsolve, tsolves,
                          stats=stats, force=forces[i], emap=emap)
                 for i, m in enumerate(modes)]
        if opts.solve_baseflow:
            b = ns.step(mesh, fc, b, order, psolves[order], vsolve, tsolves, ub=ub, tb=tb,
                        stats=stats)
            emap = None
        return b, modes

    n_ramp = min(tmax - 1, ksteps) if ramp else 0
    for k in range(n_ramp):
        base, modes = run(base, modes, k + 1)

    def orthonormalized(modes):
        orth = orthonormalize_states(mesh, _stack(modes))
        return [_mode(orth, i) for i in range(len(modes))]

    remaining = ksteps - n_ramp
    blk = ortho_every if ortho_every and ortho_every < remaining else remaining
    done = 0
    while done < remaining:
        k = min(blk, remaining - done)
        for _ in range(k):
            base, modes = run(base, modes, tmax)
        done += k
        if done < remaining:
            modes = orthonormalized(modes)
    perts = orthonormalize_states(mesh, _stack(modes))
    if emap is None:
        emap = _explicit_map(mesh, cfg, base.u, base.theta, opts.trans)
    lr = lr_of(base, [_mode(perts, i) for i in range(perts.u.shape[0])])
    return base, perts, lr


def _global_shape(mesh: SemMesh, shape) -> tuple:
    """shape with its last (element) axis the global mesh's on a rank's block."""
    shape = tuple(shape)
    return shape if mesh.part is None else shape[:-1] + (shape[-1] * mesh.part.size,)


def _to_mesh(mesh: SemMesh, f) -> torch.Tensor:
    """A whole field (host) on the mesh's device: its block on a rank's."""
    f = torch.as_tensor(f, dtype=mesh.dtype)
    return f.to(mesh.device) if mesh.part is None else shard_field(f, mesh.part)


def _random_modes(mesh: SemMesh, count: int, seed: int) -> torch.Tensor:
    """count standard-normal velocity fields, drawn whole on the host from a
    torch.Generator seeded with seed (so a card, the CPU and a run over P
    ranks start from the same modes)."""
    gen = torch.Generator()
    gen.manual_seed(int(seed))
    u = torch.randn((count, mesh.ndim) + _global_shape(mesh, mesh.bm1.shape), generator=gen,
                    dtype=mesh.dtype)
    return _to_mesh(mesh, u)


def _initial_perts(mesh: SemMesh, cfg: LinConfig, us) -> PertState:
    u = torch.stack([mesh.vmask * sem.dsavg(mesh, ui) for ui in us])
    return orthonormalize_states(mesh, _stack([pert_initial(mesh, cfg, ui) for ui in u]))


def load_otd_ics(
    mesh: SemMesh,
    cfg: LinConfig,
    paths: list[str],
    r: int | None = None,
    seed: int = 7,
) -> PertState:
    """User-supplied OTD initial conditions from field files (the
    reference's OTDIC_xx.fld convention): the first len(paths) modes come
    from the files (binary Nek .fld or .npz with a "u" array), the remaining
    of the r modes are random (a torch.Generator seeded with `seed`), and
    the whole basis is orthonormalized. A file holds the whole field; on a
    rank's block each rank keeps its block of it."""
    r = r if r is not None else len(paths)
    if len(paths) > r:
        raise ValueError(f"more IC files ({len(paths)}) than modes ({r})")
    shape = (mesh.ndim,) + _global_shape(mesh, mesh.bm1.shape)
    us = []
    for p in paths:
        if p.endswith(".npz"):
            with np.load(p) as z:
                u = np.asarray(z["u"])
        else:
            from .utils.fldfile import read_fld

            u = read_fld(p).u
        if u is None or u.shape != shape:
            raise ValueError(f"IC file {p}: expected velocity shaped {shape}, got "
                             f"{None if u is None else u.shape}")
        us.append(_to_mesh(mesh, u))
    if len(us) < r:
        us.extend(list(_random_modes(mesh, r - len(us), seed)))
    return _initial_perts(mesh, cfg, us)


@dataclasses.dataclass
class OtdResult:
    base: FlowState
    perts: PertState
    lr_history: list  # (time, Lr) tuples
    eigvals_lr: np.ndarray  # spectrum of the final reduced operator
    eigvals_sym: np.ndarray  # spectrum of its symmetric part


def outpost_otd_modes(
    mesh: SemMesh, perts: PertState, lr: np.ndarray, outdir: str,
    counter: int = 1, case: str = "otd", time: float = 0.0,
) -> list[str]:
    """Project the OTD basis by the (real part of the) Lr eigenvector matrix
    and write one binary Nek field file per mode, prefix 'm01', 'm02', ...
    (the reference's outpost_OTDmodes). On a rank's block every rank calls
    it, and rank 0 writes the gathered modes on the global mesh; every rank
    returns the paths once the files are there."""
    from .utils.fldfile import write_fld

    part = mesh.part
    w, eigvec = np.linalg.eig(np.asarray(lr))
    order = np.argsort(-w.real, kind="stable")
    ev = np.asarray(eigvec[:, order].real)  # [r (basis), r (mode)]
    u, p = (gather_field(f, part) for f in (perts.u, perts.p))  # [r, ndim, ...], [r, ...2]
    paths = [os.path.join(outdir, f"m{i + 1:02d}{case}0.f{counter:05d}")
             for i in range(perts.u.shape[0])]
    if part is None or part.is_root:
        u, p = u.cpu().numpy(), p.cpu().numpy()
        modes_u = np.einsum("jr,j...->r...", ev, u)
        modes_p = np.einsum("jr,j...->r...", ev, p)
        os.makedirs(outdir, exist_ok=True)
        whole = mesh if part is None else part.global_mesh
        for i, path in enumerate(paths):
            write_fld(path, mesh=whole, u=modes_u[i], p=modes_p[i], time=time)
    if part is not None:
        part.from_root(1.0)  # every rank returns once the files are there
    return paths


def save_otd_restart(outdir: str, perts: PertState, base: FlowState,
                     counter: int = 1, case: str = "otd", part=None) -> str:
    """Write the full OTD basis (and the co-evolved base) as a restart
    checkpoint, atomically (a kill mid-write leaves the last one whole).
    part: the `Partition` of a rank's block; every rank calls it, rank 0
    writes the gathered fields in the one-process layout, and every rank
    returns once the file is there."""
    path = os.path.join(outdir, f"rst{case}0.f{counter:05d}.npz")
    data = {}
    for f in dataclasses.fields(perts):
        data["pert_" + f.name] = gather_field(getattr(perts, f.name), part)
    for f in dataclasses.fields(base):
        v = getattr(base, f.name)
        whole = isinstance(v, torch.Tensor) and v.dim() > 0
        data["base_" + f.name] = gather_field(v, part) if whole else v
    if part is None or part.is_root:
        data = {k: v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
                for k, v in data.items()}
        os.makedirs(outdir, exist_ok=True)
        tmp = path + ".tmp.npz"  # savez appends '.npz' unless the name ends with it
        np.savez_compressed(tmp, **data)
        os.replace(tmp, path)
    if part is not None:
        part.from_root(1.0)
    return path


def _max_counter(outdir: str, prefix: str) -> int:
    """Largest .fNNNNN counter among files named <prefix>NNNNN* in outdir
    (0 if none): output numbering continues across restarts."""
    best = 0
    try:
        names = os.listdir(outdir)
    except OSError:
        return 0
    for name in names:
        if name.startswith(prefix):
            digits = name[len(prefix):len(prefix) + 5]
            if digits.isdigit():
                best = max(best, int(digits))
    return best


def load_otd_restart(path: str, perts_tmpl: PertState, base_tmpl: FlowState, part=None):
    """Resume from a save_otd_restart checkpoint: (perts, base). part: the
    `Partition` of a rank's block (templates of the block); each rank keeps
    its block of the file's whole fields."""
    def load(z, key, like):
        if isinstance(like, torch.Tensor):
            f = torch.as_tensor(z[key], dtype=like.dtype)
            return shard_field(f, part) if part is not None and like.dim() else f.to(like.device)
        return type(like)(z[key])

    with np.load(path) as z:
        pk = {f.name: load(z, "pert_" + f.name, getattr(perts_tmpl, f.name))
              for f in dataclasses.fields(perts_tmpl)}
        bk = {f.name: load(z, "base_" + f.name, getattr(base_tmpl, f.name))
              for f in dataclasses.fields(base_tmpl)}
    return dataclasses.replace(perts_tmpl, **pk), dataclasses.replace(base_tmpl, **bk)


def _spectra(lr: np.ndarray):
    ev = np.sort_complex(np.linalg.eigvals(lr))[::-1]
    evs = np.sort(np.linalg.eigvalsh(0.5 * (lr + lr.T)))[::-1]
    return ev, evs


def otd_analysis(
    mesh: SemMesh,
    cfg: LinConfig,
    opts: OtdOpts,
    base: FlowState,
    nsteps: int,
    init_perts: PertState | None = None,
    ub=None,
    tb=None,
    pc_e=None,
    outdir: str | None = None,
    seed: int = 7,
    ic_paths: list[str] | None = None,
    restart: str | None = None,
    stats: dict | None = None,
) -> OtdResult:
    """The reference's otd_analysis loop: random (a torch.Generator
    seeded with `seed`), file-loaded or given orthonormal initial modes,
    chunked evolution, Ls/Lr spectra logged every `printstep`, projected
    modes outposted every `iostep`, basis restart checkpoints every
    `iorststep`, the OTD start deferred to `startstep`. ic_paths: OTDIC
    field files (see load_otd_ics). restart: resume from a save_otd_restart
    checkpoint. The solvers are built once for the run. stats: optional
    dict, filled by every step as `step_lin` fills it.

    On a rank's block (`mesh.part`) every rank returns the same Lr history
    and its blocks of the modes and the base; rank 0 writes the files, and
    the counters that continue a restart's numbering are rank 0's."""
    fc = cfg.flow
    part = mesh.part
    if init_perts is None and ic_paths:
        init_perts = load_otd_ics(mesh, cfg, ic_paths, r=opts.r, seed=seed)
    if init_perts is None:
        init_perts = _initial_perts(mesh, cfg, list(_random_modes(mesh, opts.r, seed)))
    perts = init_perts
    done = 0
    if restart is not None:
        perts, base = load_otd_restart(restart, perts, base, part)
    solvers = otd_solvers(mesh, cfg, pc_e)

    # pre-advance the base alone until the OTD start step
    pre = min(max(opts.startstep - 1, 0), nsteps) if restart is None else 0
    if pre and opts.solve_baseflow:
        base = ns.advance(mesh, fc, base, pre, ub=ub, tb=tb, stats=stats, **solvers)
    done += pre

    lr_history = []
    f_ls = f_lr = None
    io_counter = rst_counter = 0
    if outdir and (part is None or part.is_root):
        os.makedirs(outdir, exist_ok=True)
        mode = "a" if restart is not None else "w"
        f_ls = open(os.path.join(outdir, "Ls.dat"), mode)
        f_lr = open(os.path.join(outdir, "Lr.dat"), mode)
    if outdir and restart is not None:
        # continue past existing outputs: a resumed run never overwrites the
        # checkpoint it was resumed from (rank 0's count, on every rank)
        io_counter, rst_counter = (_max_counter(outdir, pre) for pre in ("m01otd0.f", "rstotd0.f"))
        if part is not None:
            io_counter, rst_counter = (int(part.from_root(c)) for c in (io_counter, rst_counter))

    def next_event(k):
        """Steps until the next cadence boundary after k evolved OTD steps
        (cadences of 0 mean never; orthostep is one, so chunk boundaries land
        on global orthostep multiples)."""
        cadences = [c for c in (opts.printstep, opts.iostep, opts.iorststep,
                                opts.orthostep) if c > 0]
        if not cadences:
            return nsteps - done
        return min(c - (k % c) for c in cadences)

    evolved = 0  # OTD steps evolved (after startstep)
    try:
        while done < nsteps:
            k = min(next_event(evolved), nsteps - done)
            base, perts, lr = otd_chunk(
                mesh, cfg, opts, base, perts, k, ramp=(evolved == 0 and restart is None),
                ub=ub, tb=tb, ortho_every=opts.orthostep, solvers=solvers, stats=stats,
            )
            done += k
            evolved += k
            lr_np = lr.cpu().numpy()
            # a frozen base never advances base.time: the series is stamped
            # with the evolved-step clock
            t = float(base.time) if opts.solve_baseflow else done * fc.dt
            if (opts.printstep > 0 and evolved % opts.printstep == 0) or done >= nsteps:
                lr_history.append((t, lr_np))
                ev, evs = _spectra(lr_np)
                if f_ls is not None:
                    f_ls.write(" ".join(f"{v:.10e}" for v in evs) + f" {t:.6f}\n")
                    f_lr.write(
                        " ".join(f"{v.real:.10e} {v.imag:.10e}" for v in ev) + f" {t:.6f}\n"
                    )
                logger.info("otd t=%.4f: leading Re(eig Lr)=%.6f, sym=%.6f", t, ev[0].real, evs[0])
            if outdir and opts.iostep and evolved % opts.iostep == 0:
                io_counter += 1
                outpost_otd_modes(mesh, perts, lr_np, outdir, counter=io_counter, time=t)
            if outdir and opts.iorststep and evolved % opts.iorststep == 0:
                rst_counter += 1
                save_otd_restart(outdir, perts, base, counter=rst_counter, part=part)
    finally:
        if f_ls is not None:
            f_ls.close()
            f_lr.close()
    ev, evs = _spectra(lr_history[-1][1])
    return OtdResult(base=base, perts=perts, lr_history=lr_history, eigvals_lr=ev,
                     eigvals_sym=evs)
