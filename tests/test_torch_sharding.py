"""Port parity: element-partitioned runs over several gloo ranks on the CPU.

The port split over P processes (`tests/torch_shard_workers.py`, one
process per rank, a gloo group each) against the JAX package on the same
numpy-seeded inputs, and against the port in one process. Cases:

  * `shard_sem_mesh`'s fields against slices of the global mesh, and the
    reference's divisibility error; what a rank's mesh and preconditioner
    hold scales with its block;
  * `dssum`, `mass_dot`, `rand` and `cfl_dt` split against one process
    (rounding);
  * 3 nonlinear steps on tests/test_sharding.py:28-38's box against the
    reference's `advance`: 1e-10 in u and 1e-8 in p (its own bounds, with
    1e-10 solves); their state checkpoint and field file, written whole by
    rank 0 and split again on load;
  * at P = 2, nscal = 1 (`torch_shard_workers.scalar_case`: 5 steps with a
    theta-coupled force and source, `propagate` and its adjoint) against
    one process;
  * one step's all-reduces: none moves a quarter of a velocity field, and
    a velocity CG iteration makes 4 (two `dssum`s, p.Ap, and (r.z, r.r)
    together), an unpreconditioned pressure iteration on the pure-Neumann
    box 5 (E's `dssum`, the range projection of E's output, p.Ap, the
    residual's projection, (r.z, r.r));
  * `propagate` (3 steps) and its exact adjoint on an RCB-ordered `.re2`
    mesh written to tmp_path, with OAS + Q1 + E's exact blocks and with
    block Jacobi + constants (the matrix-free E): 1e-7 against the
    reference (`__graft_entry__.py:158-160`'s bound, 1e-11/1e-10 solves);
  * a 3-D `propagate` and adjoint on tests/test_precond.py:117-127's
    walled box (block Jacobi + constants), 1e-7;
  * the eigensolve of tests/test_sharding.py:199-245 through
    `linear_stability_analysis_fixed_point` at P = 2 against the
    reference's `eigs`, both from the reference's start vector (its
    `rand(3)`): |dmu| < 1e-6, residuals < 1e-7. Cut: dt 2e-3 -> 0.1 (4
    steps per matvec, the BDF1/2 ramp and two BDF3 steps, not 200; CFL
    ~0.2), so the file stays inside its time: each step makes ~150
    all-reduces, each a round trip between the rank processes; the mesh,
    base flow, nu, tau, nev, kdim and tol are the case's.
    Rank 0 alone writes the driver's files; the eigs checkpoint written by
    2 ranks loads in one process and the other way;
  * `slow`: the split port against the reference's own sharded run on the
    virtual device mesh (`make_device_mesh(P)`), at the case's dt.

Each job's ranks are killed at their time limit; the JAX side runs while
they do.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_shard_workers as W
from neklab_tpu.krylov.eigs import eigs as jeigs
from neklab_tpu.linops.exponential_propagator import ExponentialPropagator as JProp
from neklab_tpu.mesh.box import box_mesh as jbox_mesh
from neklab_tpu.mesh.re2 import mesh_from_re2 as jmesh_from_re2
from neklab_tpu.models import linearized as jlin
from neklab_tpu.models import navier_stokes as jns
from neklab_tpu.models.precond import build_e_preconditioner as jbuild
from neklab_tpu.ops import sem as jsem
from neklab_tpu.parallel import sharding as jsharding
from neklab_tpu.vectors import flow_vector as jflow_vector
from neklab_tpu.vectors import flow_vector_space as jflow_vector_space
from neklab_tpu_torch.krylov.eigs import _load_krylov_state, eigs
from neklab_tpu_torch.linops.exponential_propagator import ExponentialPropagator
from neklab_tpu_torch.mesh.box import box_mesh
from neklab_tpu_torch.models.navier_stokes import FlowConfig
from neklab_tpu_torch.models.linearized import LinConfig
from neklab_tpu_torch.ops import sem
from neklab_tpu_torch.parallel import Partition, shard_sem_mesh
from neklab_tpu_torch.models.precond import build_e_preconditioner
from neklab_tpu_torch.parallel.sharding import _HOST_FIELDS, _SEM_MESH_AXES
from neklab_tpu_torch.utils import io
from neklab_tpu_torch.utils.timestep import cfl_dt
from neklab_tpu_torch.vectors import flow_vector, flow_vector_space
from torch_port_helpers import absdiff, rel, t, write_re2

STEP_CFG = dict(viscosity=1e-3, dt=2e-3, vtol=1e-10, ptol=1e-10, vmaxit=40, pmaxit=80)
LIN_CFG = dict(viscosity=0.02, dt=5e-3, vtol=1e-11, ptol=1e-10, vmaxit=200, pmaxit=400)
EIGS_CFG = dict(viscosity=0.05, dt=0.1, vtol=1e-11, ptol=1e-11, vmaxit=60, pmaxit=120)
PRECONDS = {"oas": {}, "bj": dict(local="bj", coarse="const", exact_blocks=False)}


@pytest.fixture(autouse=True)
def no_cache(monkeypatch):
    monkeypatch.setenv("NEKLAB_PRECOND_CACHE", "0")


def jstep_box():
    return jbox_mesh(**W.STEP_BOX, dtype=jnp.float64)


def step_box():
    return box_mesh(**W.STEP_BOX, dtype=torch.float64, device="cpu")


def c0(jmesh, rng, ncomp):
    """A C0, velocity-masked numpy field of the reference mesh."""
    f = jsem.dsavg(jmesh, jnp.asarray(rng.standard_normal((ncomp,) + tuple(jmesh.bm1.shape))))
    return np.asarray(jmesh.vmask * f)


# ---------------------------------------------------------------------------
# the split mesh (in this process: slicing needs no group)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("size", [2, 4])
def test_shard_sem_mesh_slices_the_global_mesh(size):
    gm = step_box()
    covered = torch.zeros(gm.nglob, dtype=torch.int64)
    for rank in range(size):
        part = Partition(rank=rank, size=size, device=torch.device("cpu"), backend="gloo")
        m = shard_sem_mesh(gm, part)
        e0, e1 = rank * gm.nel // size, (rank + 1) * gm.nel // size
        assert m.nel == e1 - e0 and m.part.global_mesh is gm and m.part.log is part.log
        for name, axis in _SEM_MESH_AXES.items():
            whole = getattr(gm, name)
            if whole is None:
                continue
            want = whole if axis is None else whole[..., e0:e1]
            assert torch.equal(getattr(m, name), want), name
        # the local gather sums exactly the copies inside the block
        f = torch.as_tensor(np.random.default_rng(rank).standard_normal(tuple(gm.bm1.shape)))
        inside = torch.zeros_like(f)
        inside[..., e0:e1] = f[..., e0:e1]
        m1 = dataclasses.replace(m, xch_n=0)
        assert absdiff(sem.dssum(m1, f[..., e0:e1]), sem.dssum(gm, inside)[..., e0:e1]) <= 1e-14
        covered[m.gidx.reshape(-1)[m.xch_src]] += 1
        assert int(m.xch_src.numel()) == len(set(m.xch_slot.tolist()))
    # every interface DOF is owned by >= 2 ranks, and only those
    gidx = gm.gidx.reshape(-1, gm.nel)
    ranks_of = [set() for _ in range(gm.nglob)]
    for e in range(gm.nel):
        for g in gidx[:, e].tolist():
            ranks_of[g].add(e // (gm.nel // size))
    want = torch.as_tensor([len(r) if len(r) > 1 else 0 for r in ranks_of])
    assert torch.equal(covered, want)


def _tensor_bytes(obj, skip=()) -> int:
    return sum(v.numel() * v.element_size() for f in dataclasses.fields(obj)
               if f.name not in skip and isinstance(v := getattr(obj, f.name), torch.Tensor))


@pytest.mark.parametrize("size", [2, 4])
def test_a_rank_holds_its_block(size):
    """What a rank's mesh and preconditioner hold for its device scales with
    its block: at most 1/size of one process's (plus 15 % for the exchange
    plans), plus the replicated coarse space. The global mesh, and the
    global-DOF arrays that no solve reads, stay on the host: the very
    tensors of the global mesh, never a device copy."""
    gm = box_mesh(**dict(W.STEP_BOX, nels=(16, 4), order=5), dtype=torch.float64, device="cpu")
    pc1 = build_e_preconditioner(gm)
    coarse = _tensor_bytes(pc1) - _tensor_bytes(pc1, skip=("ec_inv", "q1_b4"))
    one = _tensor_bytes(gm, skip=_HOST_FIELDS) + _tensor_bytes(pc1) - coarse
    for rank in range(size):
        part = Partition(rank=rank, size=size, device=torch.device("cpu"), backend="gloo")
        m = shard_sem_mesh(gm, part)
        held = _tensor_bytes(m, skip=_HOST_FIELDS) + _tensor_bytes(build_e_preconditioner(m))
        assert held <= 1.15 * one / size + coarse, (held, one, coarse)
        assert m.part.global_mesh is gm
        assert all(getattr(m, k) is getattr(gm, k) for k in _HOST_FIELDS)


def test_shard_sem_mesh_raises_as_the_reference():
    with pytest.raises(ValueError) as jerr:
        jsharding.shard_sem_mesh(jstep_box(), jsharding.make_device_mesh(3))
    with pytest.raises(ValueError) as err:
        shard_sem_mesh(step_box(), Partition(rank=0, size=3, device=torch.device("cpu"),
                                             backend="gloo"))
    assert str(err.value) == str(jerr.value)


# ---------------------------------------------------------------------------
# the nonlinear step, dssum and the all-reduces
# ---------------------------------------------------------------------------


def scalar_inputs() -> dict:
    """C0 fields of W.SCALAR_BOX that vanish where its masks do: the scalar
    case's start (u0, th0) and its linearized direction (du, dth)."""
    gm = box_mesh(**W.SCALAR_BOX, dtype=torch.float64, device="cpu")
    rng = np.random.default_rng(12)
    shape = tuple(gm.bm1.shape)
    field = lambda mask, n, scale: (scale * mask * sem.dsavg(gm, t(rng.standard_normal(
        (n,) + shape)))).numpy()
    return dict(u0=field(gm.vmask, 2, 0.1), th0=field(gm.tmask, 1, 0.1),
                du=field(gm.vmask, 2, 1.0), dth=field(gm.tmask, 1, 1.0))


@pytest.fixture(scope="module", params=[2, 4])
def step_run(request, tmp_path_factory):
    jmesh = jstep_box()
    rng = np.random.default_rng(11)
    f = rng.standard_normal((2,) + tuple(jmesh.bm1.shape))
    y = np.asarray(jmesh.x[1])
    u0 = np.asarray(jmesh.vmask) * np.stack([1 - y**2, 0.1 * np.sin(np.asarray(jmesh.x[0]))])
    work = str(tmp_path_factory.mktemp("step"))
    # at P = 2 the ranks also run the scalar case (nscal = 1)
    scalar = request.param == 2
    inputs = dict(f=f, u0=u0, **({"scalar_" + k: v for k, v in scalar_inputs().items()}
                                 if scalar else {}))
    started = W.run_ranks("step", request.param, work, dict(cfg=STEP_CFG, scalar=scalar),
                          inputs, wait=False)
    cfg = jns.FlowConfig(**STEP_CFG)
    ref = jns.advance(jmesh, cfg, jns.initial_state(jmesh, cfg, u=jnp.asarray(u0)), 3)
    return dict(out=W.finish(started), f=f, u0=u0, ref_u=np.asarray(ref.u),
                ref_p=np.asarray(ref.p), size=request.param, work=work)


def test_split_dssum_mass_dot_rand_match_one_process(step_run):
    gm, f = step_box(), t(step_run["f"])
    out = step_run["out"]
    assert absdiff(out["dssum"], sem.dssum(gm, f)) <= 1e-13
    assert abs(float(out["mass_dot"]) - float(sem.mass_dot(gm, f, f))) <= 1e-12
    # the same start vector as one process: drawn whole, then split
    assert absdiff(out["rand"], flow_vector_space(gm, 0).rand(7)["u"]) <= 1e-13
    # every rank's CFL step is the least over every rank's block (the
    # fastest node lies in one block)
    assert out["cfl_dt"].tolist() == [cfl_dt(gm, t(step_run["u0"]) + 0.3 * f)] * step_run["size"]


def test_split_advance_matches_reference(step_run):
    out = step_run["out"]
    assert np.allclose(out["u"], step_run["ref_u"], atol=1e-10)
    assert np.allclose(out["p"], step_run["ref_p"], atol=1e-8)


def test_split_state_checkpoint_and_field_file_are_whole(step_run):
    """`save_checkpoint` and `outpost` on the ranks write the one-process
    files (rank 0, the fields gathered); `load_checkpoint` splits them
    again, exactly."""
    out, work = step_run["out"], step_run["work"]
    assert out["reloaded"].max() == 0.0
    state = io.load_field_file(os.path.join(work, "state.npz"))
    assert np.array_equal(state["u"], out["u"]) and np.array_equal(state["p"], out["p"])
    field = io.load_field_file(os.path.join(work, "splrun0.f00001.npz"))
    assert np.array_equal(field["u"], out["u"])
    assert np.array_equal(field["__x__"], step_box().x.numpy())
    assert sorted(n for n in os.listdir(work) if n.startswith("spl")) == ["splrun0.f00001.npz"]


def test_split_step_collective_pattern(step_run):
    """No all-reduce of one step moves a quarter of a velocity field or more
    (the port's counterpart of tests/test_sharding.py:56-76), and the
    all-reduces per CG iteration are those the module docstring counts."""
    out, gm = step_run["out"], step_box()
    field = 2 * gm.bm1.numel()
    assert int(out["step_sizes"].max()) < field // 4, out["step_sizes"]
    assert out["per_iter"].tolist() == [4, 5]
    iv, ip = out["step_iters"].tolist()
    # beside the iterations, each solve's set-up: a few dots and dssums
    assert 4 * iv + 5 * ip < int(out["step_calls"]) <= 4 * iv + 5 * ip + 30
    for r in range(step_run["size"]):  # every rank made the same collectives
        assert int(out[f"rank{r}"]["log_calls"]) == int(out["rank0"]["log_calls"])


@pytest.mark.parametrize("step_run", [2], indirect=True)
def test_split_scalar_case_matches_one_process(step_run):
    """nscal = 1 split over 2 ranks (`W.scalar_case`: 5 `advance` steps
    with a theta-coupled force and source, then `propagate` and its
    adjoint with the coupling linearized) against the same in one
    process: rel 1e-10 (rounding through 1e-12 solves)."""
    gm = box_mesh(**W.SCALAR_BOX, dtype=torch.float64, device="cpu")
    one = W.scalar_case(gm, {k: t(v) for k, v in scalar_inputs().items()}, lambda f: f)
    out = step_run["out"]
    diffs = {k: rel(out["scalar_" + k], want) for k, want in one.items()}
    assert all(float(want.abs().max()) > 1e-3 for want in one.values())
    assert max(diffs.values()) <= 1e-10, diffs


# ---------------------------------------------------------------------------
# the linearized map and its adjoint
# ---------------------------------------------------------------------------


def write_channel_re2(path):
    """6 x 4 elements on [0, 6] x [0, 4]: 'v' inflow on the left, 'O' on the
    right, walls below and above, one 'C' arc on the outflow side."""
    nx, ny = 6, 4
    i, j = np.meshgrid(np.arange(nx), np.arange(ny))
    i, j = i.reshape(-1).astype(float), j.reshape(-1).astype(float)
    xc = np.stack([i, i + 1, i + 1, i], 1)
    yc = np.stack([j, j, j + 1, j + 1], 1)
    vel = []
    for e in range(nx * ny):
        ie, je = e % nx, e // nx
        vel += [(e, 3, (), "v" if ie == 0 else "E"), (e, 1, (), "O" if ie == nx - 1 else "E"),
                (e, 0, (), "W" if je == 0 else "E"), (e, 2, (), "W" if je == ny - 1 else "E")]
    write_re2(path, xc, yc, curves=[(2 * nx - 1, 1, (3.0,), "C")], bcs=[vel])


def propagate_case(tmp_path_factory, size, pc, mesh_kind):
    """Starts the ranks, runs the reference meanwhile, -> (ranks' output,
    reference's mu and adjoint, the one-process field size)."""
    work = str(tmp_path_factory.mktemp(f"prop_{mesh_kind}_{pc}_{size}"))
    if mesh_kind == "re2":
        path = os.path.join(work, "channel.re2")
        write_channel_re2(path)
        jmesh = jmesh_from_re2(path, order=4, partition=size, cache=False)
        args = dict(path=path, order=4)
        y = np.asarray(jmesh.x[1])
        base = np.stack([y * (4 - y) / 4, 0 * y])
        fc = dict(LIN_CFG)
    else:
        jmesh = jbox_mesh(**W.WALLED3, dtype=jnp.float64)
        args = dict(box="walled3")
        x, y, zz = (np.asarray(c) for c in jmesh.x)
        base = np.stack([np.sin(np.pi * x / 1.5) * y * (1 - y), 0 * y, 0 * y]) * \
            np.asarray(jmesh.vmask)
        fc = dict(LIN_CFG)
    rng = np.random.default_rng(3)
    u0, v0 = c0(jmesh, rng, jmesh.ndim), c0(jmesh, rng, jmesh.ndim)
    dt_over_g0 = fc["dt"] / (11 / 6)
    args.update(cfg=fc, cfg_adj=fc, dt_over_g0=dt_over_g0, pc=PRECONDS[pc], nsteps=3)
    started = W.run_ranks("propagate", size, work, args, dict(base=base, u0=u0, v0=v0),
                          wait=False, timeout=180)
    jcfg = jlin.LinConfig(flow=jns.FlowConfig(**fc))
    jpc = jbuild(jmesh, dt_over_g0, **PRECONDS[pc])
    th = jnp.zeros((0,) + tuple(jmesh.bm1.shape))
    mu, _ = jlin.propagate(jmesh, jcfg, jnp.asarray(base), th, jnp.asarray(u0), th, 3, pc_e=jpc)
    jadj = jlin.make_adjoint_propagator(jmesh, jcfg, jnp.asarray(base), th, 3, pc_e=jpc)
    av, _ = jadj(jnp.asarray(v0), th)
    return W.finish(started), np.asarray(mu), np.asarray(av)


@pytest.mark.parametrize("pc", sorted(PRECONDS))
@pytest.mark.parametrize("size", [2, 4])
def test_split_propagate_and_adjoint_on_re2(tmp_path_factory, size, pc):
    out, mu, av = propagate_case(tmp_path_factory, size, pc, "re2")
    assert np.abs(out["mu"] - mu).max() < 1e-7
    assert np.abs(out["adj"] - av).max() < 1e-7
    lhs, rhs = out["identity"]
    assert abs(lhs - rhs) <= 1e-6 * abs(lhs), (lhs, rhs)


def test_split_propagate_3d(tmp_path_factory):
    out, mu, av = propagate_case(tmp_path_factory, 2, "bj", "walled3")
    assert np.abs(out["mu"] - mu).max() < 1e-7
    assert np.abs(out["adj"] - av).max() < 1e-7


# ---------------------------------------------------------------------------
# the eigensolve, its checkpoint and the driver's files
# ---------------------------------------------------------------------------

CK_KDIM = 4


def eigs_inputs(jmesh):
    """The base flow, and the reference's start vector (`rand(seed=3)`)."""
    y = np.asarray(jmesh.x[1])
    base = np.stack([0.3 * (1 - y**2), 0 * y])
    return base, np.asarray(jflow_vector_space(jmesh, 0).rand(jax.random.PRNGKey(3))["u"])


def one_process_checkpoint(path, base, v0):
    """The port in one process: an unconverged eigs whose checkpoint stays."""
    gm = step_box()
    fc = FlowConfig(**EIGS_CFG)
    A = ExponentialPropagator(gm, LinConfig(flow=fc), t(base), tau=0.4, dt=fc.dt)
    space = flow_vector_space(gm, 0)
    eigs(A, space, nev=2, kdim=CK_KDIM, tol=1e-14, maxiter=1, v0=flow_vector(gm, 0, u=t(v0)),
         checkpoint=path)
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


@pytest.fixture(scope="module")
def eigs_run(tmp_path_factory):
    work = str(tmp_path_factory.mktemp("eigs"))
    jmesh = jstep_box()
    base, v0 = eigs_inputs(jmesh)
    ck_one = os.path.join(work, "one.npz")
    one = one_process_checkpoint(ck_one, base, v0)
    fp = f"eigs;kdim={CK_KDIM};nev=2;which=lm;seed=0;tag="
    args = dict(cfg=EIGS_CFG, tau=0.4, kdim=16, nev=2, tol=1e-7, maxiter=8,
                outdir=os.path.join(work, "out"), ck_kdim=CK_KDIM,
                ck_split=os.path.join(work, "split.npz"), ck_one=ck_one, ck_fp=fp)
    started = W.run_ranks("eigs", 2, work, args, dict(base=base, v0=v0), wait=False,
                          timeout=240)
    fc = jns.FlowConfig(**EIGS_CFG)
    A = JProp(jmesh, jlin.LinConfig(flow=fc), jnp.asarray(base), tau=0.4, dt=fc.dt)
    ref = jeigs(A, jflow_vector_space(jmesh, 0), nev=2, kdim=16, tol=1e-7, maxiter=8,
                v0=jflow_vector(jmesh, 0, u=jnp.asarray(v0)))
    return dict(out=W.finish(started), ref=ref, args=args, one=one, base=base, v0=v0)


def test_split_eigs_matches_reference(eigs_run):
    out, ref = eigs_run["out"], eigs_run["ref"]
    assert np.asarray(ref.residuals).max() < 1e-7 and out["residuals"].max() < 1e-7
    mu_ref = np.sort_complex(np.asarray(ref.eigvals[:2]))
    mu = np.sort_complex(out["eigvals"][:2])
    assert np.abs(mu - mu_ref).max() < 1e-6, (mu, mu_ref)


def test_split_driver_files_written_by_rank_0(eigs_run):
    outdir, out = eigs_run["args"]["outdir"], eigs_run["out"]
    assert not os.path.exists(os.path.join(outdir, "rank1"))
    files = sorted(os.listdir(os.path.join(outdir, "rank0")))
    assert files == ["dir_eigenspectrum.npy", "dirmode0.f00001.npz", "dirmode0.f00002.npz",
                     "timers.log"]
    with np.load(os.path.join(outdir, "rank0", "dirmode0.f00001.npz")) as z:
        mode = z["u_re"] + 1j * z["u_im"]
    assert mode.shape == out["mode_u"].shape == (2,) + tuple(step_box().bm1.shape)
    assert np.abs(mode - out["mode_u"]).max() == 0.0
    spec = np.load(os.path.join(outdir, "rank0", "dir_eigenspectrum.npy"))
    lam = np.log(out["eigvals"].astype(complex)) / 0.4
    assert np.abs(spec[0] + 1j * spec[1] - lam).max() <= 1e-14


def test_split_eigs_checkpoint_crosses_layouts(eigs_run):
    """Written by 2 ranks, the checkpoint is the one-process file (the
    basis gathered, rank 0 writing) and loads in one process; written by
    one process, it loads on 2 ranks."""
    out, one = eigs_run["out"], eigs_run["one"]
    with np.load(eigs_run["args"]["ck_split"]) as z:
        split = {k: z[k] for k in z.files}
    assert sorted(split) == sorted(one)
    assert split["leaf_1"].shape == one["leaf_1"].shape  # the u leaf, whole
    assert int(split["vk"]) == int(one["vk"]) == CK_KDIM + 1
    assert np.abs(split["leaf_1"] - one["leaf_1"]).max() < 1e-8
    assert np.abs(split["H"] - one["H"]).max() < 1e-8
    gm = step_box()
    v0 = flow_vector(gm, 0, u=t(eigs_run["v0"]))
    fp = eigs_run["args"]["ck_fp"]
    V, H, _ = _load_krylov_state(eigs_run["args"]["ck_split"], flow_vector_space(gm, 0), v0,
                                 CK_KDIM + 1, fingerprint=fp)
    assert V.k == CK_KDIM + 1 and np.array_equal(H, split["H"])
    # and the ranks' load of the one-process file, gathered back
    assert np.array_equal(out["loaded_u"], one["leaf_1"]) and int(out["loaded_k"]) == V.k
    assert np.array_equal(out["loaded_h"], one["H"])


# ---------------------------------------------------------------------------
# against the reference's own sharded run
# ---------------------------------------------------------------------------


@pytest.mark.slow
def test_split_port_matches_sharded_reference(tmp_path):
    """The port over 4 gloo ranks against the reference sharded over 4
    virtual devices: 3 nonlinear steps of tests/test_sharding.py's case."""
    jmesh = jstep_box()
    cfg = jns.FlowConfig(**STEP_CFG)
    y = np.asarray(jmesh.x[1])
    u0 = np.asarray(jmesh.vmask) * np.stack([1 - y**2, 0.1 * np.sin(np.asarray(jmesh.x[0]))])
    dmesh = jsharding.make_device_mesh(4)
    smesh = jsharding.shard_sem_mesh(jmesh, dmesh)
    sst = jsharding.shard_flow_state(jns.initial_state(smesh, cfg, u=jnp.asarray(u0)), dmesh)
    with dmesh:
        ref = jns.advance(smesh, cfg, sst, 3)
        jax.block_until_ready(ref)
    out = W.run_ranks("step", 4, str(tmp_path), dict(cfg=STEP_CFG),
                      dict(f=np.zeros((2,) + tuple(jmesh.bm1.shape)), u0=u0))
    assert np.allclose(out["u"], np.asarray(ref.u), atol=1e-10)
    assert np.allclose(out["p"], np.asarray(ref.p), atol=1e-8)
