"""Port parity: the drivers' outputs and the utilities.

Each file format is written by one package and read by the other, both
ways: field files (`outpost`/`load_field_file`), state checkpoints,
spectra, and the Arnoldi (`eigs`) and Lanczos (`svds`) checkpoints. An
interrupted eigensolve or SVD resumed from its checkpoint gives the
eigenvalues or singular values of an uninterrupted one, to 1e-12 relative
(the same arithmetic from the same saved state), and a checkpoint of
another problem is refused. `.par` files written to tmp_path are parsed by
both packages field by field. `euclidean_space`, `pcg` (1e-10 relative,
the same CG), `ExponentialPropagator(precondition=False).matvec` (1e-9
absolute on a B-normalized input, inner solves at 1e-12) and the drivers'
files (spectrum to 1e-8, mode files' names and keys, timers.log) against
the reference's; the timers' report, and the package facade against
`neklab_tpu/__init__.py`.
"""

import ast
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import neklab_tpu_torch
from neklab_tpu import analysis as janalysis
from neklab_tpu.krylov import FunctionOperator as JFunctionOperator
from neklab_tpu.krylov import eigs as jeigs
from neklab_tpu.krylov import euclidean_space as jeuclidean_space
from neklab_tpu.krylov import svds as jsvds
from neklab_tpu.linops.exponential_propagator import ExponentialPropagator as JProp
from neklab_tpu.mesh.box import box_mesh as jbox_mesh
from neklab_tpu.models import linearized as jlin
from neklab_tpu.models import navier_stokes as jns
from neklab_tpu.models.solvers import pcg as jpcg
from neklab_tpu.ops import sem as jsem
from neklab_tpu.utils import io as jio
from neklab_tpu.utils import parfile as jparfile
from neklab_tpu.utils.timers import Timers as JTimers
from neklab_tpu_torch import analysis
from neklab_tpu_torch.krylov import FunctionOperator, euclidean_space, svds
from neklab_tpu_torch.krylov.eigs import eigs
from neklab_tpu_torch.linops.exponential_propagator import ExponentialPropagator
from neklab_tpu_torch.mesh.box import box_mesh
from neklab_tpu_torch.models import linearized as lin
from neklab_tpu_torch.models import navier_stokes as ns
from neklab_tpu_torch.models.solvers import pcg
from neklab_tpu_torch.utils import io, parfile
from neklab_tpu_torch.utils.timers import Timers
from torch_port_helpers import CHANNEL_BC, absdiff, rel, t, to_np

BOX = dict(nels=(2, 2), lims=((0, 1), (0, 1)), bc={"x-": "P", "x+": "P"}, order=3)


# ---------------------------------------------------------------------------
# field files, checkpoints, spectra
# ---------------------------------------------------------------------------


def _states():
    jmesh, mesh = jbox_mesh(**BOX), box_mesh(**BOX, device="cpu")
    jcfg, cfg = jns.FlowConfig(viscosity=0.1, dt=0.01), ns.FlowConfig(viscosity=0.1, dt=0.01)
    rng = np.random.default_rng(0)
    u = rng.standard_normal((2,) + tuple(jmesh.bm1.shape))
    p = rng.standard_normal(tuple(jmesh.bm2.shape))
    jst = jns.initial_state(jmesh, jcfg, u=jnp.asarray(u), p=jnp.asarray(p))
    st = ns.initial_state(mesh, cfg, u=t(u), p=t(p))
    return jmesh, mesh, jst, st


def test_field_files_cross_read(tmp_path):
    jmesh, mesh, jst, st = _states()
    path = io.outpost(str(tmp_path), {"u": st.u, "p": st.p, "skip": None}, mesh=mesh,
                      prefix="dir", case="mode", time=1.5)
    assert os.path.basename(path) == "dirmode0.f00001.npz"
    data = jio.load_field_file(path)
    assert sorted(data) == ["__time__", "__x__", "p", "u"] and data["__time__"] == 1.5
    assert np.array_equal(data["u"], to_np(st.u)) and np.array_equal(data["__x__"], to_np(mesh.x))
    # the next free number, then the reference's file read by the port
    jpath = jio.outpost(str(tmp_path), {"u": jst.u}, mesh=jmesh, prefix="dir", case="mode")
    assert os.path.basename(jpath) == "dirmode0.f00002.npz"
    assert os.path.basename(io.outpost(str(tmp_path), {"u": st.u}, prefix="dir",
                                       case="mode")) == "dirmode0.f00003.npz"
    data = io.load_field_file(jpath)
    assert np.array_equal(data["u"], np.asarray(jst.u)) and data["__time__"] == 0.0


def test_state_checkpoints_cross_read(tmp_path):
    jmesh, mesh, jst, st = _states()
    path = io.save_checkpoint(str(tmp_path / "port" / "ck.npz"), st, extra={"note": 2.0})
    back = jio.load_checkpoint(path, jst)
    for name in ("u", "p", "theta", "ulag", "plag"):
        assert np.array_equal(np.asarray(getattr(back, name)), to_np(getattr(st, name))), name
    with np.load(path) as z:
        assert float(z["x_note"]) == 2.0
    jpath = jio.save_checkpoint(str(tmp_path / "ref.npz"), jst)
    zero = ns.initial_state(mesh, ns.FlowConfig(viscosity=0.1, dt=0.01))
    loaded = io.load_checkpoint(jpath, zero)
    assert type(loaded) is ns.FlowState and loaded.time == 0.0
    for name in ("u", "p", "theta", "nlag"):
        got = getattr(loaded, name)
        assert got.dtype == torch.float64 and got.device.type == "cpu"
        assert np.array_equal(to_np(got), np.asarray(getattr(jst, name))), name
    with pytest.raises(ValueError):
        io.load_checkpoint(jpath, ns.initial_state(
            box_mesh((3, 2), ((0, 1), (0, 1)), {"x-": "P", "x+": "P"}, order=3, device="cpu"),
            ns.FlowConfig(viscosity=0.1, dt=0.01)))


def test_spectra_cross_read(tmp_path):
    ev = np.array([1 + 2j, 3 - 4j, -0.5])
    io.save_spectrum(str(tmp_path / "port.npy"), ev)
    jio.save_spectrum(str(tmp_path / "ref.npy"), ev)
    assert np.array_equal(jio.load_spectrum(str(tmp_path / "port.npy")), ev)
    assert np.array_equal(io.load_spectrum(str(tmp_path / "ref.npy")), ev)


# ---------------------------------------------------------------------------
# timers, .par files
# ---------------------------------------------------------------------------


def test_timers_report_matches_reference_layout():
    def drive(timers):
        for _ in range(2):
            with timers("outer"):
                with timers("inner"):
                    pass
        with timers("other"):
            pass
        return [re.sub(r"[0-9.]+s", "Ts", line) for line in timers.report().splitlines()]

    port, ref = Timers(), JTimers()
    assert drive(port) == drive(ref)
    assert port.counts == {"outer": 2, "outer/inner": 2, "other": 1}
    assert all(v >= 0 for v in port.totals.values())
    port.reset()
    assert not port.totals and not port.counts


PAR = """\
# a test case
[GENERAL]
stopAt = numSteps
numSteps = 250
dt = 2.5e-3
timeStepper = bdf2
targetCFL = 0.4
writeInterval = 50
startFrom = BF_case0.f00001
userParam03 = 7.5
userParam11 = -2

[PROBLEMTYPE]
equation = incompNS
numberOfPerturbations = 2

[PRESSURE]
residualTol = 1e-7

[VELOCITY]
viscosity = -180   # a Reynolds number
density = 1.0
residualTol = 1e-9

[TEMPERATURE]
conductivity = -125.0
residualTol = 1e-10
"""


@pytest.mark.parametrize("stop", ["numSteps", "endTime"])
def test_load_par_matches_reference(tmp_path, stop):
    text = PAR.replace("stopAt = numSteps", f"stopAt = {stop}")
    if stop == "endTime":
        text = text.replace("numSteps = 250", "endTime = 12.5")
    path = tmp_path / "case.par"
    path.write_text(text)
    got, want = parfile.load_par(str(path)), jparfile.load_par(str(path))
    for name in ("nsteps", "end_time", "start_from", "user_params", "n_perturbations",
                 "equation", "target_cfl", "write_interval"):
        assert getattr(got, name) == getattr(want, name), name
    for name in ("viscosity", "dt", "torder", "nscal", "conductivity", "rho", "vtol", "ptol",
                 "ttol", "vmaxit", "pmaxit", "pextrap"):
        assert getattr(got.config, name) == getattr(want.config, name), name
    assert got.config.viscosity == pytest.approx(1 / 180) and got.config.torder == 2
    assert got.config.conductivity == pytest.approx((1 / 125,)) and got.user_params[3] == 7.5
    assert (got.nsteps, got.end_time) == ((250, None) if stop == "numSteps" else (None, 12.5))
    assert parfile.parse_par(str(path)) == jparfile.parse_par(str(path))


# ---------------------------------------------------------------------------
# euclidean_space, pcg, ExponentialPropagator(precondition=False)
# ---------------------------------------------------------------------------


def test_euclidean_space():
    rng = np.random.default_rng(1)
    x = {"a": t(rng.standard_normal((3, 4))), "b": t(rng.standard_normal(5)),
         "c": torch.tensor(2.0, dtype=torch.float64)}
    y = {k: v + 1.0 for k, v in x.items()}
    space = euclidean_space(rand_template=x)
    jx = {k: jnp.asarray(to_np(v)) for k, v in x.items()}
    jy = {k: jnp.asarray(to_np(v)) for k, v in y.items()}
    assert space.dot(x, y) == pytest.approx(float(jeuclidean_space().dot_fn(jx, jy)), rel=1e-14)
    # a stacked basis [k, ...] against one vector: its k Gram entries
    stack = {k: torch.stack([v, 2 * v, -v]) for k, v in x.items()}
    want = space.dot(x, y) * np.array([1.0, 2.0, -1.0])
    assert np.allclose(to_np(space.dot_fn(stack, y)), want, rtol=1e-14)
    r1, r2 = space.rand(3), space.rand(3)
    assert all(torch.equal(r1[k], r2[k]) and r1[k].shape == x[k].shape for k in x)
    assert not torch.equal(r1["a"], space.rand(4)["a"])
    with pytest.raises(ValueError):
        euclidean_space().rand(0)


def test_pcg_matches_reference():
    n = 60
    rng = np.random.default_rng(2)
    q = rng.standard_normal((n, n))
    a = q @ q.T + n * np.eye(n)
    b = rng.standard_normal(n)
    x0 = rng.standard_normal(n)
    d = np.diag(a).copy()
    want = jpcg(lambda v: jnp.asarray(a) @ v, jnp.asarray(b), precond=lambda r: r / jnp.asarray(d),
                x0=jnp.asarray(x0), tol=1e-11, maxiter=200)
    got = pcg(lambda v: t(a) @ v, t(b), precond=lambda r: r / t(d), x0=t(x0), tol=1e-11,
              maxiter=200)
    assert rel(got, want) <= 1e-10
    assert np.linalg.norm(a @ to_np(got) - b) <= 1e-10


def test_propagator_without_preconditioner_matches_reference():
    """precondition=False: the pressure CG is unpreconditioned (the
    matrix-free E), in both packages."""
    kw = dict(nels=(3, 2), lims=((0, 2 * np.pi), (-1, 1)), bc=CHANNEL_BC, order=5)
    jmesh, mesh = jbox_mesh(**kw), box_mesh(**kw, device="cpu")
    fc = dict(viscosity=1 / 500, dt=1e-2, vtol=1e-12, ptol=1e-12)
    y = np.asarray(jmesh.x[1])
    base = np.stack([1 - y**2, 0 * y])
    jprop = JProp(jmesh, jlin.LinConfig(flow=jns.FlowConfig(**fc)), jnp.asarray(base), tau=0.2,
                  dt=0.02, precondition=False)
    prop = ExponentialPropagator(mesh, lin.LinConfig(flow=ns.FlowConfig(**fc)), t(base),
                                 tau=0.2, dt=0.02, precondition=False)
    assert prop.pc_e is None and jprop.pc_e is None
    rng = np.random.default_rng(3)
    u = np.asarray(jmesh.vmask * jsem.dsavg(jmesh, jnp.asarray(rng.standard_normal(base.shape))))
    u = u / np.sqrt(float(jsem.mass_dot(jmesh, u, u)))
    th = np.zeros((0,) + y.shape)
    want = jprop.matvec({"u": jnp.asarray(u), "theta": jnp.asarray(th)})
    stats = {}
    got = prop.matvec({"u": t(u), "theta": t(th)}, stats=stats)
    assert absdiff(got["u"], want["u"]) <= 1e-9
    preconditioned = ExponentialPropagator(mesh, prop.cfg, t(base), tau=0.2, dt=0.02)
    pstats = {}
    preconditioned.matvec({"u": t(u), "theta": t(th)}, stats=pstats)
    assert sum(stats["pressure"]) > sum(pstats["pressure"])


# ---------------------------------------------------------------------------
# the eigs and svds checkpoints
# ---------------------------------------------------------------------------


class Interrupted(Exception):
    pass


def _dense(n, seed):
    """A nonsymmetric matrix with a spread spectrum."""
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n, n)) / np.sqrt(n) + np.diag(np.linspace(0.0, 2.0, n))


def _port_op(a, fail_after=None):
    at_ = t(a)
    calls = {"n": 0}

    def count(v):
        calls["n"] += 1
        if fail_after is not None and calls["n"] > fail_after:
            raise Interrupted
        return v

    return FunctionOperator(matvec=lambda x: {"x": at_ @ count(x["x"])},
                            rmatvec=lambda x: {"x": at_.T @ count(x["x"])})


def _ref_op(a, fail_after=None):
    aj = jnp.asarray(a)
    calls = {"n": 0}

    def count(v):
        calls["n"] += 1
        if fail_after is not None and calls["n"] > fail_after:
            raise Interrupted
        return v

    return JFunctionOperator(matvec=lambda x: {"x": aj @ count(x["x"])},
                             rmatvec=lambda x: {"x": aj.T @ count(x["x"])})


EIGS = dict(nev=3, kdim=20, tol=1e-10, maxiter=30, checkpoint_every=3)


def test_eigs_checkpoint_resume(tmp_path):
    a = _dense(70, 4)
    space = euclidean_space(rand_template={"x": torch.zeros(70, dtype=torch.float64)})
    whole = eigs(_port_op(a), space, **EIGS)
    assert whole.converged.all() and whole.n_matvec > 25
    ck = str(tmp_path / "arnoldi.npz")
    with pytest.raises(Interrupted):  # killed inside the second cycle
        eigs(_port_op(a, fail_after=25), space, checkpoint=ck, **EIGS)
    with np.load(ck) as z:
        assert sorted(z.files) == ["H", "fingerprint", "leaf_0", "n_mv", "vk"]
        assert 0 < int(z["n_mv"]) <= 25
    resumed = eigs(_port_op(a), space, checkpoint=ck, **EIGS)
    assert resumed.n_matvec == whole.n_matvec
    assert np.abs(resumed.eigvals - whole.eigvals).max() <= 1e-12 * np.abs(whole.eigvals).max()
    assert not os.path.exists(ck)  # deleted on success
    # a checkpoint of another problem is refused
    with pytest.raises(Interrupted):
        eigs(_port_op(a, fail_after=10), space, checkpoint=ck, **EIGS)
    with pytest.raises(ValueError, match="fingerprint"):
        eigs(_port_op(a), space, checkpoint=ck, tag="other", **EIGS)


def test_eigs_resumes_the_reference_checkpoint(tmp_path):
    """A factorization saved by the reference, resumed by the port: the
    eigenvalues of the reference's uninterrupted solve."""
    a = _dense(70, 5)
    jspace = jeuclidean_space(rand_template={"x": jnp.zeros(70)})
    space = euclidean_space(rand_template={"x": torch.zeros(70, dtype=torch.float64)})
    want = jeigs(_ref_op(a), jspace, **EIGS)
    ck = str(tmp_path / "arnoldi.npz")
    with pytest.raises(Interrupted):
        jeigs(_ref_op(a, fail_after=25), jspace, checkpoint=ck, **EIGS)
    got = eigs(_port_op(a), space, checkpoint=ck, **EIGS)
    assert got.n_matvec == want.n_matvec
    assert np.abs(got.eigvals - want.eigvals).max() <= 1e-10 * np.abs(want.eigvals).max()


SVDS = dict(nsv=3, kdim=40, tol=1e-7, checkpoint_every=4)


def test_svds_checkpoint_resume_both_ways(tmp_path):
    a = _dense(60, 6)
    space = euclidean_space(rand_template={"x": torch.zeros(60, dtype=torch.float64)})
    jspace = jeuclidean_space(rand_template={"x": jnp.zeros(60)})
    whole = svds(_port_op(a), space, **SVDS)
    assert 20 < whole.n_matvec < 2 * SVDS["kdim"]  # converged
    ck = str(tmp_path / "lanczos.npz")
    with pytest.raises(Interrupted):  # killed after 9 of its iterations
        svds(_port_op(a, fail_after=19), space, checkpoint=ck, **SVDS)
    with np.load(ck) as z:
        assert int(z["j"]) == 8 and {"u_0", "v_0", "alphas", "betas", "uk", "vk"} <= set(z.files)
    resumed = svds(_port_op(a), space, checkpoint=ck, **SVDS)
    assert resumed.n_matvec == whole.n_matvec and not os.path.exists(ck)
    assert np.abs(resumed.s - whole.s).max() <= 1e-12 * whole.s[0]
    # the reference's checkpoint, resumed by the port
    want = jsvds(_ref_op(a), jspace, **SVDS)
    with pytest.raises(Interrupted):
        jsvds(_ref_op(a, fail_after=19), jspace, checkpoint=ck, **SVDS)
    got = svds(_port_op(a), space, checkpoint=ck, **SVDS)
    assert np.abs(got.s - want.s).max() <= 1e-10 * want.s[0]
    with pytest.raises(Interrupted):
        svds(_port_op(a, fail_after=9), space, checkpoint=ck, **SVDS)
    with pytest.raises(ValueError, match="fingerprint"):
        svds(_port_op(a), space, checkpoint=ck, seed=7, **SVDS)


# ---------------------------------------------------------------------------
# the drivers' files, the facade
# ---------------------------------------------------------------------------


class _Dense(FunctionOperator):
    tau = 0.5


class _JDense(JFunctionOperator):
    tau = 0.5


def test_stability_driver_files_match_reference(tmp_path):
    """Both drivers on one dense operator with a complex leading pair: the
    same files, the spectrum to 1e-8, the modes split into _re/_im; the
    port also writes the timers of its matvecs."""
    a = _dense(50, 7)
    at_, aj = t(a), jnp.asarray(a)
    op = _Dense(matvec=lambda x: {"x": at_ @ x["x"]})
    jop = _JDense(matvec=lambda x: {"x": aj @ x["x"]})
    space = euclidean_space(rand_template={"x": torch.zeros(50, dtype=torch.float64)})
    jspace = jeuclidean_space(rand_template={"x": jnp.zeros(50)})
    kw = dict(kdim=30, nev=4, tol=1e-10, maxiter=20)
    res = analysis.linear_stability_analysis_fixed_point(op, space, outdir=str(tmp_path / "p"),
                                                         **kw)
    jres = janalysis.linear_stability_analysis_fixed_point(jop, jspace,
                                                           outdir=str(tmp_path / "r"), **kw)
    assert np.abs(res.eigvals - jres.eigvals).max() <= 1e-8
    assert sorted(os.listdir(tmp_path / "p")) == sorted(os.listdir(tmp_path / "r"))
    assert "dirmode0.f00004.npz" in os.listdir(tmp_path / "p")
    got = np.load(tmp_path / "p" / "dir_eigenspectrum.npy")
    want = np.load(tmp_path / "r" / "dir_eigenspectrum.npy")
    assert np.abs(got - want).max() <= 1e-8
    for i in range(1, 5):
        name = f"dirmode0.f{i:05d}.npz"
        p, r = io.load_field_file(tmp_path / "p" / name), jio.load_field_file(tmp_path / "r" / name)
        assert sorted(p) == sorted(r)
        v = p["x_re"] + 1j * p["x_im"] if "x_re" in p else p["x"]
        assert np.linalg.norm(a @ v - np.exp(res.eigvals[i - 1] * 0.5) * v) <= 1e-8 * \
            np.linalg.norm(v)
    log = (tmp_path / "p" / "timers.log").read_text()
    assert "dir_stability" in log and re.search(r"matvec .* x\d+", log)


def test_facade_exports_the_reference_names():
    import neklab_tpu

    with open(neklab_tpu.__file__) as f:
        tree = ast.parse(f.read())
    names = {a.asname or a.name for node in ast.walk(tree) if isinstance(node, ast.ImportFrom)
             for a in node.names}
    assert len(names) > 60
    missing = sorted(n for n in names if not hasattr(neklab_tpu_torch, n))
    assert missing == [], missing
    for name in ("set_precision", "KRON3D"):  # left out, as the docstring says
        assert not hasattr(neklab_tpu_torch, name)
