"""Port parity: OTD mode evolution (apply_L, the basis orthonormalization,
otd_chunk and otd_analysis with its files).

Fixture: tests/test_otd.py's Poiseuille channel ((3, 4) elements, Re = 100,
dt = 0.06, vtol = ptol = 1e-11) at order 4, r = 2 modes, f64 on the CPU;
the initial modes are numpy-seeded and handed to both packages. Tolerances:
  * apply_l, trans False and True: 1e-12 absolute on O(1) input;
  * the Rayleigh quotient of the leading shear mode: 1e-10 of the analytic
    -nu (pi/2)^2 (tests/test_otd.py), and <L u, v>_B = <u, L* v>_B to 1e-11;
  * orthonormalize_states: 1e-12 absolute, and the basis B-orthonormal;
  * otd_chunk over 20 steps (the ramp, re-orthonormalized every 5 steps),
    frozen base, adjoint evolution and co-evolved base: the modes, Lr and
    the base within 1e-10 of the reference's;
  * otd_analysis (printstep 10, orthostep 5, iostep 20, iorststep 20, 40
    steps): Ls.dat and Lr.dat with the same rows (the time column equal,
    the spectra within 1e-9 relative), the mode files with the reference's
    names and headers and their data within 1e-6 (float32 files), and
    byte-identical files when both writers get the same modes; a run
    resumed from its checkpoint reproduces the uninterrupted Lr to 1e-12.
The convergence to the analytic shear modes over 2600 steps is `slow`.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neklab_tpu import otd as jotd
from neklab_tpu.mesh.box import box_mesh as jbox_mesh
from neklab_tpu.models import linearized as jlin
from neklab_tpu.models.navier_stokes import FlowConfig as JFlowConfig
from neklab_tpu.models.navier_stokes import initial_state as jinitial_state
from neklab_tpu.ops import sem as jsem
from neklab_tpu.utils.fldfile import read_fld as jread_fld
from neklab_tpu_torch import otd
from neklab_tpu_torch.mesh.box import box_mesh
from neklab_tpu_torch.models import linearized as lin
from neklab_tpu_torch.models.navier_stokes import FlowConfig, initial_state
from neklab_tpu_torch.ops import sem
from neklab_tpu_torch.utils.fldfile import read_fld, write_fld
from torch_port_helpers import CHANNEL_BC, absdiff, t

RE = 100.0
MESH = dict(nels=(3, 4), lims=((0, 2 * np.pi), (-1, 1)), bc=CHANNEL_BC, order=4)
FLOW = dict(viscosity=1 / RE, dt=0.06, vtol=1e-11, ptol=1e-11)


@pytest.fixture(scope="module")
def case():
    jmesh, mesh = jbox_mesh(**MESH), box_mesh(**MESH, device="cpu")
    jcfg = jlin.LinConfig(flow=JFlowConfig(**FLOW))
    cfg = lin.LinConfig(flow=FlowConfig(**FLOW))
    return jmesh, mesh, jcfg, cfg


def _modes(jmesh, seed, r=2):
    """r numpy-seeded admissible velocity fields [r, 2, ...]."""
    a = np.random.default_rng(seed).standard_normal((r, 2) + tuple(jmesh.bm1.shape))
    return np.stack([np.asarray(jmesh.vmask * jsem.dsavg(jmesh, jnp.asarray(ai)))
                     for ai in a])


def _perts(jmesh, jcfg, mesh, cfg, u, p=None):
    """The same batched PertState in both packages (before orthonormalization)."""
    jp = jax.vmap(lambda ui: jlin.pert_initial(jmesh, jcfg, ui))(jnp.asarray(u))
    tp = otd._stack([lin.pert_initial(mesh, cfg, t(ui)) for ui in u])
    if p is not None:
        jp = dataclasses.replace(jp, p=jnp.asarray(p))
        tp.p = t(p)
    return jp, tp


def _poiseuille(jmesh, mesh):
    jy, y = jmesh.x[1], mesh.x[1]
    return jnp.stack([1 - jy**2, 0 * jy]), torch.stack([1 - y**2, 0 * y])


@pytest.mark.parametrize("trans", [False, True], ids=["direct", "trans"])
def test_apply_l_matches_reference(case, trans):
    jmesh, mesh, jcfg, cfg = case
    jU, U = _poiseuille(jmesh, mesh)
    u = _modes(jmesh, 1, r=1)[0]
    p = np.random.default_rng(2).standard_normal(tuple(jmesh.bm2.shape))
    jst = dataclasses.replace(jlin.pert_initial(jmesh, jcfg, jnp.asarray(u)),
                                   p=jnp.asarray(p))
    st = lin.pert_initial(mesh, cfg, t(u))
    st.p = t(p)
    jth = jnp.zeros((0,) + jmesh.bm1.shape)
    th = torch.zeros((0,) + tuple(mesh.bm1.shape), dtype=torch.float64)
    ref = jotd.apply_l(jmesh, jcfg, jU, jth, jst, trans=trans)
    out = otd.apply_l(mesh, cfg, U, th, st, trans=trans)
    assert np.abs(np.asarray(ref)).max() > 1.0
    assert absdiff(out, ref) <= 1e-12


def test_apply_l_rayleigh_quotient_and_adjoint(case):
    _, mesh, _, cfg = case
    mesh5 = box_mesh(**{**MESH, "order": 5}, device="cpu")
    y = mesh5.x[1]
    U = torch.stack([1 - y**2, 0 * y])
    th = torch.zeros((0,) + tuple(mesh5.bm1.shape), dtype=torch.float64)
    umode = torch.stack([torch.cos(np.pi * y / 2), 0 * y])
    lu = otd.apply_l(mesh5, cfg, U, th, lin.pert_initial(mesh5, cfg, umode))
    rq = float(sem.mass_dot(mesh5, umode, lu) / sem.mass_dot(mesh5, umode, umode))
    assert abs(rq - (-(1 / RE) * (np.pi / 2) ** 2)) < 1e-10
    # the transposed operator is the exact B-adjoint (zero pressures)
    jmesh = jbox_mesh(**MESH)
    u, v = (t(m) for m in _modes(jmesh, 3))
    y = mesh.x[1]
    U = torch.stack([1 - y**2, 0 * y])
    th = torch.zeros((0,) + tuple(mesh.bm1.shape), dtype=torch.float64)
    lu = otd.apply_l(mesh, cfg, U, th, lin.pert_initial(mesh, cfg, u))
    ltv = otd.apply_l(mesh, cfg, U, th, lin.pert_initial(mesh, cfg, v), trans=True)
    a, b = float(sem.mass_dot(mesh, lu, v)), float(sem.mass_dot(mesh, u, ltv))
    assert abs(a - b) < 1e-11 * max(abs(a), 1.0), (a, b)


def test_orthonormalize_states_matches_reference(case):
    jmesh, mesh, jcfg, cfg = case
    u = _modes(jmesh, 4, r=3)
    p = np.random.default_rng(5).standard_normal((3,) + tuple(jmesh.bm2.shape))
    jp, tp = _perts(jmesh, jcfg, mesh, cfg, u, p)
    ref = jotd.orthonormalize_states(jmesh, jp)
    out = otd.orthonormalize_states(mesh, tp)
    for name in ("u", "p", "ulag"):
        assert absdiff(getattr(out, name), getattr(ref, name)) <= 1e-12, name
    g = otd._mass_dots(mesh, out.u, out.u)
    assert absdiff(g, np.eye(3)) <= 1e-12


@pytest.mark.parametrize("variant", ["frozen", "trans", "baseflow"])
def test_otd_chunk_matches_reference(case, variant):
    """The frozen base, the adjoint evolution, and a co-evolved base (its
    nonlinear step warm-starts its velocity solves, as the port's `step`
    does: the same map to the solver tolerance)."""
    jmesh, mesh, jcfg, cfg = case
    jU, U = _poiseuille(jmesh, mesh)
    jbase = jinitial_state(jmesh, jcfg.flow, u=jU)
    base = initial_state(mesh, cfg.flow, u=U)
    jp, tp = _perts(jmesh, jcfg, mesh, cfg, _modes(jmesh, 6))
    jp, tp = jotd.orthonormalize_states(jmesh, jp), otd.orthonormalize_states(mesh, tp)
    kw = dict(r=2, trans=variant == "trans", solve_baseflow=variant == "baseflow")
    jb, jperts, jlr = jotd.otd_chunk(jmesh, jcfg, jotd.OtdOpts(**kw), jbase, jp, 20, ramp=True,
                                     ortho_every=5)
    stats = {}
    b, perts, lr = otd.otd_chunk(mesh, cfg, otd.OtdOpts(**kw), base, tp, 20, ramp=True,
                                 ortho_every=5, stats=stats)
    assert absdiff(perts.u, jperts.u) <= 1e-10
    assert absdiff(perts.p, jperts.p) <= 1e-10
    assert absdiff(lr, jlr) <= 1e-10
    assert absdiff(b.u, jb.u) <= 1e-10
    # the modes loop through the solvers: r velocity solves per step (and
    # one more for a co-evolved base)
    assert len(stats["helmholtz"]) == (3 if variant == "baseflow" else 2) * 20


def test_load_otd_ics(case, tmp_path):
    """OTDIC-style file initial conditions (.fld and .npz) fill the first
    modes, the rest are random, and the basis comes back orthonormal."""
    _, mesh, _, cfg = case
    y = mesh.x[1]
    u1 = mesh.vmask * torch.stack([torch.sin(mesh.x[0]) * (1 - y**2), 0 * y])
    f1 = str(tmp_path / "OTDIC_01.f00001")
    write_fld(f1, mesh=mesh, u=u1, wdsize=8)
    f2 = str(tmp_path / "OTDIC_02.npz")
    u2 = mesh.vmask * torch.stack([0 * y, torch.cos(mesh.x[0]) * (1 - y**2)])
    np.savez(f2, u=u2.numpy())
    perts = otd.load_otd_ics(mesh, cfg, [f1, f2], r=3)
    assert absdiff(otd._mass_dots(mesh, perts.u, perts.u), np.eye(3)) <= 1e-10
    v, w = perts.u[0].flatten(), u1.flatten()
    assert float(abs(v @ w) / (v.norm() * w.norm())) > 0.99
    with pytest.raises(ValueError, match="more IC files"):
        otd.load_otd_ics(mesh, cfg, [f1, f2], r=1)


def _rows(path):
    with open(path) as f:
        return [[float(v) for v in line.split()] for line in f]


def test_otd_analysis_files_match_reference(case, tmp_path):
    jmesh, mesh, jcfg, cfg = case
    jU, U = _poiseuille(jmesh, mesh)
    jp, tp = _perts(jmesh, jcfg, mesh, cfg, _modes(jmesh, 11))
    jp, tp = jotd.orthonormalize_states(jmesh, jp), otd.orthonormalize_states(mesh, tp)
    kw = dict(r=2, printstep=10, orthostep=5, iostep=20, iorststep=20, solve_baseflow=False)
    out_j, out_t = str(tmp_path / "ref"), str(tmp_path / "port")
    jres = jotd.otd_analysis(jmesh, jcfg, jotd.OtdOpts(**kw), jinitial_state(jmesh, jcfg.flow,
                             u=jU), nsteps=40, init_perts=jp, outdir=out_j)
    res = otd.otd_analysis(mesh, cfg, otd.OtdOpts(**kw), initial_state(mesh, cfg.flow, u=U),
                           nsteps=40, init_perts=tp, outdir=out_t)
    assert sorted(os.listdir(out_t)) == sorted(os.listdir(out_j)) == [
        "Lr.dat", "Ls.dat", "m01otd0.f00001", "m01otd0.f00002", "m02otd0.f00001",
        "m02otd0.f00002", "rstotd0.f00001.npz", "rstotd0.f00002.npz"]
    for name in ("Ls.dat", "Lr.dat"):
        a, b = (np.array(_rows(os.path.join(out, name))) for out in (out_t, out_j))
        assert a.shape == b.shape == (4, 5 if name == "Lr.dat" else 3)
        assert np.array_equal(a[:, -1], b[:, -1])
        assert np.abs(a[:, :-1] - b[:, :-1]).max() <= 1e-9 * np.abs(b[:, :-1]).max()
    for name in ("m01otd0.f00002", "m02otd0.f00002"):
        pa, pb = os.path.join(out_t, name), os.path.join(out_j, name)
        with open(pa, "rb") as fa, open(pb, "rb") as fb:
            assert fa.read(136) == fb.read(136)  # header and endian tag
        fa, fb = read_fld(pa), jread_fld(pb)
        for key in ("x", "u", "p"):
            assert np.abs(getattr(fa, key) - getattr(fb, key)).max() <= 1e-6, (name, key)
    np.testing.assert_allclose(res.eigvals_lr, jres.eigvals_lr, rtol=1e-9)
    assert [h[0] for h in res.lr_history] == [h[0] for h in jres.lr_history]

    # the port's writer on the reference's final modes: the same bytes
    same_t = otd.outpost_otd_modes(mesh, otd.PertState(**{
        f: t(getattr(jres.perts, f)) for f in otd.PertState.__dataclass_fields__}),
        jres.lr_history[-1][1], str(tmp_path / "same_t"), counter=3, time=2.4)
    same_j = jotd.outpost_otd_modes(jmesh, jres.perts, jres.lr_history[-1][1],
                                    str(tmp_path / "same_j"), counter=3, time=2.4)
    for a, b in zip(same_t, same_j):
        with open(a, "rb") as fa, open(b, "rb") as fb:
            assert fa.read() == fb.read(), a

    # a run stopped at step 20 and resumed from its checkpoint
    out_r = str(tmp_path / "resumed")
    otd.otd_analysis(mesh, cfg, otd.OtdOpts(**kw), initial_state(mesh, cfg.flow, u=U),
                     nsteps=20, init_perts=tp, outdir=out_r)
    resumed = otd.otd_analysis(mesh, cfg, otd.OtdOpts(**kw), initial_state(mesh, cfg.flow, u=U),
                               nsteps=20, init_perts=tp, outdir=out_r,
                               restart=os.path.join(out_r, "rstotd0.f00001.npz"))
    assert absdiff(resumed.lr_history[-1][1], res.lr_history[-1][1]) <= 1e-12
    assert "rstotd0.f00002.npz" in os.listdir(out_r)


@pytest.mark.slow
def test_otd_converges_to_leading_modes(case):
    """For a steady base the OTD subspace converges to the leading
    eigenvectors and eig(Lr) to the analytic shear modes -nu (m pi/2)^2
    (tests/test_otd.py::test_otd_converges_to_leading_modes)."""
    _, mesh, _, cfg = case
    y = mesh.x[1]
    base = initial_state(mesh, cfg.flow, u=torch.stack([1 - y**2, 0 * y]))
    res = otd.otd_analysis(mesh, cfg, otd.OtdOpts(r=2, printstep=100), base, nsteps=2600)
    lam = np.sort(res.eigvals_lr.real)[::-1]
    exact = np.array([-(1 / RE) * (np.pi / 2) ** 2, -(1 / RE) * np.pi**2])
    assert abs(lam[0] - exact[0]) < 5e-4, (lam, exact)
    assert abs(lam[1] - exact[1]) < 5e-3, (lam, exact)
    assert len(res.lr_history) == 26


def test_chip_smoke_reference_normal_is_jax_normal():
    """chip_smoke.py starts the recorded Re=500 OTD run from the reference's
    initial modes, drawn in numpy: the threefry bits are JAX's exactly, the
    normal transform differs only through scipy's erfinv (7.4e-6 at most,
    in the tails)."""
    import importlib.util

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  os.path.join(root, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    shape = (2, 2, 7, 7, 24)
    ref = np.asarray(jax.random.normal(jax.random.PRNGKey(7), shape, jnp.float32))
    out = cs.reference_normal(7, shape)
    assert out.dtype == np.float32 and out.shape == shape
    assert np.abs(out - ref).max() <= 1e-5
    assert np.mean(out == ref) > 0.3
