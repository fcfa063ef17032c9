"""Port parity: periodic orbits and OTD split over 2 and 4 gloo ranks on the
CPU.

The port split over P processes (`tests/torch_shard_workers.py`, job
`orbits`; one set of ranks per P runs every case) against the JAX package
in one process on the same numpy-seeded inputs, f64. Cases and
tolerances:

  * tests/test_torch_upo.py's forced channel (body force 2 nu), widened to
    4 x 2 elements at order 4 so that it splits over 2 and 4 ranks, at T =
    0.2 over 5 steps, solves at 1e-12: the bordered Jacobian's matvec with
    dT != 0 (dPhi/dT by forward mode through the split `advance`, its
    pressure mean and range projections included) and its rmatvec, dPhi/dT
    itself, and the monodromy's matvec and rmatvec: 1e-9 absolute against
    the reference's (`jax.jvp`, `jax.vjp`), the T entries (the phase
    condition, a mass dot over every rank's block) 1e-9 relative;
  * `otd_analysis` on tests/test_otd.py's channel (3 x 4 elements at order
    4, Re 100, dt 0.06, solves at 1e-11; r = 2, 6 steps, printstep and
    orthostep 3, iostep and iorststep 6) from two OTDIC .npz files: the Lr
    history within 1e-9 relative of the reference's from the same files;
    Ls.dat, Lr.dat, the mode files and the restart written once, by rank 0,
    with the reference's names, the spectra within 1e-9 relative and the
    modes within 1e-6 (float32 files); the restart split again on every
    rank exactly;
  * `otd_analysis` from `_random_modes` (seed 7): the start drawn whole on
    the host and split (equal to one process's bit for bit), the Lr
    history within 1e-10 of the port's one-process run.

The JAX side runs while the ranks do; each rank set is killed at its time
limit.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_shard_workers as W
from neklab_tpu import otd as jotd
from neklab_tpu.mesh.box import box_mesh as jbox_mesh
from neklab_tpu.models.linearized import LinConfig as JLinConfig
from neklab_tpu.models.navier_stokes import FlowConfig as JFlowConfig
from neklab_tpu.models.navier_stokes import initial_state as jinitial_state
from neklab_tpu.ops import sem as jsem
from neklab_tpu.systems.periodic_orbit import MonodromyOperator as JMonodromy
from neklab_tpu.systems.periodic_orbit import PeriodicOrbitSystem as JUPO
from neklab_tpu.utils.fldfile import read_fld as jread_fld
from neklab_tpu_torch import otd
from neklab_tpu_torch.mesh.box import box_mesh
from neklab_tpu_torch.models.linearized import LinConfig
from neklab_tpu_torch.models.navier_stokes import FlowConfig, initial_state
from neklab_tpu_torch.utils.fldfile import read_fld

FORCED_CFG = dict(viscosity=W.FORCED_NU, dt=0.025, vtol=1e-12, ptol=1e-12)
T0, UPO_NSTEPS = 0.2, 5
OTD_CFG = dict(viscosity=1 / 100, dt=0.06, vtol=1e-11, ptol=1e-11)
OTD_OPTS = dict(r=2, printstep=3, orthostep=3, iostep=6, iorststep=6, solve_baseflow=False)
OTD_NSTEPS, OTD_SEED = 6, 7
OTD_FILES = ["Lr.dat", "Ls.dat", "m01otd0.f00001", "m02otd0.f00001", "rstotd0.f00001.npz"]
SIZES = (2, 4)


@pytest.fixture(autouse=True)
def no_cache(monkeypatch):
    monkeypatch.setenv("NEKLAB_PRECOND_CACHE", "0")


def _jforcing(m, t_, u, th):
    return jnp.zeros((2,) + m.bm1.shape, m.bm1.dtype).at[0].set(2.0 * W.FORCED_NU)


def _c0(jmesh, a):
    return np.asarray(jmesh.vmask * jsem.dsavg(jmesh, jnp.asarray(a)))


def _jext(u, T):
    return {"u": jnp.asarray(u), "theta": jnp.zeros((0,) + u.shape[1:]), "T": jnp.asarray(T)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    jmesh = jbox_mesh(**W.FORCED_BOX)
    y = np.asarray(jmesh.x[1])
    rng = np.random.default_rng(29)
    shape = (2,) + y.shape
    inputs = dict(upo_x=_c0(jmesh, np.stack([0.9 * (1 - y**2), 0.02 * np.sin(np.pi * y)])
                            + 0.05 * rng.standard_normal(shape)),
                  upo_du=_c0(jmesh, rng.standard_normal(shape)),
                  upo_dv=_c0(jmesh, rng.standard_normal(shape)))
    omesh = jbox_mesh(**W.OTD_BOX)
    ic_dir = str(tmp_path_factory.mktemp("otdic"))
    ic_paths = []
    for i in range(2):
        path = os.path.join(ic_dir, f"OTDIC_{i + 1:02d}.npz")
        np.savez(path, u=_c0(omesh, rng.standard_normal((2,) + tuple(omesh.bm1.shape))))
        ic_paths.append(path)
    started, args = {}, {}
    for size in SIZES:
        work = str(tmp_path_factory.mktemp(f"orbits{size}"))
        args[size] = dict(forced_cfg=FORCED_CFG, T=T0, upo_nsteps=UPO_NSTEPS, otd_cfg=OTD_CFG,
                          otd_opts=OTD_OPTS, otd_nsteps=OTD_NSTEPS, otd_seed=OTD_SEED,
                          ic_paths=ic_paths, outdir=os.path.join(work, "out"))
        started[size] = W.run_ranks("orbits", size, work, args[size], inputs, wait=False,
                                    timeout=900)

    ref = {}
    jsys = JUPO(jmesh, JLinConfig(flow=JFlowConfig(**FORCED_CFG, forcing_fn=_jforcing)),
                t_guess=T0, nsteps=UPO_NSTEPS)
    x = _jext(inputs["upo_x"], T0)
    jac = jsys.jacobian(x)
    for name, val in jac.matvec(_jext(inputs["upo_du"], 0.7)).items():
        ref[f"upo_matvec_{name}"] = np.asarray(val)
    for name, val in jac.rmatvec(_jext(inputs["upo_dv"], -0.4)).items():
        ref[f"upo_rmatvec_{name}"] = np.asarray(val)
    ref["upo_period_dir"] = np.asarray(jac._period_dir()["u"])
    mono = JMonodromy(jsys, x)
    strip = lambda key: {"u": jnp.asarray(inputs[key]), "theta": jnp.zeros((0,) + y.shape)}
    ref["mono_matvec"] = np.asarray(mono.matvec(strip("upo_du"))["u"])
    ref["mono_rmatvec"] = np.asarray(mono.rmatvec(strip("upo_dv"))["u"])

    jcfg = JLinConfig(flow=JFlowConfig(**OTD_CFG))
    jy = omesh.x[1]
    ref_dir = str(tmp_path_factory.mktemp("otd_ref"))
    jres = jotd.otd_analysis(omesh, jcfg, jotd.OtdOpts(**OTD_OPTS),
                             jinitial_state(omesh, jcfg.flow, u=jnp.stack([1 - jy**2, 0 * jy])),
                             OTD_NSTEPS, outdir=ref_dir, ic_paths=ic_paths)
    ref["otd_files_lr"] = np.stack([np.asarray(lr) for _, lr in jres.lr_history])
    # the port in one process from the random start the ranks draw
    gm = box_mesh(**W.OTD_BOX, dtype=torch.float64, device="cpu")
    cfg = LinConfig(flow=FlowConfig(**OTD_CFG))
    ty = gm.x[1]
    one = otd.otd_analysis(gm, cfg, otd.OtdOpts(**OTD_OPTS),
                           initial_state(gm, cfg.flow, u=torch.stack([1 - ty**2, 0 * ty])),
                           OTD_NSTEPS, seed=OTD_SEED)
    ref["otd_random_lr"] = np.stack([lr for _, lr in one.lr_history])
    ref["otd_random_start"] = otd._random_modes(gm, OTD_OPTS["r"], OTD_SEED).numpy()
    outs = {size: W.finish(s) for size, s in started.items()}
    return dict(outs=outs, ref=ref, args=args, ref_dir=ref_dir)


@pytest.mark.parametrize("size", SIZES)
def test_split_bordered_jacobian_and_monodromy_match_reference(runs, size):
    out, ref = runs["outs"][size], runs["ref"]
    for key in ("upo_matvec_u", "upo_rmatvec_u", "upo_period_dir", "mono_matvec",
                "mono_rmatvec"):
        assert np.abs(ref[key]).max() > 1e-3, key
        assert np.abs(out[key] - ref[key]).max() <= 1e-9, key
    for key in ("upo_matvec_T", "upo_rmatvec_T"):
        assert abs(float(out[key]) - float(ref[key])) <= 1e-9 * abs(float(ref[key])), key
    for r in range(size):  # every rank made the same collectives
        assert int(out[f"rank{r}"]["log_calls"]) == int(out["rank0"]["log_calls"])


def _rows(path):
    with open(path) as f:
        return np.array([[float(v) for v in line.split()] for line in f])


@pytest.mark.parametrize("size", SIZES)
def test_split_otd_from_files_matches_reference(runs, size):
    out, ref = runs["outs"][size], runs["ref"]
    want = ref["otd_files_lr"]
    assert np.abs(out["otd_files_lr"] - want).max() <= 1e-9 * np.abs(want).max()
    assert float(out["otd_restart_diff"]) == 0.0
    outdir = os.path.join(runs["args"][size]["outdir"], "otd")
    assert sorted(os.listdir(outdir)) == ["rank0"]
    port, jref = os.path.join(outdir, "rank0"), runs["ref_dir"]
    assert sorted(os.listdir(port)) == sorted(os.listdir(jref)) == OTD_FILES
    for name in ("Ls.dat", "Lr.dat"):
        a, b = _rows(os.path.join(port, name)), _rows(os.path.join(jref, name))
        assert a.shape == b.shape and np.array_equal(a[:, -1], b[:, -1])
        assert np.abs(a[:, :-1] - b[:, :-1]).max() <= 1e-9 * np.abs(b[:, :-1]).max()
    for name in ("m01otd0.f00001", "m02otd0.f00001"):
        fa, fb = read_fld(os.path.join(port, name)), jread_fld(os.path.join(jref, name))
        for key in ("x", "u", "p"):
            assert np.abs(getattr(fa, key) - getattr(fb, key)).max() <= 1e-6, (name, key)
    with np.load(os.path.join(port, "rstotd0.f00001.npz")) as za, \
            np.load(os.path.join(jref, "rstotd0.f00001.npz")) as zb:
        assert sorted(za.files) == sorted(zb.files)
        assert np.abs(za["pert_u"] - out["otd_files_u"]).max() == 0.0
        assert np.abs(za["pert_u"] - zb["pert_u"]).max() <= 1e-9


@pytest.mark.parametrize("size", SIZES)
def test_split_otd_random_start_is_one_process_start(runs, size):
    out, ref = runs["outs"][size], runs["ref"]
    assert np.array_equal(out["otd_random_start"], ref["otd_random_start"])
    assert np.abs(out["otd_random_lr"] - ref["otd_random_lr"]).max() <= 1e-10
