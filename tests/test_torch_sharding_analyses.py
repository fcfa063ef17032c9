"""Port parity: transient growth, the resolvent and the wavenumber-projected
propagator split over 2 and 4 gloo ranks on the CPU.

The port split over P processes (`tests/torch_shard_workers.py`, job
`analyses`; one set of ranks per P runs every case) against the JAX
package in one process on the same numpy-seeded inputs, f64, on
tests/test_sharding.py's channel box (8 x 2 elements at order 4) about
U = 0.3 (1 - y^2), nu 0.05, solves at 1e-11, dt 0.2 (CFL ~0.45; every
split step is ~200 all-reduces, each a round trip between the rank
processes, so the steps per matvec are few). At P = 4 each rank
holds half a row of elements, so the projection's coefficients are summed
across the ranks. Cases and tolerances:

  * `transient_growth_analysis_fixed_point` (tau 0.4: 2 steps per matvec;
    nsv 1, kdim 24, tol 1e-10): sigma within 1e-9 relative of the
    reference's (from its own start vector; both converged) and 1e-12 of
    the port's one-process run from the same start vector, whose optimal
    input and output the split ones match to 1e-8; the triplet identity
    |A v - sigma u| / sigma < 1e-9; singular_spectrum.dat and timers.log
    written once, by rank 0;
  * the resolvent at omega = 2 pi / 0.8 (4 steps per period, GMRES rtol
    1e-6, kdim 30): the reference's GMRES matvec counts, the response and
    the adjoint response within 1e-8 relative, the Hermitian identity to
    1e-5 (it holds to the GMRES solves' rtol);
  * `ProjectedPropagator` at alpha = 1 (tau 0.4: 2 steps) on B-normalized
    input: the projection 1e-12 absolute in one all-reduce, matvec and
    rmatvec 1e-10 absolute (tests/test_torch_resolvent.py's 1e-12 there is
    at 1e-14 solves); and the split port's matvec at P = 4 against the
    reference's own run sharded over 4 virtual devices, 1e-10.

The JAX side runs while the ranks do; each rank set is killed at its time
limit.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_shard_workers as W
from neklab_tpu.analysis import transient_growth_analysis_fixed_point as jtransient_growth
from neklab_tpu.linops.exponential_propagator import ExponentialPropagator as JProp
from neklab_tpu.linops.projected import ProjectedPropagator as JProjected
from neklab_tpu.linops.resolvent import Resolvent as JResolvent
from neklab_tpu.mesh.box import box_mesh as jbox_mesh
from neklab_tpu.models.linearized import LinConfig as JLinConfig
from neklab_tpu.models.navier_stokes import FlowConfig as JFlowConfig
from neklab_tpu.ops import sem as jsem
from neklab_tpu.parallel import sharding as jsharding
from neklab_tpu.vectors import flow_vector_space as jflow_vector_space
from neklab_tpu_torch.analysis import transient_growth_analysis_fixed_point
from neklab_tpu_torch.linops.exponential_propagator import ExponentialPropagator
from neklab_tpu_torch.mesh.box import box_mesh
from neklab_tpu_torch.models.linearized import LinConfig
from neklab_tpu_torch.models.navier_stokes import FlowConfig
from neklab_tpu_torch.vectors import flow_vector_space
from torch_port_helpers import t

LIN_CFG = dict(viscosity=0.05, dt=0.2, vtol=1e-11, ptol=1e-11, vmaxit=60, pmaxit=120)
TG = dict(kdim=24, nsv=1, tol=1e-10, seed=3)
TG_TAU = 0.4
RESOLVENT = dict(omega=2 * np.pi / 0.8, dt=0.2, gmres_rtol=1e-6, gmres_kdim=30)
PROJ_TAU, ALPHA = 0.4, 1.0
SIZES = (2, 4)


@pytest.fixture(autouse=True)
def no_cache(monkeypatch):
    monkeypatch.setenv("NEKLAB_PRECOND_CACHE", "0")


def _c0(jmesh, rng):
    a = rng.standard_normal((2,) + tuple(jmesh.bm1.shape))
    return np.asarray(jmesh.vmask * jsem.dsavg(jmesh, jnp.asarray(a)))


def _normalized(jmesh, u):
    return u / np.sqrt(float(jsem.mass_dot(jmesh, jnp.asarray(u), jnp.asarray(u))))


def _jflow(u):
    return {"u": jnp.asarray(u), "theta": jnp.zeros((0,) + u.shape[1:])}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    jmesh = jbox_mesh(**W.STEP_BOX)
    y = np.asarray(jmesh.x[1])
    base = np.stack([0.3 * (1 - y**2), 0 * y])
    rng = np.random.default_rng(17)
    inputs = dict(base=base)
    for key in ("f_re", "f_im", "g_re", "g_im"):
        inputs[key] = _c0(jmesh, rng)
    inputs["pv"], inputs["pw"] = (_normalized(jmesh, _c0(jmesh, rng)) for _ in range(2))
    started, args = {}, {}
    for size in SIZES:
        work = str(tmp_path_factory.mktemp(f"analyses{size}"))
        args[size] = dict(lin_cfg=LIN_CFG, tg_tau=TG_TAU, tg=TG, resolvent=RESOLVENT,
                          proj_tau=PROJ_TAU, alpha=ALPHA, outdir=os.path.join(work, "out"))
        started[size] = W.run_ranks("analyses", size, work, args[size], inputs, wait=False,
                                    timeout=900)

    ref = {}
    jcfg = JLinConfig(flow=JFlowConfig(**LIN_CFG))
    jA = JProp(jmesh, jcfg, jnp.asarray(base), tau=TG_TAU, dt=LIN_CFG["dt"])
    ref["tg_sigma"] = np.asarray(jtransient_growth(jA, jflow_vector_space(jmesh, 0), **TG).sigma)
    jR = JResolvent(jmesh, jcfg, jnp.asarray(base), **RESOLVENT)
    pair = lambda key: {p: _jflow(inputs[f"{key}_{p}"]) for p in ("re", "im")}
    rf = jR.matvec(pair("f"))
    counts = [jR.last_gmres_matvecs]
    rg = jR.rmatvec(pair("g"))
    ref["res_gmres"] = counts + [jR.last_gmres_matvecs]
    for p in ("re", "im"):
        ref[f"res_matvec_{p}"], ref[f"res_rmatvec_{p}"] = (np.asarray(r[p]["u"]) for r in (rf, rg))
    jP = JProjected(JProp(jmesh, jcfg, jnp.asarray(base), tau=PROJ_TAU, dt=LIN_CFG["dt"]), ALPHA)
    ref["proj_project"] = np.asarray(jP.project(_jflow(inputs["pv"]))["u"])
    ref["proj_matvec"] = np.asarray(jP.matvec(_jflow(inputs["pv"]))["u"])
    ref["proj_rmatvec"] = np.asarray(jP.rmatvec(_jflow(inputs["pw"]))["u"])
    # the port in one process, from the start vector the ranks draw
    gm = box_mesh(**W.STEP_BOX, dtype=torch.float64, device="cpu")
    A = ExponentialPropagator(gm, LinConfig(flow=FlowConfig(**LIN_CFG)), t(base), tau=TG_TAU,
                              dt=LIN_CFG["dt"])
    one_dir = str(tmp_path_factory.mktemp("tg_one"))
    one = transient_growth_analysis_fixed_point(A, flow_vector_space(gm, 0), outdir=one_dir, **TG)
    outs = {size: W.finish(s) for size, s in started.items()}
    return dict(outs=outs, ref=ref, inputs=inputs, args=args, one=one, one_dir=one_dir)


def _rel(a, b):
    return float(np.abs(a - b).max() / np.abs(b).max())


def _aligned(a, b):
    """a with the sign that brings it nearest b (a singular pair's sign is free)."""
    return a if np.abs(a - b).max() <= np.abs(a + b).max() else -a


@pytest.mark.parametrize("size", SIZES)
def test_split_transient_growth_matches_reference(runs, size):
    out, ref, one = runs["outs"][size], runs["ref"], runs["one"]
    assert out["tg_residuals"].max() < TG["tol"] * out["tg_sigma"][0]
    assert abs(out["tg_sigma"][0] - ref["tg_sigma"][0]) <= 1e-9 * ref["tg_sigma"][0]
    assert abs(out["tg_sigma"][0] - one.sigma[0]) <= 1e-12 * one.sigma[0]
    assert int(out["tg_n_matvec"]) == one.n_matvec
    assert float(out["tg_triplet"]) < 1e-9
    for key, vecs in (("tg_in", one.optimal_inputs), ("tg_out", one.optimal_outputs)):
        want = vecs[0]["u"].numpy()
        assert np.abs(_aligned(out[key], want) - want).max() <= 1e-8, key
    outdir = runs["args"][size]["outdir"]
    assert sorted(os.listdir(os.path.join(outdir, "tg"))) == ["rank0"]
    files = sorted(os.listdir(os.path.join(outdir, "tg", "rank0")))
    assert files == sorted(os.listdir(runs["one_dir"])) == ["singular_spectrum.dat", "timers.log"]
    with open(os.path.join(outdir, "tg", "rank0", "singular_spectrum.dat")) as f:
        (line,) = f.read().splitlines()
    i, s, _ = line.split()
    assert int(i) == 1 and abs(float(s) - out["tg_sigma"][0]) <= 1e-12


@pytest.mark.parametrize("size", SIZES)
def test_split_resolvent_matches_reference(runs, size):
    out, ref = runs["outs"][size], runs["ref"]
    assert out["res_gmres"].tolist() == ref["res_gmres"]
    for key in ("res_matvec_re", "res_matvec_im", "res_rmatvec_re", "res_rmatvec_im"):
        assert np.abs(ref[key]).max() > 1e-2, key
        assert _rel(out[key], ref[key]) <= 1e-8, key
    lhs, rhs = out["res_identity"]  # exact up to the GMRES solves' rtol 1e-6
    assert abs(lhs - rhs) <= 1e-5 * abs(lhs), (lhs, rhs)


@pytest.mark.parametrize("size", SIZES)
def test_split_projected_propagator_matches_reference(runs, size):
    """At P = 4 a block is half a row of the 8 x 2 box: the rows'
    coefficients are summed across the ranks, in one all-reduce."""
    out, ref = runs["outs"][size], runs["ref"]
    assert np.abs(out["proj_project"] - ref["proj_project"]).max() <= 1e-12
    assert int(out["proj_calls"]) == 1
    for key in ("proj_matvec", "proj_rmatvec"):
        assert np.abs(ref[key]).max() > 1e-2, key
        assert np.abs(out[key] - ref[key]).max() <= 1e-10, key


def test_split_projected_matches_sharded_reference(runs):
    """The split port's projected matvec at P = 4 against the reference's own
    run sharded over 4 virtual devices (`make_device_mesh(4)`)."""
    jmesh = jbox_mesh(**W.STEP_BOX)
    dmesh = jsharding.make_device_mesh(4)
    smesh = jsharding.shard_sem_mesh(jmesh, dmesh)
    spec = lambda a: jax.sharding.NamedSharding(
        dmesh, jax.sharding.PartitionSpec(*([None] * (a.ndim - 1) + ["e"])))
    sh = lambda a: jax.device_put(jnp.asarray(a), spec(np.asarray(a)))
    jcfg = JLinConfig(flow=JFlowConfig(**LIN_CFG))
    z = runs["inputs"]
    with dmesh:
        jP = JProjected(JProp(smesh, jcfg, sh(z["base"]), tau=PROJ_TAU, dt=LIN_CFG["dt"]), ALPHA)
        mv = jP.matvec({"u": sh(z["pv"]), "theta": sh(np.zeros((0,) + z["pv"].shape[1:]))})
        ref = np.asarray(jax.block_until_ready(mv["u"]))
    assert np.abs(ref).max() > 1e-2
    assert np.abs(runs["outs"][4]["proj_matvec"] - ref).max() <= 1e-10
