"""Port parity: forward mode, the fixed-point system and Newton split over 2
and 4 gloo ranks on the CPU.

The port split over P processes (`tests/torch_shard_workers.py`, jobs
`fwd_sum` and `drivers`; one set of ranks per P runs every case) against
the JAX package in one process on the same numpy-seeded inputs, f64.
Cases and tolerances:

  * `Partition.sum` under forward mode at P = 1, 2 and 4: the primal and
    the tangent are the sums over the ranks (1e-15), one all-reduce each;
  * tests/test_torch_newton.py's forced channel (body force 2 nu, fixed
    point u = 1 - y^2), widened to 4 x 2 elements at order 4 so that it
    splits over 2 and 4 ranks; tau 0.1 at dt 0.05 (2 steps), solves at
    1e-12: the response and the frozen and exact Jacobians' matvec and
    rmatvec within 1e-9 relative of the reference's (the exact matvec is
    forward mode through the split `advance`, its pressure mean and range
    projections included), the B-adjoint identity to 1e-9;
  * `newton_fixed_point_iteration` with each Jacobian, one iteration
    (GMRES kdim 20, 17 Jacobian matvecs; each split step is ~290
    all-reduces at 1e-12 solves, each a round trip between the rank
    processes, so the depth is cut from tests/test_torch_newton.py's seven
    iterations to tol 1e-9): the reference's iteration count, its |F|
    history within 1e-6 relative (both entries are >= 4e-3, far above the
    1e-12 solves), the iterate within 1e-9 of the reference's;
  * residual.dat and timers.log are written once, by rank 0, residual.dat
    with the history in the one-process format;
  * Nek5000's residual projection: `propagate` about 1 - y^2 and `advance`
    on the forced channel, 6 steps (4 past the ramp: the 3 slots roll
    over) at 1e-10 solves with recycle=3 and the system's two-level
    preconditioner (E's exact blocks: the element-first layout), within
    1e-7 of the output's max of the reference's recycle=3 (the reference's
    own bound), within 1e-9 of the port's recycle=3 in one process, and
    `propagate` within 1e-7 of the split recycle=0; each recycled solve
    adds four all-reduces (alpha, beta, (|d|_A^2, |d|^2), and the range
    projection of the deflated right-hand side: the channel is
    pure-Neumann).

The JAX side runs while the ranks do; each rank set is killed at its time
limit.
"""

import dataclasses
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_shard_workers as W
from neklab_tpu.analysis import newton_fixed_point_iteration as jnewton_fp
from neklab_tpu.mesh.box import box_mesh as jbox_mesh
from neklab_tpu.models import navier_stokes as jns
from neklab_tpu.models.linearized import LinConfig as JLinConfig
from neklab_tpu.models.linearized import propagate as jpropagate
from neklab_tpu.models.navier_stokes import FlowConfig as JFlowConfig
from neklab_tpu.models.precond import build_e_preconditioner as jbuild_pc
from neklab_tpu.ops import sem as jsem
from neklab_tpu.systems.fixed_point import FixedPointSystem as JFixedPointSystem
from neklab_tpu.vectors import flow_vector_space as jflow_vector_space
from neklab_tpu_torch.mesh.box import box_mesh
from neklab_tpu_torch.models import navier_stokes as ns
from neklab_tpu_torch.models.linearized import LinConfig
from neklab_tpu_torch.models.linearized import propagate
from neklab_tpu_torch.models.precond import build_e_preconditioner

FORCED_CFG = dict(viscosity=W.FORCED_NU, dt=0.05, vtol=1e-12, ptol=1e-12)
SYSTEM = dict(tau=0.1, dt=0.05)
NEWTON = dict(tol=1e-9, maxiter=1, gmres_kdim=20)
RECYCLE = dict(k=3, nsteps=6, tol=1e-10)
SIZES = (2, 4)


@pytest.fixture(autouse=True)
def no_cache(monkeypatch):
    monkeypatch.setenv("NEKLAB_PRECOND_CACHE", "0")


def _jforcing(m, t_, u, th):
    return jnp.zeros((2,) + m.bm1.shape, m.bm1.dtype).at[0].set(2.0 * W.FORCED_NU)


def _c0(jmesh, a):
    return np.asarray(jmesh.vmask * jsem.dsavg(jmesh, jnp.asarray(a)))


def _jvec(u):
    return {"u": jnp.asarray(u), "theta": jnp.zeros((0,) + u.shape[1:])}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Starts the rank sets (P = 1 for the forward-mode sum; P = 2 and 4 for
    every case), computes the reference meanwhile, -> both."""
    jmesh = jbox_mesh(**W.FORCED_BOX)
    y = np.asarray(jmesh.x[1])
    rng = np.random.default_rng(1)
    shape = (2,) + y.shape
    guess = _c0(jmesh, np.stack([0.7 * (1 - y**2), 0 * y]) + 0.05 * rng.standard_normal(shape))
    du, w = (_c0(jmesh, rng.standard_normal(shape)) for _ in range(2))
    base = np.stack([1 - y**2, 0 * y])
    inputs = dict(x=rng.standard_normal((4, 5)), dx=rng.standard_normal((4, 5)), guess=guess,
                  du=du, w=w, base=base)
    started = {}
    work = str(tmp_path_factory.mktemp("fwd1"))
    started[1] = W.run_ranks("fwd_sum", 1, work, {}, inputs, wait=False, timeout=60)
    args = {}
    for size in SIZES:
        work = str(tmp_path_factory.mktemp(f"drivers{size}"))
        args[size] = dict(forced_cfg=FORCED_CFG, system=SYSTEM, newton=NEWTON,
                          recycle=RECYCLE, outdir=os.path.join(work, "out"))
        started[size] = W.run_ranks("drivers", size, work, args[size], inputs, wait=False,
                                    timeout=900)

    ref = {}
    jcfg = JLinConfig(flow=JFlowConfig(**FORCED_CFG, forcing_fn=_jforcing))
    for name in ("frozen", "exact"):
        jsys = JFixedPointSystem(jmesh, jcfg, exact_jacobian=name == "exact", **SYSTEM)
        ref[f"{name}_response"] = np.asarray(jsys.response(_jvec(guess))["u"])
        jac = jsys.jacobian(_jvec(guess))
        ref[f"{name}_matvec"] = np.asarray(jac.matvec(_jvec(du))["u"])
        ref[f"{name}_rmatvec"] = np.asarray(jac.rmatvec(_jvec(w))["u"])
        res = jnewton_fp(jsys, _jvec(guess), jflow_vector_space(jmesh, 0), **NEWTON)
        ref[f"{name}_history"], ref[f"{name}_iterations"] = res.history, res.iterations
        ref[f"{name}_x"] = np.asarray(res.x["u"])
    ref.update(_recycled_one_process(jmesh, jcfg, guess, du, base))
    outs = {size: W.finish(s) for size, s in started.items()}
    return dict(outs=outs, ref=ref, inputs=inputs, args=args)


def _recycled_one_process(jmesh, jcfg, guess, du, base) -> dict:
    """The reference's and the port's (one process, the CPU) recycled
    `propagate` and `advance` of the ranks' `_recycled` case."""
    k, n, tol = RECYCLE["k"], RECYCLE["nsteps"], RECYCLE["tol"]
    jth = jnp.zeros((0,) + jmesh.bm1.shape)
    jpc = jbuild_pc(jmesh, 1.0)  # the system's
    jfc = dataclasses.replace(jcfg.flow, vtol=tol, ptol=tol)
    out = {"ref_propagate": np.asarray(jpropagate(
        jmesh, JLinConfig(flow=jfc), jnp.asarray(base), jth, jnp.asarray(du), jth, n, pc_e=jpc,
        recycle=k)[0])}
    out["ref_advance"] = np.asarray(jns.advance(
        jmesh, jfc, jns.initial_state(jmesh, jfc, u=jnp.asarray(guess)), n, pc_e=jpc,
        recycle=k).u)
    mesh = box_mesh(**W.FORCED_BOX, dtype=torch.float64, device="cpu")
    fc = ns.FlowConfig(**dict(FORCED_CFG, vtol=tol, ptol=tol), forcing_fn=W.body_force)
    pc = build_e_preconditioner(mesh)
    th = torch.zeros((0,) + tuple(mesh.bm1.shape), dtype=torch.float64)
    out["one_propagate"] = propagate(mesh, LinConfig(flow=fc), torch.as_tensor(base), th,
                                     torch.as_tensor(du), th, n, pc_e=pc, recycle=k)[0].numpy()
    out["one_advance"] = ns.advance(mesh, fc, ns.initial_state(mesh, fc, u=torch.as_tensor(guess)),
                                    n, pc_e=pc, recycle=k).u.numpy()
    return out


@pytest.mark.parametrize("size", (1,) + SIZES)
def test_split_sum_has_a_forward_mode(runs, size):
    out, z = runs["outs"][size], runs["inputs"]
    assert np.abs(out["sum"] - z["x"][:size].sum(0)).max() <= 1e-15 * size
    assert np.abs(out["sum_tangent"] - z["dx"][:size].sum(0)).max() <= 1e-15 * size
    assert int(out["sum_calls"]) == 2  # the primal's all-reduce and the tangent's


def _rel(a, b):
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.mark.parametrize("name", ["frozen", "exact"])
@pytest.mark.parametrize("size", SIZES)
def test_split_jacobians_match_reference(runs, size, name):
    out, ref = runs["outs"][size], runs["ref"]
    for key in ("response", "matvec", "rmatvec"):
        assert np.abs(ref[f"{name}_{key}"]).max() > 1e-3, key
        assert _rel(out[f"{name}_{key}"], ref[f"{name}_{key}"]) <= 1e-9, key
    lhs, rhs = out[f"{name}_identity"]
    assert abs(lhs - rhs) <= 1e-9 * abs(lhs), (lhs, rhs)
    for r in range(size):  # every rank made the same collectives
        assert int(out[f"rank{r}"]["log_calls"]) == int(out["rank0"]["log_calls"])


def _residual_file(path):
    rows = []
    with open(path) as f:
        for line in f.read().splitlines():
            assert re.fullmatch(r"\d+ \d\.\d{12}e[+-]\d\d", line), line
            i, r = line.split()
            rows.append((int(i), float(r)))
    return rows


@pytest.mark.parametrize("name", ["frozen", "exact"])
@pytest.mark.parametrize("size", SIZES)
def test_split_newton_matches_reference(runs, size, name):
    out, ref = runs["outs"][size], runs["ref"]
    history, want = out[f"{name}_history"], ref[f"{name}_history"]
    assert int(out[f"{name}_iterations"]) == ref[f"{name}_iterations"] == 1
    np.testing.assert_allclose(history, want, rtol=1e-6)
    assert np.abs(out[f"{name}_x"] - ref[f"{name}_x"]).max() <= 1e-9
    outdir = runs["args"][size]["outdir"]
    assert sorted(os.listdir(os.path.join(outdir, name))) == ["rank0"]
    files = sorted(os.listdir(os.path.join(outdir, name, "rank0")))
    assert files == ["residual.dat", "timers.log"]
    rows = _residual_file(os.path.join(outdir, name, "rank0", "residual.dat"))
    assert [r[0] for r in rows] == list(range(len(history)))
    np.testing.assert_allclose([r[1] for r in rows], history, rtol=1e-12)


@pytest.mark.parametrize("name", ["propagate", "advance"])
@pytest.mark.parametrize("size", SIZES)
def test_split_recycling_matches_reference(runs, size, name):
    out, ref = runs["outs"][size], runs["ref"]
    got = out[f"recycle{RECYCLE['k']}_{name}"]
    assert np.abs(ref[f"ref_{name}"]).max() > 1e-3
    assert _rel(got, ref[f"ref_{name}"]) <= 1e-7
    assert _rel(got, ref[f"one_{name}"]) <= 1e-9
    if name == "propagate":
        assert _rel(out["recycle0_propagate"], got) <= 1e-7
        plain, recycled = out["recycle_iters"]
        assert recycled <= plain, (plain, recycled)
        # alpha (k values), beta (k), (|d|_A^2, |d|^2) and the deflated
        # right-hand side's range projection, per recycled solve
        assert float(out["recycle_extra"]) == 4.0
