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
    with the history in the one-process format.

The JAX side runs while the ranks do; each rank set is killed at its time
limit.
"""

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest

import torch_shard_workers as W
from neklab_tpu.analysis import newton_fixed_point_iteration as jnewton_fp
from neklab_tpu.mesh.box import box_mesh as jbox_mesh
from neklab_tpu.models.linearized import LinConfig as JLinConfig
from neklab_tpu.models.navier_stokes import FlowConfig as JFlowConfig
from neklab_tpu.ops import sem as jsem
from neklab_tpu.systems.fixed_point import FixedPointSystem as JFixedPointSystem
from neklab_tpu.vectors import flow_vector_space as jflow_vector_space

FORCED_CFG = dict(viscosity=W.FORCED_NU, dt=0.05, vtol=1e-12, ptol=1e-12)
SYSTEM = dict(tau=0.1, dt=0.05)
NEWTON = dict(tol=1e-9, maxiter=1, gmres_kdim=20)
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
    inputs = dict(x=rng.standard_normal((4, 5)), dx=rng.standard_normal((4, 5)), guess=guess,
                  du=du, w=w)
    started = {}
    work = str(tmp_path_factory.mktemp("fwd1"))
    started[1] = W.run_ranks("fwd_sum", 1, work, {}, inputs, wait=False, timeout=60)
    args = {}
    for size in SIZES:
        work = str(tmp_path_factory.mktemp(f"drivers{size}"))
        args[size] = dict(forced_cfg=FORCED_CFG, system=SYSTEM, newton=NEWTON,
                          outdir=os.path.join(work, "out"))
        started[size] = W.run_ranks("drivers", size, work, args[size], inputs, wait=False,
                                    timeout=400)

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
    outs = {size: W.finish(s) for size, s in started.items()}
    return dict(outs=outs, ref=ref, inputs=inputs, args=args)


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
