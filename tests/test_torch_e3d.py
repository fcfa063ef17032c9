"""The 3-D pressure operator E as two CUDA kernels (`ops/e_kernel.py`,
`csrc/e3d.cu`) against their plain twin, `stokes.e_op_plain`.

On the CPU: `e_op` on CPU tensors is the plain chain bit for bit, the
gather plan sums every DOF's copies as `sem.dssum` does, `e3d` refuses
what the kernels cannot take (a mask that is not 0/1, another dtype or
shape, an n they are not built for, a dt/g0 that is not a scalar), and the
benchmark's reader of the applies per pressure iteration. On the card
(marked `cuda`, skipped without one): the kernels against the twin at the
benchmark cells' shapes (order 7 with 720 elements, order 5 with 1,728; f64
to 1e-13 relative) and on a deformed box (all nine rx factors) at every
order they are built for, f64 and f32 (to 1e-5), with leading batch axes
(more entries than a grid axis holds, too), a tensor dt/g0, E's symmetry,
the same bits on every call, a captured graph's replay against the eager
apply, the run counter under replays, the pressure solver against the
CPU's, a traced propagate's count, a 3-D CUDA apply the kernels cannot take
raising, and the 2-D and partitioned meshes taking no kernel run.

The file imports no jax, so it also runs on a machine that has none:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_e3d.py -q
"""

import dataclasses
import importlib.util
import os

import numpy as np
import pytest
import torch

from neklab_tpu_torch.mesh.box import box_mesh
from neklab_tpu_torch.models import navier_stokes as ns
from neklab_tpu_torch.models import stokes
from neklab_tpu_torch.ops import e_kernel, sem
from torch_port_helpers import CHANNEL_BC, rel

WALLED3 = {f: "W" for f in ("x-", "x+", "y-", "y+", "z-", "z+")}
DUCT = {"x-": "P", "x+": "P", "y-": "W", "y+": "W", "z-": "W", "z+": "W"}
CHANNEL3 = {"x-": "P", "x+": "P", "y-": "W", "y+": "W", "z-": "P", "z+": "P"}
# the benchmark's cells: (nels, lims, bc, order)
CELLS = {
    "channel3d-re7500": ((12, 10, 6), ((0.0, 2 * np.pi), (-1.0, 1.0), (0.0, np.pi)), CHANNEL3, 7),
    "duct3d-re1000": ((12, 12, 12), ((0.0, 4.0), (-1.0, 1.0), (-1.0, 1.0)), DUCT, 5),
}
C = 0.37  # a dt/g0


def wavy3(x):
    """A smooth deformation of a [0, 2] x [-1, 1] x [-1, 1] box: every rx
    factor is nonzero."""
    x = np.array(x)
    x0, x1, x2 = x[0].copy(), x[1].copy(), x[2].copy()
    x[0] = x0 + 0.05 * np.sin(np.pi * x1) * np.cos(0.5 * np.pi * x2)
    x[1] = x1 + 0.1 * np.sin(np.pi * x0) * (1 - x1**2) + 0.03 * x2
    x[2] = x2 + 0.08 * np.sin(np.pi * x0 + 0.5) * (1 - x2**2) + 0.04 * x1
    return x


def small(device, dtype=torch.float64, order=4, deform=None, bc=DUCT):
    """Nine elements: a ragged last tile of 4 (f64) and of 8 (f32), and
    with a periodic z, copies of a DOF inside one element."""
    return box_mesh((3, 3, 1), ((0.0, 2.0), (-1.0, 1.0), (-1.0, 1.0)), bc, order=order,
                    deform=deform, dtype=dtype, device=device)


def field(mesh, lead=(), seed=0):
    rng = np.random.default_rng(seed)
    return torch.as_tensor(rng.standard_normal(lead + tuple(mesh.bm2.shape)), dtype=mesh.dtype,
                           device=mesh.device)


# ---------------------------------------------------------------------------
# the CPU: the plain chain, the gather plan, the reader
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("lead", [(), (3,)])
@pytest.mark.parametrize("deform", [None, wavy3])
def test_e_op_on_cpu_is_the_plain_chain_bit_for_bit(lead, deform):
    mesh = small("cpu", deform=deform)
    dp = field(mesh, lead)
    assert not e_kernel.applies(mesh, dp)
    chain = stokes.div_weak(mesh, stokes.pressure_correct_velocity(mesh, dp, C))
    assert torch.equal(stokes.e_op_plain(mesh, dp, C), chain)
    assert torch.equal(stokes.e_op(mesh, dp, C), chain)


def _gather(plan, g: np.ndarray) -> np.ndarray:
    """Kernel B's gather, in numpy: each node sums its DOF's copies of g
    [3, npos] in the plan's order and keeps the components its mask bits
    keep."""
    node = plan.node.numpy().astype(np.int64)
    table = plan.table.numpy()
    out = np.zeros_like(g)
    for i, code in enumerate(node):
        off = code >> 3
        if off == 0:
            s = g[:, i]
        else:
            s = g[:, table[off + 1]]
            for at in table[off + 2 : off + 1 + table[off]]:
                s = s + g[:, at]
        out[:, i] = s * np.array([(code >> k) & 1 for k in range(3)])
    return out


@pytest.mark.parametrize("bc", [DUCT, WALLED3, CHANNEL3], ids=["duct", "walled", "channel"])
def test_gather_plan_sums_like_dssum(bc):
    """Every copy of a DOF receives the same sum (the same bits), and the
    sums are `dssum`'s, masked; interior nodes read no table entry."""
    mesh = small("cpu", bc=bc)
    plan = e_kernel.build_plan(mesh)
    g = np.random.default_rng(1).standard_normal((3,) + tuple(mesh.bm1.shape))
    want = (sem.dssum(mesh, torch.as_tensor(g)) * mesh.vmask).numpy().reshape(3, -1)
    got = _gather(plan, g.reshape(3, -1))
    assert np.abs(got - want).max() <= 1e-14 * np.abs(want).max()
    gidx = mesh.gidx.numpy().reshape(-1)
    for k in range(3):
        first = np.full(mesh.nglob, np.nan)
        first[gidx[::-1]] = got[k][::-1]
        assert np.array_equal(got[k], first[gidx])  # bit for bit across the copies
    mult = np.bincount(gidx)[gidx]
    assert np.array_equal(plan.node.numpy() >> 3 == 0, mult == 1)
    # three entries of padding, then a count and the copies for each shared DOF
    shared_dofs = int((np.bincount(gidx) > 1).sum())
    assert plan.table.numel() == 3 + shared_dofs + int((mult > 1).sum())


@pytest.mark.parametrize("what", ["mask", "dtype", "shape", "order", "dt_over_g0"])
def test_e3d_refuses_what_the_kernels_cannot_take(what):
    """Each raises before any launch, so on the card such an apply fails
    loudly rather than running the plain chain."""
    mesh = small("cpu")
    dp, c = field(mesh), C
    if what == "mask":
        mesh = dataclasses.replace(mesh, vmask=0.5 * mesh.vmask)
        with pytest.raises(ValueError, match="0/1"):
            e_kernel.build_plan(mesh)
        return
    if what == "dtype":
        dp = dp.float()
    elif what == "shape":
        dp = dp[..., :-1]
    elif what == "order":
        mesh = box_mesh((1, 1, 1), ((0.0, 1.0),) * 3, WALLED3, order=12, device="cpu")
        dp = field(mesh)
    else:
        c = torch.full((2,), C, dtype=torch.float64)
    with pytest.raises(ValueError, match="e3d"):
        e_kernel.e3d(mesh, dp, c)


def _reader():
    path = os.path.join(os.path.dirname(__file__), "..", "benchmark", "metrics",
                        "e3d_applies_per_pressure_iter.py")
    spec = importlib.util.spec_from_file_location("e3d_applies_reader", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def test_reader_of_applies_per_pressure_iteration():
    read = _reader()
    assert read({"counters": {"pressure": [12, 13], "time_steps": 2}}) is None
    assert read({"counters": {"neklab.e3d": [28], "pressure": [12, 13]}}) == 28 / 25


# ---------------------------------------------------------------------------
# the card
# ---------------------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: CUDA kernels have no CPU mode")
    return torch.device("cuda", 0)


def _kernel_and_twin(mesh, dp):
    e_kernel.reset_launches(mesh.device)
    assert e_kernel.applies(mesh, dp)
    out = stokes.e_op(mesh, dp, C)
    assert e_kernel.launches(mesh.device) == 1
    return out, stokes.e_op_plain(mesh, dp, C)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", list(CELLS))
def test_kernels_match_the_twin_at_the_cells_shapes(card, cell):
    nels, lims, bc, order = CELLS[cell]
    mesh = box_mesh(nels, lims, bc, order=order, dtype=torch.float64, device=card)
    out, twin = _kernel_and_twin(mesh, field(mesh))
    assert rel(out, twin) <= 1e-13


@pytest.mark.cuda
@pytest.mark.parametrize("order", [n - 1 for n in e_kernel.NS])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_kernels_match_the_twin_on_a_deformed_box(card, order, dtype):
    """Every n the kernels are built for, every rx factor nonzero."""
    mesh = small(card, dtype=dtype, order=order, deform=wavy3, bc=WALLED3)
    assert all(float(mesh.rx[a, k].abs().max()) > 1e-3 for a in range(3) for k in range(3))
    out, twin = _kernel_and_twin(mesh, field(mesh))
    assert rel(out, twin) <= (1e-13 if dtype == torch.float64 else 1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("lead", [(1,), (5,), (2, 3), (70000,)])
def test_kernels_take_leading_batch_axes(card, lead):
    """The preconditioner's probes pass a leading axis; each entry is E of
    its own field. 70,000 entries pass a grid's second axis (65,535)."""
    mesh = small(card, deform=wavy3, order=3 if lead == (70000,) else 4)
    dp = field(mesh, lead)
    out, twin = _kernel_and_twin(mesh, dp)
    assert out.shape == dp.shape and rel(out, twin) <= 1e-13
    one = stokes.e_op(mesh, dp.reshape((-1,) + tuple(mesh.bm2.shape))[-1], C)
    assert torch.equal(out.reshape((-1,) + tuple(mesh.bm2.shape))[-1], one)


@pytest.mark.cuda
def test_kernels_symmetric_and_the_same_bits_every_call(card):
    mesh = small(card, deform=wavy3, bc=CHANNEL3)
    x, y = field(mesh, seed=2), field(mesh, seed=3)
    ex, ey = stokes.e_op(mesh, x, C), stokes.e_op(mesh, y, C)
    assert abs(float((y * ex).sum() - (x * ey).sum())) <= 1e-13 * float((x * ex).sum().abs())
    assert torch.equal(stokes.e_op(mesh, x, C), ex)


@pytest.mark.cuda
def test_graph_replay_equals_the_eager_apply_and_counts(card):
    mesh = small(card, order=5)
    x = field(mesh, seed=4)
    side = torch.cuda.Stream(card)
    side.wait_stream(torch.cuda.current_stream(card))
    with torch.cuda.stream(side):
        stokes.e_op(mesh, x, C)
    torch.cuda.current_stream(card).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = stokes.e_op(mesh, x, C)
    e_kernel.reset_launches(card)
    for seed in (5, 6, 7):
        x.copy_(field(mesh, seed=seed))
        graph.replay()
        assert torch.equal(captured, stokes.e_op(mesh, x, C))
    assert e_kernel.launches(card) == 6  # three replays and three eager applies


@pytest.mark.cuda
def test_pressure_solver_on_the_kernels_matches_cpu(card):
    """The built-once pressure solver, its CG a graph replay of the kernels,
    with a warm start and its backward, against the same on CPU tensors."""
    meshes = {dev: small(dev, order=5, deform=wavy3) for dev in (card, "cpu")}
    cfg = ns.FlowConfig(viscosity=1e-2, dt=1e-2, ptol=1e-11)
    rng = np.random.default_rng(8)
    rhs, x0, g = (rng.standard_normal(tuple(meshes["cpu"].bm2.shape)) for _ in range(3))
    out, grads, stats = {}, {}, {}
    e_kernel.reset_launches(card)
    for dev, m in meshes.items():
        solve = ns.make_pressure_solver(m, cfg, 0.5)
        r = torch.as_tensor(rhs, device=dev).requires_grad_(True)
        stats[dev] = {}
        out[dev] = solve(r, x0=torch.as_tensor(x0, device=dev), stats=stats[dev])
        (grads[dev],) = torch.autograd.grad(out[dev], r, torch.as_tensor(g, device=dev))
    # unpreconditioned, ~100 iterations: E's other summation order may move
    # the last by one
    iters = stats[card]["pressure"]
    assert len(iters) == 2 and min(iters) > 3
    assert all(abs(a - b) <= 1 for a, b in zip(iters, stats["cpu"]["pressure"]))
    # the capture's warm-up iteration, the warm start, one apply an iteration
    assert e_kernel.launches(card) == sum(iters) + 2
    assert rel(out[card], out["cpu"].detach()) <= 1e-10
    assert rel(grads[card], grads["cpu"]) <= 1e-10


@pytest.mark.cuda
def test_traced_propagate_counts_its_applies(card):
    from neklab_tpu_torch.linops.exponential_propagator import ExponentialPropagator
    from neklab_tpu_torch.models.linearized import LinConfig

    m = small(card, order=5)
    cfg = LinConfig(flow=ns.FlowConfig(viscosity=1 / 500, dt=1e-2, vtol=1e-10, ptol=1e-10))
    base = torch.zeros((3,) + tuple(m.bm1.shape), dtype=m.dtype, device=card)
    base[0] = (1 - m.x[1] ** 2) * (1 - m.x[2] ** 2)
    prop = ExponentialPropagator(m, cfg, base, tau=0.05)
    u = torch.as_tensor(np.random.default_rng(9).standard_normal((3,) + tuple(m.bm1.shape)),
                        device=card)
    x = {"u": m.vmask * sem.dsavg(m, u),
         "theta": torch.zeros((0,) + tuple(m.bm1.shape), dtype=m.dtype, device=card)}
    for name in ("matvec", "rmatvec"):
        getattr(prop, name)(x)  # the adjoint records its tape at its first call
        stats = {}
        getattr(prop, name)(x, stats=stats)
        assert len(stats[e_kernel.STATS_KEY]) == 1
        assert stats[e_kernel.STATS_KEY][0] >= sum(stats["pressure"]) >= prop.nsteps, name


@pytest.mark.cuda
def test_2d_and_partitioned_meshes_take_no_kernel_run(card):
    mesh2 = box_mesh((4, 3), ((0, 2 * np.pi), (-1, 1)), CHANNEL_BC, order=6, device=card)
    mesh3 = small(card)
    split = dataclasses.replace(mesh3, part=object())
    e_kernel.reset_launches(card)
    for mesh in (mesh2, split):
        dp = field(mesh)
        assert not e_kernel.applies(mesh, dp)
        assert torch.equal(stokes.e_op(mesh, dp, C), stokes.e_op_plain(mesh, dp, C))
    assert e_kernel.launches(card) == 0


@pytest.mark.cuda
def test_tensor_dt_over_g0_runs_the_kernels(card):
    mesh = small(card, deform=wavy3)
    dp = field(mesh)
    e_kernel.reset_launches(card)
    out = stokes.e_op(mesh, dp, torch.tensor(C, dtype=torch.float64, device=card))
    assert e_kernel.launches(card) == 1
    assert rel(out, stokes.e_op_plain(mesh, dp, C)) <= 1e-13


@pytest.mark.cuda
def test_3d_cuda_apply_the_kernels_cannot_take_raises(card):
    """No silent plain chain on the card: another dtype than the mesh's
    raises."""
    mesh = small(card)
    with pytest.raises(ValueError, match="e3d"):
        stokes.e_op(mesh, field(mesh).float(), C)
