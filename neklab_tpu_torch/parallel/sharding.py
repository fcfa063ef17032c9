"""Element-partitioned runs over a torch.distributed process group.

Counterpart of `neklab_tpu/parallel/sharding.py`. The reference's one scaling
strategy is element decomposition (Nek5000's MPI): JAX shards every field
along its element axis over one mesh axis 'e' and XLA's partitioner emits
the collectives. Here each rank of a process group holds one contiguous
block of the element axis on its own device, and the port places the
collectives itself, at the few points where the reference relies on XLA:

  * `sem.dssum`: a local gather-sum, then one all-reduce of the packed
    interface DOFs (the mesh's exchange plan, `shard_sem_mesh`);
  * the pressure preconditioner's patches and E's neighbour blocks: one
    all-reduce of the packed boundary elements (`ETwoLevel.shard`), the
    coarse residual packed beside them;
  * every global sum (the CG's dots, the Krylov Gram vectors, the pressure
    mean): one all-reduce per dot or per stacked Gram vector.

All-reduce is the only collective on the solve path: gloo supports it on
CUDA tensors, and NCCL's is captured in a CUDA graph (`PCG.graphed`). It
gives every rank the same bits, so every stopping test and the small dense
algebra (Hessenberg, Schur, Ritz) take the same branches on every rank.

The element count must be divisible by the world size (the reference's
rule); `mesh_from_re2(..., partition=P)` orders the elements by RCB so that
each block is spatially compact.
"""

from __future__ import annotations

import collections
import dataclasses
import datetime
import os
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

# which SemMesh fields carry the element axis (last): the rest is replicated
# (the reference's _SEM_MESH_AXES without its exchange schedules, which the
# port does not have)
_SEM_MESH_AXES = {
    "x": -1, "jac": -1, "rx": -1, "bm1": -1, "g": -1, "xd": -1, "rxd": -1,
    "bmd": -1, "bm2": -1, "binv": -1, "gidx": -1, "vmult": -1, "vmask": -1,
    "pmask": -1, "tmask": -1, "vmask_hat": None, "tmask_hat": None, "gfirst": None,
    "volume": None, "eperm": None,
}
# the replicated global-DOF arrays, which no solve reads: a rank's mesh keeps
# them on the host, with the global mesh, so that its device holds its block
_HOST_FIELDS = ("vmask_hat", "tmask_hat", "gfirst")
_FLOW_STATE_AXES = {
    "u": -1, "p": -1, "theta": -1, "ulag": -1, "nlag": -1, "tlag": -1,
    "ntlag": -1, "plag": -1, "time": None,
}


class CommLog:
    """What the collectives moved (the all-reduces, and the broadcasts of
    `gather_field`): calls, bytes, and the calls per element count
    (`by_numel`). A graphed CG's replays are added by `PCG`."""

    def __init__(self):
        self.calls = 0
        self.bytes = 0
        self.by_numel: collections.Counter = collections.Counter()

    def add(self, calls: int, nbytes: int, by_numel, times: int = 1) -> None:
        self.calls += times * calls
        self.bytes += times * nbytes
        self.by_numel.update({k: times * v for k, v in by_numel.items()})

    def snapshot(self) -> tuple:
        return self.calls, self.bytes, collections.Counter(self.by_numel)

    def since(self, snap: tuple) -> tuple:
        """(calls, bytes, by_numel) added after `snapshot()` gave snap."""
        calls, nbytes, by_numel = snap
        diff = collections.Counter(self.by_numel)
        diff.subtract(by_numel)
        return self.calls - calls, self.bytes - nbytes, +diff

    def reset(self) -> None:
        self.calls, self.bytes = 0, 0
        self.by_numel.clear()


class _AllReduceSum(torch.autograd.Function):
    """A summed copy of x across the ranks. Its backward is the same sum:
    y = sum_r x_r on every rank, so the cotangent of each x_r is the sum of
    every rank's cotangent of y. Its forward-mode tangent is the sum too:
    dy = sum_r dx_r, one all-reduce of the tangent (logged as every other)."""

    @staticmethod
    def forward(ctx, x, part):
        ctx.part = part
        return part.all_reduce(x.contiguous().clone())

    @staticmethod
    def backward(ctx, g):
        return ctx.part.all_reduce(g.contiguous().clone()), None

    @staticmethod
    def jvp(ctx, dx, _):
        return ctx.part.all_reduce(dx.contiguous().clone())


@dataclasses.dataclass(eq=False)
class Partition:
    """One rank's share of an element-partitioned run: its rank, the world
    size, its process group (None: the default group) and device, and the
    log of its all-reduces. `shard_sem_mesh` attaches the global mesh it
    split (`global_mesh`, on the host), from which the pressure
    preconditioner is built; rank r holds elements [r * nel / size,
    (r + 1) * nel / size)."""

    rank: int
    size: int
    device: torch.device
    backend: str
    group: Any = None
    log: CommLog = dataclasses.field(default_factory=CommLog, repr=False)
    global_mesh: Any = dataclasses.field(default=None, repr=False)

    @property
    def is_root(self) -> bool:
        return self.rank == 0

    @property
    def capturable(self) -> bool:
        """Whether a CUDA graph can capture this group's all-reduce (NCCL's;
        gloo stages every collective through the host)."""
        return self.backend == "nccl"

    def block(self, n: int) -> tuple[int, int]:
        """[start, stop) of this rank's block of an axis of n elements."""
        if n % self.size != 0:
            raise ValueError(f"element count {n} is not divisible by the device count "
                             f"{self.size}; pick a divisor device count or pad the mesh")
        nl = n // self.size
        return self.rank * nl, (self.rank + 1) * nl

    def all_reduce(self, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """Sums (or takes the min or max of) t across the ranks, in place, and
        returns it: the one place where the port's all-reduces run and are
        logged."""
        self.log.add(1, t.numel() * t.element_size(), {t.numel(): 1})
        dist.all_reduce(t, op=getattr(dist.ReduceOp, op.upper()), group=self.group)
        return t

    def broadcast(self, t: torch.Tensor, src: int) -> torch.Tensor:
        """Rank src's t on every rank, in place (gathering for files only;
        logged beside the all-reduces)."""
        self.log.add(1, t.numel() * t.element_size(), {t.numel(): 1})
        dist.broadcast(t, src=dist.get_global_rank(self.group, src) if self.group else src,
                       group=self.group)
        return t

    def all_reduce_many(self, *ts: torch.Tensor) -> list[torch.Tensor]:
        """Sums of several tensors of one dtype in ONE all-reduce: flattened,
        packed, summed and split again."""
        flat = self.all_reduce(torch.cat([t.reshape(-1) for t in ts]))
        return [p.view(t.shape) for p, t in zip(flat.split([t.numel() for t in ts]), ts)]

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        """A summed copy of t across the ranks, through autograd (its backward
        is the same sum)."""
        return _AllReduceSum.apply(t, self)

    def from_root(self, value: float) -> float:
        """Rank 0's number on every rank (a host decision, such as whether a
        file exists or which counter a file takes, taken once for all)."""
        t = torch.tensor([float(value) if self.is_root else 0.0], dtype=torch.float64,
                         device=self.device)
        return float(self.all_reduce(t).item())


def global_sum(part: Partition | None, t: torch.Tensor) -> torch.Tensor:
    """t summed across the ranks of `part` (t itself in one process)."""
    return t if part is None else part.sum(t)


# ---------------------------------------------------------------------------
# process groups
# ---------------------------------------------------------------------------


def _default_device(backend: str) -> torch.device:
    if not torch.cuda.is_available():
        raise RuntimeError(f"no CUDA card for the {backend} group: pass device='cpu' "
                           "(with backend='gloo') to run the ranks on the CPU")
    return torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))


def make_device_mesh(n_devices: int | None = None, device=None, group=None) -> Partition:
    """This rank's `Partition` of the initialized process group (the
    reference's one-axis 'e' mesh). n_devices: asserted equal to the
    group's size. device: None is `cuda:{LOCAL_RANK}`, the card that
    `torchrun` gives this rank."""
    if not dist.is_initialized():
        raise RuntimeError("make_device_mesh: no process group (call init_distributed first)")
    size = dist.get_world_size(group)
    if n_devices is not None and n_devices != size:
        raise ValueError(f"make_device_mesh: {n_devices} devices asked, the group has {size}")
    backend = str(dist.get_backend(group)).lower()
    device = _default_device(backend) if device is None else torch.device(device)
    return Partition(rank=dist.get_rank(group), size=size, device=device, backend=backend,
                     group=group)


def init_distributed(backend: str | None = None, init_method: str | None = None,
                     world_size: int | None = None, rank: int | None = None, device=None,
                     timeout: float | None = None) -> Partition:
    """Start this rank's process group and return its `Partition`.

    backend: "nccl" by default (one rank per card); "gloo" runs any number
    of ranks on the CPU, or on one shared card (its CUDA all-reduce is
    staged through the host). init_method, world_size, rank: as
    `torch.distributed.init_process_group` takes them; None reads the
    `torchrun` environment (`env://`: RANK, WORLD_SIZE, MASTER_ADDR,
    MASTER_PORT). device: None is `cuda:{LOCAL_RANK}`; without a card that
    raises: nothing runs on the CPU unless the caller asks for it, and
    nothing replaces NCCL by gloo. timeout: seconds a collective may wait
    (a rank that fails then fails the others instead of hanging them)."""
    backend = (backend or "nccl").lower()
    device = _default_device(backend) if device is None else torch.device(device)
    if backend == "nccl":
        if device.type != "cuda":
            raise ValueError(f"the nccl backend runs on a CUDA card, not on {device}")
        torch.cuda.set_device(device)
    kw = {}
    if timeout is not None:
        kw["timeout"] = datetime.timedelta(seconds=timeout)
    if backend == "nccl":
        kw["device_id"] = device  # the communicator is made now, before any capture
    dist.init_process_group(backend=backend, init_method=init_method or "env://",
                            world_size=-1 if world_size is None else world_size,
                            rank=-1 if rank is None else rank, **kw)
    return make_device_mesh(device=device)


# ---------------------------------------------------------------------------
# sharding and gathering
# ---------------------------------------------------------------------------


def _exchange_plan(gidx_global: np.ndarray, part: Partition):
    """(slot, src, remap, n): the interface DOFs (those with copies on more
    than one rank) in one global order, this rank's flat positions of one
    copy of each of its interface DOFs (src) with their slots, and the
    index that maps [local sums, summed interface buffer] back onto every
    local flat position (remap). gidx_global: [pts..., nel] global ids."""
    npts = int(np.prod(gidx_global.shape[:-1]))
    g = gidx_global.reshape(npts, -1)
    nel = g.shape[1]
    e0, e1 = part.block(nel)
    owner = np.broadcast_to(np.arange(nel) // (e1 - e0), g.shape)
    pairs = np.unique(np.stack([g.reshape(-1), owner.reshape(-1)], 1), axis=0)
    dofs, counts = np.unique(pairs[:, 0], return_counts=True)
    iface = dofs[counts > 1]  # sorted: the buffer's order, the same on every rank
    local = g[:, e0:e1].reshape(-1)  # this rank's flat positions, element-last
    pos = np.flatnonzero(np.isin(local, iface))
    slots = np.searchsorted(iface, local[pos])
    first = np.unique(slots, return_index=True)[1]
    remap = np.arange(local.size)
    remap[pos] = local.size + slots
    return slots[first], pos[first], remap, len(iface)


def shard_sem_mesh(mesh, dmesh: Partition):
    """This rank's block of the global SemMesh, on the rank's device.

    mesh: the global mesh, best built on the host (device='cpu'): it is
    kept there (moved there otherwise), so that no rank's device holds it.
    Element-local fields are sliced to the block (`_SEM_MESH_AXES`);
    `volume`, the global-DOF masks and the basis stay whole, as the
    reference leaves them unsharded (the global-DOF arrays on the host,
    `_HOST_FIELDS`). The local mesh gets its own
    `dss_copies`, the exchange plan of its interface DOFs, and a
    `Partition` that keeps the global mesh on the host
    (`build_e_preconditioner` builds from it there). Raises when the
    element count is not divisible by the world size."""
    from ..mesh.core import _dss_copies

    e0, e1 = dmesh.block(mesh.nel)
    if mesh.device.type != "cpu":
        mesh = mesh.to("cpu")
    part = dataclasses.replace(dmesh, global_mesh=mesh)
    upd = {}
    for name, axis in _SEM_MESH_AXES.items():
        val = getattr(mesh, name)
        if val is None:
            continue
        upd[name] = val if axis is None else val[..., e0:e1].contiguous()
    gidx = mesh.gidx.cpu().numpy()
    slot, src, remap, n = _exchange_plan(gidx, part)
    as_t = lambda a: torch.as_tensor(np.ascontiguousarray(a), dtype=torch.int64)
    local = dataclasses.replace(
        mesh, nel=e1 - e0, **upd, dss_copies=as_t(_dss_copies(gidx[..., e0:e1])),
        xch_slot=as_t(slot), xch_src=as_t(src), xch_remap=as_t(remap), xch_n=n, part=part)
    local = local.to(part.device)
    return dataclasses.replace(local, **{k: getattr(mesh, k) for k in _HOST_FIELDS})


def shard_field(f, part: Partition, elem_axis: int = -1) -> torch.Tensor:
    """This rank's block of a global field (tensor or array) along its
    element axis, on the rank's device."""
    f = torch.as_tensor(np.asarray(f)) if not isinstance(f, torch.Tensor) else f
    e0, e1 = part.block(f.shape[elem_axis])
    return f.narrow(elem_axis, e0, e1 - e0).contiguous().to(part.device)


def shard_flow_state(state, part: Partition):
    """A FlowState or PertState (global, any device) with every field that
    carries the element axis cut to this rank's block, on its device."""
    upd = {}
    for f in dataclasses.fields(state):
        axis = _FLOW_STATE_AXES.get(f.name)
        if axis is not None:
            upd[f.name] = shard_field(getattr(state, f.name), part, axis)
    return dataclasses.replace(state, **upd)


def gather_field(f, part: Partition | None, elem_axis: int = -1):
    """The global field of which every rank holds its block f (a tensor or a
    numpy array, complex too), on rank 0's host: the counterpart of
    `np.asarray` on a sharded array, for the files rank 0 writes. Every
    rank must call it; the other ranks get None. Each rank's block reaches
    rank 0 in one broadcast of a block-sized buffer (gathering is not on
    the solve path), so no rank's device holds more than one block more.
    A tensor comes back as a CPU tensor, an array as an array; a 0-d
    tensor (a replicated scalar, the period of an orbit) as it is; with
    part None, f itself."""
    if part is None:
        return f
    if not isinstance(f, torch.Tensor):
        arr = np.asarray(f)
        if np.iscomplexobj(arr):
            re = gather_field(np.ascontiguousarray(arr.real), part, elem_axis)
            im = gather_field(np.ascontiguousarray(arr.imag), part, elem_axis)
            return None if re is None else re + 1j * im
        out = gather_field(torch.as_tensor(arr), part, elem_axis)
        return None if out is None else out.numpy()
    if f.dim() == 0:
        return f.cpu() if part.is_root else None
    f = f.detach().contiguous().to(part.device)
    blocks = []
    for r in range(part.size):
        buf = f if r == part.rank else torch.empty_like(f)
        if f.numel():
            part.broadcast(buf, r)
        if part.is_root:
            blocks.append(buf.cpu())
    return torch.cat(blocks, dim=elem_axis) if part.is_root else None


def gather_state(state, part: Partition | None):
    """`gather_field` of every element-axis field of a FlowState/PertState
    (the whole fields on rank 0's host, None on the other ranks)."""
    if part is None:
        return state
    upd = {f.name: gather_field(getattr(state, f.name), part, axis)
           for f in dataclasses.fields(state)
           if (axis := _FLOW_STATE_AXES.get(f.name)) is not None}
    return dataclasses.replace(state, **upd)
