"""Krylov vector spaces over SEM flow fields.

The stability-analysis vector is {u: [ndim, pts..., nel], theta: [nscal,
pts..., nel]}; pressure and time-integration history are not part of it
(the propagator is self-starting). dot: the mass-weighted inner product over
u and theta. rand: Gaussian noise made C0-conforming and BC-compliant. The
extended space adds the period T of a periodic orbit: {u, theta, T}.
"""

from __future__ import annotations

import torch

from .krylov.space import VectorSpace
from .mesh.core import SemMesh
from .ops import sem
from .parallel.sharding import global_sum, shard_field


def flow_vector(mesh: SemMesh, nscal: int, u=None, theta=None) -> dict:
    shape = tuple(mesh.bm1.shape)
    if u is None:
        u = torch.zeros((mesh.ndim,) + shape, dtype=mesh.dtype, device=mesh.device)
    if theta is None:
        theta = torch.zeros((nscal,) + shape, dtype=mesh.dtype, device=mesh.device)
    return {"u": u, "theta": theta}


def project_c0(mesh: SemMesh, vec: dict) -> dict:
    """Make a vector admissible: C0-continuous and BC-masked."""
    out = dict(vec)
    out["u"] = mesh.vmask * sem.dsavg(mesh, vec["u"])
    out["theta"] = mesh.tmask * sem.dsavg(mesh, vec["theta"])
    return out


def flow_vector_space(mesh: SemMesh, nscal: int) -> VectorSpace:
    """dot_fn contracts the trailing field axes (component, points, element),
    so a stacked basis [k, ...] against one vector gives its k Gram entries.

    rand_fn draws from a seeded generator on the host and moves the result
    to the mesh's device, so the card and the CPU start from one vector. On
    a rank's block of a partitioned mesh, dot_fn sums across the ranks in
    one all-reduce per call (one per stacked Gram vector), and rand_fn draws
    the whole global field on the host and moves only the rank's block to
    its device, so a run over P ranks starts from the vector one process
    draws."""
    nfield = mesh.ndim + 2  # component axis + point axes + element axis
    part = mesh.part

    def dot_fn(x, y):
        su = (x["u"] * y["u"] * mesh.bm1).flatten(-nfield).sum(-1)
        st = (x["theta"] * y["theta"] * mesh.bm1).flatten(-nfield).sum(-1)
        return global_sum(part, su + st)

    def rand_fn(seed: int):
        gen = torch.Generator()
        gen.manual_seed(int(seed))
        shape = tuple(mesh.bm1.shape)
        if part is not None:
            shape = shape[:-1] + (shape[-1] * part.size,)
        u = torch.randn((mesh.ndim,) + shape, generator=gen, dtype=mesh.dtype)
        theta = torch.randn((nscal,) + shape, generator=gen, dtype=mesh.dtype)
        if part is None:
            u, theta = u.to(mesh.device), theta.to(mesh.device)
        else:
            u, theta = (shard_field(f, part) for f in (u, theta))
        return project_c0(mesh, {"u": u, "theta": theta})

    return VectorSpace(dot_fn=dot_fn, rand_fn=rand_fn, part=part)


def ext_flow_vector(mesh: SemMesh, nscal: int, u=None, theta=None, T=0.0) -> dict:
    """{u, theta, T}: a flow vector extended by a period T (a 0-d tensor on
    the mesh's device), the unknowns of a periodic orbit."""
    v = flow_vector(mesh, nscal, u, theta)
    v["T"] = torch.as_tensor(T, dtype=mesh.dtype, device=mesh.device).clone()
    return v


def ext_flow_vector_space(mesh: SemMesh, nscal: int) -> VectorSpace:
    """flow_vector_space's dot plus T * T; rand also draws a standard normal T."""
    base = flow_vector_space(mesh, nscal)

    def dot_fn(x, y):
        return base.dot_fn(x, y) + x["T"] * y["T"]  # T is the same on every rank

    def rand_fn(seed: int):
        v = base.rand_fn(seed)
        gen = torch.Generator()
        gen.manual_seed(int(seed) + 1)
        v["T"] = torch.randn((), generator=gen, dtype=mesh.dtype).to(mesh.device)
        return v

    return VectorSpace(dot_fn=dot_fn, rand_fn=rand_fn, part=base.part)


def get_size(mesh: SemMesh, nscal: int, extended: bool = False) -> int:
    """Active DOF count: (ndim + nscal) fields of bm1's size (the global
    mesh's, on a rank's block), + 1 for T."""
    n = (mesh.ndim + nscal) * int(mesh.bm1.numel()) * (1 if mesh.part is None else mesh.part.size)
    return n + 1 if extended else n
