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
    so a stacked basis [k, ...] against one vector gives its k Gram entries."""
    nfield = mesh.ndim + 2  # component axis + point axes + element axis

    def dot_fn(x, y):
        su = (x["u"] * y["u"] * mesh.bm1).flatten(-nfield).sum(-1)
        st = (x["theta"] * y["theta"] * mesh.bm1).flatten(-nfield).sum(-1)
        return su + st

    def rand_fn(seed: int):
        gen = torch.Generator(device=mesh.device)
        gen.manual_seed(int(seed))
        shape = tuple(mesh.bm1.shape)
        kw = dict(generator=gen, dtype=mesh.dtype, device=mesh.device)
        u = torch.randn((mesh.ndim,) + shape, **kw)
        theta = torch.randn((nscal,) + shape, **kw)
        return project_c0(mesh, {"u": u, "theta": theta})

    return VectorSpace(dot_fn=dot_fn, rand_fn=rand_fn)


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
        return base.dot_fn(x, y) + x["T"] * y["T"]

    def rand_fn(seed: int):
        v = base.rand_fn(seed)
        gen = torch.Generator(device=mesh.device)
        gen.manual_seed(int(seed) + 1)
        v["T"] = torch.randn((), generator=gen, dtype=mesh.dtype, device=mesh.device)
        return v

    return VectorSpace(dot_fn=dot_fn, rand_fn=rand_fn)


def get_size(mesh: SemMesh, nscal: int, extended: bool = False) -> int:
    """Active DOF count: (ndim + nscal) fields of bm1's size, + 1 for T."""
    n = (mesh.ndim + nscal) * int(mesh.bm1.numel())
    return n + 1 if extended else n
