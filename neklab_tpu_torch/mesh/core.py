"""SEM mesh container on one torch device.

`SemMesh` bundles everything the operators need: geometric factors, the
gather-scatter numbering, multiplicity weights and the Dirichlet masks, all
as tensors on ONE device. It mirrors `neklab_tpu.mesh.core.SemMesh` field by
field (without the reference's face-pair and roll exchange schedules: the
port's gather-scatter is one gather form for every mesh), plus the 1-D basis
matrices the operators contract with and the gather table of `sem.dssum`,
kept on the device so no operator copies them from the host per call.

Layout: element-LAST (`[..., pts..., nel]`), as in the reference.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ops.basis import Basis, make_basis
from ..ops.geometry import GeomFactors

# Tensor fields shared with the reference SemMesh (same names, same layouts);
# `mesh_from_arrays` takes exactly these.
MESH_FIELDS = (
    "x", "jac", "rx", "bm1", "g", "xd", "rxd", "bmd", "bm2", "binv",
    "gidx", "gfirst", "vmult", "vmask", "pmask", "tmask", "vmask_hat",
    "tmask_hat", "volume",
)
_INT_FIELDS = ("gidx", "gfirst")


@dataclasses.dataclass(frozen=True)
class SemMesh:
    basis: Basis
    ndim: int
    nel: int
    nglob: int
    bc: tuple  # (name, value) pairs; carries the structured-grid metadata
    x: torch.Tensor  # [ndim, pts..., nel]
    jac: torch.Tensor  # [pts..., nel]
    rx: torch.Tensor  # [ndim, ndim, pts..., nel]
    bm1: torch.Tensor  # [pts..., nel]
    g: torch.Tensor  # [ndim, ndim, pts..., nel]
    xd: torch.Tensor  # [ndim, ptsd..., nel]
    rxd: torch.Tensor  # [ndim, ndim, ptsd..., nel]
    bmd: torch.Tensor  # [ptsd..., nel]
    bm2: torch.Tensor  # [pts2..., nel] pressure-grid mass
    binv: torch.Tensor  # [pts..., nel] inverse assembled mass, per copy
    gidx: torch.Tensor  # int64 [pts..., nel] global DOF ids
    gfirst: torch.Tensor  # int64 [nglob] flat position of one copy of each DOF
    vmult: torch.Tensor  # [pts..., nel] 1/multiplicity
    vmask: torch.Tensor  # [ndim, pts..., nel]
    pmask: torch.Tensor  # [pts..., nel]
    tmask: torch.Tensor  # [pts..., nel]
    vmask_hat: torch.Tensor  # [ndim, nglob]
    tmask_hat: torch.Tensor  # [nglob]
    volume: torch.Tensor  # scalar
    # 1-D basis matrices in the compute dtype, on the mesh's device
    d: torch.Tensor  # [n, n] GLL derivative
    jd: torch.Tensor  # [nd, n] GLL -> dealias interpolation
    j12: torch.Tensor  # [n-2, n] GLL -> pressure-grid interpolation
    # int64 [npts*nel, maxmult]: flat positions of every copy of the DOF at
    # each flat position, padded with npts*nel (a zero slot), for `sem.dssum`
    dss_copies: torch.Tensor
    # int64 [nel]: the element permutation of a builder that reordered the
    # elements (RCB, `mesh_from_re2(partition=)`): arr_here =
    # arr_file_order[..., eperm]. None is the identity.
    eperm: torch.Tensor | None = None

    @property
    def npts(self) -> int:
        return self.basis.n**self.ndim

    @property
    def p_fixed(self) -> bool:
        """True when the pressure problem is pure Neumann (constant nullspace)."""
        return ("__pure_neumann__", "1") in self.bc

    @property
    def device(self) -> torch.device:
        return self.bm1.device

    @property
    def dtype(self) -> torch.dtype:
        return self.bm1.dtype

    def to(self, device) -> "SemMesh":
        """The same mesh with every tensor on `device`."""
        moved = {
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self)
            if isinstance(getattr(self, f.name), torch.Tensor)
        }
        return dataclasses.replace(self, **moved)


def resolve_device(device) -> torch.device:
    """`device`, or the current CUDA card when it is None. The port runs on
    the card unless the caller asks for the CPU: without a card, None raises
    and never falls back."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA card: pass device='cpu' to build the mesh on the CPU")
    return torch.device("cuda", torch.cuda.current_device())


def _dss_copies(gidx: np.ndarray) -> np.ndarray:
    """Gather table of the direct-stiffness sum: row i lists the flat
    positions of all copies of DOF gidx[i], padded with gidx.size."""
    g = gidx.reshape(-1)
    order = np.argsort(g, kind="stable")
    counts = np.bincount(g)
    starts = np.cumsum(counts) - counts
    rank = np.arange(g.size) - starts[g[order]]  # copy number within its DOF
    copies = np.full((counts.size, counts.max()), g.size, np.int64)
    copies[g[order], rank] = order
    return copies[g]


def _basis_tensors(basis: Basis, dtype, device) -> dict:
    cast = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype, device=device)
    return dict(d=cast(basis.d), jd=cast(basis.jd), j12=cast(basis.j12))


def build_mesh(
    geom: GeomFactors,
    basis: Basis,
    gidx: np.ndarray,
    vmask: np.ndarray,
    pmask: np.ndarray,
    tmask: np.ndarray | None = None,
    bc: tuple = (),
    dtype=torch.float64,
    device=None,
    eperm: np.ndarray | None = None,
) -> SemMesh:
    """Finalize host-side geometry + connectivity into a device SemMesh.

    Inputs use the builder's ELEMENT-FIRST layout ([.., nel, pts..]); the
    stored tensors are ELEMENT-LAST ([.., pts.., nel]). Same numpy
    arithmetic as the reference builder. device: None is the current CUDA
    card (`resolve_device`). eperm: the builder's element permutation, if
    it reordered the elements (`SemMesh.eperm`)."""
    device = resolve_device(device)
    nel = geom.x.shape[1]
    gidx = np.asarray(gidx, dtype=np.int64)
    nglob = int(gidx.max()) + 1

    cnt = np.zeros(nglob)
    np.add.at(cnt, gidx.reshape(-1), np.ones(gidx.size))
    vmult = (1.0 / cnt)[gidx.reshape(-1)].reshape(gidx.shape)

    if tmask is None:
        tmask = np.ones_like(pmask)

    bsum = np.zeros(nglob)
    np.add.at(bsum, gidx.reshape(-1), geom.bm1.reshape(-1))
    binv = (1.0 / bsum)[gidx.reshape(-1)].reshape(gidx.shape)

    # global-DOF masks (min over copies: Dirichlet wins at shared nodes),
    # scattered back so every element copy of a DOF carries the same mask
    ndim = geom.ndim
    vmask_hat = np.ones((ndim, nglob))
    for c in range(ndim):
        np.minimum.at(vmask_hat[c], gidx.reshape(-1), vmask[c].reshape(-1))
    tmask_hat = np.ones(nglob)
    np.minimum.at(tmask_hat, gidx.reshape(-1), tmask.reshape(-1))
    vmask = np.stack([vmask_hat[c][gidx] for c in range(ndim)])
    tmask = tmask_hat[gidx]

    pure_neumann = bool(np.all(pmask > 0.5))
    bc = tuple(bc) + ((("__pure_neumann__", "1"),) if pure_neumann else ())

    def el_last(a: np.ndarray, nel_axis: int) -> np.ndarray:
        return np.ascontiguousarray(np.moveaxis(a, nel_axis, -1))

    gidx_el_last = np.moveaxis(gidx, 0, -1).reshape(-1)
    _, first_pos = np.unique(gidx_el_last, return_index=True)

    arrays = dict(
        x=el_last(geom.x, 1), jac=el_last(geom.jac, 0), rx=el_last(geom.rx, 2),
        bm1=el_last(geom.bm1, 0), g=el_last(geom.g, 2), xd=el_last(geom.xd, 1),
        rxd=el_last(geom.rxd, 2), bmd=el_last(geom.bmd, 0), bm2=el_last(geom.bm2, 0),
        binv=el_last(binv, 0), gidx=el_last(gidx, 0), gfirst=first_pos,
        vmult=el_last(vmult, 0), vmask=el_last(vmask, 1), pmask=el_last(pmask, 0),
        tmask=el_last(tmask, 0), vmask_hat=vmask_hat, tmask_hat=tmask_hat,
        volume=np.asarray(geom.bm1.sum()),
    )
    if eperm is not None:
        arrays["eperm"] = np.asarray(eperm, np.int64)
    meta = dict(n=basis.n, nd=basis.nd, ndim=ndim, nel=nel, nglob=nglob, bc=bc)
    return mesh_from_arrays(arrays, meta, dtype=dtype, device=device)


def mesh_from_arrays(arrays: dict, meta: dict, dtype=torch.float64, device=None) -> SemMesh:
    """Build a SemMesh from numpy arrays of the reference mesh's fields.

    arrays: {name: np.ndarray} for every name in MESH_FIELDS, in the
    reference's element-last layouts (e.g. `np.asarray(jax_mesh.bm1)`), and
    optionally "eperm".
    meta: {"n", "nd", "ndim", "nel", "nglob", "bc"} — the reference's static
    metadata (basis.n, basis.nd, ndim, nel, nglob, bc). This carries a mesh
    the port cannot build itself yet (e.g. the annulus) across unchanged.
    device: None is the current CUDA card (`resolve_device`)."""
    device = resolve_device(device)
    missing = [k for k in MESH_FIELDS if k not in arrays]
    if missing:
        raise ValueError(f"mesh_from_arrays: missing fields {missing}")
    basis = make_basis(int(meta["n"]), int(meta["nd"]))
    tensors = {}
    for k in MESH_FIELDS:
        a = np.array(arrays[k], dtype=np.int64 if k in _INT_FIELDS else None)  # a copy
        dt = torch.int64 if k in _INT_FIELDS else dtype
        tensors[k] = torch.as_tensor(a, dtype=dt, device=device)
    return SemMesh(
        basis=basis,
        ndim=int(meta["ndim"]),
        nel=int(meta["nel"]),
        nglob=int(meta["nglob"]),
        bc=tuple(tuple(p) for p in meta["bc"]),
        **tensors,
        **_basis_tensors(basis, dtype, device),
        dss_copies=torch.as_tensor(_dss_copies(np.asarray(arrays["gidx"])), device=device),
        eperm=(None if arrays.get("eperm") is None
               else torch.as_tensor(np.asarray(arrays["eperm"], np.int64), device=device)),
    )


def from_file_order(mesh: SemMesh, arr):
    """Map an element-LAST array in FILE (.re2/.fld) element order onto this
    mesh's element order (the identity unless the mesh was built with RCB
    reordering). A tensor stays on its device; anything else becomes a
    tensor on the mesh's device."""
    if not isinstance(arr, torch.Tensor):
        arr = torch.as_tensor(np.asarray(arr), device=mesh.device)
    if mesh.eperm is None:
        return arr
    return arr.index_select(-1, mesh.eperm.to(arr.device))
