"""Structured box mesh generator (2-D / 3-D) with BC masks.

Replaces the reference stack's `genbox` + `genmap` tools (SURVEY section 2.2).
Supports per-dimension element-edge grading, periodic dimensions, and an
optional pointwise coordinate deformation (stretched channels, wavy walls),
which keeps the structured connectivity valid.

BC characters follow Nek5000 conventions (e.g.
the reference neklab examples/poiseuille cases):
  'W'   wall            — velocity Dirichlet (all components)
  'v'   inflow          — velocity Dirichlet (values supplied by the case)
  'O'   outflow         — natural BC for velocity, p = 0 for pressure
  'SYM' symmetry        — normal velocity component Dirichlet
  'P'   periodic        — must be set on both faces of the dimension
Temperature BCs via `bc_temp`: 't' Dirichlet, 'I' insulated (natural).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.basis import make_basis
from ..ops.geometry import compute_geom
from .core import SemMesh, build_mesh, resolve_device

_FACES_2D = ("x-", "x+", "y-", "y+")
_FACES_3D = _FACES_2D + ("z-", "z+")


def _face_dim_side(face: str) -> tuple[int, int]:
    d = {"x": 0, "y": 1, "z": 2}[face[0]]
    side = 0 if face[1] == "-" else 1
    return d, side


def box_mesh(
    nels: tuple[int, ...],
    lims: tuple[tuple[float, float], ...],
    bc: dict[str, str],
    order: int = 5,
    dealias_order: int | None = None,
    edges: list[np.ndarray] | None = None,
    deform=None,
    bc_temp: dict[str, str] | None = None,
    dtype=torch.float64,
    device=None,
) -> SemMesh:
    """Build a box SemMesh.

    nels: elements per dimension (nelx, nely[, nelz]).
    lims: ((x0,x1), (y0,y1)[, (z0,z1)]).
    bc:   face -> BC char; periodic dims must have 'P' on both faces.
    order: polynomial order p (n = p+1 GLL points per direction).
    edges: optional per-dim arrays of element edge coordinates (grading).
    deform: optional fn(x: [ndim, nel, ...]) -> deformed coords.
    dtype, device: every mesh tensor is created with them; device None is
    the current CUDA card, and raises where there is none (pass "cpu").
    """
    device = resolve_device(device)
    ndim = len(nels)
    n = order + 1
    nd = dealias_order + 1 if dealias_order is not None else None
    basis = make_basis(n, nd)
    faces = _FACES_2D if ndim == 2 else _FACES_3D
    bc = dict(bc)
    bc_temp = dict(bc_temp or {})
    for f in faces:
        bc.setdefault(f, "W")

    periodic = []
    for d in range(ndim):
        lo, hi = bc[faces[2 * d]], bc[faces[2 * d + 1]]
        per = lo == "P" or hi == "P"
        if per and lo != hi:
            raise ValueError(f"periodic dim {d} needs 'P' on both faces")
        periodic.append(per)

    if edges is None:
        edges = [np.linspace(lims[d][0], lims[d][1], nels[d] + 1) for d in range(ndim)]
    else:
        edges = [np.asarray(e, dtype=np.float64) for e in edges]

    z01 = (basis.z + 1.0) / 2.0
    # per-dim, per-element GLL coordinates: cs[d][e_d, i_d]
    cs = [e[:-1, None] + z01[None, :] * np.diff(e)[:, None] for e in edges]

    nel = int(np.prod(nels))
    shape_el = tuple(nels[::-1])  # (nelz, nely, nelx)
    shape_nd = (n,) * ndim
    full = shape_el + shape_nd

    def _expand(arr_2d: np.ndarray, d: int) -> np.ndarray:
        """Broadcast a [nel_d, n] per-dim array to the full mesh shape."""
        sh = [1] * (2 * ndim)
        sh[ndim - 1 - d] = nels[d]
        sh[2 * ndim - 1 - d] = n
        return np.broadcast_to(arr_2d.reshape(sh), full)

    x = np.stack([_expand(cs[d], d) for d in range(ndim)], axis=0)

    # global numbering with periodic wrap
    npts_dim = [nels[d] * (n - 1) + (0 if periodic[d] else 1) for d in range(ndim)]
    strides = [int(np.prod(npts_dim[:d])) for d in range(ndim)]
    gidx = np.zeros(full, dtype=np.int64)
    for d in range(ndim):
        gi = np.arange(nels[d])[:, None] * (n - 1) + np.arange(n)[None, :]
        if periodic[d]:
            gi = gi % npts_dim[d]
        gidx += _expand(gi, d) * strides[d]

    # masks
    vmask = np.ones((ndim,) + full)
    pmask = np.ones(full)
    tmask = np.ones(full)

    def _face_sel(d: int, side: int):
        idx = [slice(None)] * (2 * ndim)
        idx[ndim - 1 - d] = -1 if side else 0
        idx[2 * ndim - 1 - d] = -1 if side else 0
        return tuple(idx)

    for f in faces:
        d, side = _face_dim_side(f)
        ch = bc[f]
        sel = _face_sel(d, side)
        if ch in ("W", "v"):
            for c in range(ndim):
                vmask[(c,) + sel] = 0.0
        elif ch == "SYM":
            vmask[(d,) + sel] = 0.0
        elif ch == "O":
            pmask[sel] = 0.0
        elif ch in ("P", "E"):
            pass
        else:
            raise ValueError(f"unknown velocity BC {ch!r} on face {f}")
        if bc_temp.get(f, "I").lower() == "t":
            tmask[sel] = 0.0

    x = x.reshape(ndim, nel, *shape_nd)
    if deform is not None:
        x = np.asarray(deform(x), dtype=np.float64)
    gidx = gidx.reshape(nel, *shape_nd)
    # compact the numbering (periodic wrap can leave gaps)
    _, gidx = np.unique(gidx, return_inverse=True)
    gidx = gidx.reshape(nel, *shape_nd)
    vmask = vmask.reshape(ndim, nel, *shape_nd)
    pmask = pmask.reshape(nel, *shape_nd)
    tmask = tmask.reshape(nel, *shape_nd)

    geom = compute_geom(x, basis)
    bc_meta = tuple(sorted(bc.items())) + tuple(sorted(("T:" + k, v) for k, v in bc_temp.items()))
    bc_meta = bc_meta + (("__box__", "x".join(str(v) for v in nels)),)
    # structured-dssum metadata: element-grid shape leading-dim first
    # (matching the C-ordered flat element axis) + per-direction periodicity
    rev = list(range(ndim))[::-1]
    bc_meta = bc_meta + (
        (
            "__struct__",
            ",".join(str(nels[d]) for d in rev)
            + ","
            + ",".join(str(int(periodic[d])) for d in rev),
        ),
    )
    return build_mesh(geom, basis, gidx, vmask, pmask, tmask, bc=bc_meta, dtype=dtype,
                      device=device)
