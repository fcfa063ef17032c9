"""Curved annular (O-grid) meshes: cylinder-in-crossflow and thermosyphon.

Structured polar mesh (nel_r radial x nel_t angular elements, periodic in
the angle) with exact circular-arc element geometry: the GLL nodes are
placed by the polar map, so the curvature is represented to the full
polynomial order. Radial element edges take a geometric grading that
clusters resolution at the cylinder. Counterpart of
`neklab_tpu.mesh.cylinder` (the same numpy arithmetic), finished by the
port's `build_mesh`.

BCs: the inner circle is a wall ('W'); the outer circle is a wall too
(thermosyphon annulus, 'W') or split into upstream inflow 'v' and downstream
outflow 'O' at x = 0 (cylinder in a free stream, 'vO'), where the pressure
is pinned.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.basis import make_basis
from ..ops.geometry import compute_geom
from .core import SemMesh, build_mesh, resolve_device


def annulus_mesh(
    nel_r: int,
    nel_t: int,
    r_in: float = 0.5,
    r_out: float = 10.0,
    order: int = 6,
    grading: float = 1.3,
    outer_bc: str = "W",
    bc_temp: tuple[str, str] | None = None,
    dealias_order: int | None = None,
    shift: float = 0.0,
    dtype=torch.float64,
    device=None,
) -> SemMesh:
    """Build an annular SemMesh.

    grading: ratio between consecutive radial element sizes (> 1 clusters at
    the inner circle). outer_bc: 'W' (annulus) or 'vO' (upstream Dirichlet
    inflow + downstream outflow, split at x = 0).
    bc_temp: optional ('t'|'I', 't'|'I') temperature BCs for (inner, outer).
    shift: downstream skewing of the O-grid (the fraction of r_out by which
    the outer rings move in +x), clustering resolution in the wake.
    dtype, device: every mesh tensor is created with them; device None is
    the current CUDA card, and raises where there is none (pass "cpu")."""
    device = resolve_device(device)
    n = order + 1
    nd = dealias_order + 1 if dealias_order is not None else None
    basis = make_basis(n, nd)

    # radial element edges with geometric grading
    if abs(grading - 1.0) < 1e-12:
        widths = np.ones(nel_r)
    else:
        widths = grading ** np.arange(nel_r)
    widths = widths / widths.sum() * (r_out - r_in)
    redges = np.concatenate([[r_in], r_in + np.cumsum(widths)])
    tedges = np.linspace(0.0, 2 * np.pi, nel_t + 1)

    z01 = (basis.z + 1.0) / 2.0
    # per-element GLL coordinates in (r, theta)
    rg = redges[:-1, None] + z01[None, :] * np.diff(redges)[:, None]  # [nel_r, n]
    tg = tedges[:-1, None] + z01[None, :] * np.diff(tedges)[:, None]  # [nel_t, n]

    nel = nel_r * nel_t
    # element (et, er): index e = et * nel_r + er; axes [e, s=theta, r=radial]
    r_full = np.broadcast_to(rg[None, :, None, :], (nel_t, nel_r, n, n))
    t_full = np.broadcast_to(tg[:, None, :, None], (nel_t, nel_r, n, n))
    frac = (r_full - r_in) / (r_out - r_in)
    xshift = shift * r_out * frac**2
    x = np.stack([r_full * np.cos(t_full) + xshift, r_full * np.sin(t_full)], axis=0)
    x = x.reshape(2, nel, n, n)

    # structured numbering: radial nodes npr = nel_r*(n-1)+1 (not periodic),
    # angular nel_t*(n-1) (periodic)
    npr = nel_r * (n - 1) + 1
    gr = np.arange(nel_r)[:, None] * (n - 1) + np.arange(n)[None, :]  # [nel_r, n]
    gt = (np.arange(nel_t)[:, None] * (n - 1) + np.arange(n)[None, :]) % (nel_t * (n - 1))
    gidx = (
        np.broadcast_to(gt[:, None, :, None], (nel_t, nel_r, n, n)) * npr
        + np.broadcast_to(gr[None, :, None, :], (nel_t, nel_r, n, n))
    ).reshape(nel, n, n)
    _, gidx = np.unique(gidx, return_inverse=True)
    gidx = gidx.reshape(nel, n, n)

    full = (nel_t, nel_r, n, n)
    vmask = np.ones((2,) + full)
    pmask = np.ones(full)
    tmask = np.ones(full)

    # inner wall: er == 0, radial node index 0 (last axis)
    vmask[:, :, 0, :, 0] = 0.0
    if bc_temp and bc_temp[0].lower() == "t":
        tmask[:, 0, :, 0] = 0.0

    # outer boundary: er == nel_r-1, radial node -1
    if outer_bc == "W":
        vmask[:, :, -1, :, -1] = 0.0
        if bc_temp and bc_temp[1].lower() == "t":
            tmask[:, -1, :, -1] = 0.0
    elif outer_bc == "vO":
        upstream = np.cos(t_full[:, -1, :, -1]) < 0.0  # x < 0: inflow
        for c in range(2):
            vmask[c, :, -1, :, -1] = np.where(upstream, 0.0, 1.0)
        pmask[:, -1, :, -1] = np.where(upstream, 1.0, 0.0)  # p pinned at the outflow
    else:
        raise ValueError(outer_bc)

    geom = compute_geom(x, basis)
    bc_meta = (
        ("inner", "W"),
        ("outer", outer_bc),
        ("__struct__", f"{nel_t},{nel_r},1,0"),  # theta periodic, r not
    )
    return build_mesh(geom, basis, gidx, vmask.reshape(2, nel, n, n), pmask.reshape(nel, n, n),
                      tmask.reshape(nel, n, n), bc=bc_meta, dtype=dtype, device=device)
