"""Backward-facing-step mesh (L-shaped multi-block domain).

Counterpart of `neklab_tpu.mesh.bfs`. Geometry (Nek5000's back_fstep case):
inflow channel of height 1 for x in [-li, 0], sudden expansion to height
1 + s for x in [0, lo]:

      y=1  +-----------------------------+
           |  inflow ->                  |
      y=0  +---------+                   | outflow
                     | step             |
      y=-s           +-------------------+
                    x=0                x=lo

Built as a union of conforming blocks; the global numbering comes from the
generic coordinate-clustering connectivity (`mesh/connectivity.py`). BCs:
'v' inflow at x=-li, 'O' outflow at x=lo, 'W' everywhere else.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.basis import make_basis
from ..ops.geometry import compute_geom
from .connectivity import connectivity_from_coords
from .core import SemMesh, build_mesh, resolve_device


def _block_coords(xs: np.ndarray, ys: np.ndarray, z01: np.ndarray):
    """Element-first coords [2, nel, n, n] for a tensor block with element
    edges xs, ys."""
    n = len(z01)
    nelx, nely = len(xs) - 1, len(ys) - 1
    cx = xs[:-1, None] + z01[None, :] * np.diff(xs)[:, None]  # [nelx, n]
    cy = ys[:-1, None] + z01[None, :] * np.diff(ys)[:, None]  # [nely, n]
    x = np.broadcast_to(cx[None, :, None, :], (nely, nelx, n, n))
    y = np.broadcast_to(cy[:, None, :, None], (nely, nelx, n, n))
    return np.stack([x, y], 0).reshape(2, nely * nelx, n, n)


def bfs_mesh(
    li: float = 5.0,
    lo: float = 15.0,
    step: float = 1.0,
    nel_li: int = 5,
    nel_lo: int = 15,
    nel_y_in: int = 3,
    nel_y_step: int = 3,
    order: int = 6,
    dtype=torch.float64,
    device=None,
) -> SemMesh:
    """Backward-facing step SemMesh. Channel height 1 upstream; step height
    `step` added below y=0 downstream. device: None is the current CUDA
    card, and raises where there is none (pass "cpu")."""
    device = resolve_device(device)
    n = order + 1
    basis = make_basis(n)
    z01 = (basis.z + 1.0) / 2.0

    xs_in = np.linspace(-li, 0.0, nel_li + 1)
    xs_out = np.linspace(0.0, lo, nel_lo + 1)
    ys_up = np.linspace(0.0, 1.0, nel_y_in + 1)
    ys_dn = np.linspace(-step, 0.0, nel_y_step + 1)

    # blocks: upstream channel, downstream upper, downstream lower
    x = np.concatenate([_block_coords(xs_in, ys_up, z01), _block_coords(xs_out, ys_up, z01),
                        _block_coords(xs_out, ys_dn, z01)], axis=1)  # [2, nel, n, n]
    nel = x.shape[1]

    scale = max(li + lo, 1.0 + step)
    tol = 1e-8 * scale
    gidx = connectivity_from_coords(x, tol=tol)

    # masks: Dirichlet velocity on all boundary nodes except the outflow
    vmask = np.ones((2, nel, n, n))
    pmask = np.ones((nel, n, n))
    tmask = np.ones((nel, n, n))
    xx, yy = x[0], x[1]
    on_boundary = (
        (np.abs(xx + li) < tol)
        | (np.abs(yy - 1.0) < tol)
        | ((np.abs(yy) < tol) & (xx < tol))  # upstream lower wall y=0, x<=0
        | ((np.abs(xx) < tol) & (yy < tol))  # step face x=0, y<=0
        | (np.abs(yy + step) < tol)  # downstream floor
    )
    for c in range(2):
        vmask[c][on_boundary] = 0.0
    pmask[np.abs(xx - lo) < tol] = 0.0  # the outflow: E is nonsingular

    geom = compute_geom(x, basis)
    bc_meta = (("inflow", "v"), ("outflow", "O"), ("walls", "W"))
    return build_mesh(geom, basis, gidx, vmask, pmask, tmask, bc=bc_meta, dtype=dtype,
                      device=device)


def bfs_inflow(mesh: SemMesh, dtype=None) -> torch.Tensor:
    """Parabolic inflow profile u = 4 y (1 - y) on the inlet channel,
    extended over the whole field (used only at Dirichlet nodes), in dtype
    (None: the mesh's)."""
    y = mesh.x[1] if dtype is None else mesh.x[1].to(dtype)
    prof = torch.where(y > 0.0, 4.0 * y * (1.0 - y), torch.zeros_like(y))
    return torch.stack([prof, torch.zeros_like(prof)])


# ---------------------------------------------------------------------------
# BC classification for Nek5000's rounded-BFS gmsh mesh (bfs.re2)
# ---------------------------------------------------------------------------

# cache_tag for mesh_from_re2 when using reference_bfs_bc; bump on any change
# to the classification so stale mesh-cache entries are invalidated.
REFERENCE_BFS_CACHE_TAG = "bfs-usrdat2-v2"


def reference_bfs_bc(c):
    """usrdat2-analog BC assignment for the gmsh-imported back_fstep
    `bfs.re2` (all of whose boundary faces ship as 'MSH' placeholders), by
    the Physical Curves of its bfs.geo:

      Inflow  (x = -20, y in [1, 20])           -> 'v'
      Outflow (x = 100, y in [0, 20])           -> 'O'
      Sym     = top (y = 20)  AND the upstream free-slip floor
                (y = 1, x in [-20, -2])         -> 'SYM'
      Wall    = flat plate (y = 1, x in [-2, 0]), rounded step arc,
                downstream floor (y = 0)        -> 'W'

    `c` is the face centroid."""
    if abs(c[0] - (-20.0)) < 1e-6:
        return "v"
    if abs(c[0] - 100.0) < 1e-6:
        return "O"
    if c[1] > 19.0:
        return "SYM"
    if abs(c[1] - 1.0) < 1e-6 and c[0] < -2.0:
        return "SYM"
    return "W"
