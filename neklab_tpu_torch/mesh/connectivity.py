"""Global DOF numbering for conforming SEM meshes.

Counterpart of `neklab_tpu.mesh.connectivity` (host numpy, the same
arithmetic). `connectivity_from_coords` derives the gather-scatter numbering
from the GLL node coordinates alone: coincident nodes (within tol) get the
same global id. It stands in for Nek5000's `genmap` and gslib set-up for any
conforming mesh, curved ones included, as long as shared-face nodes agree
to ~1e-8 of the domain scale.

Robust clustering: each coordinate dimension is quantized by sorting all
values and starting a new cluster wherever the gap exceeds tol, so nodes that
straddle a naive rounding boundary still merge.
"""

from __future__ import annotations

import numpy as np


def _cluster_1d(vals: np.ndarray, tol: float) -> np.ndarray:
    """Map each value to a cluster id such that values within tol of each
    other (transitively) share an id."""
    order = np.argsort(vals, kind="stable")
    sorted_vals = vals[order]
    new_cluster = np.empty(len(vals), dtype=bool)
    new_cluster[0] = True
    new_cluster[1:] = np.diff(sorted_vals) > tol
    out = np.empty(len(vals), dtype=np.int64)
    out[order] = np.cumsum(new_cluster) - 1
    return out


def _number(pts: np.ndarray, tol: float) -> np.ndarray:
    keys = np.stack([_cluster_1d(pts[i], tol) for i in range(pts.shape[0])], axis=1)
    _, inverse = np.unique(keys, axis=0, return_inverse=True)
    return inverse.reshape(-1)


def connectivity_from_coords(x: np.ndarray, tol: float = 1e-8) -> np.ndarray:
    """x: [ndim, nel, ...] GLL coordinates -> gidx [nel, ...] int64 global ids
    numbered 0..nglob-1."""
    return _number(x.reshape(x.shape[0], -1), tol).reshape(x.shape[1:])


def merge_periodic(gidx: np.ndarray, x: np.ndarray, dim: int, length: float,
                   tol: float = 1e-8) -> np.ndarray:
    """Identify global ids of nodes at coordinate x[dim] == max with those at
    x[dim] == min (translated by `length`). Returns a renumbered gidx."""
    pts = x.reshape(x.shape[0], -1).copy()
    lo, hi = pts[dim].min(), pts[dim].max()
    if not np.isclose(hi - lo, length, atol=tol):
        raise ValueError(f"periodic dim {dim}: span {hi - lo} != length {length}")
    pts[dim] = np.where(pts[dim] > hi - tol, lo, pts[dim])
    return _number(pts, tol).reshape(gidx.shape)
