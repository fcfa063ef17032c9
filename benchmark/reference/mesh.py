"""Plain spectral-element box meshes: GLL quadrature, the 1-D basis, the
geometric factors and the gather-scatter numbering of a structured box with
periodic and wall faces, in numpy, moved to torch tensors at the end.

A frozen, self-contained copy of the plain code paths the benchmark's
configurations need (box meshes, element-last layout `[..., pts..., nel]`),
so the reference imports nothing of the program under test.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch


# ---------------------------------------------------------------------------
# quadrature and the 1-D basis
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def gll(n: int) -> tuple[np.ndarray, np.ndarray]:
    """n-point Gauss-Lobatto-Legendre nodes and weights on [-1, 1]."""
    x = -np.cos(np.pi * np.arange(n) / (n - 1))
    p = np.zeros((n, n))
    x_old = 2 * np.ones_like(x)
    while np.max(np.abs(x - x_old)) > 1e-15:
        x_old = x.copy()
        p[:, 0] = 1.0
        p[:, 1] = x
        for k in range(2, n):
            p[:, k] = ((2 * k - 1) * x * p[:, k - 1] - (k - 1) * p[:, k - 2]) / k
        x = x_old - (x * p[:, n - 1] - p[:, n - 2]) / (n * p[:, n - 1])
    w = 2.0 / (n * (n - 1) * p[:, n - 1] ** 2)
    x[0], x[-1] = -1.0, 1.0
    return 0.5 * (x - x[::-1]), 0.5 * (w + w[::-1])


def _bary(x: np.ndarray) -> np.ndarray:
    return np.array([1.0 / np.prod(x[j] - np.delete(x, j)) for j in range(len(x))])


def derivative_matrix(x: np.ndarray) -> np.ndarray:
    """D[i, j] = l_j'(x_i), with the negative-sum diagonal."""
    n, wb = len(x), _bary(x)
    d = np.zeros((n, n))
    for i in range(n):
        for j in range(n):
            if i != j:
                d[i, j] = (wb[j] / wb[i]) / (x[i] - x[j])
    d[np.arange(n), np.arange(n)] = -d.sum(axis=1)
    return d


def interp_matrix(x_from: np.ndarray, x_to: np.ndarray) -> np.ndarray:
    """I[i, j] = l_j(x_to[i])."""
    wb = _bary(x_from)
    out = np.zeros((len(x_to), len(x_from)))
    for i, xt in enumerate(x_to):
        diff = xt - x_from
        hit = np.abs(diff) < 1e-14
        if np.any(hit):
            out[i, np.argmax(hit)] = 1.0
        else:
            t = wb / diff
            out[i] = t / t.sum()
    return out


@dataclasses.dataclass(frozen=True)
class Basis1D:
    n: int  # GLL points per direction (order + 1)
    nd: int  # dealias (Gauss) points per direction
    z: np.ndarray
    w: np.ndarray
    d: np.ndarray  # [n, n]
    wd: np.ndarray
    jd: np.ndarray  # [nd, n] GLL -> dealias grid
    w2: np.ndarray
    j12: np.ndarray  # [n-2, n] GLL -> pressure (interior Gauss) grid


@functools.lru_cache(maxsize=None)
def basis(n: int) -> Basis1D:
    """The P(N)/P(N-2) basis with the 3/2-rule dealias grid."""
    nd = (3 * n + 1) // 2
    z, w = gll(n)
    zd, wd = np.polynomial.legendre.leggauss(nd)
    z2, w2 = np.polynomial.legendre.leggauss(n - 2)
    return Basis1D(n=n, nd=nd, z=z, w=w, d=derivative_matrix(z), wd=wd,
                   jd=interp_matrix(z, zd), w2=w2, j12=interp_matrix(z, z2))


# ---------------------------------------------------------------------------
# geometry (host, float64, element-first [.., nel, pts..])
# ---------------------------------------------------------------------------


def _along(a, u, axis):
    return np.moveaxis(np.tensordot(a, u, axes=(1, axis)), 0, axis)


def _weights(w: np.ndarray, ndim: int) -> np.ndarray:
    return np.einsum("s,r->sr", w, w) if ndim == 2 else np.einsum("t,s,r->tsr", w, w, w)


def _interp_all(j, u, ndim, first):
    for ax in range(first, first + ndim):
        u = _along(j, u, ax)
    return u


def _invert(dxdr: np.ndarray, ndim: int):
    """(jac, rx) with rx[i, j] = dr_i / dx_j."""
    if ndim == 2:
        xr, xs = dxdr[0]
        yr, ys = dxdr[1]
        jac = xr * ys - xs * yr
        inv = 1.0 / jac
        return jac, np.stack([np.stack([ys * inv, -xs * inv]), np.stack([-yr * inv, xr * inv])])
    xr, xs, xt = dxdr[0]
    yr, ys, yt = dxdr[1]
    zr, zs, zt = dxdr[2]
    jac = xr * (ys * zt - yt * zs) - xs * (yr * zt - yt * zr) + xt * (yr * zs - ys * zr)
    inv = 1.0 / jac
    rx = np.stack([
        np.stack([(ys * zt - yt * zs), -(xs * zt - xt * zs), (xs * yt - xt * ys)]),
        np.stack([-(yr * zt - yt * zr), (xr * zt - xt * zr), -(xr * yt - xt * yr)]),
        np.stack([(yr * zs - ys * zr), -(xr * zs - xs * zr), (xr * ys - xs * yr)]),
    ]) * inv
    return jac, rx


def geometry(x: np.ndarray, b: Basis1D) -> dict:
    """Geometric factors from GLL coordinates x [ndim, nel, pts...]."""
    ndim = x.shape[0]
    dxdr = np.stack([np.stack([_along(b.d, x[i], x[i].ndim - 1 - j) for j in range(ndim)])
                     for i in range(ndim)])
    jac, rx = _invert(dxdr, ndim)
    bm1 = jac * _weights(b.w, ndim)
    g = np.einsum("ak...,bk...->ab...", rx, rx) * bm1
    dxdr_d = np.stack([np.stack([_interp_all(b.jd, dxdr[i, j], ndim, 1) for j in range(ndim)])
                       for i in range(ndim)])
    jacd, rxd = _invert(dxdr_d, ndim)
    dxdr_2 = np.stack([np.stack([_interp_all(b.j12, dxdr[i, j], ndim, 1) for j in range(ndim)])
                       for i in range(ndim)])
    jac2, _ = _invert(dxdr_2, ndim)
    return dict(rx=rx, bm1=bm1, g=g, rxd=rxd, bmd=jacd * _weights(b.wd, ndim),
                bm2=jac2 * _weights(b.w2, ndim))


# ---------------------------------------------------------------------------
# the box: coordinates, numbering, masks
# ---------------------------------------------------------------------------

_FACES = ("x-", "x+", "y-", "y+", "z-", "z+")


def box_arrays(nels, lims, bc: dict, order: int) -> dict:
    """Coordinates x [ndim, nel, pts...], global ids gidx [nel, pts...] and
    the velocity mask vmask [ndim, nel, pts...] of a uniform box, faces 'P'
    (periodic, both sides) or 'W' (wall). Elements in C order of (z, y, x)
    element indices, points in (t, s, r) order."""
    ndim = len(nels)
    n = order + 1
    b = basis(n)
    faces = _FACES[: 2 * ndim]
    periodic = [bc[faces[2 * d]] == "P" for d in range(ndim)]
    for f in faces:
        if bc[f] not in ("P", "W"):
            raise ValueError(f"face {f}: only 'P' and 'W' are supported, got {bc[f]!r}")
    for d in range(ndim):
        if periodic[d] != (bc[faces[2 * d + 1]] == "P"):
            raise ValueError(f"periodic dim {d} needs 'P' on both faces")
    z01 = (b.z + 1.0) / 2.0
    edges = [np.linspace(lims[d][0], lims[d][1], nels[d] + 1) for d in range(ndim)]
    cs = [e[:-1, None] + z01[None, :] * np.diff(e)[:, None] for e in edges]
    full = tuple(nels[::-1]) + (n,) * ndim

    def expand(a, d):
        sh = [1] * (2 * ndim)
        sh[ndim - 1 - d] = nels[d]
        sh[2 * ndim - 1 - d] = n
        return np.broadcast_to(a.reshape(sh), full)

    x = np.stack([expand(cs[d], d) for d in range(ndim)])
    npts = [nels[d] * (n - 1) + (0 if periodic[d] else 1) for d in range(ndim)]
    gidx = np.zeros(full, np.int64)
    for d in range(ndim):
        gi = np.arange(nels[d])[:, None] * (n - 1) + np.arange(n)[None, :]
        if periodic[d]:
            gi = gi % npts[d]
        gidx += expand(gi, d) * int(np.prod(npts[:d]))
    vmask = np.ones((ndim,) + full)
    for f in faces:
        if bc[f] != "W":
            continue
        d, side = "xyz".index(f[0]), int(f[1] == "+")
        idx = [slice(None)] * (2 * ndim)
        idx[ndim - 1 - d] = -1 if side else 0
        idx[2 * ndim - 1 - d] = -1 if side else 0
        vmask[(slice(None),) + tuple(idx)] = 0.0
    nel = int(np.prod(nels))
    _, gidx = np.unique(gidx.reshape(-1), return_inverse=True)
    gidx = gidx.reshape((nel,) + (n,) * ndim)
    # Dirichlet wins at shared nodes: the least mask over a DOF's copies
    vflat = vmask.reshape(ndim, nel, -1)
    hat = np.ones((ndim, int(gidx.max()) + 1))
    for c in range(ndim):
        np.minimum.at(hat[c], gidx.reshape(-1), vflat[c].reshape(-1))
    vmask = np.stack([hat[c][gidx] for c in range(ndim)])
    return dict(x=x.reshape((ndim, nel) + (n,) * ndim), gidx=gidx, vmask=vmask, basis=b,
                ndim=ndim, nel=nel)


def el_last(a: np.ndarray, axis: int) -> np.ndarray:
    return np.ascontiguousarray(np.moveaxis(a, axis, -1))


def dss_table(gidx_last: np.ndarray) -> np.ndarray:
    """Row i lists the flat positions of every copy of DOF gidx[i], padded
    with gidx.size (a zero slot)."""
    g = gidx_last.reshape(-1)
    order = np.argsort(g, kind="stable")
    counts = np.bincount(g)
    starts = np.cumsum(counts) - counts
    rank = np.arange(g.size) - starts[g[order]]
    copies = np.full((counts.size, counts.max()), g.size, np.int64)
    copies[g[order], rank] = order
    return copies[g]


def host_fields(nels, lims, bc: dict, order: int) -> dict:
    """What the harness needs before any operator: coordinates x [ndim,
    pts..., nel], gidx [pts..., nel], vmask [ndim, pts..., nel] and
    1/multiplicity vmult, element-last, numpy."""
    a = box_arrays(nels, lims, bc, order)
    gidx = el_last(a["gidx"], 0)
    cnt = np.bincount(gidx.reshape(-1))
    return dict(x=el_last(a["x"], 1), gidx=gidx, vmask=el_last(a["vmask"], 1),
                vmult=1.0 / cnt[gidx])


@dataclasses.dataclass(frozen=True)
class RefMesh:
    ndim: int
    nel: int
    n: int
    x: torch.Tensor  # [ndim, pts..., nel]
    rx: torch.Tensor  # [ndim, ndim, pts..., nel]
    bm1: torch.Tensor
    g: torch.Tensor  # [ndim, ndim, pts..., nel]
    rxd: torch.Tensor
    bmd: torch.Tensor
    bm2: torch.Tensor
    binv: torch.Tensor
    vmult: torch.Tensor
    vmask: torch.Tensor
    d: torch.Tensor
    jd: torch.Tensor
    j12: torch.Tensor
    dss: torch.Tensor  # int64 [npts*nel, maxmult]
    gidx: torch.Tensor  # int64 [pts..., nel]
    x_host: np.ndarray

    @property
    def dtype(self):
        return self.bm1.dtype

    @property
    def device(self):
        return self.bm1.device


def box_mesh(nels, lims, bc: dict, order: int, dtype=torch.float64, device="cpu") -> RefMesh:
    """A box mesh's operator data as tensors on `device` (every face 'P' or
    'W': the pressure problem is pure Neumann)."""
    a = box_arrays(nels, lims, bc, order)
    b, ndim = a["basis"], a["ndim"]
    geo = geometry(a["x"], b)
    gidx = a["gidx"]
    nglob = int(gidx.max()) + 1
    cnt = np.bincount(gidx.reshape(-1), minlength=nglob)
    bsum = np.bincount(gidx.reshape(-1), weights=geo["bm1"].reshape(-1), minlength=nglob)
    t = lambda arr: torch.as_tensor(np.ascontiguousarray(arr), dtype=dtype, device=device)
    gl = el_last(gidx, 0)
    return RefMesh(
        ndim=ndim, nel=a["nel"], n=b.n,
        x=t(el_last(a["x"], 1)), rx=t(el_last(geo["rx"], 2)), bm1=t(el_last(geo["bm1"], 0)),
        g=t(el_last(geo["g"], 2)), rxd=t(el_last(geo["rxd"], 2)), bmd=t(el_last(geo["bmd"], 0)),
        bm2=t(el_last(geo["bm2"], 0)), binv=t(el_last((1.0 / bsum)[gidx], 0)),
        vmult=t(el_last((1.0 / cnt)[gidx], 0)), vmask=t(el_last(a["vmask"], 1)),
        d=t(b.d), jd=t(b.jd), j12=t(b.j12),
        dss=torch.as_tensor(dss_table(gl), device=device),
        gidx=torch.as_tensor(gl, device=device), x_host=el_last(a["x"], 1))
