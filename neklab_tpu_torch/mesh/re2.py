"""Nek5000 binary `.re2` mesh importer.

Counterpart of `neklab_tpu/mesh/re2.py`. Reads Nek5000's mesh files (written by
genbox/gmsh2nek/reatore2) and builds a SemMesh directly:

  * element corner vertices -> GLL coordinates by Gordon-Hall transfinite
    interpolation, with curved sides ('C' circular arc, 'm' quadratic
    midpoint) honored to full polynomial order;
  * BC character codes -> Dirichlet masks (W/v/V walls+inflow, O/o outflow
    pins pressure, SYM masks the dominant-normal component, t/T temperature
    Dirichlet, I insulated);
  * 'P ' periodic faces -> global-DOF identification (translation inferred
    from the paired face centroids);
  * interior connectivity from coincident GLL nodes
    (mesh/connectivity.py), i.e. no `.ma2` file is needed — partitioning is
    the package's own RCB (`native/`).

Format (public Nek5000 layout): 80-byte ASCII header
`#v00K nelgt ndim nelgv ...`, float32 endian tag 6.54321, then real*8
(real*4 for #v001) records: per element [group, x(corners), y(corners)
(, z(corners))]; a curve block [ncurve, then 8-word records
(ieg, iside, 5 params, ccurve)]; BC blocks per field [nbc, then 8-word
records (ieg, iside, 5 params, cbc char*3)].
"""

from __future__ import annotations

import dataclasses
import struct

import numpy as np
import torch

from ..ops.basis import make_basis
from ..ops.geometry import compute_geom
from .connectivity import connectivity_from_coords
from .core import SemMesh, build_mesh, resolve_device


@dataclasses.dataclass
class Re2Data:
    ndim: int
    nel: int
    xc: np.ndarray  # [nel, 2^ndim] corner x
    yc: np.ndarray
    zc: np.ndarray | None
    curves: list  # (iel0, iside0, params[5], ccurve)
    bcs: list  # list per field of (iel0, iside0, params[5], cbc)


def read_re2(path: str) -> Re2Data:
    with open(path, "rb") as f:
        hdr = f.read(80).decode("ascii", errors="replace")
        if not hdr.startswith("#v"):
            raise ValueError(f"not a .re2 file: {path}")
        version = int(hdr[2:5])
        tok = hdr[5:].split()
        nelgt, ndim, _nelgv = int(tok[0]), int(tok[1]), int(tok[2])
        wdsize = 4 if version == 1 else 8
        rdt = np.dtype(f"<f{wdsize}")

        tag = struct.unpack("<f", f.read(4))[0]
        if abs(tag - 6.54321) > 1e-4:
            raise ValueError("big-endian .re2 not supported (or corrupt tag)")

        ncorn = 2**ndim
        per_el = 1 + ndim * ncorn  # group + coords
        raw = np.frombuffer(f.read(wdsize * per_el * nelgt), dtype=rdt)
        raw = raw.reshape(nelgt, per_el)
        xc = raw[:, 1 : 1 + ncorn].astype(np.float64)
        yc = raw[:, 1 + ncorn : 1 + 2 * ncorn].astype(np.float64)
        zc = raw[:, 1 + 2 * ncorn : 1 + 3 * ncorn].astype(np.float64) if ndim == 3 else None

        def read_records(count):
            rec = np.frombuffer(f.read(wdsize * 8 * count), dtype=rdt).reshape(count, 8)
            out = []
            for r in rec:
                iel = int(r[0]) - 1
                iside = int(r[1]) - 1
                params = r[2:7].astype(np.float64)
                rawch = r[7:8].tobytes().decode("ascii", errors="replace")
                # char*1 (curve) / char*3 (bc) packed into a float word; keep
                # the leading printable letters only (the rest is junk bytes)
                ch = ""
                for c in rawch:
                    if c.isalpha() or (ch and c == " "):
                        ch += c
                    else:
                        break
                ch = ch.strip()
                out.append((iel, iside, params, ch))
            return out

        curves = []
        buf = f.read(wdsize)
        if len(buf) == wdsize:
            ncurve = int(np.frombuffer(buf, dtype=rdt)[0])
            curves = read_records(ncurve)

        bcs = []
        while True:
            buf = f.read(wdsize)
            if len(buf) < wdsize:
                break
            nbc = int(np.frombuffer(buf, dtype=rdt)[0])
            bcs.append(read_records(nbc))

    return Re2Data(ndim=ndim, nel=nelgt, xc=xc, yc=yc, zc=zc, curves=curves, bcs=bcs)


# corner order (Nek preprocessor): 1:(-1,-1) 2:(+1,-1) 3:(+1,+1) 4:(-1,+1);
# side i joins corner i -> i+1: side 0: s=-1, 1: r=+1, 2: s=+1, 3: r=-1
_SIDE_CORNERS_2D = ((0, 1), (1, 2), (2, 3), (3, 0))


def _edge_points(p0, p1, params, ccurve, z01):
    """Sample an element edge at parameter z01 in [0,1]: straight, circular
    arc ('C', params[0] = signed radius), or quadratic midpoint ('m')."""
    p0 = np.asarray(p0, dtype=np.float64)
    p1 = np.asarray(p1, dtype=np.float64)
    if ccurve == "C":
        radius = params[0]
        chord = p1 - p0
        c2 = np.dot(chord, chord)
        h2 = radius * radius - c2 / 4.0
        if h2 < 0:
            raise ValueError(f"arc radius {radius} too small for chord {np.sqrt(c2)}")
        mid = 0.5 * (p0 + p1)
        # Nek sign convention (as in Nek5000's 1cyl.re2 and its BF_1cyl0
        # coordinates): positive radius puts the curvature CENTER on
        # the LEFT of the directed chord p0->p1 (arc bulges right), negative
        # radius on the right. nrm is the left unit normal.
        nrm = np.array([-chord[1], chord[0]]) / np.sqrt(c2)
        center = mid + np.sign(radius) * np.sqrt(h2) * nrm
        a0 = np.arctan2(p0[1] - center[1], p0[0] - center[0])
        a1 = np.arctan2(p1[1] - center[1], p1[0] - center[0])
        da = a1 - a0
        # shortest arc consistent with orientation
        if da > np.pi:
            da -= 2 * np.pi
        if da < -np.pi:
            da += 2 * np.pi
        ang = a0 + z01 * da
        return center[None, :] + np.abs(radius) * np.stack([np.cos(ang), np.sin(ang)], axis=1)
    if ccurve == "m":
        pm = np.asarray(params[:2], dtype=np.float64)
        # quadratic Lagrange through p0 (t=0), pm (t=.5), p1 (t=1)
        t = z01[:, None]
        return (
            (1 - t) * (1 - 2 * t) * p0[None]
            + 4 * t * (1 - t) * pm[None]
            + t * (2 * t - 1) * p1[None]
        )
    t = z01[:, None]
    return (1 - t) * p0[None] + t * p1[None]


def _gll_coords_2d(data: Re2Data, n: int, z01: np.ndarray) -> np.ndarray:
    """Gordon-Hall transfinite GLL coordinates [2, nel, n(s), n(r)]."""
    nel = data.nel
    curve_map = {(iel, iside): (params, c) for iel, iside, params, c in data.curves}
    x = np.zeros((2, nel, n, n))
    for e in range(nel):
        corners = np.stack([data.xc[e], data.yc[e]], axis=1)  # [4, 2]
        edges = []
        for iside, (c0, c1) in enumerate(_SIDE_CORNERS_2D):
            params, cc = curve_map.get((e, iside), (None, ""))
            edges.append(_edge_points(corners[c0], corners[c1], params, cc, z01))
        e1, e2, e3, e4 = edges  # bottom(r), right(s), top(r, from corner 2->3), left(s, 3->0)
        r = z01[None, :, None]  # [1, n, 1] along r
        s = z01[:, None, None]  # [n, 1, 1] along s
        top = e3[::-1]  # corner order 2->3 means decreasing r; flip to r-increasing
        left = e4[::-1]  # 3->0 decreasing s; flip to s-increasing
        right = e2
        bottom = e1
        blend = (
            (1 - s) * bottom[None, :, :]
            + s * top[None, :, :]
            + (1 - r) * left[:, None, :]
            + r * right[:, None, :]
            - (1 - r) * (1 - s) * corners[0][None, None, :]
            - r * (1 - s) * corners[1][None, None, :]
            - r * s * corners[2][None, None, :]
            - (1 - r) * s * corners[3][None, None, :]
        )
        x[:, e] = np.moveaxis(blend, -1, 0)
    return x


def _gll_coords_3d(data: Re2Data, n: int, z01: np.ndarray) -> np.ndarray:
    """Trilinear GLL coordinates [3, nel, n, n, n] (straight edges; curved
    3-D sides are not yet supported)."""
    nel = data.nel
    # corner order: 4 bottom (z-) then 4 top (z+), each CCW as in 2-D
    corners = np.stack([data.xc, data.yc, data.zc], axis=-1)  # [nel, 8, 3]
    r = z01[None, None, None, :, None]
    s = z01[None, None, :, None, None]
    t = z01[None, :, None, None, None]
    w = [
        (1 - r) * (1 - s) * (1 - t),
        r * (1 - s) * (1 - t),
        r * s * (1 - t),
        (1 - r) * s * (1 - t),
        (1 - r) * (1 - s) * t,
        r * (1 - s) * t,
        r * s * t,
        (1 - r) * s * t,
    ]
    out = np.zeros((3, nel, n, n, n))
    for k in range(8):
        ck = corners[:, k, :]  # [nel, 3]
        wk = w[k][0]  # [1/n broadcast dims]
        for d in range(3):
            out[d] += wk * ck[:, d][:, None, None, None]
    return out


# faces of side index -> (axis from last: 0=r,1=s,2=t, end: 0=lo,1=hi)
_SIDE_FACE_2D = {0: (1, 0), 1: (0, 1), 2: (1, 1), 3: (0, 0)}
_SIDE_FACE_3D = {0: (1, 0), 1: (0, 1), 2: (1, 1), 3: (0, 0), 4: (2, 0), 5: (2, 1)}


def _face_slice(ndim, n, axis, end):
    """Index tuple selecting a face of an [<el>, (t,)s,r] element block."""
    idx = [slice(None)] * ndim
    idx[ndim - 1 - axis] = 0 if end == 0 else n - 1
    return tuple(idx)


def rcb_order(centroids: np.ndarray, nparts: int) -> np.ndarray:
    """Element permutation placing each recursive-coordinate-bisection part
    contiguously (part 0 first): perm[new_position] = old_element. Under a
    contiguous element partition this makes each part spatially compact, so
    face partners are local (genmap's RCB partitioning role). Native C++
    RCB when available, numpy recursion otherwise; the two may split equal
    centroids differently."""
    from .. import native

    part = native.rcb_partition(centroids, nparts)
    if part is None:
        nel = centroids.shape[0]
        part = np.zeros(nel, dtype=np.int64)

        def rec(idx, p0, np_):
            if np_ == 1:
                part[idx] = p0
                return
            c = centroids[idx]
            ax = int(np.argmax(c.max(axis=0) - c.min(axis=0)))
            half = np_ // 2
            cut = len(idx) * half // np_
            order = idx[np.argsort(c[:, ax], kind="stable")]
            rec(order[:cut], p0, half)
            rec(order[cut:], p0 + half, np_ - half)

        rec(np.arange(nel), 0, nparts)
    return np.argsort(part, kind="stable")


def mesh_from_re2(
    path: str,
    order: int = 6,
    dealias_order: int | None = None,
    dtype=torch.float64,
    tol: float = 1e-8,
    bc_fn=None,
    partition: int | None = None,
    cache: bool = True,
    cache_tag: str | None = None,
    device=None,
) -> SemMesh:
    """Read a .re2 file and build a SemMesh (general unstructured path).

    bc_fn: optional callback `(centroid: np.ndarray[ndim]) -> str` assigning a
    BC code ('W', 'v', 'O', 'SYM', 'I'/'' for none, 't' for temperature
    Dirichlet, 'Wt'/'vt' combining both) to each BOUNDARY face whose file
    code is unassigned ('E', 'MSH', empty) — the analog of the Nek5000
    cases' `usrdat2` BC rewiring (e.g. gmsh-imported meshes ship with 'MSH'
    placeholders, back_fstep/*).

    partition: reorder elements by a `partition`-way RCB so a contiguous
    element partition over that many devices gets spatially compact
    subdomains. The permutation is recorded on the mesh (mesh.eperm); map
    file-ordered fields with mesh.core.from_file_order.

    cache: persist the finished SemMesh under the mesh cache directory
    (`mesh/cache.py`) keyed on (file bytes, order, dealias, dtype, tol,
    partition) — genmap's build-once-use-many contract. When bc_fn is given
    the key cannot hash the callback, so caching is skipped unless
    `cache_tag` names the BC assignment uniquely (the caller's contract).

    device: None is the current CUDA card, and raises where there is none
    (pass "cpu"). The host preprocessing is the same on every device.
    """
    device = resolve_device(device)
    cache_path = None
    if cache and (bc_fn is None or cache_tag is not None):
        from .cache import cache_key, default_cache_dir, load_semmesh
        import os as _os

        key = cache_key(
            path, order=order, dealias=dealias_order, dtype=str(dtype),
            tol=tol, partition=partition, bc_tag=cache_tag or "",
        )
        cache_path = _os.path.join(default_cache_dir(), f"torch_re2_{key}.npz")
        if _os.path.exists(cache_path):
            try:
                return load_semmesh(cache_path, dtype=dtype, device=device)
            except (OSError, ValueError, KeyError):  # corrupt/stale: rebuild
                pass

    data = read_re2(path)
    n = order + 1
    nd = dealias_order + 1 if dealias_order is not None else None
    basis = make_basis(n, nd)
    z01 = (basis.z + 1.0) / 2.0

    if data.ndim == 2:
        x = _gll_coords_2d(data, n, z01)
    else:
        x = _gll_coords_3d(data, n, z01)

    eperm = None
    el_newpos = None  # old element id -> new position
    if partition is not None and partition > 1:
        cent = x.reshape(data.ndim, data.nel, -1).mean(axis=2).T  # [nel, ndim]
        eperm = rcb_order(cent, partition)
        el_newpos = np.empty(data.nel, dtype=np.int64)
        el_newpos[eperm] = np.arange(data.nel)
        x = np.ascontiguousarray(x[:, eperm])

    scale = max(np.ptp(x[d]) for d in range(data.ndim))
    gidx = connectivity_from_coords(x, tol=tol * max(scale, 1.0))

    nel, ndim = data.nel, data.ndim
    pts = (n,) * ndim
    vmask = np.ones((ndim, nel) + pts)
    pmask = np.ones((nel,) + pts)
    tmask = np.ones((nel,) + pts)
    side_face = _SIDE_FACE_2D if ndim == 2 else _SIDE_FACE_3D

    vel_bcs = data.bcs[0] if data.bcs else []
    tmp_bcs = data.bcs[1] if len(data.bcs) > 1 else []
    if el_newpos is not None:
        # BC records reference FILE element ids; remap to the RCB order
        # (incl. the periodic partner id stored in params[0])
        def _remap(rec):
            iel, iside, params, cbc = rec
            params = np.array(params, copy=True)
            if cbc.strip().upper() == "P":
                params[0] = el_newpos[int(params[0]) - 1] + 1
            return (int(el_newpos[iel]), iside, params, cbc)

        vel_bcs = [_remap(r) for r in vel_bcs]
        tmp_bcs = [_remap(r) for r in tmp_bcs]
    periodic_pairs = []

    if bc_fn is not None:
        # boundary-face detection: a face is on the boundary iff its corner
        # global ids are not shared with any other element's face
        nsides = 2 * ndim
        face_key = {}
        for e in range(nel):
            for iside in range(nsides):
                axis, end = side_face[iside]
                fs = _face_slice(ndim, n, axis, end)
                gface = gidx[(e,) + fs].reshape(-1)
                # conforming faces share all nodes; the full sorted id set is
                # a robust face identity in 2-D and 3-D alike
                key = tuple(sorted(np.unique(gface)))
                face_key.setdefault(key, []).append((e, iside))
        assigned = {(iel, iside) for iel, iside, _, c in vel_bcs if c.strip() not in ("", "E", "MSH")}
        extra = []
        for key, faces in face_key.items():
            if len(faces) != 1 or faces[0] in assigned:
                continue
            e, iside = faces[0]
            axis, end = side_face[iside]
            fs = _face_slice(ndim, n, axis, end)
            centroid = x[(slice(None), e) + fs].reshape(ndim, -1).mean(axis=1)
            code = (bc_fn(centroid) or "").strip()
            if not code:
                continue
            if code.endswith("t"):
                tmp_bcs = list(tmp_bcs) + [(e, iside, np.zeros(5), "t")]
                code = code[:-1]
            if code:
                extra.append((e, iside, np.zeros(5), code))
        vel_bcs = list(vel_bcs) + extra

    for iel, iside, params, cbc in vel_bcs:
        axis, end = side_face[iside]
        fs = _face_slice(ndim, n, axis, end)
        code = cbc.strip().upper()
        if code in ("W", "V", "VL", "MV"):
            for c in range(ndim):
                vmask[(c, iel) + fs] = 0.0
        elif code in ("O", "ON"):
            pmask[(iel,) + fs] = 0.0
        elif code in ("SYM",):
            # mask the dominant-normal component (axis-aligned SYM faces)
            fx = x[(slice(None), iel) + fs].reshape(ndim, -1)
            spans = fx.max(axis=1) - fx.min(axis=1)
            comp = int(np.argmin(spans))
            vmask[(comp, iel) + fs] = 0.0
        elif code == "P":
            periodic_pairs.append((iel, iside, int(params[0]) - 1, int(params[1]) - 1))
        # 'E', '' : internal

    for iel, iside, params, cbc in tmp_bcs:
        axis, end = side_face[iside]
        fs = _face_slice(ndim, n, axis, end)
        if cbc.strip().upper() in ("T", "W"):
            tmask[(iel,) + fs] = 0.0

    # periodic identification: merge the two faces' global ids by nearest
    # translated coordinates
    if periodic_pairs:
        gflat = gidx.reshape(nel, -1)
        remap = np.arange(gidx.max() + 1)
        seen = set()
        for iel, iside, jel, jside in periodic_pairs:
            if (jel, jside, iel, iside) in seen:
                continue
            seen.add((iel, iside, jel, jside))
            ax_i, end_i = side_face[iside]
            ax_j, end_j = side_face[jside]
            fi = _face_slice(ndim, n, ax_i, end_i)
            fj = _face_slice(ndim, n, ax_j, end_j)
            xi = x[(slice(None), iel) + fi].reshape(ndim, -1)
            xj = x[(slice(None), jel) + fj].reshape(ndim, -1)
            shift = xj.mean(axis=1) - xi.mean(axis=1)
            gi = gidx[(iel,) + fi].reshape(-1)
            gj = gidx[(jel,) + fj].reshape(-1)
            d2 = (((xi + shift[:, None])[:, :, None] - xj[:, None, :]) ** 2).sum(axis=0)
            match = np.argmin(d2, axis=1)
            if not np.allclose(np.sqrt(d2[np.arange(len(match)), match]), 0.0, atol=1e-6 * max(scale, 1.0)):
                raise ValueError(f"periodic faces {iel}/{iside} <-> {jel}/{jside} do not match")
            for a, b in zip(gi, gj[match]):
                ra, rb = remap[a], remap[b]
                lo, hi = (ra, rb) if ra < rb else (rb, ra)
                remap[remap == hi] = lo
        _, gidx = np.unique(remap[gidx.reshape(-1)], return_inverse=True)
        gidx = gidx.reshape((nel,) + pts)
        # shared DOFs must carry the intersection of masks
        for arr in (pmask, tmask):
            m = np.ones(gidx.max() + 1)
            np.minimum.at(m, gidx.reshape(-1), arr.reshape(-1))
            arr[...] = m[gidx.reshape(-1)].reshape(arr.shape)
        for c in range(ndim):
            m = np.ones(gidx.max() + 1)
            np.minimum.at(m, gidx.reshape(-1), vmask[c].reshape(-1))
            vmask[c] = m[gidx.reshape(-1)].reshape(vmask[c].shape)

    geom = compute_geom(x, basis)
    bc_meta = (("re2", path.rsplit("/", 1)[-1]),)
    mesh = build_mesh(geom, basis, gidx, vmask, pmask, tmask, bc=bc_meta, dtype=dtype,
                      device=device, eperm=eperm)
    if cache_path is not None:
        from .cache import save_semmesh

        save_semmesh(cache_path, mesh)
    return mesh
