"""Nek5000 binary field-file ("#std" / .fXXXXX) reader and writer.

Interop with the reference stack's field files: base flows written by Nek
(`outpost`, loaded in the reference by `load_fld` — SURVEY section 2.2
"Field I/O" row) can be read directly, and fields written here are readable
by Nek tooling / VisIt / ParaView's Nek reader.

Format (public Nek5000 "#std" layout, one file, single output group):
  * 132-byte ASCII header:
      #std <wdsize> <lx> <ly> <lz> <nelt> <nelgt> <time> <iostep>
           <fid0> <nfileoo> <rdcode>
    rdcode letters (in data order): X coords, U velocity, P pressure,
    T temperature, S## (## = number of extra scalars).
  * 4-byte endian tag: float32 6.54321.
  * int32[nelt] global element ids (the "map").
  * per rdcode section, elements in map order; vector sections store all
    points of component 1, then component 2(,3) per element; points are
    x-fastest ([lz, ly, lx] C order) = this framework's [t, s, r] axes.

Arrays here use the element-LAST layout f[..., (t,) s, r, nel]; `write_fld`
also takes torch tensors on any device. Counterpart of
`neklab_tpu/utils/fldfile.py` (the same format, byte for byte).
"""

from __future__ import annotations

import dataclasses
import struct

import numpy as np
import torch

_ENDIAN_TAG = 6.54321


def _host(a) -> np.ndarray:
    """numpy view of a tensor on any device (or of an array-like)."""
    return a.detach().cpu().numpy() if hasattr(a, "detach") else np.asarray(a)


def _np_dtype(mesh):
    return np.float32 if mesh.bm1.dtype == torch.float32 else np.float64


def _interp_nd(j: np.ndarray, u: np.ndarray, ndim: int) -> np.ndarray:
    """j applied along every reference axis of an element-last field (r,
    then s, then t): the grid change of `ops.tensor.interp_nd`, on the host."""
    for axis in (-2, -3, -4)[:ndim]:
        u = np.moveaxis(np.tensordot(j, u, axes=([1], [u.ndim + axis])), 0, axis)
    return u


@dataclasses.dataclass
class FldFile:
    """Parsed field file. Arrays are float64 numpy in element-last layout:
    x/u: [ndim, (t,)s,r, nel]; p/t: [(t,)s,r, nel]; s: [nscal, (t,)s,r, nel].
    """

    lx: int
    ndim: int
    nelt: int
    time: float
    iostep: int
    emap: np.ndarray  # [nelt] int32 global element ids (1-based, Nek order)
    x: np.ndarray | None = None
    u: np.ndarray | None = None
    p: np.ndarray | None = None
    t: np.ndarray | None = None
    s: np.ndarray | None = None


def _parse_rdcode(rdcode: str) -> list[tuple[str, int]]:
    """-> [(letter, ncomp)] in data order."""
    out = []
    i = 0
    while i < len(rdcode):
        c = rdcode[i]
        if c in " 0123456789":
            i += 1
            continue
        if c == "S":
            n = int(rdcode[i + 1 : i + 3] or "0")
            out.append(("S", n))
            i += 3
        else:
            out.append((c, 0))
            i += 1
    return out


def read_fld(path: str, reorder: bool = True) -> FldFile:
    """Read a '#std' field file.

    reorder=True (default) returns element axes in GLOBAL element order
    (1..nelgt): files written by parallel Nek runs store elements in map
    (rank-ownership) order, so the int32 element map must be inverted to
    align with the .re2 mesh ordering (the reference's `load_fld` does this
    inside Nek's I/O layer). Requires emap to be a permutation of 1..nelt
    (single-output-group files); raises otherwise. reorder=False returns
    raw disk order with `emap` as stored.
    """
    with open(path, "rb") as f:
        header = f.read(132).decode("ascii", errors="replace")
        if not header.startswith("#std"):
            raise ValueError(f"not a Nek '#std' field file: {path}")
        tok = header[4:].split()
        wdsize, lx, ly, lz, nelt, _nelgt = (int(t) for t in tok[:6])
        time = float(tok[6])
        iostep = int(tok[7])
        rdcode = "".join(tok[10:])
        tag = f.read(4)
        (tagval,) = struct.unpack("<f", tag)
        bo = "<"
        if abs(tagval - _ENDIAN_TAG) > 1e-4:
            (tagval,) = struct.unpack(">f", tag)
            if abs(tagval - _ENDIAN_TAG) > 1e-4:
                raise ValueError(f"bad endian tag in {path}")
            bo = ">"
        ndim = 3 if lz > 1 else 2
        npts = lx * ly * lz
        fdt = np.dtype(f"{bo}f{wdsize}")
        emap = np.frombuffer(f.read(4 * nelt), dtype=f"{bo}i4").copy()

        def read_block(ncomp):
            # [nelt, ncomp, npts] on disk (per element: comp-major)
            raw = np.frombuffer(f.read(wdsize * nelt * ncomp * npts), dtype=fdt)
            a = raw.reshape(nelt, ncomp, *([lz] if ndim == 3 else []), ly, lx)
            # -> [ncomp, (t,)s,r, nel]
            return np.moveaxis(a, (0, 1), (-1, 0)).astype(np.float64)

        out = FldFile(lx=lx, ndim=ndim, nelt=nelt, time=time, iostep=iostep, emap=emap)
        for letter, n in _parse_rdcode(rdcode):
            if letter == "X":
                out.x = read_block(ndim)
            elif letter == "U":
                out.u = read_block(ndim)
            elif letter == "P":
                out.p = read_block(1)[0]
            elif letter == "T":
                out.t = read_block(1)[0]
            elif letter == "S" and n:
                out.s = np.stack([read_block(1)[0] for _ in range(n)])
        if reorder and not np.array_equal(emap, np.arange(1, nelt + 1)):
            if sorted(emap) != list(range(1, nelt + 1)):
                raise ValueError(
                    f"{path}: element map is not a permutation of 1..{nelt} "
                    "(multi-file output group?); use reorder=False"
                )
            perm = np.argsort(emap)  # disk position of global element i+1
            for name in ("x", "u", "p", "t", "s"):
                a = getattr(out, name)
                if a is not None:
                    setattr(out, name, np.ascontiguousarray(a[..., perm]))
            out.emap = emap[perm]
        return out


def write_fld(
    path: str,
    mesh=None,
    x=None,
    u=None,
    p=None,
    t=None,
    s=None,
    time: float = 0.0,
    iostep: int = 0,
    wdsize: int = 4,
    emap: np.ndarray | None = None,
) -> str:
    """Write a '#std' field file. Fields in element-last layout (see FldFile).

    p may live on the (n-2)^d pressure grid — it is then interpolated onto
    the GLL grid with the basis j21 matrix (Nek's `mappr` analog), which is
    how the reference outposts pressure (neklab_utils.f90:305-361).
    """
    if mesh is not None and x is None:
        x = mesh.x
    x, u, p, t, s = (None if a is None else _host(a) for a in (x, u, p, t, s))
    ref = np.asarray(next(a for a in (u, x, t, p) if a is not None))
    if x is not None:
        ndim = int(np.asarray(x).shape[0])
    elif u is not None:
        ndim = int(np.asarray(u).shape[0])
    else:
        raise ValueError("need x or u to infer dimensionality")
    if u is not None:
        pts_shape = np.asarray(u).shape[1:-1]
    elif x is not None:
        pts_shape = np.asarray(x).shape[1:-1]
    else:
        pts_shape = np.asarray(t).shape[:-1]
    lx = pts_shape[-1]
    lz = pts_shape[0] if ndim == 3 else 1
    nelt = int(ref.shape[-1])

    if p is not None and mesh is not None and np.asarray(p).shape[-2] != lx:
        p = _interp_nd(np.asarray(mesh.basis.j21, dtype=_np_dtype(mesh)), _host(p), ndim)

    rdcode = ""
    if x is not None:
        rdcode += "X"
    if u is not None:
        rdcode += "U"
    if p is not None:
        rdcode += "P"
    if t is not None:
        rdcode += "T"
    if s is not None and len(s):
        rdcode += f"S{len(s):02d}"

    header = (
        f"#std {wdsize:1d} {lx:2d} {lx:2d} {lz:2d} {nelt:10d} {nelt:10d} "
        f"{time:20.13E} {iostep:9d} {0:6d} {1:6d} {rdcode:10s}"
    )
    header = header.ljust(132)[:132]
    fdt = np.dtype(f"<f{wdsize}")
    if emap is None:
        emap = np.arange(1, nelt + 1, dtype=np.int32)

    def block(a, ncomp):
        a = np.asarray(a).reshape((ncomp,) + tuple(pts_shape) + (nelt,))
        return np.ascontiguousarray(np.moveaxis(a, (-1, 0), (0, 1))).astype(fdt)

    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        f.write(struct.pack("<f", _ENDIAN_TAG))
        f.write(np.asarray(emap, dtype="<i4").tobytes())
        if x is not None:
            f.write(block(x, ndim).tobytes())
        if u is not None:
            f.write(block(u, ndim).tobytes())
        if p is not None:
            f.write(block(p, 1).tobytes())
        if t is not None:
            f.write(block(t, 1).tobytes())
        if s is not None and len(s):
            for i in range(len(s)):
                f.write(block(s[i], 1).tobytes())
    return path
