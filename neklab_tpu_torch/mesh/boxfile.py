"""genbox `.box` file reader.

Counterpart of `neklab_tpu.mesh.boxfile`. Builds a SemMesh directly from
Nek5000's genbox input files (e.g. rayBen/baseflow/rayBen.box,
thermosyphon/baseflow/tsyphon.box), replacing the genbox -> .re2 -> genmap
toolchain with a single call.

Supported (the subset the Nek5000 example cases use):
  * rectilinear "Box": negative nel = uniform/geometrically-graded spacing
    from `x0 x1 ratio`; positive nel = explicit element edges on the next
    line;
  * cylindrical boxes (name starting with 'c'/'C'): dim 1 = radius, dim 2 =
    angle in DEGREES about the given center — GLL nodes placed by the polar
    map, so arcs are exact to the polynomial order;
  * velocity BC line (x-, x+, y-, y+[, z-, z+]; 3-char codes P/W/v/O/SYM)
    and optional temperature BC line (t = Dirichlet, anything else
    insulated).
"""

from __future__ import annotations

import numpy as np
import torch

from .box import box_mesh
from .core import SemMesh

_FACES = ("x-", "x+", "y-", "y+", "z-", "z+")


def _numbers(line: str) -> list[float]:
    out = []
    for tok in line.replace(",", " ").split():
        try:
            out.append(float(tok))
        except ValueError:
            break
    return out


def _edges(nel_signed: int, x0: float, x1: float, ratio: float, lines, li: int):
    """Element edge coordinates for one dimension; returns (edges, next li)."""
    nel = abs(int(nel_signed))
    if nel_signed > 0:
        # explicit edges on the following line(s)
        vals: list[float] = []
        while len(vals) < nel + 1:
            if li >= len(lines):
                raise ValueError(f"genbox: ran out of lines reading {nel + 1} element edges")
            nums = _numbers(lines[li])
            if not nums:
                raise ValueError(f"genbox: expected element-edge coordinates, got {lines[li]!r}")
            vals.extend(nums)
            li += 1
        return np.asarray(vals[: nel + 1]), li
    if abs(ratio - 1.0) < 1e-12:
        return np.linspace(x0, x1, nel + 1), li
    w = ratio ** np.arange(nel)
    w = w / w.sum() * (x1 - x0)
    return np.concatenate([[x0], x0 + np.cumsum(w)]), li


def mesh_from_box(
    path: str,
    order: int = 6,
    dealias_order: int | None = None,
    dtype=torch.float64,
    device=None,
) -> SemMesh:
    """Read a genbox `.box` file and build its SemMesh (`box_mesh`). device:
    None is the current CUDA card, and raises where there is none (pass
    "cpu")."""
    with open(path) as f:
        lines = [ln for ln in (l.strip() for l in f) if ln]
    li = 0
    ndim = abs(int(_numbers(lines[li])[0])); li += 1
    nfields = int(_numbers(lines[li])[0]); li += 1
    name = lines[li].split()[0]; li += 1
    cylindrical = name[:1].lower() == "c"
    center = (0.0, 0.0)
    if cylindrical:
        c = _numbers(lines[li]); li += 1
        center = (c[0], c[1] if len(c) > 1 else 0.0)

    nels_signed = [int(v) for v in _numbers(lines[li])[:ndim]]; li += 1
    edges = []
    for d in range(ndim):
        if nels_signed[d] < 0:
            # negative nel: uniform/graded spacing from an 'x0 x1 ratio' line
            x0, x1, ratio = (_numbers(lines[li]) + [1.0])[:3]
            li += 1
            e, li = _edges(nels_signed[d], x0, x1, ratio, lines, li)
        else:
            # positive nel: the ratio line is REPLACED by nel+1 explicit
            # element edges starting on the current line (genbox format)
            e, li = _edges(nels_signed[d], 0.0, 0.0, 1.0, lines, li)
        edges.append(e)

    def _bc_line(ln: str) -> list[str]:
        # "P  ,P  ,W  ,W  ,  comment" -> 3-char fields
        parts = [p.strip() for p in ln.split(",")]
        return [p for p in parts[: 2 * ndim]]

    vbc = _bc_line(lines[li]); li += 1
    tbc = _bc_line(lines[li]) if nfields >= 2 and li < len(lines) else []

    bc = {}
    bc_temp = {}
    for i, f in enumerate(_FACES[: 2 * ndim]):
        code = (vbc[i] if i < len(vbc) else "W").upper()[:3].strip() or "E"
        if code.startswith("P"):
            bc[f] = "P"
        elif code.startswith("W"):
            bc[f] = "W"
        elif code.startswith("V"):
            bc[f] = "v"
        elif code.startswith("O"):
            bc[f] = "O"
        elif code.startswith("SYM"):
            bc[f] = "SYM"
        else:
            bc[f] = "W"
        if i < len(tbc) and tbc[i].strip().lower().startswith("t"):
            bc_temp[f] = "t"

    nels = tuple(abs(n) for n in nels_signed)
    lims = tuple((float(e[0]), float(e[-1])) for e in edges)

    deform = None
    if cylindrical:
        cx, cy = center
        deg = np.pi / 180.0

        def deform(x):
            r, th = x[0], x[1] * deg
            return np.stack([cx + r * np.cos(th), cy + r * np.sin(th)])

    return box_mesh(
        nels, lims, bc, order=order, dealias_order=dealias_order,
        edges=[np.asarray(e) for e in edges], deform=deform,
        bc_temp=bc_temp or None, dtype=dtype, device=device,
    )
