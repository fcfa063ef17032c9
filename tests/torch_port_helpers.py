"""Shared helpers for the port-parity tests (tests/test_torch_*.py).

Each parity test builds its inputs with numpy from a fixed seed and feeds
them to a `neklab_tpu` (JAX, CPU, float64 via conftest.py) function and to
its `neklab_tpu_torch` counterpart in the same process. Data crosses between
the packages as numpy arrays only.
"""

import numpy as np
import torch

from neklab_tpu_torch.mesh.core import MESH_FIELDS, mesh_from_arrays
from neklab_tpu_torch.utils.timers import counts as cg_counts  # noqa: F401  (the tests')

# Tier-1 runs several pytest workers on a few cores; unbounded intra-op
# threads in every worker would oversubscribe them.
torch.set_num_threads(2)

CHANNEL_BC = {"x-": "P", "x+": "P", "y-": "W", "y+": "W"}
WALLED_BC = {"x-": "W", "x+": "W", "y-": "W", "y+": "W"}


def wavy(x):
    """Sinusoidal deformation of a [0,2]x[-1,1] box: curved elements (g01 != 0)."""
    x = np.array(x)
    x[1] = x[1] + 0.1 * np.sin(np.pi * x[0]) * (1 - x[1] ** 2)
    x[0] = x[0] + 0.05 * np.sin(np.pi * x[1])
    return x


def rel(a, b) -> float:
    """max |a - b| / max |b| (b is the reference)."""
    a, b = to_np(a), to_np(b)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def absdiff(a, b) -> float:
    return float(np.abs(to_np(a) - to_np(b)).max())


def to_np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.array(a)


def t(a) -> torch.Tensor:
    """float64 CPU tensor of a numpy or JAX array (copied)."""
    return torch.as_tensor(np.array(a, dtype=np.float64))


def carry_mesh(jmesh, dtype=torch.float64, device="cpu"):
    """The port's SemMesh built from a reference SemMesh's fields."""
    arrays = {k: np.asarray(getattr(jmesh, k)) for k in MESH_FIELDS}
    meta = dict(n=jmesh.basis.n, nd=jmesh.basis.nd, ndim=jmesh.ndim, nel=jmesh.nel,
                nglob=jmesh.nglob, bc=jmesh.bc)
    return mesh_from_arrays(arrays, meta, dtype=dtype, device=device)


def write_re2(path, xc, yc, curves=(), bcs=(), version=2):
    """Write a 2-D Nek5000 `.re2` file by its public layout: an 80-byte
    ASCII header `#v00K nelgt ndim nelgv`, the float32 endian tag 6.54321,
    then real*8 words (real*4 for #v001): per element [group, x(4 corners),
    y(4 corners)] (corners counterclockwise from (-1, -1)); the curve block
    [ncurve, then 8-word records (element, side, 5 parameters, curve char)];
    one BC block per field [nbc, then 8-word records (element, side, 5
    parameters, BC chars)]. Elements and sides are 1-based in the file and
    0-based in `curves` and `bcs` ((element, side, params, chars) tuples);
    a periodic record's first two parameters are the partner's element and
    side, 1-based."""
    import struct

    xc, yc = np.asarray(xc, float), np.asarray(yc, float)
    nel = xc.shape[0]
    wd = 8 if version == 2 else 4
    rdt = np.dtype(f"<f{wd}")

    def records(items):
        out = [np.array([len(items)], rdt).tobytes()]
        for iel, iside, params, chars in items:
            w = np.zeros(8, rdt)
            w[0], w[1] = iel + 1, iside + 1
            w[2:2 + len(params)] = params
            b = bytearray(w.tobytes())
            b[7 * wd:] = chars.encode().ljust(wd)
            out.append(bytes(b))
        return b"".join(out)

    with open(path, "wb") as f:
        f.write(f"#v00{version} {nel:9d} 2 {nel:9d} written by a test".ljust(80).encode())
        f.write(struct.pack("<f", 6.54321))
        el = np.concatenate([np.ones((nel, 1)), xc, yc], axis=1)
        f.write(el.astype(rdt).tobytes())
        f.write(records(list(curves)))
        for field in bcs:
            f.write(records(list(field)))
