"""Persistent mesh-preprocessing cache.

Counterpart of `neklab_tpu/mesh/cache.py`. Building a SemMesh from a `.re2`
file is host-side Python (Gordon-Hall coordinates, coincident-node
connectivity, periodic pairing); genmap's build-once-use-many contract
keeps the result on disk. This module persists the port's SemMesh: the
fields `mesh_from_arrays` takes (`MESH_FIELDS`, `eperm`) and its static
metadata, as one `.npz` keyed on (file bytes, build parameters). The
entries carry the port's own format tag, in the key and in the file, so the
port never loads an entry the reference package wrote into the same
directory (whose meshes carry its exchange schedules instead).
"""

from __future__ import annotations

import hashlib
import json
import os

import numpy as np
import torch

from .core import MESH_FIELDS, SemMesh, mesh_from_arrays

FORMAT = "neklab_tpu_torch-mesh-1"  # change when what an entry holds changes


def default_cache_dir() -> str:
    return os.environ.get(
        "NEKLAB_MESH_CACHE", os.path.join(os.path.dirname(__file__), "..", "..", ".mesh_cache")
    )


def cache_key(path: str, **params) -> str:
    """sha256 over the mesh FILE BYTES (not the path/mtime: copies of the
    same mesh share the entry), the build parameters and the format tag."""
    h = hashlib.sha256()
    with open(path, "rb") as f:
        h.update(f.read())
    h.update(json.dumps({k: str(v) for k, v in sorted(params.items())},
                        sort_keys=True).encode())
    h.update(FORMAT.encode())
    return h.hexdigest()[:24]


def save_semmesh(cache_path: str, mesh: SemMesh) -> None:
    """Atomic write of the mesh's fields and static metadata."""
    data = {k: getattr(mesh, k).cpu().numpy() for k in MESH_FIELDS}
    if mesh.eperm is not None:
        data["eperm"] = mesh.eperm.cpu().numpy()
    meta = dict(format=FORMAT, n=mesh.basis.n, nd=mesh.basis.nd, ndim=mesh.ndim, nel=mesh.nel,
                nglob=mesh.nglob, bc=[list(pair) for pair in mesh.bc])
    data["__meta__"] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
    os.makedirs(os.path.dirname(cache_path), exist_ok=True)
    tmp = cache_path + f".tmp{os.getpid()}.npz"
    np.savez_compressed(tmp, **data)
    os.replace(tmp, cache_path)


def load_semmesh(cache_path: str, dtype=torch.float64, device=None) -> SemMesh:
    """The mesh `save_semmesh` wrote, on `device` (None: the current CUDA
    card). Raises ValueError for an entry of another format."""
    with np.load(cache_path) as z:
        meta = json.loads(bytes(z["__meta__"]).decode())
        if meta.get("format") != FORMAT:
            raise ValueError(f"{cache_path}: not a {FORMAT} mesh entry")
        arrays = {k: z[k] for k in z.files if k != "__meta__"}
    return mesh_from_arrays(arrays, meta, dtype=dtype, device=device)
