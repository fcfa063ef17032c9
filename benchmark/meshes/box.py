"""The box mesh (Nek5000's genbox layout): `nels` elements a direction over
`lims`, every face periodic ('P') or a wall ('W'), GLL points of `order`.

A mesh builder is found by the name in a configuration's `mesh.builder`:
`program` builds the program's mesh, `host` the numpy fields the harness
needs before any operator (coordinates, global numbering, wall mask and
multiplicity), `reference` the plain reference's mesh.
"""

import torch

from reference import mesh as refmesh


def _args(spec: dict):
    return tuple(spec["nels"]), spec["lims"], spec["bc"], spec["order"]


def program(spec: dict, dtype, device):
    from neklab_tpu_torch import box_mesh

    nels, lims, bc, order = _args(spec)
    return box_mesh(nels, lims, bc, order=order, dtype=dtype, device=device)


def host(spec: dict) -> dict:
    return refmesh.host_fields(*_args(spec))


def reference(spec: dict, dtype=torch.float64, device="cpu"):
    return refmesh.box_mesh(*_args(spec), dtype=dtype, device=device)
