"""The box mesh (`box.py`'s) with the temperature held on some faces: the
configuration's `mesh.bc_temp` gives 't' (temperature given) for those
faces; every other face is insulated or periodic.

`program` builds the program's mesh with `bc_temp`; `host` the numpy
fields the harness needs, with the temperature's mask as a last
component of `vmask` (the benchmark's vectors carry the temperature as a
last component of "u"); `reference` the plain reference's mesh, whose
temperature mask the reference's operator takes from
`reference.boussinesq.temperature_mask`.
"""

import numpy as np
import torch

from reference import boussinesq
from reference import mesh as refmesh


def _args(spec: dict):
    return tuple(spec["nels"]), spec["lims"], spec["bc"], spec["order"]


def program(spec: dict, dtype, device):
    from neklab_tpu_torch import box_mesh

    nels, lims, bc, order = _args(spec)
    return box_mesh(nels, lims, bc, order=order, bc_temp=spec["bc_temp"], dtype=dtype,
                    device=device)


def host(spec: dict) -> dict:
    fields = refmesh.host_fields(*_args(spec))
    tmask = boussinesq.temperature_mask(fields["x"], spec["lims"], spec["bc_temp"])
    fields["vmask"] = np.concatenate([fields["vmask"], tmask[None]])
    return fields


def reference(spec: dict, dtype=torch.float64, device="cpu"):
    return refmesh.box_mesh(*_args(spec), dtype=dtype, device=device)
