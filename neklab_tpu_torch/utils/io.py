"""Field I/O: checkpoint/restart and result outposting.

Counterpart of `neklab_tpu/utils/io.py`, with its file names and npz keys, so
each package reads the other's files: `<prefix><case>0.f<NNNNN>.npz` field
files (the fields by name, `__time__`, `__x__` with a mesh), checkpoints
of a state dataclass (one key per field, `x_<name>` for extras) and
spectra as stacked [re, im] rows. Tensors go to numpy on the host;
`load_checkpoint` puts them back on the template's device.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any

import numpy as np
import torch

from ..parallel.sharding import _FLOW_STATE_AXES, gather_field, gather_state, shard_field
from .fldfile import _host


def _counter_name(outdir: str, prefix: str, case: str, counter: int | None) -> str:
    if counter is None:
        counter = _free_counter(outdir, prefix, case)
    return os.path.join(outdir, f"{prefix}{case}0.f{counter:05d}.npz")


def _free_counter(outdir: str, prefix: str, case: str) -> int:
    counter = 1
    while os.path.exists(os.path.join(outdir, f"{prefix}{case}0.f{counter:05d}.npz")):
        counter += 1
    return counter


def outpost(
    outdir: str,
    fields: dict[str, Any],
    mesh=None,
    prefix: str = "   ",
    case: str = "run",
    counter: int | None = None,
    time: float = 0.0,
    part=None,
) -> str:
    """Write a field file (the reference's outpost_dnek/outpost_nek) and
    return its path. fields: name -> tensor or array (None entries are
    skipped); counter None takes the first free number.

    part: the `Partition` of an element-partitioned run (the mesh's when
    None and a mesh is given): every rank calls this with its blocks, the
    fields (element axis last) are gathered, and rank 0 writes the
    one-process file; every rank returns its path once it is written."""
    if part is None and mesh is not None:
        part = mesh.part
    prefix = prefix.strip() or "out"
    x = None if mesh is None else mesh.x
    if part is not None:
        if counter is None:  # rank 0's choice, on every rank
            counter = int(part.from_root(_free_counter(outdir, prefix, case)))
        fields = {k: gather_field(v, part) for k, v in fields.items() if v is not None}
        x = None if mesh is None else gather_field(x, part)
    path = _counter_name(outdir, prefix, case, counter)
    if part is None or part.is_root:
        os.makedirs(outdir, exist_ok=True)
        data = {k: _host(v) for k, v in fields.items() if v is not None}
        data["__time__"] = np.asarray(float(time))
        if x is not None:
            data["__x__"] = _host(x)
        np.savez_compressed(path, **data)
    if part is not None:
        part.from_root(1.0)  # every rank returns once the file is there
    return path


def load_field_file(path: str) -> dict[str, np.ndarray]:
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def save_checkpoint(path: str, state, extra: dict | None = None, part=None) -> str:
    """Every field of a state dataclass (FlowState, PertState) to npz, with
    `extra` entries under `x_<name>`. part: the `Partition` of an
    element-partitioned run: every rank calls this with its block of the
    state, which is gathered, and rank 0 writes the one-process file (the
    extras as rank 0 holds them); every rank returns once it is written."""
    if part is not None:
        state = gather_state(state, part)
    if part is None or part.is_root:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        data = {f.name: _host(getattr(state, f.name)) for f in dataclasses.fields(state)}
        for k, v in (extra or {}).items():
            data["x_" + k] = _host(v)
        np.savez_compressed(path, **data)
    if part is not None:
        part.from_root(1.0)  # every rank returns once the file is there
    return path


def load_checkpoint(path: str, template, part=None) -> Any:
    """A dataclass of the template's type from a `save_checkpoint` file: each
    tensor field in the template's dtype and on its device (shapes must
    match); a plain number as the template holds it (FlowState.time).
    part: the `Partition` of an element-partitioned run whose block the
    template is: each rank keeps its block of the file's fields."""
    with np.load(path) as z:
        kwargs = {}
        for f in dataclasses.fields(template):
            arr, ref = z[f.name], getattr(template, f.name)
            want = np.shape(_host(ref))
            split = part is not None and f.name in _FLOW_STATE_AXES and \
                _FLOW_STATE_AXES[f.name] is not None
            if split:
                want = want[:-1] + (want[-1] * part.size,)
            if arr.shape != want:
                raise ValueError(f"checkpoint field {f.name}: shape {arr.shape}, the template's "
                                 f"{want}")
            if isinstance(ref, torch.Tensor):
                t = torch.as_tensor(arr, dtype=ref.dtype)
                kwargs[f.name] = (shard_field(t, part) if split else t).to(ref.device)
            else:
                kwargs[f.name] = type(ref)(arr)
        return dataclasses.replace(template, **kwargs)


def save_spectrum(path: str, eigvals: np.ndarray) -> None:
    """Eigenvalues as stacked [re, im] rows (.npy), `save_eigenspectrum`'s
    layout."""
    ev = np.asarray(eigvals, dtype=complex)
    np.save(path, np.stack([ev.real, ev.imag]))


def load_spectrum(path: str) -> np.ndarray:
    a = np.load(path)
    return a[0] + 1j * a[1]
