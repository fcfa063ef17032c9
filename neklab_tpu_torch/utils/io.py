"""Field I/O: checkpoint/restart and result outposting.

Counterpart of `neklab_tpu.utils.io`, with its file names and npz keys, so
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

from .fldfile import _host


def _counter_name(outdir: str, prefix: str, case: str, counter: int | None) -> str:
    if counter is None:
        counter = 1
        while os.path.exists(os.path.join(outdir, f"{prefix}{case}0.f{counter:05d}.npz")):
            counter += 1
    return os.path.join(outdir, f"{prefix}{case}0.f{counter:05d}.npz")


def outpost(
    outdir: str,
    fields: dict[str, Any],
    mesh=None,
    prefix: str = "   ",
    case: str = "run",
    counter: int | None = None,
    time: float = 0.0,
) -> str:
    """Write a field file (the reference's outpost_dnek/outpost_nek) and
    return its path. fields: name -> tensor or array (None entries are
    skipped); counter None takes the first free number."""
    os.makedirs(outdir, exist_ok=True)
    path = _counter_name(outdir, prefix.strip() or "out", case, counter)
    data = {k: _host(v) for k, v in fields.items() if v is not None}
    data["__time__"] = np.asarray(float(time))
    if mesh is not None:
        data["__x__"] = _host(mesh.x)
    np.savez_compressed(path, **data)
    return path


def load_field_file(path: str) -> dict[str, np.ndarray]:
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def save_checkpoint(path: str, state, extra: dict | None = None) -> str:
    """Every field of a state dataclass (FlowState, PertState) to npz, with
    `extra` entries under `x_<name>`."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    data = {f.name: _host(getattr(state, f.name)) for f in dataclasses.fields(state)}
    for k, v in (extra or {}).items():
        data["x_" + k] = _host(v)
    np.savez_compressed(path, **data)
    return path


def load_checkpoint(path: str, template) -> Any:
    """A dataclass of the template's type from a `save_checkpoint` file: each
    tensor field in the template's dtype and on its device (shapes must
    match); a plain number as the template holds it (FlowState.time)."""
    with np.load(path) as z:
        kwargs = {}
        for f in dataclasses.fields(template):
            arr, ref = z[f.name], getattr(template, f.name)
            if arr.shape != np.shape(_host(ref)):
                raise ValueError(f"checkpoint field {f.name}: shape {arr.shape}, the template's "
                                 f"{np.shape(_host(ref))}")
            if isinstance(ref, torch.Tensor):
                kwargs[f.name] = torch.as_tensor(arr, dtype=ref.dtype).to(ref.device)
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
