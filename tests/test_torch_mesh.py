"""Port parity: meshes.

Both packages run the same numpy builder (box_mesh -> compute_geom ->
build_mesh), so every SemMesh field must agree to 1e-13 absolute (the
only possible difference is the final cast). `mesh_from_arrays` must carry
a reference mesh across exactly (bitwise): the annulus, which the port
cannot build yet, and a box.
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neklab_tpu.mesh.box import box_mesh as jbox_mesh
from neklab_tpu.mesh.cylinder import annulus_mesh
from neklab_tpu_torch.mesh.box import box_mesh
from neklab_tpu_torch.mesh.core import MESH_FIELDS
from torch_port_helpers import CHANNEL_BC, WALLED_BC, carry_mesh, to_np, wavy

MESHES = {
    "channel": dict(nels=(4, 5), lims=((0, 2 * np.pi), (-1, 1)), bc=CHANNEL_BC, order=6),
    "box": dict(nels=(5, 3), lims=((0.0, 2.0), (-1.0, 1.0)), bc=WALLED_BC, order=5),
    "deformed": dict(nels=(5, 3), lims=((0.0, 2.0), (-1.0, 1.0)), bc=WALLED_BC, order=5,
                     deform=wavy),
}


def _assert_same_mesh(mesh, jmesh, atol):
    assert (mesh.ndim, mesh.nel, mesh.nglob, mesh.bc) == (jmesh.ndim, jmesh.nel, jmesh.nglob,
                                                          jmesh.bc)
    assert (mesh.basis.n, mesh.basis.nd) == (jmesh.basis.n, jmesh.basis.nd)
    for k in MESH_FIELDS:
        a, b = to_np(getattr(mesh, k)), np.asarray(getattr(jmesh, k))
        assert a.shape == b.shape, (k, a.shape, b.shape)
        assert np.abs(a - b).max(initial=0.0) <= atol, k


@pytest.mark.parametrize("name", sorted(MESHES))
def test_box_mesh_matches_reference(name):
    kw = MESHES[name]
    mesh = box_mesh(**kw, device="cpu")
    jmesh = jbox_mesh(**kw)
    _assert_same_mesh(mesh, jmesh, 1e-13)
    assert mesh.gidx.dtype == torch.int64
    assert all(t.device.type == "cpu" for t in (mesh.bm1, mesh.gidx, mesh.d))
    if name == "deformed":
        assert np.abs(to_np(mesh.g[0, 1])).max() > 1e-3  # curved: cross metric present


@pytest.mark.parametrize("which", ["annulus", "box"])
def test_mesh_from_arrays_roundtrip(which):
    if which == "annulus":
        jmesh = annulus_mesh(3, 8, r_in=0.5, r_out=2.0, order=4, dtype=jnp.float64)
    else:
        jmesh = jbox_mesh(**MESHES["box"])
    mesh = carry_mesh(jmesh)
    _assert_same_mesh(mesh, jmesh, 0.0)
    np.testing.assert_array_equal(to_np(mesh.d), jmesh.basis.d)
    assert mesh.p_fixed == jmesh.p_fixed


def test_mesh_to_moves_every_tensor():
    mesh = box_mesh(**MESHES["box"], device="cpu").to("cpu")
    for k in MESH_FIELDS + ("d", "jd", "j12", "dss_copies"):
        assert getattr(mesh, k).device.type == "cpu"


@pytest.mark.parametrize("builder", ["box_mesh", "mesh_from_arrays"])
def test_mesh_defaults_to_the_card(builder):
    """Without `device=` a mesh lands on the current CUDA card; without a
    card the builder raises and says to pass device="cpu"."""
    if builder == "box_mesh":
        build = lambda: box_mesh(**MESHES["box"])
    else:
        build = lambda: carry_mesh(jbox_mesh(**MESHES["box"]), device=None)
    if torch.cuda.is_available():
        mesh = build()
        assert mesh.device == torch.device("cuda", torch.cuda.current_device())
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build()


def test_port_imports_without_jax():
    """Every module of the port, chip_smoke.py, tools/profile_torch_step.py
    and tools/newton_floor.py import without pulling in jax or
    neklab_tpu."""
    code = """
import importlib, importlib.util, pkgutil, sys
import neklab_tpu_torch
mods = [m.name for m in pkgutil.walk_packages(neklab_tpu_torch.__path__, "neklab_tpu_torch.")]
assert "neklab_tpu_torch.ops.helmholtz_kernel" in mods and len(mods) > 20, mods
for m in mods:
    importlib.import_module(m)
import chip_smoke
for tool in ("profile_torch_step", "newton_floor"):
    spec = importlib.util.spec_from_file_location(tool, f"tools/{tool}.py")
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "neklab_tpu"))
assert not bad, bad
"""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120, cwd=root)
