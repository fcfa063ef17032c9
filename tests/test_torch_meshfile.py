"""Port parity: meshes from files and generators beyond the box.

`connectivity_from_coords` and `merge_periodic`, the backward-facing step
(`bfs_mesh`, `bfs_inflow`, `reference_bfs_bc`), genbox `.box` files
(`mesh_from_box`), Nek5000 `.re2` files (`mesh_from_re2`: #v002 and #v001
headers, 'C' arcs and 'm' midpoint curves, 'P' periodic pairs, v/O/W/SYM
and t/I, `bc_fn` with `cache_tag`, `partition` with `from_file_order`),
`rcb_order`, the mesh cache and the gather `dssum` on a periodic pair
inside one element. Each file is written to `tmp_path` by the test itself
(a `.box` as tests/test_re2.py writes one, a `.re2` by the public layout,
`torch_port_helpers.write_re2`) and read by both packages, f64 on the CPU.
Tolerances: gidx, masks and eperm identical; coordinates and geometric
factors 1e-13 relative to the field's largest entry; dssum 1e-13.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neklab_tpu.mesh import bfs as jbfs
from neklab_tpu.mesh import connectivity as jconn
from neklab_tpu.mesh import core as jcore
from neklab_tpu.mesh import re2 as jre2
from neklab_tpu.mesh.boxfile import mesh_from_box as jmesh_from_box
from neklab_tpu.ops import sem as jsem
from neklab_tpu_torch.mesh import bfs, connectivity, core, re2
from neklab_tpu_torch.mesh.boxfile import mesh_from_box
from neklab_tpu_torch.mesh.cache import load_semmesh
from neklab_tpu_torch.mesh.core import MESH_FIELDS
from neklab_tpu_torch.ops import sem
from torch_port_helpers import absdiff, t, to_np, write_re2

EXACT = ("gidx", "gfirst", "vmask", "pmask", "tmask", "vmask_hat", "tmask_hat")


def assert_same_mesh(jmesh, mesh):
    assert (mesh.nel, mesh.nglob, mesh.ndim) == (jmesh.nel, jmesh.nglob, jmesh.ndim)
    assert (mesh.basis.n, mesh.basis.nd) == (jmesh.basis.n, jmesh.basis.nd)
    assert mesh.p_fixed == jmesh.p_fixed
    for k in MESH_FIELDS:
        a, b = np.asarray(getattr(jmesh, k)), to_np(getattr(mesh, k))
        assert a.shape == b.shape, k
        if k in EXACT:
            assert np.array_equal(a, b), k
        else:
            assert np.abs(a - b).max() <= 1e-13 * max(1.0, np.abs(a).max()), k
    if jmesh.eperm is None:
        assert mesh.eperm is None
    else:
        assert np.array_equal(np.asarray(jmesh.eperm), to_np(mesh.eperm))


@pytest.fixture(autouse=True)
def mesh_cache(tmp_path, monkeypatch):
    """Both packages' mesh cache in the test's own directory."""
    path = tmp_path / "mesh_cache"
    monkeypatch.setenv("NEKLAB_MESH_CACHE", str(path))
    return path


# -- connectivity ------------------------------------------------------------


def test_connectivity_and_periodic_merge():
    rng = np.random.default_rng(3)
    # a 3 x 2 grid of order-4 elements, nodes jittered far below the tolerance
    z = (1 - np.cos(np.pi * np.arange(5) / 4)) / 2
    xs, ys = np.arange(3)[:, None] + z, np.arange(2)[:, None] + z
    x = np.stack(np.broadcast_arrays(xs[None, :, None, :], ys[:, None, :, None]))
    x = x.reshape(2, 6, 5, 5) + 1e-11 * rng.standard_normal((2, 6, 5, 5))
    gidx = connectivity.connectivity_from_coords(x, tol=1e-8)
    assert np.array_equal(gidx, jconn.connectivity_from_coords(x, tol=1e-8))
    assert gidx.max() + 1 == 13 * 9
    per = connectivity.merge_periodic(gidx, x, 0, 3.0)
    assert np.array_equal(per, jconn.merge_periodic(gidx, x, 0, 3.0))
    assert per.max() + 1 == 12 * 9
    with pytest.raises(ValueError):
        connectivity.merge_periodic(gidx, x, 0, 2.5)


# -- the backward-facing step ------------------------------------------------

BFS = dict(li=2, lo=8, nel_li=2, nel_lo=6, nel_y_in=2, nel_y_step=2, order=5)


def test_bfs_mesh_matches_reference():
    jmesh, mesh = jbfs.bfs_mesh(**BFS), bfs.bfs_mesh(**BFS, device="cpu")
    assert mesh.nel == 2 * 2 + 6 * 2 + 6 * 2
    assert_same_mesh(jmesh, mesh)
    assert absdiff(bfs.bfs_inflow(mesh), jbfs.bfs_inflow(jmesh)) <= 1e-15
    assert not mesh.p_fixed and mesh.bc == jmesh.bc


def test_reference_bfs_bc_classification():
    assert bfs.REFERENCE_BFS_CACHE_TAG == jbfs.REFERENCE_BFS_CACHE_TAG
    for c in ((-20.0, 5.0), (100.0, 3.0), (10.0, 19.5), (-10.0, 1.0), (-1.0, 1.0),
              (30.0, 0.0), (0.3, 0.7)):
        assert bfs.reference_bfs_bc(np.array(c)) == jbfs.reference_bfs_bc(np.array(c))


# -- genbox .box files ----------------------------------------------------------

BOXES = {
    "graded": """\
2                 ndim
2                 nfields
Box
-4 3              nelx nely
0.0 2.0 1.3       x0 x1 ratio
0.0 0.4 1.1 2.0   explicit y edges
P  ,P  ,W  ,W  ,
P  ,P  ,t  ,I  ,
""",
    "cylindrical": """\
2
1
CBox
0.5 -0.25         center
-2 -8
1.0 2.0 1.0
0.0 360.0 1.0
W  ,v  ,P  ,P  ,
""",
    "mixed": """\
2
1
Box
-3 -2
0.0 3.0 1.0
-1.0 1.0 0.8
v  ,O  ,SYM,W  ,
""",
}


@pytest.mark.parametrize("name", sorted(BOXES))
def test_mesh_from_box_matches_reference(tmp_path, name):
    path = tmp_path / f"{name}.box"
    path.write_text(BOXES[name])
    jmesh = jmesh_from_box(str(path), order=4)
    mesh = mesh_from_box(str(path), order=4, device="cpu")
    assert_same_mesh(jmesh, mesh)
    assert mesh.bc == jmesh.bc


# -- Nek5000 .re2 files ----------------------------------------------------------


def grid(nx, ny, x0=0.0, y0=0.0):
    """Corner arrays of an nx x ny grid of unit squares, element e = j nx + i."""
    i, j = np.meshgrid(np.arange(nx), np.arange(ny))
    i, j = i.reshape(-1) + x0, j.reshape(-1) + y0
    return (np.stack([i, i + 1, i + 1, i], 1).astype(float),
            np.stack([j, j, j + 1, j + 1], 1).astype(float))


def re2_v2(path):
    """3 x 2 elements on [0, 3] x [0, 2]: 'v' on the left, 'O' on the right,
    'W' below and above the first column, 'P' pairs joining the bottom and
    top of the other two, one 'C' arc on the outflow side of element 2,
    'E' on interior faces; the scalar 't' on the left, 'I' on the right."""
    xc, yc = grid(3, 2)
    vel, tmp = [], []
    for e in range(6):
        i, j = e % 3, e // 3
        vel.append((e, 3, (), "v") if i == 0 else (e, 3, (), "E"))
        vel.append((e, 1, (), "O") if i == 2 else (e, 1, (), "E"))
        if j == 0:
            vel.append((e, 0, (), "W") if i == 0 else (e, 0, (e + 4, 3), "P"))
        else:
            vel.append((e, 2, (), "W") if i == 0 else (e, 2, (e - 2, 1), "P"))
        tmp.append((e, 3, (), "t") if i == 0 else (e, 1, (), "I"))
    write_re2(path, xc, yc, curves=[(2, 1, (2.0,), "C")], bcs=[vel, tmp])


def re2_v1(path):
    """#v001 (real*4), one element wide: 1 x 2 elements on [0, 1] x [0, 2],
    each element's left side paired with its own right side ('P'), 'W'
    below, 'SYM' above with an 'm' midpoint curve bulging to y = 2.1."""
    xc, yc = grid(1, 2)
    vel = [(0, 3, (1, 2), "P"), (0, 1, (1, 4), "P"), (1, 3, (2, 2), "P"), (1, 1, (2, 4), "P"),
           (0, 0, (), "W"), (1, 2, (), "SYM")]
    write_re2(path, xc, yc, curves=[(1, 2, (0.5, 2.1), "m")], bcs=[vel], version=1)


@pytest.mark.parametrize("kind", ["v002", "v001"])
def test_mesh_from_re2_matches_reference(tmp_path, kind):
    path = str(tmp_path / f"{kind}.re2")
    (re2_v2 if kind == "v002" else re2_v1)(path)
    data, jdata = re2.read_re2(path), jre2.read_re2(path)
    assert [c for *_, c in data.curves] == [c for *_, c in jdata.curves] == (
        ["C"] if kind == "v002" else ["m"])
    assert [[r[3] for r in f] for f in data.bcs] == [[r[3] for r in f] for f in jdata.bcs]
    jmesh = jre2.mesh_from_re2(path, order=5, cache=False)
    mesh = re2.mesh_from_re2(path, order=5, cache=False, device="cpu")
    assert_same_mesh(jmesh, mesh)
    assert mesh.bc == jmesh.bc
    # the arc and the midpoint curve moved boundary nodes off the straight edge
    xmax = float(mesh.x[0].max()) if kind == "v002" else float(mesh.x[1].max())
    assert xmax > (3.0 if kind == "v002" else 2.0) + 1e-3
    rng = np.random.default_rng(5)
    f = rng.standard_normal((2,) + tuple(mesh.bm1.shape))
    assert absdiff(sem.dssum(mesh, t(f)), jsem.dssum(jmesh, jnp.asarray(f))) <= 1e-13


def test_dssum_with_a_periodic_pair_inside_one_element(tmp_path):
    """On the one-element-wide periodic mesh two copies of one DOF sit in
    the same element: the gather sums both, as the reference's scatter-add
    does, and a C0 field passes through dsavg unchanged."""
    path = str(tmp_path / "narrow.re2")
    re2_v1(path)
    mesh = re2.mesh_from_re2(path, order=4, cache=False, device="cpu")
    g = mesh.gidx.numpy()
    assert np.array_equal(g[:, 0], g[:, -1])  # left and right columns are one DOF
    copies = mesh.dss_copies.numpy()
    e0 = np.arange(g.size).reshape(g.shape)[:, :, 0].reshape(-1)  # element 0's nodes
    same_el = [(copies[p][copies[p] < g.size] % mesh.nel == 0).sum() for p in e0]
    assert max(same_el) >= 2
    ones = torch.ones_like(mesh.bm1)
    mult = sem.dssum(mesh, ones)
    assert float((mult * mesh.vmult - 1).abs().max()) <= 1e-15
    smooth = torch.cos(2 * np.pi * mesh.x[0]) * mesh.x[1]
    assert float((sem.dsavg(mesh, smooth) - smooth).abs().max()) <= 1e-13


def test_bc_fn_and_partition_match_reference(tmp_path, mesh_cache):
    path = str(tmp_path / "msh.re2")
    xc, yc = grid(4, 3)
    write_re2(path, xc, yc, curves=[(1, 0, (1.5, -0.2), "m")],
              bcs=[[(e, s, (), "MSH") for e in range(12) for s in range(4)]])

    def bc_fn(c):
        if c[0] < 1e-9:
            return "vt"
        if c[0] > 4 - 1e-9:
            return "O"
        return "SYM" if c[1] > 3 - 1e-9 else "W"

    kw = dict(order=4, bc_fn=bc_fn, cache_tag="test-bc-v1", partition=3)
    jmesh = jre2.mesh_from_re2(path, **kw)
    mesh = re2.mesh_from_re2(path, device="cpu", **kw)
    assert mesh.eperm is not None and not np.array_equal(mesh.eperm.numpy(), np.arange(12))
    assert_same_mesh(jmesh, mesh)
    file_order = np.random.default_rng(2).standard_normal((2, 5, 5, 12))
    assert absdiff(core.from_file_order(mesh, t(file_order)),
                   jcore.from_file_order(jmesh, file_order)) == 0.0
    assert absdiff(core.from_file_order(mesh, file_order),
                   jcore.from_file_order(jmesh, file_order)) == 0.0
    # the cached entry (the tag names the BC assignment) loads the same mesh
    entries = [f for f in os.listdir(mesh_cache) if f.startswith("torch_re2_")]
    assert len(entries) == 1
    again = re2.mesh_from_re2(path, device="cpu", **kw)
    assert_same_mesh(jmesh, again)


# -- recursive coordinate bisection ------------------------------------------------


@pytest.mark.parametrize("path", ["native", "numpy"])
def test_rcb_order_matches_reference(monkeypatch, path):
    """Like with like: the port's native library against the reference's,
    and the numpy recursions against each other (the two may split equal
    centroids differently). The centroids carry many ties."""
    from neklab_tpu import native as jnative
    from neklab_tpu_torch import native

    if path == "numpy":
        monkeypatch.setattr(native, "rcb_partition", lambda c, n: None)
        monkeypatch.setattr(jnative, "rcb_partition", lambda c, n: None)
    else:
        assert native.available() and jnative.available()
    rng = np.random.default_rng(9)
    for nel, ndim, nparts in ((500, 2, 7), (1000, 2, 37), (300, 3, 16)):
        cent = np.round(rng.random((nel, ndim)) * 9) / 9
        perm = re2.rcb_order(cent, nparts)
        assert np.array_equal(perm, jre2.rcb_order(cent, nparts))
        assert np.array_equal(np.sort(perm), np.arange(nel))


# -- the mesh cache -----------------------------------------------------------------


def test_mesh_cache_roundtrip(tmp_path, mesh_cache):
    path = str(tmp_path / "v002.re2")
    re2_v2(path)
    m1 = re2.mesh_from_re2(path, order=4, device="cpu")
    jre2.mesh_from_re2(path, order=4)  # the reference's entry in the same directory
    files = sorted(os.listdir(mesh_cache))
    ours = [f for f in files if f.startswith("torch_re2_")]
    assert len(ours) == 1 and len(files) == 2
    m2 = re2.mesh_from_re2(path, order=4, device="cpu")  # a hit
    for k in MESH_FIELDS + ("dss_copies",):
        a, b = getattr(m1, k), getattr(m2, k)
        assert a.dtype == b.dtype and torch.equal(a, b), k
    assert (m1.nel, m1.nglob, m1.bc, m1.basis.n, m1.basis.nd) == (
        m2.nel, m2.nglob, m2.bc, m2.basis.n, m2.basis.nd)
    # another order or dtype is another entry; a float32 entry stays float32
    m3 = re2.mesh_from_re2(path, order=3, dtype=torch.float32, device="cpu")
    m4 = re2.mesh_from_re2(path, order=3, dtype=torch.float32, device="cpu")
    assert m4.dtype == torch.float32 and torch.equal(m3.x, m4.x)
    assert len([f for f in os.listdir(mesh_cache) if f.startswith("torch_re2_")]) == 2
    # the port never loads the reference's entry
    (theirs,) = [f for f in files if not f.startswith("torch_re2_")]
    with pytest.raises((ValueError, KeyError)):
        load_semmesh(os.path.join(mesh_cache, theirs), device="cpu")
