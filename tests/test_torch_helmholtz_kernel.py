"""Port parity: the fused 2-D Helmholtz apply.

On the CPU the port's `helmholtz_local` runs `helmholtz2d_plain`, the plain
twin of the CUDA kernel. It is held against the reference's Pallas kernel
(`HelmholtzPallas2D`, interpret mode on the CPU) and against the reference's
`sem.helmholtz_local`, on the cases of tests/test_pallas.py, with and
without a leading axis. Tolerance: 1e-11 absolute, that of test_pallas.py
(f64; the forms differ only in summation order).

The kernel itself runs only on a CUDA card: tests/test_torch_card.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neklab_tpu.mesh.box import box_mesh as jbox_mesh
from neklab_tpu.mesh.cylinder import annulus_mesh
from neklab_tpu.ops import sem as jsem
from neklab_tpu.ops.pallas_kernels import HelmholtzPallas2D
from neklab_tpu_torch.mesh.box import box_mesh
from neklab_tpu_torch.models import navier_stokes as ns
from neklab_tpu_torch.ops import helmholtz_kernel, sem
from torch_port_helpers import WALLED_BC, absdiff, carry_mesh, rel, t

ATOL = 1e-11


def _card_runs():
    """The kernel's run counter on the current card (0 with no card)."""
    return helmholtz_kernel.launches("cuda") if torch.cuda.is_available() else 0


def _case(name):
    if name == "box":
        kw = dict(nels=(5, 3), lims=((0.0, 2.0), (-1.0, 1.0)), bc=WALLED_BC, order=5)
        return jbox_mesh(**kw), box_mesh(**kw, device="cpu"), (0.01, 3.7), 0
    jmesh = annulus_mesh(3, 8, r_in=0.5, r_out=2.0, order=4, dtype=jnp.float64)
    return jmesh, carry_mesh(jmesh), (1.0, 0.0), 1


@pytest.mark.parametrize("lead", [(), (2,)])
@pytest.mark.parametrize("name", ["box", "annulus"])
def test_plain_twin_matches_pallas_and_sem(name, lead):
    jmesh, mesh, (h1, h2), seed = _case(name)
    u = np.random.default_rng(seed).standard_normal(jmesh.bm1.shape)
    if lead:
        u = np.stack([u, 2.0 * u])
    before = _card_runs()
    out = sem.helmholtz_local(mesh, t(u), h1, h2)
    assert _card_runs() == before  # CPU tensors never launch
    pallas = HelmholtzPallas2D(jmesh, h1, h2, block_elems=128)(jnp.asarray(u))
    ref = jsem.helmholtz_local(jmesh, jnp.asarray(u), h1, h2)
    assert tuple(out.shape) == u.shape
    assert absdiff(out, pallas) < ATOL
    assert absdiff(out, ref) < ATOL


def test_plain_3d_path_matches_reference():
    """3-D meshes keep the plain torch chain on the CPU."""
    kw = dict(nels=(2, 2, 2), lims=((0.0, 1.0), (0.0, 1.0), (0.0, 1.0)),
              bc={f: "W" for f in ("x-", "x+", "y-", "y+", "z-", "z+")}, order=3)
    jmesh, mesh = jbox_mesh(**kw), box_mesh(**kw, device="cpu")
    u = np.random.default_rng(2).standard_normal((3,) + tuple(jmesh.bm1.shape))
    out = sem.helmholtz_local(mesh, t(u), 0.5, 2.0)
    ref = jsem.helmholtz_local(jmesh, jnp.asarray(u), 0.5, 2.0)
    assert rel(out, ref) <= 1e-12


def test_launches_stay_zero_on_cpu_tensors():
    """The run counters live on the card: work on CPU tensors, the Jacobi
    probe included, never counts."""
    _, mesh, (h1, h2), _ = _case("box")
    u = t(np.random.default_rng(3).standard_normal((2,) + tuple(mesh.bm1.shape)))
    before = _card_runs()
    sem.helmholtz_local(mesh, u, h1, h2)
    ns.helmholtz_diag(mesh, h1, h2, mesh.vmask)
    assert helmholtz_kernel.launches("cpu") == 0
    assert _card_runs() == before
