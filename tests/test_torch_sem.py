"""Port parity: SEM element operators and the pressure operators.

Same numpy-seeded inputs through `neklab_tpu` (JAX, f64) and
`neklab_tpu_torch` (torch, f64, CPU) on three meshes: the periodic channel,
the sinusoidally deformed walled box (g01 != 0) and the annulus carried
across with `mesh_from_arrays`. Tolerance: rel <= 1e-12 (max abs difference
over max abs of the reference) — the operators are the same arithmetic and
differ only in f64 summation order.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neklab_tpu.mesh.box import box_mesh as jbox_mesh
from neklab_tpu.mesh.cylinder import annulus_mesh
from neklab_tpu.models import stokes as jstokes
from neklab_tpu.ops import sem as jsem
from neklab_tpu_torch.mesh.box import box_mesh
from neklab_tpu_torch.models import stokes
from neklab_tpu_torch.ops import sem
from torch_port_helpers import CHANNEL_BC, WALLED_BC, carry_mesh, rel, t, wavy

TOL = 1e-12


def _meshes(name):
    if name == "channel":
        kw = dict(nels=(4, 5), lims=((0, 2 * np.pi), (-1, 1)), bc=CHANNEL_BC, order=6)
    elif name == "deformed":
        kw = dict(nels=(5, 3), lims=((0.0, 2.0), (-1.0, 1.0)), bc=WALLED_BC, order=5,
                  deform=wavy)
    else:
        jmesh = annulus_mesh(3, 8, r_in=0.5, r_out=2.0, order=4, dtype=jnp.float64)
        return jmesh, carry_mesh(jmesh)
    return jbox_mesh(**kw), box_mesh(**kw, device="cpu")


@pytest.fixture(scope="module", params=["channel", "deformed", "annulus"])
def case(request):
    jmesh, mesh = _meshes(request.param)
    rng = np.random.default_rng(7)
    shape = tuple(jmesh.bm1.shape)
    x = {
        "s": rng.standard_normal(shape),
        "v": rng.standard_normal((2,) + shape),
        "w": rng.standard_normal((2,) + shape),
        "U": rng.standard_normal((2,) + shape),
        "Th": rng.standard_normal((1,) + shape),
        "th": rng.standard_normal((1,) + shape),
        "q": rng.standard_normal(tuple(jmesh.bm2.shape)),
        "qb": rng.standard_normal((3,) + tuple(jmesh.bm2.shape)),
    }
    return jmesh, mesh, x


def _run(pkg_sem, pkg_stokes, m, x, op):
    if op == "dssum":
        return pkg_sem.dssum(m, x["v"])
    if op == "dsavg":
        return pkg_sem.dsavg(m, x["v"])
    if op == "grad":
        return pkg_sem.grad(m, x["s"])
    if op == "stiffness_local":
        return pkg_sem.stiffness_local(m, x["s"])
    if op == "helmholtz_local":
        return pkg_sem.helmholtz_local(m, x["v"], 0.01, 3.7)
    if op == "wgradp_t":
        return pkg_sem.wgradp_t(m, x["v"])
    if op == "grad_d":
        return pkg_sem.grad_d(m, x["s"])
    if op == "lin_convect_cache":
        c = pkg_sem.lin_convect_cache(m, x["U"], x["Th"])
        return [c["ud"], c["gradud"], c["gradthd"]]
    if op == "convect_lin_weak":
        c = pkg_sem.lin_convect_cache(m, x["U"], x["Th"])
        return list(pkg_sem.convect_lin_weak(m, x["v"], x["th"], c))
    if op == "mass_dot":
        return pkg_sem.mass_dot(m, x["v"], x["w"])
    if op == "div_weak":
        return pkg_stokes.div_weak(m, x["v"])
    if op == "grad_weak_t":
        return pkg_stokes.grad_weak_t(m, x["q"])
    if op == "pressure_correct_velocity":
        return pkg_stokes.pressure_correct_velocity(m, x["q"], 0.3)
    if op == "e_op":
        return pkg_stokes.e_op(m, x["q"], 0.3)
    raise ValueError(op)


OPS = ["dssum", "dsavg", "grad", "stiffness_local", "helmholtz_local", "wgradp_t", "grad_d",
       "lin_convect_cache", "convect_lin_weak", "mass_dot", "div_weak", "grad_weak_t",
       "pressure_correct_velocity", "e_op"]


@pytest.mark.parametrize("op", OPS)
def test_op_matches_reference(case, op):
    jmesh, mesh, x = case
    ref = _run(jsem, jstokes, jmesh, {k: jnp.asarray(v) for k, v in x.items()}, op)
    out = _run(sem, stokes, mesh, {k: t(v) for k, v in x.items()}, op)
    refs = ref if isinstance(ref, list) else [ref]
    outs = out if isinstance(out, list) else [out]
    for r, o in zip(refs, outs):
        assert tuple(o.shape) == tuple(np.shape(r))
        assert rel(o, r) <= TOL, (op, rel(o, r))


def test_batched_e_op_matches_vmap(case):
    """A written-out leading batch axis replaces the reference's vmap."""
    jmesh, mesh, x = case
    ref = jax.vmap(lambda z: jstokes.e_op(jmesh, z, 0.3))(jnp.asarray(x["qb"]))
    out = stokes.e_op(mesh, t(x["qb"]), 0.3)
    assert rel(out, ref) <= TOL


def test_dssum_matches_reference_general_forms(case):
    """The port has one gather-form dssum; without the structured-grid
    metadata the reference takes its face-pair or scatter-add form, and the
    sums agree."""
    jmesh, mesh, x = case
    general = dataclasses.replace(jmesh, bc=tuple(p for p in jmesh.bc if p[0] != "__struct__"))
    ref = jsem.dssum(general, jnp.asarray(x["v"]))
    assert rel(sem.dssum(mesh, t(x["v"])), ref) <= TOL
