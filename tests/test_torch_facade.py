"""The port's package surfaces against the reference's.

`neklab_tpu_torch.krylov` exports every name of `neklab_tpu.krylov.__all__`,
with `eigs`, `gmres` and `newton` bound to the functions as the reference
binds them (their modules stay reachable by their full names), and the
functions imported from there solve small Euclidean problems as the
reference's do: the same matvec counts, eigenvalues to 1e-10, the GMRES
solution to 1e-10. Every mesh builder and the process-group entry point
run on the CUDA card unless the caller asks for the CPU: here, without a
card, they raise and say so (`tests/test_torch_mesh.py` covers `box_mesh`
and `mesh_from_arrays`).
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import neklab_tpu.krylov as jkrylov
import neklab_tpu_torch.krylov as krylov
from neklab_tpu_torch import (annulus_mesh, bfs_mesh, box_mesh, init_distributed, mesh_from_box,
                              mesh_from_re2)
from neklab_tpu_torch.mesh.cache import load_semmesh, save_semmesh
from torch_port_helpers import absdiff, t, write_re2


def test_krylov_exports_every_reference_name():
    from neklab_tpu_torch.krylov import eigs, gmres, newton

    assert set(jkrylov.__all__) <= set(krylov.__all__)
    missing = [name for name in jkrylov.__all__ if not hasattr(krylov, name)]
    assert not missing, missing
    for f, ref in ((eigs, jkrylov.eigs), (gmres, jkrylov.gmres), (newton, jkrylov.newton)):
        assert callable(f) and not isinstance(f, types.ModuleType)
        assert f.__name__ == ref.__name__
    from neklab_tpu_torch.krylov.eigs import EigsResult  # the module by its full name

    assert krylov.EigsResult is EigsResult


def _dense_ops(a):
    aj, at_ = jnp.asarray(a), t(a)
    jop = jkrylov.FunctionOperator(matvec=lambda x: aj @ x, rmatvec=lambda x: aj.T @ x)
    op = krylov.FunctionOperator(matvec=lambda x: {"x": at_ @ x["x"]},
                                 rmatvec=lambda x: {"x": at_.T @ x["x"]})
    return jop, jkrylov.euclidean_space(), op, krylov.euclidean_space()


def test_eigs_from_the_krylov_package_matches_reference():
    """A 60 x 60 non-normal matrix with a known leading spectrum, both
    packages' `eigs` from one start vector."""
    rng = np.random.default_rng(3)
    n = 60
    q = np.linalg.qr(rng.standard_normal((n, n)))[0]
    lam = np.concatenate([[2.0, 1.7, 1.5, 1.3], rng.uniform(-0.9, 0.9, n - 4)])
    a = q @ (np.diag(lam) + np.triu(0.1 * rng.standard_normal((n, n)), 1)) @ q.T
    v0 = rng.standard_normal(n)
    jop, jspace, op, space = _dense_ops(a)
    kw = dict(nev=4, kdim=30, tol=1e-10, maxiter=20)
    ref = jkrylov.eigs(jop, jspace, v0=jnp.asarray(v0), **kw)
    res = krylov.eigs(op, space, v0={"x": t(v0)}, **kw)
    assert res.n_matvec == ref.n_matvec
    assert np.abs(res.eigvals - np.asarray(ref.eigvals)).max() <= 1e-10
    assert np.abs(np.sort(res.eigvals.real)[::-1] - lam[:4]).max() <= 1e-8


def test_gmres_from_the_krylov_package_matches_reference():
    rng = np.random.default_rng(4)
    n = 40
    a = np.eye(n) + 0.4 * rng.standard_normal((n, n)) / np.sqrt(n)
    b = rng.standard_normal(n)
    jop, jspace, op, space = _dense_ops(a)
    kw = dict(kdim=12, max_restarts=20, rtol=1e-11, atol=1e-14)
    ref = jkrylov.gmres(jop, jnp.asarray(b), jspace, **kw)
    res = krylov.gmres(op, {"x": t(b)}, space, **kw)
    assert res.converged and ref.converged
    assert (res.n_matvec, res.n_restart) == (ref.n_matvec, ref.n_restart)
    assert absdiff(res.x["x"], ref.x) <= 1e-10


def _re2(path):
    """Two unit squares side by side, walled."""
    xc = np.array([[0.0, 1.0, 1.0, 0.0], [1.0, 2.0, 2.0, 1.0]])
    yc = np.array([[0.0, 0.0, 1.0, 1.0]] * 2)
    vel = [(e, f, (), "E" if (e, f) in ((0, 1), (1, 3)) else "W")
           for e in range(2) for f in range(4)]
    write_re2(path, xc, yc, bcs=[vel])
    return path


BUILDERS = {
    "annulus_mesh": lambda tmp: annulus_mesh(2, 4, order=2),
    "bfs_mesh": lambda tmp: bfs_mesh(li=2, lo=8, nel_li=2, nel_lo=6, nel_y_in=2, nel_y_step=2,
                                     order=2),
    "mesh_from_box": lambda tmp: mesh_from_box(str(tmp / "m.box"), order=2),
    "mesh_from_re2": lambda tmp: mesh_from_re2(str(_re2(tmp / "m.re2")), order=2, cache=False),
    "load_semmesh": lambda tmp: load_semmesh(str(tmp / "m.npz")),
    "init_distributed": lambda tmp: init_distributed(
        backend="gloo", init_method="file://" + str(tmp / "rdv"), world_size=1, rank=0),
}


@pytest.mark.parametrize("builder", sorted(BUILDERS))
def test_builders_default_to_the_card(builder, tmp_path):
    """Without `device=` each builder puts its tensors on the current CUDA
    card; without a card it raises before it builds anything."""
    (tmp_path / "m.box").write_text(chip_smoke.BOX_FILE)
    save_semmesh(str(tmp_path / "m.npz"), box_mesh((2, 2), ((0, 1), (0, 1)), chip_smoke.WALLED,
                                                   order=2, device="cpu"))
    if torch.cuda.is_available():
        out = BUILDERS[builder](tmp_path)
        if builder == "init_distributed":
            import torch.distributed as dist

            assert out.device.type == "cuda"
            dist.destroy_process_group()
        else:
            assert out.device == torch.device("cuda", torch.cuda.current_device())
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            BUILDERS[builder](tmp_path)
