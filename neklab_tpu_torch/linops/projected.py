"""Wavenumber-projected exponential propagator (exptA_proj).

For streamwise-periodic flows: restricts the propagator to one Fourier
wavenumber alpha by projecting onto span{cos(alpha x), sin(alpha x)} with a
streamwise plane average, before and after the time integration:

  M_alpha = P_alpha exp(tau A) P_alpha.

Counterpart of `neklab_tpu.linops.projected`: on a structured box mesh the
plane average is a weighted contraction over the (element-x, node-x) axes
of the element-last field. Each element's share of the cos (and sin)
coefficients of every row of elements is summed into a [..., n, nely]
buffer by its row index, so the same code serves a rank's block of a
partitioned mesh, any block (also one that cuts a row of elements): the
ranks' buffers are summed in one all-reduce, where the reference's XLA
places a psum over the element axis.
"""

from __future__ import annotations

import numpy as np
import torch

from ..krylov.linop import LinearOperator
from ..mesh.core import SemMesh
from ..parallel.sharding import global_sum
from .exponential_propagator import ExponentialPropagator


def _box_shape(mesh: SemMesh) -> tuple[int, ...]:
    for k, v in mesh.bc:
        if k == "__box__":
            return tuple(int(t) for t in v.split("x"))
    raise ValueError("mesh has no structured-box metadata (__box__)")


class ProjectedPropagator(LinearOperator):
    """M_alpha = P exp(tau A) P over {u, theta} vectors.

    Valid for tensor-product (undeformed) 2-D box meshes, periodic in x; the
    x-line quadrature weights come from the mesh coordinates and the GLL
    rule. On a rank's block the element widths and the period Lx come from
    the global mesh on the host (`Partition.global_mesh`), and each rank
    keeps the weights of its own elements."""

    def __init__(self, exptA: ExponentialPropagator, alpha: float):
        self.exptA = exptA
        mesh = exptA.mesh
        self.mesh = mesh
        if mesh.ndim != 2:
            raise NotImplementedError("ProjectedPropagator: 2-D only")
        part = mesh.part
        whole = mesh if part is None else part.global_mesh
        nelx, nely = _box_shape(mesh)
        n = mesh.basis.n
        # element-last layout: field [.., j, i, nel] with nel C-ordered (ey, ex)
        x = whole.x[0].detach().cpu().numpy().astype(np.float64).reshape(n, n, nely, nelx)
        dxe = x[0, -1, 0, :] - x[0, 0, 0, :]  # [nelx] element widths
        self.lx = float(dxe.sum())
        e0, e1 = (0, mesh.nel) if part is None else part.block(whole.nel)
        ey, ex = np.divmod(np.arange(e0, e1), nelx)  # this block's (row, column)
        w = np.asarray(mesh.basis.w)
        kw = dict(dtype=mesh.dtype, device=mesh.device)
        wx = torch.as_tensor(w[:, None] * (dxe[ex][None, :] / 2.0), **kw)  # [n_i, nel]
        # [nel, nely]: which row each element lies in (a product with it sums
        # by row deterministically, where a scatter-add's atomics would not)
        self.rows = torch.as_tensor(np.eye(nely)[ey], **kw)
        self.alpha = float(alpha)
        xj = mesh.x[0]  # [j, i, nel]
        basis = [torch.cos(alpha * xj)] + ([torch.sin(alpha * xj)] if alpha != 0.0 else [])
        self.cs = torch.stack(basis)  # [1 or 2, j, i, nel]: cos (and sin)
        self.wcs = self.cs * wx
        # ||cos(alpha x)||^2 over a full period = Lx/2 (alpha = 0: Lx)
        self.cnorm = self.lx if alpha == 0.0 else self.lx / 2.0

    @property
    def tau(self):
        return self.exptA.tau

    def _project_field(self, f: torch.Tensor) -> torch.Tensor:
        """[..., j, i, nel] -> its projection onto the alpha mode (same shape):
        each element's share of its row's coefficients, summed by row (and
        over the ranks, in one all-reduce), spread back onto the elements."""
        lead = tuple(f.shape[:-3])
        share = torch.einsum("...jie,cjie->c...je", f, self.wcs)  # [c, ..., j, nel]
        coef = global_sum(self.mesh.part, share @ self.rows) / self.cnorm  # [c, ..., j, nely]
        back = coef @ self.rows.T  # [c, ..., j, nel]
        cs = self.cs.reshape((self.cs.shape[0],) + (1,) * len(lead) + tuple(self.cs.shape[1:]))
        return (back.unsqueeze(-2) * cs).sum(0)

    def project(self, v: dict) -> dict:
        """The projection P_alpha (the reference's proj_alpha): u and theta
        together, one coefficient buffer (one all-reduce on a rank's block)."""
        u, theta = v["u"], v["theta"]
        both = self._project_field(torch.cat([u, theta]) if theta.numel() else u)
        return {"u": both[: u.shape[0]], "theta": both[u.shape[0]:] if theta.numel() else theta}

    def matvec(self, v: dict) -> dict:
        return self.project(self.exptA.matvec(self.project(v)))

    def rmatvec(self, v: dict) -> dict:
        return self.project(self.exptA.rmatvec(self.project(v)))
