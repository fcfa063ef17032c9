"""Wavenumber-projected exponential propagator (exptA_proj).

For streamwise-periodic flows: restricts the propagator to one Fourier
wavenumber alpha by projecting onto span{cos(alpha x), sin(alpha x)} with a
streamwise plane average, before and after the time integration:

  M_alpha = P_alpha exp(tau A) P_alpha.

Counterpart of `neklab_tpu.linops.projected`: on a structured box mesh the
plane average is a weighted contraction over the (element-x, node-x) axes
of the element-last field, one einsum per coefficient.
"""

from __future__ import annotations

import numpy as np
import torch

from ..krylov.linop import LinearOperator
from ..mesh.core import SemMesh
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
    rule."""

    def __init__(self, exptA: ExponentialPropagator, alpha: float):
        self.exptA = exptA
        mesh = exptA.mesh
        self.mesh = mesh
        if mesh.ndim != 2:
            raise NotImplementedError("ProjectedPropagator: 2-D only")
        nelx, nely = _box_shape(mesh)
        n = mesh.basis.n
        # element-last layout: field [.., j, i, nel] with nel C-ordered (ey, ex)
        self.shape_el = (n, n, nely, nelx)
        x = mesh.x[0].detach().cpu().numpy().astype(np.float64).reshape(self.shape_el)
        dxe = x[0, -1, 0, :] - x[0, 0, 0, :]  # [nelx] element widths
        w = np.asarray(mesh.basis.w)
        kw = dict(dtype=mesh.dtype, device=mesh.device)
        self.wx = torch.as_tensor((dxe[:, None] / 2.0) * w[None, :], **kw)  # [nelx, n_i]
        self.lx = float(dxe.sum())
        xj = mesh.x[0].reshape(self.shape_el)
        self.cv = torch.cos(alpha * xj)  # [j, i, ney, nex]
        self.sv = torch.sin(alpha * xj)
        self.alpha = float(alpha)
        # ||cos(alpha x)||^2 over a full period = Lx/2 (alpha = 0: Lx)
        self.cnorm = self.lx if alpha == 0.0 else self.lx / 2.0

    @property
    def tau(self):
        return self.exptA.tau

    def _project_field(self, f: torch.Tensor) -> torch.Tensor:
        """[..., j, i, nel] -> its projection onto the alpha mode (same shape)."""
        lead = tuple(f.shape[:-3])
        g = f.reshape(lead + self.shape_el)
        a = torch.einsum("...jiyx,xi,jiyx->...jy", g, self.wx, self.cv) / self.cnorm
        rec = torch.einsum("...jy,jiyx->...jiyx", a, self.cv)
        if self.alpha != 0.0:
            b = torch.einsum("...jiyx,xi,jiyx->...jy", g, self.wx, self.sv) / self.cnorm
            rec = rec + torch.einsum("...jy,jiyx->...jiyx", b, self.sv)
        return rec.reshape(f.shape)

    def project(self, v: dict) -> dict:
        """The projection P_alpha (the reference's proj_alpha)."""
        return {
            "u": self._project_field(v["u"]),
            "theta": self._project_field(v["theta"]) if v["theta"].numel() else v["theta"],
        }

    def matvec(self, v: dict) -> dict:
        return self.project(self.exptA.matvec(self.project(v)))

    def rmatvec(self, v: dict) -> dict:
        return self.project(self.exptA.rmatvec(self.project(v)))
