"""P(N)/P(N-2) divergence/gradient pair and the pressure (E) operator.

The pressure lives on the element-interior Gauss grid (mesh 2) and is
discontinuous across elements: incompressibility and all pressure coupling
go through the div/grad pair

  div_weak(u)[q]  = (q, div u)      : velocity -> pressure space
  grad_weak_t(p)  = div_weak^T p    : the (p, div v) momentum term

and the fractional-step operator E = div ((dt/g0) Binv_masked dssum(grad^T .))
is symmetric positive semi-definite by construction.

Batching: a pressure field may carry leading axes, [*lead, pts2..., nel];
vector fields put their component axis first, [ndim, *lead, pts..., nel].
That written-out batch axis is how the preconditioner probes E.
"""

from __future__ import annotations

import torch

from ..mesh.core import SemMesh
from ..ops import sem
from ..ops.tensor import grad_rst, grad_rst_t, interp_nd, interp_nd_t


def _rx(mesh: SemMesh, nlead: int) -> torch.Tensor:
    """mesh.rx [ndim, ndim, pts..., nel] with `nlead` unit axes after the
    first two, to meet a field's leading batch axes."""
    rx = mesh.rx
    return rx.reshape(rx.shape[:2] + (1,) * nlead + rx.shape[2:])


def div_weak(mesh: SemMesh, u: torch.Tensor) -> torch.Tensor:
    """(q, div u) for all pressure test functions q: [ndim, *lead, ...] ->
    [*lead, pts2..., nel]. Every component is differentiated at once (ndim
    contractions, not ndim^2) and the chain rule is one product and one sum
    over (a, k): a handful of launches on the card in place of ~30 in 3-D."""
    du = torch.stack(grad_rst(u, mesh.d, mesh.ndim))  # [a, k, *lead, pts..., nel]
    divu = (_rx(mesh, u.dim() - 1 - mesh.bm1.dim()) * du).sum((0, 1))
    return interp_nd(mesh.j12, divu, mesh.ndim) * mesh.bm2


def grad_weak_t(mesh: SemMesh, p: torch.Tensor) -> torch.Tensor:
    """Exact transpose of div_weak: out_k = sum_a D_a^T (rx[a,k] I12^T (bm2 p)),
    all k at once."""
    w = interp_nd_t(mesh.j12, p * mesh.bm2, mesh.ndim)
    f = _rx(mesh, p.dim() - mesh.bm2.dim()) * w  # [a, k, *lead, pts..., nel]
    return grad_rst_t(tuple(f), mesh.d, mesh.ndim)


def pressure_correct_velocity(mesh: SemMesh, dp: torch.Tensor, dt_over_g0) -> torch.Tensor:
    """du = (dt/g0) * Binv * vmask * dssum(grad^T dp)."""
    gp = grad_weak_t(mesh, dp)  # [ndim, *lead, pts..., nel]
    nlead = gp.dim() - mesh.vmask.dim()
    vmask = mesh.vmask.reshape(mesh.vmask.shape[:1] + (1,) * nlead + mesh.vmask.shape[1:])
    # the field meets each mesh field in a product of its own (a product of
    # constants made per call would be kept by autograd's tape)
    return sem.dssum(mesh, gp) * vmask * mesh.binv * dt_over_g0


def e_op(mesh: SemMesh, dp: torch.Tensor, dt_over_g0) -> torch.Tensor:
    """The SPD pressure Schur-complement approximation E dp."""
    return div_weak(mesh, pressure_correct_velocity(mesh, dp, dt_over_g0))


def remove_pressure_mean(mesh: SemMesh, p: torch.Tensor) -> torch.Tensor:
    """Zero bm2-weighted (physical) mean."""
    return p - torch.sum(p * mesh.bm2) / torch.sum(mesh.bm2)


def project_onto_range(rhs: torch.Tensor) -> torch.Tensor:
    """Project onto range(E) = {r : sum r = 0} (Euclidean: E's nullspace is
    the constant vector)."""
    return rhs - torch.mean(rhs)
