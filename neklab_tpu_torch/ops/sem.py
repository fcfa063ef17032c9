"""Element-local and assembled SEM operators on torch tensors.

Counterparts of `neklab_tpu.ops.sem`. Fields are element-last
`[..., pts..., nel]`; vector fields put their component axis first. "Weak"
operators return quadrature-weighted, unassembled residuals; assembly across
element boundaries is the separate `dssum`.

`helmholtz_local` on a 2-D mesh goes through `ops.helmholtz_kernel`: the
hand-written CUDA kernel for CUDA tensors, its plain torch twin for CPU
tensors. On a 3-D mesh it is the plain torch chain on every device, as the
reference's 3-D apply is plain XLA: no TPU kernel exists for it.
"""

from __future__ import annotations

import functools

import torch

from ..mesh.core import SemMesh
from . import helmholtz_kernel
from .tensor import grad_rst, grad_rst_t, interp_nd, interp_nd_t, linear, tsum

__all__ = [
    "dssum",
    "dsavg",
    "grad",
    "grad_d",
    "stiffness_local",
    "helmholtz_local",
    "wgradp_t",
    "convect_weak",
    "convect_volume_weak",
    "lin_convect_cache",
    "convect_lin_weak",
    "mass_dot",
]


# ---------------------------------------------------------------------------
# direct-stiffness summation (gather-scatter)
# ---------------------------------------------------------------------------


def dssum(mesh: SemMesh, f: torch.Tensor) -> torch.Tensor:
    """Direct-stiffness sum: add all element-local copies of each shared DOF
    and write the sum back into every copy. Any leading axes.

    One gather form for every mesh: each copy gathers all copies of its DOF
    through `mesh.dss_copies` and sums them (pad, gather, sum: three
    launches, and deterministic, unlike an atomic scatter-add). It replaces
    the reference's structured, face-pair and scatter-add forms, which were
    shaped by what XLA fuses on the TPU.

    Q Q^T is symmetric, so under autograd the backward is `dssum` of the
    cotangent: deterministic, unlike the atomic `index_add_` that autograd
    would make of the gather."""
    if f.numel() == 0:
        return f
    return linear(functools.partial(_dssum, mesh), f)


def _dssum(mesh: SemMesh, f: torch.Tensor) -> torch.Tensor:
    lead = f.shape[: f.dim() - mesh.gidx.dim()]
    flat = torch.nn.functional.pad(f.reshape(lead + (-1,)), (0, 1))  # zero slot at the end
    copies = mesh.dss_copies
    out = flat.index_select(-1, copies.view(-1)).view(lead + tuple(copies.shape))
    return out.sum(-1).view(f.shape)


def dsavg(mesh: SemMesh, f: torch.Tensor) -> torch.Tensor:
    """Average shared DOFs (dssum weighted by 1/multiplicity)."""
    return dssum(mesh, f) * mesh.vmult


# ---------------------------------------------------------------------------
# differential operators
# ---------------------------------------------------------------------------


def grad(mesh: SemMesh, u: torch.Tensor) -> torch.Tensor:
    """Pointwise physical gradient of scalar field u -> [ndim, ...]."""
    durst = grad_rst(u, mesh.d, mesh.ndim)
    return torch.stack(
        [tsum(mesh.rx[a, j] * durst[a] for a in range(mesh.ndim)) for j in range(mesh.ndim)]
    )


def stiffness_local(mesh: SemMesh, u: torch.Tensor) -> torch.Tensor:
    """Unassembled weak Laplacian: out = sum_a D_a^T ( sum_b g[a,b] D_b u )."""
    nd = mesh.ndim
    du = grad_rst(u, mesh.d, nd)
    flux = tuple(tsum(mesh.g[a, b] * du[b] for b in range(nd)) for a in range(nd))
    return grad_rst_t(flux, mesh.d, nd)


def helmholtz_local(mesh: SemMesh, u: torch.Tensor, h1, h2) -> torch.Tensor:
    """Unassembled Helmholtz operator h1 * A u + h2 * B u (Nek `axhelm`).

    2-D: the fused Helmholtz kernel (CUDA tensors) or its plain twin (CPU
    tensors). 3-D: the plain torch chain (per-axis batched matmuls and
    elementwise products) on any device. The map is symmetric per element,
    so it runs through `tensor.linear` as its own transpose: a backward or a
    forward-mode tangent applies the map again instead of recording its
    ~30 intermediates, each of them a whole field."""
    if mesh.ndim == 2:
        g = mesh.g
        return helmholtz_kernel.helmholtz2d(
            u.contiguous(), mesh.d, g[0, 0], g[0, 1], g[1, 1], mesh.bm1, h1, h2
        )
    return linear(lambda v: h1 * stiffness_local(mesh, v.contiguous()) + h2 * mesh.bm1 * v, u)


def wgradp_t(mesh: SemMesh, v: torch.Tensor) -> torch.Tensor:
    """Weak transpose gradient of a vector field: rhs_i = (grad phi_i, v)."""
    nd = mesh.ndim
    flux = tuple(
        tsum(mesh.rx[a, k] * v[k] for k in range(nd)) * mesh.bm1 for a in range(nd)
    )
    return grad_rst_t(flux, mesh.d, nd)


# ---------------------------------------------------------------------------
# dealiased convection
# ---------------------------------------------------------------------------


def grad_d(mesh: SemMesh, u: torch.Tensor) -> torch.Tensor:
    """Physical gradient of u evaluated on the dealias (Gauss) grid."""
    nd = mesh.ndim
    durst_d = [interp_nd(mesh.jd, c, nd) for c in grad_rst(u, mesh.d, nd)]
    return torch.stack(
        [tsum(mesh.rxd[a, j] * durst_d[a] for a in range(nd)) for j in range(nd)]
    )


def convect_weak(mesh: SemMesh, u: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Weak-form dealiased convection of u by the velocity c:

      out_i = (phi_i, c . grad u)  evaluated on the Gauss dealias grid.

    u: [*lead, pts..., nel], any leading axes (one field or several, all
    convected at once); c: [ndim, pts..., nel] (GLL grid). Each field goes
    through one interpolation to the dealias grid, its leading axes
    batched, and one projection back. Returns the mass-weighted residual on
    the GLL grid."""
    jd = mesh.jd
    nd = mesh.ndim
    c_d = interp_nd(jd, c, nd)
    durst_d = interp_nd(jd, torch.stack(grad_rst(u, mesh.d, nd)), nd)  # [nd, *lead, ...]
    s = None
    for k in range(nd):
        term = c_d[k] * tsum(mesh.rxd[a, k] * durst_d[a] for a in range(nd))
        s = term if s is None else s + term
    return interp_nd_t(jd, s * mesh.bmd, nd)


def convect_volume_weak(mesh: SemMesh, u: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """`convect_weak` of every component of the vector field u [ndim, ...]
    (the components are convected together, as one batch)."""
    return convect_weak(mesh, u, c)


def lin_convect_cache(mesh: SemMesh, base_u: torch.Tensor, base_theta=None) -> dict:
    """Frozen base-flow quantities of the linearized advection on the
    dealias grid, computed once per propagate: U_d[k] = I_d U_k,
    gradU_d[i, k] = (grad_d U_i)_k and (with scalars) gradTh_d[s, k]."""
    nd = mesh.ndim
    u_d = torch.stack([interp_nd(mesh.jd, base_u[k], nd) for k in range(nd)])
    gradu_d = torch.stack([grad_d(mesh, base_u[i]) for i in range(nd)])
    if base_theta is not None and base_theta.shape[0]:
        gradth_d = torch.stack([grad_d(mesh, base_theta[s]) for s in range(base_theta.shape[0])])
    else:
        gradth_d = None
    return {"ud": u_d, "gradud": gradu_d, "gradthd": gradth_d}


def convect_lin_weak(mesh: SemMesh, u: torch.Tensor, theta, cache: dict):
    """Weak-form linearized advection about a frozen base (U, Theta):

        n_u[i] = (phi_i, U . grad u_i) + (phi_i, u . grad U_i)
        n_t[s] = (q,     U . grad th_s) + (q,     u . grad Th_s)

    with the base quantities from `lin_convect_cache`. Returns (n_u, n_t);
    n_t is None without scalars."""
    ud_base, gradud_base, gradthd_base = cache["ud"], cache["gradud"], cache["gradthd"]
    jd = mesh.jd
    nd = mesh.ndim
    u_d = [interp_nd(jd, u[k], nd) for k in range(nd)]

    def fused(field, grad_base_row):
        durst_d = [interp_nd(jd, c, nd) for c in grad_rst(field, mesh.d, nd)]
        s = None
        for k in range(nd):
            g_k = tsum(mesh.rxd[a, k] * durst_d[a] for a in range(nd))
            term = ud_base[k] * g_k + u_d[k] * grad_base_row[k]
            s = term if s is None else s + term
        return interp_nd_t(jd, s * mesh.bmd, nd)

    n_u = torch.stack([fused(u[i], gradud_base[i]) for i in range(nd)])
    n_t = None
    if theta is not None and theta.shape[0]:
        n_t = torch.stack([fused(theta[s], gradthd_base[s]) for s in range(theta.shape[0])])
    return n_u, n_t


# ---------------------------------------------------------------------------
# inner products
# ---------------------------------------------------------------------------


def mass_dot(mesh: SemMesh, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Mass-weighted global inner product sum(u * v * bm1) over all axes."""
    return torch.sum(u * v * mesh.bm1)
