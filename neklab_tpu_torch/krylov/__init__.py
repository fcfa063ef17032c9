"""Krylov layer over dict-of-tensor vectors: Krylov-Schur Arnoldi eigs,
Lanczos-bidiagonalization svds, restarted (F)GMRES, CG, and inexact
Newton-Krylov with tolerance schedulers (`neklab_tpu/krylov/`'s surface).

As in the reference, `eigs`, `gmres` and `newton` are bound here to the
functions; their modules stay reachable by their full names
(`from neklab_tpu_torch.krylov.eigs import ...`)."""

from .space import (KrylovBasis, VectorSpace, euclidean_space, tree_add, tree_axpby, tree_scale,
                    tree_sub, tree_zeros_like)
from .linop import AdjointOperator, FunctionOperator, LinearOperator, NonlinearSystem
from .eigs import EigsResult, eigs
from .svd import SvdsResult, svds
from .gmres import GmresResult, cg, fgmres, gmres
from .newton import NewtonResult, constant_tol, dynamic_tol, newton

__all__ = [
    "KrylovBasis", "VectorSpace", "euclidean_space", "tree_add", "tree_axpby", "tree_scale",
    "tree_sub", "tree_zeros_like", "AdjointOperator", "FunctionOperator", "LinearOperator",
    "NonlinearSystem", "EigsResult", "eigs", "SvdsResult", "svds", "GmresResult", "cg", "fgmres",
    "gmres", "NewtonResult", "constant_tol", "dynamic_tol", "newton",
]
