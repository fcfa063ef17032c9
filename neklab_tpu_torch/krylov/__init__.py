"""Krylov layer over dict-of-tensor vectors: Krylov-Schur Arnoldi eigs,
Lanczos-bidiagonalization svds, restarted (F)GMRES, CG, and inexact
Newton-Krylov with tolerance schedulers (`neklab_tpu.krylov`'s surface).

The three functions named like their modules, `eigs`, `gmres` and
`newton`, are not bound here, so that `krylov.eigs`, `krylov.gmres` and
`krylov.newton` stay the modules; import them from their modules or from
the package's top level (`from neklab_tpu_torch import eigs`)."""

from .eigs import EigsResult
from .gmres import GmresResult, cg, fgmres
from .linop import AdjointOperator, FunctionOperator, LinearOperator, NonlinearSystem
from .newton import NewtonResult, constant_tol, dynamic_tol
from .space import (KrylovBasis, VectorSpace, euclidean_space, tree_add, tree_axpby, tree_scale,
                    tree_sub, tree_zeros_like)
from .svd import SvdsResult, svds

__all__ = [
    "KrylovBasis", "VectorSpace", "euclidean_space", "tree_add", "tree_axpby", "tree_scale",
    "tree_sub", "tree_zeros_like", "AdjointOperator", "FunctionOperator", "LinearOperator",
    "NonlinearSystem", "EigsResult", "SvdsResult", "svds", "GmresResult", "cg", "fgmres",
    "NewtonResult", "constant_tol", "dynamic_tol",
]
