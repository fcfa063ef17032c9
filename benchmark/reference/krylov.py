"""Plain Krylov recurrences in the mass-weighted inner product: the Arnoldi
and Golub-Kahan-Lanczos steps (classical Gram-Schmidt, two passes), as
records of what goes into and comes out of the operator and of the
projected matrix they build.

A record is a dict: lists of host tensors, `x` the inputs of the
operator's matvecs and `y` their outputs, and for Lanczos `u`, `z` the
inputs and outputs of its rmatvecs; Arnoldi's Hessenberg matrix `H`
(numpy, [steps + 1, steps]), Lanczos's `alphas` and `betas` (numpy; the
couplings y_j -> u_j and z_j -> x_{j+1}). The harness records the
program's driver in the same layout, so one check reads both.
"""

from __future__ import annotations

import numpy as np
import torch


def bdot(bm1, a, b) -> torch.Tensor:
    return torch.sum(a * b * bm1)


def bnorm(bm1, a) -> torch.Tensor:
    return torch.sqrt(torch.clamp_min(bdot(bm1, a, a), 0.0))


def project(bm1, w, basis: list):
    """w with its B-projections on the orthonormal `basis` removed, twice:
    -> (the B-normalized remainder, the summed projections h [len(basis)],
    the remainder's B-norm), the column that an Arnoldi step adds to its
    Hessenberg matrix."""
    h = torch.zeros(len(basis), dtype=w.dtype, device=w.device)
    if basis:
        stack = torch.stack(basis)
        for _ in range(2):
            c = (stack * w * bm1).flatten(1).sum(-1)
            w = w - torch.tensordot(c, stack, dims=([0], [0]))
            h = h + c
    beta = bnorm(bm1, w)
    return w / beta, h, beta


def orthonormalize(bm1, w, basis: list):
    return project(bm1, w, basis)[0]


def arnoldi(matvec, v0, bm1, steps: int) -> dict:
    """`steps` Arnoldi steps from v0: x[j] the j-th basis vector, y[j] = M x[j];
    x has steps + 1 entries."""
    x = [orthonormalize(bm1, v0, [])]
    rec = {"x": [x[0].cpu()], "y": [], "H": np.zeros((steps + 1, steps))}
    for j in range(steps):
        y = matvec(x[-1])
        rec["y"].append(y.cpu())
        w, h, beta = project(bm1, y, x)
        rec["H"][: j + 1, j] = h.cpu().numpy()
        rec["H"][j + 1, j] = float(beta)
        x.append(w)
        rec["x"].append(w.cpu())
    return rec


def lanczos(matvec, rmatvec, v0, bm1, steps: int) -> dict:
    """`steps` Golub-Kahan-Lanczos steps from v0 (full reorthogonalization):
    y[j] = M x[j], u[j] the orthonormalized y[j] (alphas[j] its norm), z[j]
    = M* u[j], x[j+1] the orthonormalized z[j] (betas[j])."""
    xs, us = [orthonormalize(bm1, v0, [])], []
    rec = {"x": [xs[0].cpu()], "y": [], "u": [], "z": [], "alphas": np.zeros(steps),
           "betas": np.zeros(steps)}
    for j in range(steps):
        y = matvec(xs[-1])
        rec["y"].append(y.cpu())
        u, _, a = project(bm1, y, us)
        us.append(u)
        rec["u"].append(u.cpu())
        rec["alphas"][j] = float(a)
        z = rmatvec(u)
        rec["z"].append(z.cpu())
        x, _, b = project(bm1, z, xs)
        xs.append(x)
        rec["x"].append(x.cpu())
        rec["betas"][j] = float(b)
    return rec
