"""Laminar flow in the square duct |y|, |z| < 1, streamwise (x) velocity
only: the solution of lap w = -1 with w = 0 on the walls (the classical
Fourier series, e.g. White, Viscous Fluid Flow, eq. 3-48), divided by its
centreline value. The series in cos(n pi y / 2) cosh(n pi z / 2) converges
geometrically away from z = +-1, the one in the roles of y and z swapped
away from y = +-1; each node takes the form whose convergence is fastest
there (|z| <= |y|: the first). `terms` odd harmonics are summed.
"""

from __future__ import annotations

import numpy as np


def _duct_w(y: np.ndarray, z: np.ndarray, terms: int) -> np.ndarray:
    """w with lap w = -1, w = 0 on |y| = 1 and |z| = 1, in the form
    (1 - y^2)/2 - sum_n c_n cos(k_n y) cosh(k_n z)/cosh(k_n), k_n = n pi/2,
    n odd; (1 - y^2)/2 = sum_n c_n cos(k_n y), c_n = 16 (-1)^((n-1)/2) /
    (n pi)^3."""
    n = 2 * np.arange(terms) + 1.0
    k = n * np.pi / 2.0
    c = 16.0 * np.where((n - 1) % 4 == 0, 1.0, -1.0) / (n * np.pi) ** 3
    az = np.abs(z)[..., None]
    # cosh(k z) / cosh(k), overflow-free
    ratio = np.exp(k * (az - 1.0)) * (1.0 + np.exp(-2.0 * k * az)) / (1.0 + np.exp(-2.0 * k))
    return 0.5 * (1.0 - y**2) - (c * np.cos(k * y[..., None]) * ratio).sum(-1)


def duct_profile(y: np.ndarray, z: np.ndarray, terms: int = 400) -> np.ndarray:
    """The square duct's laminar profile normalised to 1 at the centreline."""
    y, z = np.broadcast_arrays(np.asarray(y, np.float64), np.asarray(z, np.float64))
    first = np.abs(z) <= np.abs(y)
    w = np.where(first, _duct_w(y, z, terms), _duct_w(z, y, terms))
    return w / _duct_w(np.zeros(1), np.zeros(1), terms)[0]


def evaluate(spec: dict, x: np.ndarray) -> np.ndarray:
    # the profile depends on (y, z) only: evaluate it once per pair
    u = np.zeros_like(x)
    yz = np.stack([x[1].reshape(-1), x[2].reshape(-1)], 1)
    uniq, inv = np.unique(yz, axis=0, return_inverse=True)
    u[0] = duct_profile(uniq[:, 0], uniq[:, 1], spec["terms"])[inv.reshape(-1)].reshape(
        x[1].shape)
    return u
