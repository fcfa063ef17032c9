"""Plane Poiseuille flow U = 1 - y^2 between walls at y = -1, 1, streamwise
(x) velocity only, 1 at the centreline."""

import numpy as np


def evaluate(spec: dict, x: np.ndarray) -> np.ndarray:
    u = np.zeros_like(x)
    u[0] = 1.0 - x[1] ** 2
    return u
