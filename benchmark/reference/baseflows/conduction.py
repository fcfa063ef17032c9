"""The conduction state of a fluid layer heated from below: at rest, U = 0,
with the temperature Theta = 1 - y between y = 0 (Theta 1) and y = 1
(Theta 0). Its velocity's components, then the temperature."""

import numpy as np


def evaluate(spec: dict, x: np.ndarray) -> np.ndarray:
    return np.concatenate([np.zeros_like(x), 1.0 - x[1:2]])
