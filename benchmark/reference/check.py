"""The comparison that decides `correct`: what every driver's readings share.

The harness records what the timed path fed to and got from its operator,
in `krylov.py`'s record layout, at the steps that the check reads (the
first, and one step s drawn from the seed before the window opens), and
the projected matrix that the program's Krylov driver built. After the
window the plain reference recomputes them at the timed sizes; each driver
(`drivers/<name>.py`) names its readings. Every reading is a distance
relative to the reference's own value: for vectors in the B-norm, for
the projected matrix's entries the largest gap over the norm of the
reference's column.
"""

from __future__ import annotations

import numpy as np

from .krylov import bnorm


def sample_step(seed: int, within: int) -> int:
    """The step the later checks read: drawn from the seed among
    1..within-1, before the window opens."""
    return int(np.random.default_rng([int(seed), 7]).integers(1, max(within, 2)))


def rel(bm1, a, b) -> float:
    """|a - b|_B / |b|_B."""
    return float(bnorm(bm1, a - b) / bnorm(bm1, b))


def column_rel(program, reference) -> float:
    """The largest gap between the program's entries and the reference's,
    over the norm of the reference's (a missing or non-finite entry reads
    inf)."""
    p = np.asarray(program, dtype=np.float64)
    r = np.asarray(reference, dtype=np.float64)
    if p.shape != r.shape or not np.all(np.isfinite(p)):
        return float("inf")
    return float(np.abs(p - r).max() / np.linalg.norm(r))


def verdict(values: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}): every compared number finite
    and at most its limit; a number the run could not read is nan."""
    table = {k: {"value": float(values.get(k, float("nan"))), "limit": limits[k]}
             for k in limits}
    ok = all(np.isfinite(v["value"]) and v["value"] <= v["limit"] for v in table.values())
    return ok, table
