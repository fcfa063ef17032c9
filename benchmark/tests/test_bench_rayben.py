"""The Boussinesq cell, `rayben3d-ra1900.boussinesq-eigs`, at a small size
on the CPU: the float32 control comes out not correct on three seeds, and a
whole traced run comes out correct with the three scalar metrics. The
cell's fast checks (the reference against the port, the fold, the masks,
the readers) are tests/test_torch_bench_rayben.py, in the repository's
own run."""

import math

import control
import harness
from conftest import ROOT

CELL = "rayben3d-ra1900.boussinesq-eigs"
LC = 6.283185307179586 / 3.11632  # one critical wavelength
# the configuration at a (2, 2, 2) order-4 mesh over one wavelength, 5 steps
SMALL = {
    "mesh": {"builder": "box_thermal", "nels": [2, 2, 2], "lims": [[0.0, LC], [0.0, 1.0],
                                                                   [0.0, LC]],
             "bc": {"x-": "P", "x+": "P", "y-": "W", "y+": "W", "z-": "P", "z+": "P"},
             "bc_temp": {"y-": "t", "y+": "t"}, "order": 4},
    "tau": 0.005,
}


def test_float32_control_fails():
    """On three seeds the plain reference in float32 in the program's place
    exceeds a limit of the cell."""
    for seed, values, correct, _ in control.control_readings(CELL, [11, 12, 13], 3, ROOT,
                                                             "cpu", SMALL):
        assert not correct, (seed, values)


def test_whole_traced_run():
    """One traced run of the cell at the small size on the CPU: correct at
    the cell's limits, and the three scalar metrics reported, finite."""
    out = harness.run_cell(CELL, 2**31 + 1616, 0.5, True, ROOT, "cpu", overrides=SMALL)
    assert out["correct"] is True and out["failed"] == 0, out["checks"]
    for name in ("scalar_iters_per_step", "scalar_iter_us", "scalar_other_ms"):
        value = out["metrics"][name]["value"]
        assert math.isfinite(value) and value > 0, (name, value)
