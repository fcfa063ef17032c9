"""The readers of the program's own spans and timings (`stats=` of a traced
call): a traced run at a small size on the CPU reports each where its cell
has it, finite and non-negative; an untraced run reports none; and a
record without the program's timings (a program that keeps none) gives
nothing and raises nothing."""

import math

import pytest

import harness
from conftest import TINY

SPANS = ("cg_turnaround_us", "pressure_iter_us", "velocity_iter_us", "stepper_other_ms",
         "adjoint_other_ms")


def _has(cell: str, root: str) -> set:
    return {m["name"] for m in harness.resolve(cell, root)["per_layer"] if m["name"] in SPANS}


@pytest.mark.parametrize("cell", ["channel3d-re7500.eigs", "duct3d-re1000.growth"])
def test_traced_run_reports_the_program_spans(cell, root):
    want = _has(cell, root)
    assert want == set(SPANS) - ({"adjoint_other_ms"} if cell.endswith(".eigs") else set())
    out = harness.run_cell(cell, 2**31 + 4242, 0.5, True, root, "cpu",
                           overrides=TINY[cell.split(".")[0]])
    assert out["correct"]
    got = {k: m["value"] for k, m in out["metrics"].items() if k in SPANS}
    assert set(got) == want
    for name, value in got.items():
        assert math.isfinite(value) and value >= 0.0, (name, value)


def test_untraced_run_reports_no_span(root):
    out = harness.run_cell("duct3d-re1000.growth", 2**31 + 4243, 0.3, False, root, "cpu",
                           overrides=TINY["duct3d-re1000"])
    assert out["correct"] and not set(out["metrics"]) & set(SPANS)


@pytest.mark.parametrize("name", SPANS)
def test_reader_without_the_program_timings_gives_nothing(name):
    rec = {"counters": {"pressure": [12, 13], "helmholtz": [4, 4], "time_steps": 2},
           "spans": {"matvec": [1.0]}, "steps": 1, "window_s": 1.0}
    assert harness.reader(name)(rec) is None
