"""Milliseconds of a time step's scalar block outside its CG solve, as the
device's stream saw it: events around the block of each `step_lin` of a
traced `propagate` (the scalar's extrapolation, right-hand side, solve and
stack) less the solve's event-timed span; the median over the window's
time steps. A part of `stepper_other_ms`'s step. The program's
`stats["neklab.scalar"]`; nothing where the program keeps none."""

import statistics


def read(rec):
    v = rec["counters"].get("neklab.scalar")
    return 1e3 * statistics.median(v) if v else None
