"""Milliseconds per time step of an exact-adjoint call (rmatvec) outside
its transposed CG solves, as the device's stream saw it: events around the
backward of the recorded propagate, less the solves' event-timed spans,
over the time steps (the autograd engine and the tape's own kernels); the
median over the window's rmatvecs. The program's `stats["neklab.adjoint"]`;
nothing where the program keeps none."""

import statistics


def read(rec):
    v = rec["counters"].get("neklab.adjoint")
    return 1e3 * statistics.median(v) if v else None
