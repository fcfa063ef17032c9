"""Microseconds the device waits between one CG iteration and the next: per
traced solve of every kind, forward and adjoint, the event-timed gaps
(the set-up's or an iteration's end to the next iteration's start: the
residual's copy to the host, the host's wake-up and test, the next event)
over its iterations; the median over the window's solves, which keeps the
two profiled Krylov steps out. The program's `stats["neklab.cg.<kind>"]`
(`solvers.CGTiming`); nothing where the program keeps none."""

import statistics


def read(rec):
    c = rec["counters"]
    per = [t.gap_s / t.iters for key, v in c.items() if key.startswith("neklab.cg.")
           for t in v if t.iters]
    return 1e6 * statistics.median(per) if per else None
