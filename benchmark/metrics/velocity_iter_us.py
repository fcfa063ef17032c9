"""Microseconds of device time a velocity (Helmholtz) CG iteration takes,
the three components one CG: per traced velocity solve, forward and
adjoint, the event-timed iterations over their count; the median over the
window's solves. The program's `stats["neklab.cg.helmholtz"]`; nothing
where the program keeps none."""

import statistics


def read(rec):
    per = [t.iter_s / t.iters for t in rec["counters"].get("neklab.cg.helmholtz", ()) if t.iters]
    return 1e6 * statistics.median(per) if per else None
