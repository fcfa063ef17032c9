"""Microseconds of device time a pressure (E) CG iteration takes: per
traced pressure solve, forward and adjoint, the event-timed iterations
(each from the event before its graph's launch to its end) over their
count; the median over the window's solves. The program's
`stats["neklab.cg.pressure"]`; nothing where the program keeps none."""

import statistics


def read(rec):
    per = [t.iter_s / t.iters for t in rec["counters"].get("neklab.cg.pressure", ()) if t.iters]
    return 1e6 * statistics.median(per) if per else None
