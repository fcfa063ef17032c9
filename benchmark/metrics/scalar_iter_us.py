"""Microseconds of device time a temperature (scalar) CG iteration takes:
per traced scalar solve, the event-timed iterations over their count; the
median over the window's solves. The program's
`stats["neklab.cg.scalar"]`; nothing where the program keeps none."""

import statistics


def read(rec):
    per = [t.iter_s / t.iters for t in rec["counters"].get("neklab.cg.scalar", ()) if t.iters]
    return 1e6 * statistics.median(per) if per else None
