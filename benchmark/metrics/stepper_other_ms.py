"""Milliseconds of a forward time step outside its CG solves, as the
device's stream saw it: events around each `step_lin` of a traced
`propagate`, less the solves' event-timed spans (the explicit terms, the
right-hand sides, the pressure correction, the lag shifts and the waits
between them); the median over the window's time steps. The program's
`stats["neklab.step"]`; nothing where the program keeps none."""

import statistics


def read(rec):
    v = rec["counters"].get("neklab.step")
    return 1e3 * statistics.median(v) if v else None
