"""Pressure (E) CG iterations per time step, from the program's `stats=`
counts over the traced window's matvecs and rmatvecs."""


def read(rec):
    c = rec["counters"]
    if not c.get("pressure") or not c.get("time_steps"):
        return None
    return sum(c["pressure"]) / c["time_steps"]
