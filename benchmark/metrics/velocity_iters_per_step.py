"""Velocity (Helmholtz) CG iterations per time step (the three components
are one CG), from the program's `stats=` counts over the traced window."""


def read(rec):
    c = rec["counters"]
    if not c.get("helmholtz") or not c.get("time_steps"):
        return None
    return sum(c["helmholtz"]) / c["time_steps"]
