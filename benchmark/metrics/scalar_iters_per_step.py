"""Temperature (scalar) CG iterations per time step, from the program's
`stats=` counts (`stats["scalar"]`) over the traced window's matvecs;
nothing where no call solved for a scalar."""


def read(rec):
    c = rec["counters"]
    if not c.get("scalar") or not c.get("time_steps"):
        return None
    return sum(c["scalar"]) / c["time_steps"]
