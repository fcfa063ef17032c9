"""Per cent of a Krylov step's wall time (step 3, profiled with the
device's activity alone, so that the host runs nearly as unprofiled) in
which no kernel, copy or set ran on the device (the union of their
intervals, overlaps once)."""


def read(rec):
    p = rec.get("profile")
    if not p or not p.get("window_s") or not p.get("busy_s"):
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["window_s"])
