"""Seconds per matvec of the propagator (a span that ends in a
synchronize), over the steps the profiler did not slow."""


def read(rec):
    s = rec["spans"].get("matvec")
    return sum(s) / len(s) if s else None
