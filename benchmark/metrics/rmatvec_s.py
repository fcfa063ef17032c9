"""Seconds per rmatvec, the exact adjoint (a span that ends in a
synchronize), over the steps the profiler did not slow."""


def read(rec):
    s = rec["spans"].get("rmatvec")
    return sum(s) / len(s) if s else None
