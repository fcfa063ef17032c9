"""Device memory (GB) held by the adjoint's recorded propagate, as the
program counts it (`AdjointPropagator.tape_bytes`)."""


def read(rec):
    b = rec["counters"].get("tape_bytes")
    return b / 1e9 if b else None
