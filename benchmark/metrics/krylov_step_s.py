"""Seconds per Krylov step: the window's wall time over the Krylov steps it
completed (a matvec in eigs, a matvec and an rmatvec in growth), the
Krylov solver's orthogonalisation included."""


def read(rec):
    return rec["window_s"] / rec["steps"] if rec.get("steps") else None
