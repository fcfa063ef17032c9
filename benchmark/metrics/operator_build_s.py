"""Seconds to build the propagator: the preconditioner (or its cache),
the Jacobi diagonal, the CG graphs, and in growth the adjoint's recording."""


def read(rec):
    return rec["spans"].get("operator_build")
