"""Seconds from the process's start to the window: imports, the mesh, the
preconditioner, the diagonals, the CG graphs, (growth) the adjoint's tape
and a warm-up matvec (and rmatvec)."""


def read(rec):
    return rec["setup_s"]
