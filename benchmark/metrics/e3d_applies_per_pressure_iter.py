"""E applies through the 3-D pressure kernels per pressure (E) CG
iteration: the kernels' own device run counter over every traced call,
forward and adjoint (the program's `stats["neklab.e3d"]`), over the
pressure iterations of the same calls (`stats["pressure"]`); nothing where
the program keeps no such count.

An engagement check, met at 1 or a little above: one apply an iteration,
plus each solve's warm start. Below 1,
some pressure iterations ran without the kernels (the fault it guards
against, hence `better: higher`); well above 1.1, E is applied more often
than the CG needs, which is waste and not a gain."""


def read(rec):
    c = rec["counters"]
    runs, iters = c.get("neklab.e3d"), c.get("pressure")
    if not runs or not iters or not sum(iters):
        return None
    return sum(runs) / sum(iters)
