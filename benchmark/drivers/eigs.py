"""The direct eigensolve: `analysis.linear_stability_analysis_fixed_point`
(Krylov-Schur Arnoldi, CGS2) on the operator's matvec. A Krylov step is
one matvec and its orthogonalisation.

A driver is found by the name in a traffic mix's `driver`. It gives the
operator calls of a Krylov step (the first opens it) and the record keys
of their inputs and outputs, the records the check reads at step s, a
capture of the projected matrix that the program's driver builds, one
solve of the mix's entry point, the plain recurrence that the control puts in
the program's place, and the readings.
"""

import contextlib
import importlib

from reference import check, krylov

CALLS = ("matvec",)
RECORD = {"matvec": ("x", "y")}


def keep(s: int) -> dict:
    """The records the readings use: the basis up to x[s + 1], y[0], y[s]."""
    return {"x": set(range(s + 2)), "y": {0, s}}


@contextlib.contextmanager
def capture(out: dict):
    """out["H"]: the Hessenberg matrix of the program's first Arnoldi
    cycle, the array that `krylov.eigs._expand_krylov` fills in place."""
    # the module, which the package's facade shadows with a function of its name
    mod = importlib.import_module("neklab_tpu_torch.krylov.eigs")

    orig = mod._expand_krylov

    def spy(op, space, V, H, *args, **kwargs):
        out.setdefault("H", H)
        return orig(op, space, V, H, *args, **kwargs)

    mod._expand_krylov = spy
    try:
        yield
    finally:
        mod._expand_krylov = orig


def solve(entry: str, op, space, sizes: dict, seed: int, v0) -> None:
    """One solve of the mix's entry point (`linear_stability_analysis_fixed_point`)."""
    from neklab_tpu_torch import analysis

    getattr(analysis, entry)(op, space, seed=seed, v0=v0, **sizes)


def control(matvec, rmatvec, v0, bm1, steps: int) -> dict:
    return krylov.arnoldi(matvec, v0, bm1, steps)


def readings(rec: dict, prop, v0, s: int) -> dict:
    """matvec0_rel: the matvec of the start vector (the benchmark's own,
    B-normalized here); matvec_s_rel: of the program's s-th Arnoldi vector;
    arnoldi_rel: the program's x[s + 1] against y[s] orthonormalized again
    on its basis; hessenberg_rel: the program's Hessenberg column s against
    the B-inner products that step makes."""
    m = prop.m
    dev = lambda t: t.to(device=m.device, dtype=m.dtype)
    out = {"matvec0_rel": check.rel(m.bm1, dev(rec["y"][0]),
                                    prop.matvec(krylov.orthonormalize(m.bm1, dev(v0), [])))}
    xs = [dev(rec["x"][i]) for i in range(s + 2)]
    ys = dev(rec["y"][s])
    out["matvec_s_rel"] = check.rel(m.bm1, ys, prop.matvec(xs[s]))
    want, h, beta = krylov.project(m.bm1, ys, xs[: s + 1])
    out["arnoldi_rel"] = float(krylov.bnorm(m.bm1, xs[s + 1] - want))
    col = list(h.cpu().numpy()) + [float(beta)]
    out["hessenberg_rel"] = check.column_rel(rec["H"][: s + 2, s], col)
    return out
