"""Optimal transient growth: `analysis.transient_growth_analysis_fixed_point`
(Golub-Kahan-Lanczos, full CGS2 reorthogonalisation of both bases) on the
operator's matvec and rmatvec. A Krylov step is one matvec, one rmatvec
and their orthogonalisations. The driver's interface: `drivers/eigs.py`.
"""

import contextlib
import importlib

from reference import check, krylov

CALLS = ("matvec", "rmatvec")
RECORD = {"matvec": ("x", "y"), "rmatvec": ("u", "z")}


def keep(s: int) -> dict:
    """x[0..s+1], u[0..s], y[0], y[s], z[s]."""
    return {"x": set(range(s + 2)), "u": set(range(s + 1)), "y": {0, s}, "z": {s}}


@contextlib.contextmanager
def capture(out: dict):
    """out["alphas"], out["betas"]: the couplings of the program's first
    solve, the arrays whose leading parts `krylov.svd._bidiag` receives at
    every convergence test (filled in place)."""
    # the module, which the package's facade shadows with a function of its name
    mod = importlib.import_module("neklab_tpu_torch.krylov.svd")

    orig = mod._bidiag

    def spy(alphas, betas):
        out.setdefault("alphas", alphas if alphas.base is None else alphas.base)
        out.setdefault("betas", betas if betas.base is None else betas.base)
        return orig(alphas, betas)

    mod._bidiag = spy
    try:
        yield
    finally:
        mod._bidiag = orig


def solve(entry: str, op, space, sizes: dict, seed: int, v0) -> None:
    """One solve of the mix's entry point (`transient_growth_analysis_fixed_point`),
    from space.rand(seed), the benchmark's start vector v0."""
    from neklab_tpu_torch import analysis

    getattr(analysis, entry)(op, space, seed=seed, **sizes)


def control(matvec, rmatvec, v0, bm1, steps: int) -> dict:
    return krylov.lanczos(matvec, rmatvec, v0, bm1, steps)


def readings(rec: dict, prop, v0, s: int) -> dict:
    """matvec0_rel: the matvec of the start vector; rmatvec_s_rel: the exact
    adjoint of the program's s-th left vector u[s]; lanczos_rel: u[s] and
    x[s + 1] against y[s] and z[s] orthonormalized again on the program's
    bases; bidiag_rel: the program's alpha[s] and beta[s] against the
    norms those steps leave."""
    m = prop.m
    dev = lambda t: t.to(device=m.device, dtype=m.dtype)
    out = {"matvec0_rel": check.rel(m.bm1, dev(rec["y"][0]),
                                    prop.matvec(krylov.orthonormalize(m.bm1, dev(v0), [])))}
    xs = [dev(rec["x"][i]) for i in range(s + 2)]
    us = [dev(rec["u"][i]) for i in range(s + 1)]
    zs = dev(rec["z"][s])
    out["rmatvec_s_rel"] = check.rel(m.bm1, zs, prop.rmatvec(us[s]))
    want_u, _, a = krylov.project(m.bm1, dev(rec["y"][s]), us[:s])
    want_x, _, b = krylov.project(m.bm1, zs, xs[: s + 1])
    out["lanczos_rel"] = max(float(krylov.bnorm(m.bm1, us[s] - want_u)),
                             float(krylov.bnorm(m.bm1, xs[s + 1] - want_x)))
    out["bidiag_rel"] = max(check.column_rel([rec["alphas"][s]], [float(a)]),
                            check.column_rel([rec["betas"][s]], [float(b)]))
    return out
