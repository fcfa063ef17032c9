"""Do the spans of a traced call close its time step? On a CUDA card, for
one cell of the benchmark (BENCHMARK.json), at the cell's own size:

    python3 tools/trace_closure.py --cell channel3d-re7500.eigs[,<cell>...] [--pairs 3] [--seed 7]

Builds the cell's operator as the benchmark does (benchmark/harness.py's
plug-ins: configuration, mesh builder, base flow, operator), warms it up,
then calls each of the mix's operator calls (matvec; growth: matvec and
rmatvec) on the seed's B-normalized start vector, untraced and traced
(`stats=`) in turns (untraced, traced, traced, untraced per pair), each
call between two `torch.cuda.synchronize()`, no profiler running. Prints
one JSON line per call name:

  * `untraced_ms` and `traced_ms`: wall ms per time step of the calls
    (medians), and `traced_over_untraced`, the tracing's cost when on;
  * `parts_ms`: per time step, medians over the traced calls, from the
    program's own timings: the CG iterations (`iter`), the device's gaps
    between them (`gap`), the rest of the solves' spans, set-up and final
    read (`setup`), and the step outside its solves (`other`:
    `neklab.step`, or `neklab.adjoint` for rmatvec), with scalars the
    scalar block's part of it (`scalar_other`: `neklab.scalar`); `read_us` the host's
    time blocked in one residual read;
  * `solves`: per kind, the CG iterations a time step and the medians per
    solve of an iteration's device time and of the gap before it (us);
  * `closure_sum`: the parts' sum over `untraced_ms`, and `closure_metrics`:
    what the benchmark's readers report (medians per solve and per step:
    iterations a step times (iteration + turnaround) per kind, plus the
    set-up and the other part) over `untraced_ms`.

Needs a CUDA card; imports no jax.
"""

import argparse
import json
import os
import statistics
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path[:0] = [os.path.join(ROOT, "benchmark"), ROOT]
os.environ.setdefault("NEKLAB_MESH_CACHE", os.path.join(ROOT, ".mesh_cache"))


def _parts(stats: dict, nsteps: int, name: str) -> dict:
    """Per time step seconds of one traced call, and its metric-style sums."""
    cg = [t for key, v in stats.items() if key.startswith("neklab.cg.") for t in v]
    other = stats["neklab.step"] if name == "matvec" else stats["neklab.adjoint"]
    other_s = sum(other) if name == "matvec" else other[0] * nsteps
    out = dict(iter=sum(t.iter_s for t in cg), gap=sum(t.gap_s for t in cg),
               setup=sum(t.span_s - t.iter_s - t.gap_s for t in cg), other=other_s)
    if stats.get("neklab.scalar"):
        out["scalar_other"] = sum(stats["neklab.scalar"])  # a part of `other`
    out = {k: v / nsteps for k, v in out.items()}
    out["read_us"] = 1e6 * sum(t.read_s for t in cg) / sum(t.iters + 1 for t in cg)
    # what the readers report: medians per solve and per time step
    med = lambda xs: statistics.median(xs) if xs else 0.0
    turn = med([t.gap_s / t.iters for t in cg if t.iters])
    metric = out["setup"] + med(other if name == "matvec" else [other[0]])
    for kind in ("pressure", "helmholtz", "scalar"):
        ts = [t for t in stats.get("neklab.cg." + kind, []) if t.iters]
        if ts:
            per_step = sum(t.iters for t in ts) / nsteps
            iter_us = 1e6 * med([t.iter_s / t.iters for t in ts])
            metric += per_step * (iter_us * 1e-6 + turn)
            out[kind] = dict(iters_per_step=per_step, iter_us=iter_us,
                             gap_us=1e6 * med([t.gap_s / t.iters for t in ts]))
    out["metric"] = metric
    return out


def measure(cell: str, device, pairs: int, seed: int, overrides: dict | None = None) -> list:
    """The lines for one cell on `device` (the configuration's entries
    replaced by `overrides`, for a rehearsal at a small size)."""
    import numpy as np
    import torch

    import harness
    from reference import baseflows

    device = torch.device(device)
    spec = harness.resolve(cell, ROOT)
    cfg, mix = {**spec["config"], **(overrides or {})}, spec["mix"]
    driver = harness.plugin("drivers", mix["driver"])
    operator = harness.plugin("operators", mix["operator"])
    meshes = harness.plugin("meshes", cfg["mesh"]["builder"])
    dtype = getattr(torch, cfg["dtype"])
    host = meshes.host(cfg["mesh"])
    mesh = meshes.program(cfg["mesh"], dtype, device)
    base = torch.as_tensor(baseflows.evaluate(cfg["base_flow"], host["x"]), dtype=dtype,
                           device=device)
    op = operator.program(mesh, cfg, base, mix.get("operator_args", {}))
    u = torch.as_tensor(harness.start_vector(seed, host), dtype=dtype, device=device)
    u = u / torch.sqrt(torch.sum(u * u * mesh.bm1))
    x = {"u": u, "theta": operator.theta(mesh, dtype, device)}
    nsteps = operator.time_steps_per_call(op)

    def call(name, traced):
        stats = {} if traced else None
        harness.sync(device)
        t = time.perf_counter()
        getattr(op, name)(x, stats=stats)
        harness.sync(device)
        return time.perf_counter() - t, stats

    for name in driver.CALLS:  # warm-up, both paths
        call(name, False)
        call(name, True)
    lines = []
    for name in driver.CALLS:
        walls = {False: [], True: []}
        parts = []
        for _ in range(pairs):
            for traced in (False, True, True, False):
                wall, stats = call(name, traced)
                walls[traced].append(wall)
                if traced:
                    parts.append(_parts(stats, nsteps, name))
        plain = 1e3 * statistics.median(walls[False]) / nsteps
        timed = 1e3 * statistics.median(walls[True]) / nsteps
        med = {k: 1e3 * statistics.median(p[k] for p in parts)
               for k in ("iter", "gap", "setup", "other", "metric", "scalar_other")
               if k in parts[0]}
        total = med["iter"] + med["gap"] + med["setup"] + med["other"]
        kinds = {kind: {k: statistics.median(p[kind][k] for p in parts) for k in parts[0][kind]}
                 for kind in ("pressure", "helmholtz", "scalar") if kind in parts[0]}
        lines.append(dict(
            cell=cell, call=name, time_steps=nsteps, untraced_ms=plain, traced_ms=timed,
            traced_over_untraced=timed / plain,
            parts_ms={k: med[k] for k in ("iter", "gap", "setup", "other", "scalar_other")
                      if k in med},
            read_us=statistics.median(p["read_us"] for p in parts), solves=kinds,
            closure_sum=total / plain, closure_metrics=med["metric"] / plain,
            walls_s={"untraced": walls[False], "traced": walls[True]},
            device=harness.card_info(device), numpy=np.__version__, torch=torch.__version__))
    return lines


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cell", required=True, help="a cell, or a comma list of cells")
    ap.add_argument("--pairs", type=int, default=3)
    ap.add_argument("--seed", type=int, default=7)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("trace_closure: needs a CUDA card", file=sys.stderr)
        return 2
    for cell in args.cell.split(","):
        for line in measure(cell, torch.device("cuda", 0), args.pairs, args.seed):
            print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
