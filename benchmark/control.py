"""The control of the comparison that decides `correct`: the plain
reference put in the program's place, computed one precision below the
configuration's (float32 for float64), with the driver's plain recurrence
(`drivers/<name>.py`'s `control`), then judged by the same readings and
verdict as a run of the program. It has to come out not correct.

    python3 benchmark/control.py --workload <cell> --seeds 11,12,13 [--steps 3]

One JSON line per seed: the readings, the cell's limits and the verdict.
Not run by the benchmark's own runs; at the cells' sizes it needs the card
(`--device cpu` runs it on the CPU, for small configurations). `--steps`
Krylov steps are taken, and the check reads step min(s, steps - 1), s the
seed's sampled step.
"""

import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

import torch  # noqa: E402

import harness  # noqa: E402
from reference import baseflows, check  # noqa: E402

LOWER = {"float64": torch.float32}


def control_readings(workload: str, seeds, steps: int, root: str, device,
                     overrides: dict | None = None):
    """Yields (seed, readings, correct, table) for each seed."""
    spec = harness.resolve(workload, root)
    cfg = {**spec["config"], **(overrides or {})}
    mix = spec["mix"]
    driver = harness.plugin("drivers", mix["driver"])
    operator = harness.plugin("operators", mix["operator"])
    meshes = harness.plugin("meshes", cfg["mesh"]["builder"])
    host = meshes.host(cfg["mesh"])
    base = baseflows.evaluate(cfg["base_flow"], host["x"])
    low = LOWER[cfg["dtype"]]
    m_low = meshes.reference(cfg["mesh"], low, device)
    ref = operator.reference(meshes.reference(cfg["mesh"], torch.float64, device), base, cfg)
    ctl = operator.reference(m_low, base, cfg, dt=ref.dt)
    for seed in seeds:
        v0_np = harness.start_vector(seed, host)
        v0 = torch.as_tensor(v0_np, dtype=low, device=device)
        rec = driver.control(ctl.matvec, ctl.rmatvec, v0, m_low.bm1, steps)
        s = min(check.sample_step(seed, mix["sample_within"]), steps - 1)
        values = driver.readings(rec, ref, torch.as_tensor(v0_np), s)
        correct, table = check.verdict(values, spec["limits"])
        yield seed, values, correct, table


def main():
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("control: needs a CUDA card (or --device cpu)")
    t0 = time.perf_counter()
    for seed, values, correct, table in control_readings(
            args.workload, [int(s) for s in args.seeds.split(",")], args.steps, os.getcwd(),
            args.device):
        print(json.dumps({"workload": args.workload, "seed": seed, "readings": values,
                          "correct": correct, "checks": table,
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
