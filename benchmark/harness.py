"""The benchmark of neklab_tpu_torch's stability analyses on one CUDA card.

One run: build the cell's configuration on the card, warm up (`setup_s`),
drive the cell's analysis entry point for `--seconds` (the window ends at
the end of the Krylov step that crosses the deadline), then judge what the
timed path produced against the plain reference and print one JSON line.

Everything is found by name. A cell `<config>.<mix>` of BENCHMARK.json
names its configuration `configs/<config>.json` and its traffic mix
`traffic/<mix>.json`; its limits are `limits/<cell>.json`, and each metric
has its reader `metrics/<metric>.py`. The configuration names its mesh
builder (`meshes/<builder>.py`) and its base flow
(`reference/baseflows/<kind>.py`); the mix names the operator
(`operators/<operator>.py`) and the Krylov driver (`drivers/<driver>.py`)
that the window drives, and a cell run by several processes names a
`launchers/<name>.py` that runs it whole. A new cell is new files of these
kinds.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import os
import resource
import subprocess
import sys
import time

import numpy as np
import torch

from reference import baseflows, check, yardstick

HERE = os.path.dirname(os.path.abspath(__file__))
FORBIDDEN = ("jax", "jaxlib", "flax", "neklab_tpu")
# the Krylov steps a traced run profiles: step 1 with the host's calls
# (launches, what the host did in each idle gap), step 3 with the device's
# activity alone (the idle share, at a small cost to the host)
PROFILED = {1: "host", 3: "device"}
# how long after the window's close the run waits for the steps whose
# answers the check reads
LATE_S = 60.0


class WindowClosed(Exception):
    """Raised into the Krylov solver at the first call after the deadline."""


def load_json(path: str):
    with open(path) as f:
        return json.load(f)


_PLUGINS: dict = {}


def plugin(folder: str, name: str):
    """The module `<folder>/<name>.py` under the benchmark."""
    key = (folder, name)
    if key not in _PLUGINS:
        path = os.path.join(HERE, folder, name + ".py")
        if not os.path.exists(path):
            raise SystemExit(f"benchmark: no {folder}/{name}.py")
        spec = importlib.util.spec_from_file_location(
            f"bench_{folder}_{name}".replace(".", "_").replace("-", "_"), path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _PLUGINS[key] = mod
    return _PLUGINS[key]


def resolve(workload: str, root: str) -> dict:
    """The cell's BENCHMARK.json entry, configuration, traffic mix, limits
    and the metrics it reports."""
    bench = load_json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; BENCHMARK.json has {sorted(cells)}")
    cell = cells[workload]
    conf = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    mine = lambda ms: [m for m in ms if workload in m.get("workloads", [workload])]
    return dict(
        cell=cell,
        config=load_json(os.path.join(root, conf["file"])),
        mix=load_json(os.path.join(HERE, "traffic", cell["traffic"] + ".json")),
        limits=load_json(os.path.join(HERE, "limits", workload + ".json")),
        end_to_end=mine(bench["end_to_end"]),
        per_layer=mine(bench["per_layer"]),
    )


def reader(name: str):
    """metrics/<name>.py's `read(record)`."""
    return plugin("metrics", name).read


def start_vector(seed: int, host: dict) -> np.ndarray:
    """The seed's start vector: standard normals at every local copy,
    averaged over each DOF's copies (C0) and zero on the walls."""
    rng = np.random.default_rng(int(seed))
    g = host["gidx"].reshape(-1)
    raw = rng.standard_normal(host["vmask"].shape)
    out = np.empty_like(raw)
    for c in range(raw.shape[0]):
        s = np.bincount(g, weights=raw[c].reshape(-1))
        out[c] = (s[g] * host["vmult"].reshape(-1)).reshape(raw[c].shape)
    return out * host["vmask"]


def on_card(device) -> bool:
    return torch.device(device).type == "cuda"


def sync(device) -> None:
    if on_card(device):
        torch.cuda.synchronize(device)


class Probe:
    """The operator handed to the entry point: the program's operator, with
    the window's deadline, the records the check reads (copied into host
    buffers made in set-up, without a wait), the memory peak after a fixed
    number of Krylov steps, and, traced, a span and the solvers' counts
    around every call and the profiles of `PROFILED` steps."""

    def __init__(self, op, driver, device, deadline: float, trace: bool, buffers: dict,
                 memory_after: int, need: int):
        self.op, self.tau, self.device = op, op.tau, device
        self.calls, self.keys = driver.CALLS, driver.RECORD
        self.deadline, self.trace = deadline, trace
        self.buffers = buffers  # {(record key, index): host tensor}
        self.count = {k: 0 for pair in self.keys.values() for k in pair}
        self.recording = True  # the first solve's records only
        self.steps = 0  # completed Krylov steps
        self._open = False  # a step has begun and not yet been counted
        self.memory_after = memory_after
        self.peak_at = None  # the allocator's peak once memory_after steps completed
        self.spans = {c + p: [] for c in self.calls for p in ("", "_profiled")}
        self.stats: dict | None = {} if trace else None
        self.prof = None
        self.profiles: dict = {}
        self.profile_overhead_s = 0.0  # starting and stopping the profiler
        self.step_starts: list = []
        self.closed_at = None
        self.steps_at_close = None
        self.need = need  # the steps after which every record the check reads exists

    def _keep(self, key, t):
        if self.recording:
            i = self.count[key]
            self.count[key] = i + 1
            buf = self.buffers.get((key, i))
            if buf is not None:
                buf.copy_(t["u"], non_blocking=True)

    def _count_step(self):
        if self._open:
            self.steps += 1
            self._open = False
            if self.steps == self.memory_after and on_card(self.device):
                self.peak_at = torch.cuda.max_memory_allocated(self.device)

    def _step_boundary(self):
        """The call that opens a Krylov step: the previous one has ended."""
        self._count_step()
        if self.prof is not None:
            self._stop_profile()
        now = time.perf_counter()
        if self.closed_at is None:
            self.step_starts.append(now)
        # a traced run profiles its PROFILED steps, so its window runs through them
        if now >= self.deadline and (not self.trace or self.steps > max(PROFILED)):
            if self.closed_at is None:
                sync(self.device)
                self.closed_at, self.steps_at_close = time.perf_counter(), self.steps
            # an answer the check reads that is still due is waited for, untimed
            if self.steps >= self.need or now >= self.closed_at + LATE_S:
                raise WindowClosed
        self._open = True
        if self.trace and self.steps in PROFILED:
            self._start_profile(PROFILED[self.steps])

    def _start_profile(self, kind: str):
        from torch.profiler import ProfilerActivity, profile, record_function

        t = time.perf_counter()
        acts = [ProfilerActivity.CUDA] if on_card(self.device) else []
        if kind == "host" or not acts:
            acts.append(ProfilerActivity.CPU)
        sync(self.device)
        self.prof, self._kind = profile(activities=acts), kind
        self.prof.__enter__()
        self._mark = record_function("bench::krylov_step") if kind == "host" else None
        if self._mark is not None:
            self._mark.__enter__()
        self.profile_overhead_s += time.perf_counter() - t
        self._t_prof = time.perf_counter()

    def _stop_profile(self):
        sync(self.device)
        window_s = time.perf_counter() - self._t_prof
        if self._mark is not None:
            self._mark.__exit__(None, None, None)
        t = time.perf_counter()
        self.prof.__exit__(None, None, None)
        self.profiles[self._kind] = {"prof": self.prof, "window_s": window_s}
        self.prof = None
        self.profile_overhead_s += time.perf_counter() - t

    def _call(self, name, x):
        kin, kout = self.keys[name]
        self._keep(kin, x)
        fn = getattr(self.op, name)
        if self.trace and self.closed_at is None:
            sync(self.device)
            t = time.perf_counter()
            y = fn(x, stats=self.stats)
            sync(self.device)
            # the profiled steps' spans are kept apart: the profiler slows them
            self.spans[name + ("_profiled" if self.prof is not None else "")].append(
                time.perf_counter() - t)
        else:
            y = fn(x)
        self._keep(kout, y)
        return y

    def _enter(self, name, x):
        if name == self.calls[0]:
            try:
                self._step_boundary()
            except WindowClosed:
                self._keep(self.keys[name][0], x)
                raise
        return self._call(name, x)

    def matvec(self, x):
        return self._enter("matvec", x)

    def rmatvec(self, x):
        return self._enter("rmatvec", x)

    def finish(self):
        """After a solve that returned: its last step has ended, and the
        records keep the first solve only."""
        self._count_step()
        if self.prof is not None:
            self._stop_profile()
        self.recording = False


def _space(mesh, vectors):
    """The program's flow vector space whose rand(seed) is the benchmark's
    start vector."""
    from neklab_tpu_torch import flow_vector_space
    from neklab_tpu_torch.krylov.space import VectorSpace

    base = flow_vector_space(mesh, 0)
    return VectorSpace(dot_fn=base.dot_fn, rand_fn=lambda seed: vectors(seed), part=None)


def drive(driver, entry: str, probe: Probe, space, sizes: dict, seed: int, vectors) -> None:
    """Runs the driver's entry point on the probe until the window closes;
    a solve that ends first is followed by another from the next seed's
    start."""
    k = 0
    while True:
        try:
            driver.solve(entry, probe, space, sizes, seed + k, vectors(seed + k))
        except WindowClosed:
            return
        probe.finish()
        if time.perf_counter() >= probe.deadline:
            if probe.closed_at is None:
                probe.closed_at, probe.steps_at_close = time.perf_counter(), probe.steps
            return
        k += 1


def _device_intervals(prof):
    """(kernel, copy and set intervals on the device, host events): a range
    marked on the host (record_function) shows on the device too, under the
    same name, and is no device work."""
    DT = torch.autograd.DeviceType
    events = prof.events()
    host_names = {e.name for e in events if e.device_type != DT.CUDA}
    dev = [e for e in events if e.device_type == DT.CUDA and e.name not in host_names]
    return dev, [e for e in events if e.device_type != DT.CUDA]


def host_profile_summary(prof, time_steps: int) -> dict:
    """Launch calls and the longest idle gaps, by what the host was doing,
    of the step profiled with the host's calls."""
    dev, host = _device_intervals(prof)
    window = next(((e.time_range.start, e.time_range.end) for e in host
                   if e.name == "bench::krylov_step"), None)
    if window is None:
        return {}
    launches = sum(e.name in yardstick.LAUNCH_CALLS for e in host)
    host_ops = [(e.time_range.start, e.time_range.end, e.name) for e in host
                if e.name != "bench::krylov_step"]
    dev_iv = [(e.time_range.start, e.time_range.end) for e in dev]
    return dict(launches=launches, time_steps=time_steps,
                idle_gaps=yardstick.idle_gaps(dev_iv, window, host_ops) if dev_iv else [])


def device_profile_summary(prof, window_s: float) -> dict:
    """Device busy seconds (the union of its intervals, overlaps once) and
    the top device operations of the step profiled with the device's
    activity alone; window_s its wall time on the host's clock."""
    dev, _ = _device_intervals(prof)
    by: dict = {}
    for e in dev:
        by[e.name] = by.get(e.name, 0.0) + (e.time_range.end - e.time_range.start) * 1e-6
    busy = yardstick.union_length([(e.time_range.start, e.time_range.end) for e in dev]) * 1e-6
    return dict(busy_s=busy, window_s=window_s,
                device_ops=[[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:10]])


def apply_seconds(mesh, h1: float, h2: float, calls: int = 50) -> float | None:
    """Device seconds of one `sem.helmholtz_local` (2-D or 3-D) at the
    velocity CG's shape: `calls` calls queued behind a sleep, timed by CUDA
    events."""
    if mesh.device.type != "cuda":
        return None
    from neklab_tpu_torch.ops import sem

    u = torch.randn((mesh.ndim,) + tuple(mesh.bm1.shape), dtype=mesh.dtype, device=mesh.device)
    for _ in range(3):
        sem.helmholtz_local(mesh, u, h1, h2)
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(200_000_000)
    a.record()
    for _ in range(calls):
        sem.helmholtz_local(mesh, u, h1, h2)
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) * 1e-3 / calls


def _smi(query: str) -> str | None:
    try:
        out = subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader",
                              "-i", "0"], capture_output=True, text=True, timeout=20)
        return out.stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return None


def card_info(device) -> dict:
    if not on_card(device):
        return {"platform": "cpu", "kind": "cpu", "count": 0}
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": 1}
    limit = _smi("power.limit")
    if limit:
        info["power_limit"] = limit
    return info


def cpu_seconds() -> float:
    """The process's CPU time, user and system: beside the window's wall
    time it says how far the host's thread paces a step."""
    ru = resource.getrusage(resource.RUSAGE_SELF)
    return ru.ru_utime + ru.ru_stime


def forbidden_modules() -> list:
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def run_cell(workload: str, seed: int, seconds: float, trace: bool, root: str, device,
             t0: float | None = None, overrides: dict | None = None) -> dict:
    """One run of the cell; -> the result line's dict. overrides: entries
    replacing the configuration's (the tests' small sizes)."""
    t0_harness = time.perf_counter()
    t0 = t0_harness if t0 is None else t0
    spec = resolve(workload, root)
    cfg = {**spec["config"], **(overrides or {})}
    mix, limits = spec["mix"], spec["limits"]
    driver = plugin("drivers", mix["driver"])
    operator = plugin("operators", mix["operator"])
    meshes = plugin("meshes", cfg["mesh"]["builder"])
    sizes = {**cfg[mix["driver"]], **mix.get("solver_args", {})}
    device = torch.device(device)
    card = on_card(device)
    dtype = getattr(torch, cfg["dtype"])
    rec = {"cell": workload, "config": cfg, "mix": mix, "spans": {}, "counters": {}}
    # the step whose records the check reads, drawn before the window opens
    s = check.sample_step(seed, mix["sample_within"])

    # ---- set-up: the program on the card, the inputs from the seed ----
    phases = rec["spans"]
    t = time.perf_counter()
    import neklab_tpu_torch  # noqa: F401  (its import is part of set-up)

    phases["import_program"] = time.perf_counter() - t
    t = time.perf_counter()
    host = meshes.host(cfg["mesh"])
    base_np = baseflows.evaluate(cfg["base_flow"], host["x"])
    start = lambda k: start_vector(k, host)
    v0_np = start(seed)
    phases["inputs"] = time.perf_counter() - t
    t = time.perf_counter()
    if card:
        torch.cuda.init()
        torch.empty(1, device=device)  # the allocator exists before its statistics are reset
        torch.cuda.reset_peak_memory_stats(device)
    sync(device)
    phases["card_init"] = time.perf_counter() - t
    t = time.perf_counter()
    mesh = meshes.program(cfg["mesh"], dtype, device)
    sync(device)
    phases["mesh_build"] = time.perf_counter() - t
    t = time.perf_counter()
    base_u = torch.as_tensor(base_np, dtype=dtype, device=device)
    op = operator.program(mesh, cfg, base_u, mix.get("operator_args", {}))
    rec["counters"].update(operator.counters(op, driver.CALLS))
    sync(device)
    phases["operator_build"] = time.perf_counter() - t
    setup_peak = torch.cuda.max_memory_allocated(device) if card else 0
    if card:
        torch.cuda.reset_peak_memory_stats(device)
    theta = operator.theta(mesh, dtype, device)

    def vectors(k):
        arr = v0_np if k == seed else start(k)
        return {"u": torch.as_tensor(arr, dtype=dtype, device=device), "theta": theta}

    t = time.perf_counter()
    warm = vectors(seed)
    for name in driver.CALLS:
        warm = getattr(op, name)(warm)
    del warm
    shape = tuple(v0_np.shape)
    buffers = {(key, i): torch.empty(shape, dtype=dtype, pin_memory=card)
               for key, idx in driver.keep(s).items() for i in idx}
    sync(device)
    phases["warmup"] = time.perf_counter() - t
    setup_s = time.perf_counter() - t0
    phases["before_harness"] = t0_harness - t0

    # ---- the window ----
    space = _space(mesh, vectors)
    captured: dict = {}
    cpu0 = cpu_seconds()
    t_w = time.perf_counter()
    probe = Probe(op, driver, device, t_w + seconds, trace, buffers, mix["memory_after_steps"],
                  need=s + 1)
    with driver.capture(captured):
        drive(driver, mix["entry"], probe, space, sizes, seed, vectors)
    sync(device)
    window_s = (probe.closed_at or time.perf_counter()) - t_w
    cpu_s = cpu_seconds() - cpu0
    bad = forbidden_modules()
    if bad:
        print(f"benchmark: the process imported {bad}", file=sys.stderr)
        raise SystemExit(3)
    steps = probe.steps if probe.steps_at_close is None else probe.steps_at_close
    end_peak = torch.cuda.max_memory_allocated(device) if card else 0
    rec.update(steps=steps, window_s=window_s, setup_s=setup_s,
               peak_bytes=probe.peak_at if probe.peak_at is not None else end_peak,
               profile_overhead_s=probe.profile_overhead_s,
               step_s=list(np.diff(probe.step_starts)))
    rec["spans"].update(probe.spans)
    record = {key: {i: buffers[(key, i)] for i in range(probe.count[key])
                    if (key, i) in buffers} for key in probe.count}
    record.update({k: np.array(v) for k, v in captured.items()})
    if trace:
        rec["counters"].update({k: list(v) for k, v in probe.stats.items()})
        per_call = operator.time_steps_per_call(op)
        # every call's counts are in stats, the profiled steps' too
        rec["counters"]["time_steps"] = per_call * sum(len(v) for v in probe.spans.values())
        profile = {}
        if "host" in probe.profiles:
            profile.update(host_profile_summary(probe.profiles["host"]["prof"],
                                                len(driver.CALLS) * per_call))
        if "device" in probe.profiles:
            p = probe.profiles["device"]
            profile.update(device_profile_summary(p["prof"], p["window_s"]))
        rec["profile"] = profile
        h1, h2 = operator.apply_shape(op, cfg)
        apply_s = apply_seconds(mesh, h1, h2)
        rec["roofline"] = None if apply_s is None else dict(
            apply_s=apply_s, n=cfg["mesh"]["order"] + 1, ndim=mesh.ndim,
            nel=mesh.nel, ncomp=mesh.ndim, dtype=cfg["dtype"],
            word_bytes=torch.empty((), dtype=dtype).element_size())

    # ---- judge the window's answers against the plain reference ----
    t_ref = time.perf_counter()
    del probe, space, op, mesh, base_u, theta
    gc.collect()
    if card:
        torch.cuda.empty_cache()
    rmesh = meshes.reference(cfg["mesh"], torch.float64, device)
    prop = operator.reference(rmesh, base_np, cfg)
    try:
        values = driver.readings(record, prop, torch.as_tensor(v0_np), s)
    except (KeyError, IndexError) as e:
        # a record the check reads never came: the window ended before it
        print(f"benchmark: no record to judge ({e!r}) after {steps} steps", file=sys.stderr)
        values = {}
    correct, table = check.verdict(values, limits)

    metrics = {}
    for m in (spec["per_layer"] if trace else spec["end_to_end"]):
        v = reader(m["name"])(rec)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = card_info(device)
    dev["memory_peak_bytes"] = int(max(setup_peak, end_peak))
    out = {"correct": bool(correct), "attempted": steps,
           "failed": sum(not (np.isfinite(r["value"]) and r["value"] <= r["limit"])
                         for r in table.values()),
           "metrics": metrics, "device": dev}
    if trace and rec.get("profile"):
        p = rec["profile"]
        if "busy_s" in p:
            dev.update(busy_s=p["busy_s"], window_s=p["window_s"])
        out["breakdown"] = {"device_ops": p.get("device_ops", []),
                            "idle_gaps": p.get("idle_gaps", [])}
    out["sampled_step"] = s
    out["diagnostics"] = {"spans": rec["spans"], "step_s": rec["step_s"],
                          "reference_s": time.perf_counter() - t_ref, "window_cpu_s": cpu_s,
                          "peak_at_step": min(steps, mix["memory_after_steps"]),
                          "window_end_peak_bytes": end_peak,
                          "card_after": _smi("clocks.sm,clocks.mem,temperature.gpu,power.draw")
                          if card else None}
    bad = forbidden_modules()
    if bad:
        print(f"benchmark: the process imported {bad}", file=sys.stderr)
        raise SystemExit(3)
    out["checks"] = table
    return out


def main(argv=None, t0: float | None = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    root = os.getcwd()
    spec = resolve(args.workload, root)
    if "launcher" in spec["mix"]:
        # a cell run by several processes: launchers/<name>.py runs it whole
        return plugin("launchers", spec["mix"]["launcher"]).main(args, spec, root, t0)
    need = int(spec["cell"]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        print(f"benchmark: needs {need} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    out = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), root,
                   torch.device("cuda", 0), t0=t0)
    print("diagnostics " + json.dumps(out.pop("diagnostics")), file=sys.stderr)
    for name, r in out["checks"].items():
        print(f"check {name} = {r['value']:.6e} (limit {r['limit']:.3e})", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0
