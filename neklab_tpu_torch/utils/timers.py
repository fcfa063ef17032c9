"""Hierarchical named-scope timers with an exit summary, and the spans of a
traced call.

Counterpart of `neklab_tpu/utils/timers.py` (LightKrylov's global timer around
every analysis driver, flushed to a log at the driver's exit). Use as:

    with timer("eigs"):
        ...
    timer.report()          # or timer.write("timers.log")

A timer reads the host's wall clock, as the reference's does, and adds no
synchronisation with the card, so timing does not change what it times.
Its totals are the host's time in each scope: on the card that is the time
to enqueue the scope's work plus the waits the scope itself makes (a CG's
residual read, a Krylov coefficient), not the card's work, which may run on
past the scope's end. A caller who wants a scope to wait for the card ends
it with `torch.cuda.synchronize()`. While a `torch.profiler` records, each
scope is also a profiler range named `neklab.<scope>` (`neklab.exptA/matvec`),
so its host time shows in the trace; with none recording, a scope costs one
check more.

The spans of a traced call. A call is traced when its caller passes a
`stats=` dict (`traced`; a `Counts` dict takes the counts alone): the
solvers, the linearized stepper and the exact adjoint then time their parts
on the card's stream with CUDA events (`Clock`; the host's clock on the
CPU) and append them to that dict beside the iteration counts, under the
names of their profiler ranges:

    stats["neklab.cg.<kind>"]  one `solvers.CGTiming` per solve (kind:
                               "helmholtz", "pressure", "scalar", the keys of
                               the counts)
    stats["neklab.step"]       seconds of each time step of `propagate`
                               outside its solves
    stats["neklab.scalar"]     seconds of each time step's scalar block
                               (`step_lin`, with scalars: the extrapolation,
                               right-hand sides and stack) outside its
                               solves; a part of "neklab.step"
    stats["neklab.adjoint"]    seconds per time step of each exact-adjoint
                               call outside its transposed solves
    stats["neklab.e3d"]        the E applies the 3-D pressure kernels ran in
                               each propagate and exact-adjoint call on the
                               card (`ops/e_kernel.py`; their device counter,
                               read once the call's last stamp has passed)

While a profiler records, a traced call opens the ranges `neklab.step`,
`neklab.scalar`, `neklab.cg.<kind>`, `neklab.cg.read` (each residual read)
and `neklab.adjoint` instead, and takes no stamp: the profile times that call,
and the events' own runtime records would crowd the profiler's buffers (a
device-only profile of a transient-growth Krylov step once read 29 % less
busy time with them, on an H100). An untraced call records no event and
opens no range.
"""

from __future__ import annotations

import time
from collections import defaultdict
from contextlib import contextmanager, nullcontext

import torch
from torch.autograd import profiler as _profiler

NULL = nullcontext()  # a context that does nothing, for an untraced part
# torch's light range (a C++ context, ~1 us; `record_function` takes ~15 us a
# range, which a profiled step would pay at every residual read)
_RANGE = getattr(torch._C._profiler, "_RecordFunctionFast", None) or _profiler.record_function


def profiling() -> bool:
    """Whether a `torch.profiler` records now: one read of the flag torch
    keeps for this."""
    return _profiler._is_profiler_enabled


def profiler_range(name: str):
    """A `torch.profiler` range named `name` while a profiler records (its
    host activity holds the range), else a context that does nothing."""
    return _RANGE(name) if _profiler._is_profiler_enabled else NULL


def traced(stats) -> bool:
    """Whether a call given `stats` times its parts: it does for any dict a
    caller passes, and for a `Counts` only while its `traced` is set."""
    return stats is not None and getattr(stats, "traced", True)


class Counts(dict):
    """A stats dict that takes the iteration counts alone: a call given one
    records no timing while its `traced` is False. For a caller who wants
    the counts without the tracing's cost, and for the exact adjoint's
    recorded solves, whose every backward reports to one that a traced
    call switches on for its duration."""

    traced = False


class Clock:
    """Stamps on a device's current stream: CUDA events from a pool that
    every `start` reuses, or, on the CPU, readings of the host's clock.
    `seconds(a, b)` reads a span once `wait(b)` has returned."""

    def __init__(self, device):
        device = torch.device(device)
        self.cuda = device.type == "cuda"
        self.device = device
        self._pool: list = []
        self._used = 0

    def start(self) -> None:
        """Every stamp after this one may reuse the pool's events."""
        self._used = 0

    def stamp(self):
        if not self.cuda:
            return time.perf_counter()
        if self._used == len(self._pool):
            self._pool.append(torch.cuda.Event(enable_timing=True))
        event = self._pool[self._used]
        self._used += 1
        event.record(torch.cuda.current_stream(self.device))
        return event

    def wait(self, stamp) -> None:
        if self.cuda:
            stamp.synchronize()

    def seconds(self, a, b) -> float:
        return a.elapsed_time(b) * 1e-3 if self.cuda else b - a


def counts(stats: dict) -> dict:
    """stats without the timings of a traced call (its keys under
    "neklab."): the iteration counts, and any list of the caller's own."""
    return {k: v for k, v in stats.items() if not k.startswith("neklab.")}


def solve_seconds(stats: dict, since: dict | None = None) -> float:
    """Seconds of the traced solves in stats (`CGTiming.span_s`), those
    appended after `since` (a `solve_marks`) alone when given."""
    since = since or {}
    return sum(t.span_s for key, timings in stats.items() if key.startswith("neklab.cg.")
               for t in timings[since.get(key, 0):])


def solve_marks(stats: dict) -> dict:
    """The number of traced solves in stats so far, by key."""
    return {key: len(v) for key, v in stats.items() if key.startswith("neklab.cg.")}


class Spans:
    """One part of a traced call, timed each time it runs, less the traced
    solves inside it: `with spans():` around the part stamps it on `clock`;
    `close()` waits for the last stamp and appends each run's seconds to
    stats[name]. With no clock (a profiler records) the part is the range
    `name` instead and takes no stamp."""

    def __init__(self, name: str, clock: Clock | None, stats: dict):
        self.name, self.clock, self.stats = name, clock, stats
        self._runs: list = []  # (stamp before, stamp after, seconds of its solves)

    @contextmanager
    def __call__(self):
        if self.clock is None:
            with profiler_range(self.name):
                yield
            return
        marks = solve_marks(self.stats)
        before = self.clock.stamp()
        yield
        self._runs.append((before, self.clock.stamp(), solve_seconds(self.stats, marks)))

    def close(self) -> None:
        if self._runs:
            self.clock.wait(self._runs[-1][1])
            self.stats.setdefault(self.name, []).extend(
                self.clock.seconds(a, b) - solves for a, b, solves in self._runs)
            self._runs = []


class Timers:
    def __init__(self):
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)
        self._stack: list[str] = []

    @contextmanager
    def __call__(self, name: str):
        full = "/".join(self._stack + [name])
        self._stack.append(name)
        with profiler_range("neklab." + full):
            t0 = time.perf_counter()
            try:
                yield
            finally:
                dt = time.perf_counter() - t0
                self._stack.pop()
                self.totals[full] += dt
                self.counts[full] += 1

    def report(self) -> str:
        """The totals as an indented tree (printed and returned), the
        reference's format: `name  seconds  xcount`."""
        lines = ["--- timers ---"]
        for k in sorted(self.totals):
            depth = k.count("/")
            lines.append(
                f"{'  ' * depth}{k.split('/')[-1]:<30s} {self.totals[k]:10.3f}s  x{self.counts[k]}"
            )
        out = "\n".join(lines)
        print(out)
        return out

    def write(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.report())

    def reset(self) -> None:
        self.totals.clear()
        self.counts.clear()


timer = Timers()
