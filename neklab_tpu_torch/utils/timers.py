"""Hierarchical named-scope timers with an exit summary.

Counterpart of `neklab_tpu.utils.timers` (LightKrylov's global timer around
every analysis driver, flushed to a log at the driver's exit). Use as:

    with timer("eigs"):
        ...
    timer.report()          # or timer.write("timers.log")

A timer reads the host's wall clock, as the reference's does, and adds no
synchronisation with the card, so timing does not change what it times:
work queued on the card counts where the host next waits for it (a CG's
residual read, a Krylov coefficient), not where it was queued. The
drivers' scopes end at such a read, so their totals hold the card's work.
A caller who wants a scope to wait for the card ends it with
`torch.cuda.synchronize()`; device times per op come from `torch.profiler`
(`tools/profile_torch_step.py`).
"""

from __future__ import annotations

import time
from collections import defaultdict
from contextlib import contextmanager


class Timers:
    def __init__(self):
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)
        self._stack: list[str] = []

    @contextmanager
    def __call__(self, name: str):
        full = "/".join(self._stack + [name])
        self._stack.append(name)
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
