"""The benchmark's fixed arithmetic: published H100 peaks, the operation and
byte counts of the 3-D Helmholtz apply, and the reductions of a profiler
trace (launch calls, the union of device intervals, idle gaps).

The counts come from the operator's shapes, not from any implementation,
so a later kernel is read against the same work.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense, at the 700 W power limit
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float64": 67e12, "float32": 67e12}  # f64: tensor-core rate; f32: outside them

# the runtime calls by which the host puts work on the card
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cudaGraphLaunch")


def helmholtz3d_counts(n: int, nel: int, ncomp: int, word_bytes: int) -> tuple[float, float]:
    """(flops, bytes) of h1 A u + h2 B u on ncomp fields of nel elements of
    n^3 GLL points, unassembled (Nek's axhelm): per element and field, the
    reference gradient (three contractions of 2 n^4), the symmetric metric
    product (9 multiplies and 6 adds a point), the transposed gradient
    (three contractions, two sums a point), the h1 scale and the h2 mass
    term (multiply, multiply-add): 12 n^4 + 21 n^3. Bytes: every field read
    and written once, and the six distinct metric factors and the mass
    read once for all fields; the n x n derivative matrix once."""
    pts = n**3
    flops = ncomp * nel * (12 * n**4 + 21 * pts)
    words = (2 * ncomp + 7) * pts * nel + n * n
    return float(flops), float(words * word_bytes)


def bound_seconds(flops: float, nbytes: float, dtype: str) -> float:
    """The least time the card could take: the larger of the compute and
    the bandwidth bounds."""
    return max(flops / PEAK_FLOPS[dtype], nbytes / HBM_BYTES_PER_S)


def union_length(intervals) -> float:
    """Length of the union of [start, end) intervals (overlaps once)."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        elif e > cur_e:
            cur_e = e
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def merged(intervals) -> list:
    """The union of intervals as disjoint sorted [start, end] pairs."""
    out: list = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def idle_gaps(device_intervals, window, host_ops, top: int = 10) -> list:
    """The device's idle time inside `window` = (start, end), summed by what
    the host was doing when each gap began: the host op of host_ops =
    [(start, end, name)] that began last among those still open then (the
    innermost, where ops nest), "(python)" where none is open (the host in
    Python code between ops). -> [[name, seconds]], longest first (times in
    microseconds in, seconds out)."""
    w0, w1 = window
    busy = merged([(max(s, w0), min(e, w1)) for s, e in device_intervals if e > w0 and s < w1])
    gaps, t = [], w0
    for s, e in busy:
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if w1 > t:
        gaps.append((t, w1))
    ops = sorted(host_ops)
    by: dict = {}
    stack: list = []
    i = 0
    for g0, g1 in gaps:
        while i < len(ops) and ops[i][0] <= g0:
            stack.append(ops[i])
            i += 1
        while stack and stack[-1][1] < g0:
            stack.pop()
        name = stack[-1][2] if stack else "(python)"
        by[name] = by.get(name, 0.0) + (g1 - g0) * 1e-6
    return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:top]]
