"""Milliseconds per Krylov step spent outside the operator's spans: the
Krylov solver (orthogonalisation, the projected problem, its host reads).
The time the profiler takes to start and stop is left out."""


def read(rec):
    spans = rec["spans"]
    if not rec.get("steps") or not spans.get("matvec"):
        return None
    inside = sum(sum(v) for v in spans.values() if isinstance(v, list))
    outside = rec["window_s"] - rec.get("profile_overhead_s", 0.0) - inside
    return 1e3 * outside / rec["steps"]
