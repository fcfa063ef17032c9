"""Per cent of its roofline that one 3-D Helmholtz apply reaches at the
velocity CG's shape: the least time the benchmark's own operation and byte
count allows on the published H100 peaks, over the measured device time."""

from reference import yardstick


def read(rec):
    r = rec.get("roofline")
    if not r or not r.get("apply_s") or r.get("ndim") != 3:
        return None
    flops, nbytes = yardstick.helmholtz3d_counts(r["n"], r["nel"], r["ncomp"], r["word_bytes"])
    return 100.0 * yardstick.bound_seconds(flops, nbytes, r["dtype"]) / r["apply_s"]
