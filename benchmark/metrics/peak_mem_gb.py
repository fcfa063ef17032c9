"""Peak device memory (GB, 1e9 bytes) allocated over the warm-up and the
first `memory_after_steps` Krylov steps of the window (the traffic mix's
count; the window's end where fewer completed): the program's solvers, its
Krylov basis and (growth) its adjoint tape. A fixed count of steps, so
that a faster program, which completes more steps and so holds a larger
Gram product, reads the same. The preconditioner's probing, which runs in
set-up only while its disk cache is cold, is left out, so that every run
reads the same."""


def read(rec):
    return rec["peak_bytes"] / 1e9 if rec.get("peak_bytes") else None
