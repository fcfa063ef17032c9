"""Host launch calls (cudaLaunchKernel, cudaLaunchKernelExC, cudaGraphLaunch
events of the profiler's CPU trace) per time step, over Krylov step 1,
profiled with the host's calls."""


def read(rec):
    p = rec.get("profile")
    return p["launches"] / p["time_steps"] if p and p.get("time_steps") else None
