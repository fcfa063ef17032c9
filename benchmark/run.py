"""The benchmark's command:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Needs a CUDA card; prints one JSON line.
"""

import time

T0 = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.getcwd()
# every cache of the program and its libraries inside the checkout, at fixed paths
os.environ.setdefault("NEKLAB_MESH_CACHE", os.path.join(ROOT, ".mesh_cache"))
os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(ROOT, ".bench_cache", "triton"))
os.environ.setdefault("TORCH_EXTENSIONS_DIR", os.path.join(ROOT, ".bench_cache", "extensions"))
for var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
    os.environ.setdefault(var, "4")
sys.path.insert(0, HERE)
sys.path.insert(1, ROOT)

if __name__ == "__main__":
    import harness

    sys.exit(harness.main(t0=T0))
