"""Tests of the benchmark (not of the program): run from the repo root,

    python -m pytest benchmark/tests -q

They import the harness as `python3 benchmark/run.py` does (benchmark/ on
sys.path, the repo root after it). The ones marked `cuda` need a card and
skip without one; they decide so in the `card` fixture."""

import os
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
ROOT = os.path.dirname(BENCH)
for p in (ROOT, BENCH):
    if p not in sys.path:
        sys.path.insert(0, p)

# small sizes of each configuration (every width of the cells' own is kept
# where it is a count of the discretisation, not of the flow)
TINY = {
    "channel3d-re7500": {
        "mesh": {"builder": "box", "nels": [3, 2, 2], "lims": [[0.0, 6.283185307179586], [-1.0, 1.0],
                                            [0.0, 3.141592653589793]],
                 "bc": {"x-": "P", "x+": "P", "y-": "W", "y+": "W", "z-": "P", "z+": "P"},
                 "order": 4},
        "tau": 0.2, "viscosity": 1e-2,
    },
    "duct3d-re1000": {
        "mesh": {"builder": "box", "nels": [2, 3, 3], "lims": [[0.0, 4.0], [-1.0, 1.0], [-1.0, 1.0]],
                 "bc": {"x-": "P", "x+": "P", "y-": "W", "y+": "W", "z-": "W", "z+": "W"},
                 "order": 4},
        "tau": 0.2, "viscosity": 1e-2,
    },
}


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    return torch.device("cuda", 0)


@pytest.fixture
def root():
    return ROOT
