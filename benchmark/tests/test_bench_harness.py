"""The harness: every cell resolves by name, the result line's schema, no
JAX in any module the benchmark imports, and a run on the card."""

import ast
import importlib.util
import json
import os
import subprocess
import sys

import pytest

import harness
from conftest import BENCH, ROOT, TINY

BENCHMARK = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
CELLS = [w["name"] for w in BENCHMARK["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves_by_name(cell):
    """Each cell finds its configuration, traffic mix, limits and a reader
    for every metric it reports; the configuration names itself, its
    source and its cuts."""
    spec = harness.resolve(cell, ROOT)
    conf = {c["name"]: c for c in BENCHMARK["configs"]}[spec["cell"]["config"]]
    assert spec["config"]["name"] == conf["name"]
    assert spec["config"]["reduced"] == conf["reduced"]
    assert {"source", "assumed", "mesh", "dtype", "tau", "base_flow"} <= set(spec["config"])
    mix = spec["mix"]
    assert mix["driver"] in spec["config"]
    driver = harness.plugin("drivers", mix["driver"])
    for attr in ("CALLS", "RECORD", "keep", "capture", "solve", "control", "readings"):
        assert hasattr(driver, attr), attr
    operator = harness.plugin("operators", mix["operator"])
    for attr in ("program", "counters", "reference", "time_steps_per_call", "apply_shape"):
        assert hasattr(operator, attr), attr
    meshes = harness.plugin("meshes", spec["config"]["mesh"]["builder"])
    assert {"program", "host", "reference"} <= set(dir(meshes))
    assert importlib.util.find_spec(f"reference.baseflows.{spec['config']['base_flow']['kind']}")
    assert 1 <= mix["sample_within"] and 1 <= mix["memory_after_steps"]
    assert spec["limits"]
    names = [m["name"] for m in spec["end_to_end"] + spec["per_layer"]]
    assert {"krylov_step_s", "peak_mem_gb", "setup_s"} <= set(names)
    for name in names:
        assert callable(harness.reader(name))


def test_every_config_and_metric_is_used():
    used = {w["config"] for w in BENCHMARK["workloads"]}
    assert used == {c["name"] for c in BENCHMARK["configs"]}
    for m in BENCHMARK["per_layer"]:
        assert set(m["workloads"]) <= set(CELLS)
        assert m["moves"] in {e["name"] for e in BENCHMARK["end_to_end"]}


@pytest.mark.parametrize("cell", ["channel3d-re7500.eigs", "duct3d-re1000.growth"])
@pytest.mark.parametrize("trace", [False, True])
def test_result_line_schema(cell, trace, root):
    """A whole run at a small size on the CPU: the keys the result line
    needs, the cell's metrics by name and unit, `checks` last, and every
    number compared inside its limit."""
    out = harness.run_cell(cell, 2**31 + 12345, 0.5, trace, root, "cpu",
                           overrides=TINY[cell.split(".")[0]])
    line = json.loads(json.dumps(out))
    assert list(line)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(line)
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] >= 1
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(line["device"])
    spec = harness.resolve(cell, root)
    want = spec["per_layer"] if trace else spec["end_to_end"]
    units = {m["name"]: m["unit"] for m in want}
    for name, m in line["metrics"].items():
        assert m["unit"] == units[name] and isinstance(m["value"], float)
    if trace:
        assert {"matvec_s", "pressure_iters_per_step", "velocity_iters_per_step",
                "krylov_host_ms"} <= set(line["metrics"])
        assert {"busy_s", "window_s"} <= set(line["device"])
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert {"krylov_step_s", "setup_s"} <= set(line["metrics"])
    for r in line["checks"].values():
        assert r["value"] <= r["limit"]


FORBIDDEN = set(harness.FORBIDDEN)


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_no_module_under_benchmark_imports_jax():
    """Top-level names compared whole: neklab_tpu_torch is not neklab_tpu."""
    for dirpath, _, files in os.walk(BENCH):
        for f in files:
            if f.endswith(".py"):
                tops = {name.split(".")[0] for name in _imports(os.path.join(dirpath, f))}
                assert not tops & FORBIDDEN, (f, tops & FORBIDDEN)


def test_a_run_loads_no_jax():
    """Every module a whole run loads (the program's included), in a
    process of its own."""
    code = (
        "import sys, json; sys.path[:0] = [%r, %r]\n"
        "from conftest import TINY\nimport harness\n"
        "harness.run_cell('duct3d-re1000.growth', 5, 0.2, True, %r, 'cpu', "
        "overrides=TINY['duct3d-re1000'])\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n"
    ) % (os.path.join(BENCH, "tests"), BENCH, ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=ROOT, timeout=600, env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stderr[-2000:]
    tops = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "neklab_tpu_torch" in tops and not tops & FORBIDDEN


def test_cli_refuses_without_a_card(root):
    """No card (CUDA hidden): exit code other than 0 and no result."""
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", CELLS[0], "--seed",
                          "1", "--seconds", "1", "--trace", "0"], capture_output=True,
                         text=True, cwd=root, timeout=300,
                         env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0 and out.stdout.strip() == ""


@pytest.mark.cuda
def test_a_small_run_on_the_card(card, root):
    """The whole traced run on the card at a small size: correct, and the
    profiled step saw the device busy."""
    out = harness.run_cell("duct3d-re1000.growth", 77, 1.0, True, root, card,
                           overrides=TINY["duct3d-re1000"])
    assert out["correct"] and out["device"]["busy_s"] > 0
    assert out["metrics"]["helmholtz3d_roofline"]["value"] <= 100


def test_a_solve_that_converges_is_followed_by_the_next(root):
    """A loose eigs tolerance converges inside the window: the next seed's
    solve follows, every step is counted once, and the records of the
    first solve are judged."""
    over = {**TINY["channel3d-re7500"], "eigs": {"kdim": 16, "nev": 1, "tol": 1e-1}}
    out = harness.run_cell("channel3d-re7500.eigs", 99, 4.0, False, root, "cpu", overrides=over)
    # the first solve converges at kdim, 16 steps; the next one's follow
    assert out["correct"] and out["attempted"] > 16
