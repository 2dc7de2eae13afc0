"""The measurement path on a machine without a card, the import checks,
and a configuration, a cell and a per-layer metric added by files alone."""

import ast
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from benchmark import harness

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "benchmark"


def test_no_card_fails_without_a_result():
    """Here there is no CUDA device: the run exits non-zero and prints no
    result line, and nothing falls back to the CPU."""
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                          "solve.fleet_n50_k8.b8192", "--seed", str(2 ** 40 + 3), "--seconds",
                          "1", "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "no CUDA device" in out.stderr


def test_only_benchmark_files_fail_without_the_port(tmp_path):
    """A directory holding BENCHMARK.json and the benchmark alone gives no
    result."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                          "node.node_n7.b1", "--seed", "1", "--seconds", "1", "--trace", "0"],
                         cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "the port is not beside the benchmark" in out.stderr


def _files():
    return sorted(p for p in BENCH.rglob("*.py") if "__pycache__" not in p.parts)


@pytest.mark.parametrize("path", _files(), ids=lambda p: str(p.relative_to(BENCH)))
def test_nothing_imports_jax_or_the_jax_package(path):
    names = harness.imported_top_levels(path)
    assert not names & set(harness.FORBIDDEN)
    if path.parent.name == "reference":
        assert "kissmpc_tpu_torch" not in names
    if "reference" in path.parts:
        for node in ast.walk(ast.parse(path.read_text())):  # no test helpers either
            if isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
                assert node.module.split(".")[0] in ("torch", "numpy", "typing",
                                                     "__future__", "dataclasses", "functools")


def test_reference_check_runs_clean():
    assert harness.reference_imports_ok() == []


def test_forbidden_modules_compare_top_level_names_whole():
    assert harness.forbidden_modules({"kissmpc_tpu_torch.solver": 1, "jaxtyping": 1,
                                      "numpy": 1}) == []
    assert harness.forbidden_modules({"kissmpc_tpu.solver.ipm": 1, "jax.numpy": 1,
                                      "flax": 1}) == ["flax", "jax", "kissmpc_tpu"]


def test_a_run_loads_no_jax():
    """Everything a run imports (the harness, both drivers, the reference,
    the metric readers and the port) leaves no forbidden module loaded."""
    code = ("import sys; sys.path.insert(0, '.'); from benchmark import harness; "
            "[harness.load_module(d, p.stem) for d in ('traffic', 'metrics') "
            " for p in (harness.BENCH / d).glob('*.py')]; "
            "import kissmpc_tpu_torch, kissmpc_tpu_torch.io; "
            "print(harness.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300, env={**os.environ, "USE_FLAX": "0"})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_added_by_files_alone(tmp_path):
    """A new configuration, cell and per-layer metric: new files and
    BENCHMARK.json entries, no edit to a file the benchmark has."""
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    before = {p.relative_to(tmp_path): p.read_bytes()
              for p in (tmp_path / "benchmark").rglob("*") if p.is_file()}
    b = tmp_path / "benchmark"
    config = json.loads((b / "configs" / "fleet_n50_k8.json").read_text())
    config.update(name="free_n50", max_obstacles=0, dynamic_obstacles=0)
    (b / "configs" / "free_n50.json").write_text(json.dumps(config))
    cell = json.loads((b / "workloads" / "solve.fleet_n50_k8.b8192.json").read_text())
    cell.update(name="solve.free_n50.b8192", config="free_n50", traffic="solve_free_b8192")
    (b / "workloads" / "solve.free_n50.b8192.json").write_text(json.dumps(cell))
    (b / "metrics" / "calls_traced.solve.py").write_text(
        "def read(run):\n    return float(len(run.window.trace_times)) or None\n")
    spec["configs"].append({"name": "free_n50", "source": "x", "file":
                            "benchmark/configs/free_n50.json", "reduced": [], "why": "x"})
    spec["workloads"].append({"name": "solve.free_n50.b8192", "config": "free_n50",
                              "traffic": "solve_free_b8192", "chips": 1, "why": "x"})
    spec["per_layer"].append({"name": "calls_traced.solve", "unit": "calls", "better": "higher",
                              "source": "device_trace", "layer": "device",
                              "moves": "solves_per_s", "workloads": ["solve.free_n50.b8192"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    code = ("import sys; sys.path.insert(0, '.'); from benchmark import harness; "
            "cell, cfg = harness.load_cell('solve.free_n50.b8192'); "
            "harness.load_module('traffic', cell['driver']); "
            "m = harness.load_module('metrics', 'calls_traced.solve'); "
            "w = harness.Window([1.0], 1.0, None, 0, [1.0, 1.0]); "
            "print(cfg['max_obstacles'], m.read(harness.Run(cell, cfg, None, w)))")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["0", "2.0"]
    after = {p.relative_to(tmp_path): p.read_bytes()
             for p in (tmp_path / "benchmark").rglob("*") if p.is_file()
             and "__pycache__" not in p.parts}
    assert all(after[p] == data for p, data in before.items())
