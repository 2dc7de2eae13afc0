"""BENCHMARK.json against the benchmark's contract, and every file it
names found by name."""

import json
import re
from pathlib import Path

import pytest

from benchmark import harness

ROOT = Path(__file__).resolve().parents[2]
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\t\n\r]{1,200}$")
WIDTH_WORDS = ("hidden", "intermediate", "latent", "state_size", "projection", "head",
               "expansion", "per_tok")


def metrics():
    return SPEC["end_to_end"] + SPEC["per_layer"]


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert len(json.dumps(SPEC)) <= 64 * 1024
    assert 1 <= len(SPEC["command"]) <= 32
    for word in SPEC["command"]:
        assert LINE.match(word) and not word.startswith("/") and ".." not in word
    for path in SPEC["paths"]:
        assert re.match(r"^[A-Za-z0-9_./-]{1,200}$", path) and (ROOT / path).is_dir()
    named = [w for w in SPEC["command"] if "/" in w]
    assert all(any(w.startswith(p + "/") for p in SPEC["paths"]) for w in named)


@pytest.mark.parametrize("entry", SPEC["configs"] + SPEC["workloads"] + metrics(),
                         ids=lambda e: e["name"])
def test_names_and_units(entry):
    assert NAME.match(entry["name"])
    if "unit" in entry:
        assert UNIT.match(entry["unit"])
        assert entry["better"] in ("lower", "higher")
        assert entry["source"] in ("device_trace", "program_span", "program_counter",
                                   "host_clock")
    for key in ("why", "layer", "source"):
        if key in entry and key != "source" or key == "source" and "file" in entry:
            assert LINE.match(entry[key])
    for key in ("config", "traffic"):
        if key in entry:
            assert NAME.match(entry[key])


def test_unique_names():
    for group in (SPEC["configs"], SPEC["workloads"], metrics()):
        names = [e["name"] for e in group]
        assert len(names) == len(set(names))
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_entry_keys():
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith(tuple(p + "/" for p in SPEC["paths"]))
        assert len(c["reduced"]) <= 16
        assert not any(k.endswith(("_dim", "_rank")) or any(w in k for w in WIDTH_WORDS)
                       for k in c["reduced"])
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4)
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
    assert any(m["name"] == "setup_s" and "workloads" not in m for m in SPEC["end_to_end"])


def test_run_seconds_fit_a_full_check():
    s = SPEC["run_seconds"]
    assert isinstance(s, int) and 1 <= s <= 51
    runs = 2 + 14 * 24
    assert runs * (s + 60) + 24 * 2 * 90 + 1200 <= 43200


def reported(cell):
    return {m["name"] for m in SPEC["end_to_end"]
            if "workloads" not in m or cell in m["workloads"]}


@pytest.mark.parametrize("metric", SPEC["per_layer"], ids=lambda m: m["name"])
def test_per_layer_cells_report_what_the_metric_moves(metric):
    cells = {w["name"] for w in SPEC["workloads"]}
    assert metric["moves"] in {m["name"] for m in SPEC["end_to_end"]}
    for cell in metric.get("workloads", cells):
        assert cell in cells
        assert metric["moves"] in reported(cell)
    harness.load_module("metrics", metric["name"])


def test_every_cell_reports_enough():
    for w in SPEC["workloads"]:
        got = reported(w["name"])
        assert "setup_s" in got and len(got) >= 2
        assert any(w["name"] in m.get("workloads", []) for m in SPEC["per_layer"])


@pytest.mark.parametrize("entry", SPEC["workloads"], ids=lambda e: e["name"])
def test_cell_and_config_files_found_by_name(entry):
    cell, config = harness.load_cell(entry["name"])
    assert cell["config"] == entry["config"] and cell["traffic"] == entry["traffic"]
    assert cell["chips"] == entry["chips"] and cell["why"] == entry["why"]
    spec_config = next(c for c in SPEC["configs"] if c["name"] == entry["config"])
    assert (ROOT / spec_config["file"]).resolve() == (
        harness.BENCH / "configs" / f"{config['name']}.json").resolve()
    assert set(cell["check"]["limits"]) and "assumed" in config
    harness.load_module("traffic", cell["driver"])


def test_every_config_is_used_and_files_are_distinct():
    used = {w["config"] for w in SPEC["workloads"]}
    assert used == {c["name"] for c in SPEC["configs"]}
    files = [c["file"] for c in SPEC["configs"]]
    assert len(files) == len(set(files))
