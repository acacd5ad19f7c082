"""BENCHMARK.json against the benchmark's contract, and every file it names
found by name."""

from __future__ import annotations

import ast
import json
import re
from pathlib import Path

import pytest

from cudabench import harness

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def one_line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_paths():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["cudabench"]
    assert len(BENCH["command"]) <= 32 and all(one_line(w) for w in BENCH["command"])
    for word in BENCH["command"][1:]:
        assert not word.startswith("/") and ".." not in word
        assert word.startswith("cudabench/")
    assert (ROOT / BENCH["command"][1]).is_file()
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_run_seconds_fits_a_full_check_of_24_cells():
    rs = BENCH["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda c: c["name"])
def test_config_entry(entry):
    assert set(entry) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(entry["name"]) and one_line(entry["why"]) and one_line(entry["source"])
    assert entry["file"].startswith("cudabench/configs/") and (ROOT / entry["file"]).is_file()
    assert len(entry["reduced"]) <= 16 and all(NAME.match(k) for k in entry["reduced"])
    config = json.loads((ROOT / entry["file"]).read_text())
    for key in entry["reduced"]:
        assert key in config and not key.endswith(("_dim", "_rank"))
    assert (ROOT / "cudabench" / "drivers" / f"{config['kind']}.py").is_file()
    assert (ROOT / "cudabench" / "references" / f"{config['reference']}.py").is_file()
    assert any(w["config"] == entry["name"] for w in BENCH["workloads"])


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda w: w["name"])
def test_workload_entry(cell):
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(cell["name"]) and NAME.match(cell["traffic"]) and one_line(cell["why"])
    assert cell["chips"] == 1
    assert cell["config"] in {c["name"] for c in BENCH["configs"]}
    assert (ROOT / "cudabench" / "traffic" / f"{cell['traffic']}.json").is_file()
    loaded = harness.load_cell(ROOT, cell["name"])
    e2e = {m["name"] for m in loaded.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert loaded.per_layer


def test_cells_are_unique_pairs():
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(set(pairs)) == len(pairs) == len(set(CELLS))
    assert 1 <= len(CELLS) <= 24


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_metric_entry(metric):
    per_layer = metric in BENCH["per_layer"]
    keys = {"name", "unit", "better", "source"} | (
        {"layer", "moves"} if per_layer else {"bound"})
    assert set(metric) - {"workloads"} == keys
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher") and metric["source"] in SOURCES
    assert set(metric.get("workloads", CELLS)) <= set(CELLS)
    assert (ROOT / "cudabench" / "metrics" / f"{metric['name']}.py").is_file()
    if per_layer:
        assert one_line(metric["layer"])
        moves = {m["name"]: m for m in BENCH["end_to_end"]}[metric["moves"]]
        assert set(metric["workloads"]) <= set(moves.get("workloads", CELLS))
    else:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25


def test_metric_names_unique_and_setup_s_present():
    names = [m["name"] for m in METRICS]
    assert len(set(names)) == len(names)
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_every_metric_has_a_reader(metric):
    path = ROOT / "cudabench" / "metrics" / f"{metric['name']}.py"
    module = harness.load_file_module(path, "spec_" + metric["name"].replace(".", "_"))
    assert callable(module.read)
    assert module.read(harness.Record()) in (None, 0.0)


def test_unknown_workload_names_the_cells():
    with pytest.raises(KeyError, match="solve-batched-64x1e5"):
        harness.load_cell(ROOT, "no-such-cell")


@pytest.mark.parametrize("path", sorted((ROOT / "cudabench").rglob("*.py")),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_module_imports_jax_or_the_jax_package(path):
    """Each import's top-level name compared whole: ``repro_torch`` is the
    port, ``repro`` the JAX package."""
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops = [a.name.split(".")[0] for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            tops = [node.module.split(".")[0]]
        else:
            continue
        assert not set(tops) & {"jax", "jaxlib", "flax", "repro", "benchmarks"}, (
            path, node.lineno, tops)


def test_foreign_modules_compares_whole_top_level_names(monkeypatch):
    import sys
    import types

    monkeypatch.setitem(sys.modules, "repro_torch_lookalike", types.ModuleType("x"))
    assert "repro" not in harness.foreign_modules() or "repro" in {
        m.split(".")[0] for m in sys.modules}
    monkeypatch.setitem(sys.modules, "flax", types.ModuleType("flax"))
    assert "flax" in harness.foreign_modules()
