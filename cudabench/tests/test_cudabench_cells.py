"""Each cell driven end to end on the CPU at a tiny size (the chip is not
looked for), its result line, a cell added as files alone, and the
comparison that decides ``correct`` catching the control and every planted
fault."""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from cudabench import faults, harness

ROOT = Path(__file__).resolve().parents[2]
CPU = torch.device("cpu")
SEED = 2**31 + 12345  # past 32 signed bits, as the driver's seeds are
SOLVE_TINY = {
    "solve-batched-64x1e5": {"traffic": {"sizes": [1000], "batch": 40, "sample_per_shape": 4}},
}
TRAIN_TINY = {
    "config": {"n_layer": 2, "d_model": 64, "vocab_size": 512,
               "ssm_cfg": {"layer": "Mamba2", "d_state": 16, "d_conv": 4, "expand": 2,
                           "headdim": 16, "ngroups": 1, "chunk_size": 32}},
    "traffic": {"batch": 2, "seq_len": 64},
}
TINY = {**SOLVE_TINY, "mamba2-train-2x2048": TRAIN_TINY}
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def run(workload, trace=False, seed=SEED, variant="program", root=ROOT):
    cell, rec = harness.execute(root, workload, seed, 0.3, trace, CPU, variant=variant,
                                overrides=TINY.get(workload))
    return cell, rec, harness.result_line(cell, rec, trace, platform="cpu")


@pytest.mark.parametrize("workload", sorted(TINY))
@pytest.mark.parametrize("trace", [False, True], ids=["untraced", "traced"])
def test_cell_runs_and_is_correct(workload, trace):
    cell, rec, line = run(workload, trace)
    assert list(line) == KEYS + (["breakdown"] if trace else []) + ["checks"]
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] > 0
    assert set(line["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    names = {m["name"] for m in (cell.per_layer if trace else cell.end_to_end)}
    assert set(line["metrics"]) <= names
    if not trace:
        assert {"setup_s"} < set(line["metrics"])  # a rate beside it
    else:
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    for check in line["checks"].values():
        assert check["value"] <= check["limit"]
    json.dumps(line, allow_nan=False)


@pytest.mark.parametrize("seed", [SEED, 3])
def test_same_seed_same_inputs(seed):
    from cudabench.drivers import tridiag_session
    from cudabench.references import tridiag

    spec = harness.load_cell(ROOT, "solve-batched-64x1e5").config["system"]
    a, b = (tridiag.make_system(torch.Generator().manual_seed(seed), (3, 50), spec, CPU)
            for _ in range(2))
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    order = [tridiag_session.schedule(7, seed) for _ in range(2)]
    first = [[next(o) for _ in range(21)] for o in order]
    assert first[0] == first[1]
    assert all(sorted(first[0][i:i + 7]) == list(range(7)) for i in (0, 7, 14))


@pytest.mark.parametrize("workload", sorted(SOLVE_TINY))
def test_solver_control_is_not_correct(workload):
    """The configuration's float32 path in the program's place."""
    _, rec, line = run(workload, variant="control")
    assert line["correct"] is False
    assert rec.checks["max_rel_err"][0] > 1e3 * rec.checks["max_rel_err"][1]


@pytest.mark.parametrize("fault", faults.FAULTS)
@pytest.mark.parametrize("workload", sorted(TINY))
def test_planted_fault_is_not_correct(workload, fault):
    kind = harness.load_cell(ROOT, workload).config["kind"]
    with faults.planted(kind, fault):
        _, _, line = run(workload)
    assert line["correct"] is False, line["checks"]


def added_cell(tmp_path, name, traffic, mix=None):
    """A copy of the benchmark with the cell ``name`` (tridiag-paper-fp64
    under ``traffic``, whose file is written when ``mix`` is given) added
    to BENCHMARK.json and to the solver metrics' cells."""
    shutil.copytree(ROOT / "cudabench", tmp_path / "cudabench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": name, "config": "tridiag-paper-fp64",
                               "traffic": traffic, "chips": 1, "why": "a test cell"})
    for metric in bench["end_to_end"] + bench["per_layer"]:
        if "solve-batched-64x1e5" in metric.get("workloads", ()):
            metric["workloads"].append(name)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    if mix is not None:
        (tmp_path / "cudabench" / "traffic" / f"{traffic}.json").write_text(json.dumps(mix))
    return tmp_path


def test_a_cell_added_as_files_alone_runs(tmp_path):
    """One more traffic file and its entry in BENCHMARK.json: the harness
    runs the cell without an edit of its code."""
    root = added_cell(tmp_path, "solve-odd-sizes", "odd-sizes", {
        "verb": "solve", "sizes": [1230, 4560], "batch": None,
        "systems_per_shape": 2, "sample_per_shape": 2})
    _, _, line = run("solve-odd-sizes", root=root)
    assert line["correct"] is True
    assert {"solve_unknowns_per_s", "solve_p95_ms", "setup_s"} == set(line["metrics"])


@pytest.mark.parametrize("trace", [False, True], ids=["untraced", "traced"])
def test_the_kept_paper_sizes_mix_runs(tmp_path, trace):
    """``traffic/paper-sizes.json``, kept for a later cell (PERF.md §7), at
    tiny sizes: the closed loop of ``solve`` in seeded cycles."""
    root = added_cell(tmp_path, "solve-paper-sizes", "paper-sizes")
    cell, rec = harness.execute(root, "solve-paper-sizes", SEED, 0.3, trace, CPU,
                                overrides={"traffic": {"sizes": [1000, 2000, 5000]}})
    line = harness.result_line(cell, rec, trace, platform="cpu")
    assert line["correct"] is True and rec.attempted >= 3
    with faults.planted("tridiag_session", "altered"):
        _, rec = harness.execute(root, "solve-paper-sizes", SEED, 0.3, trace, CPU,
                                 overrides={"traffic": {"sizes": [1000, 2000, 5000]}})
    assert not rec.correct


def test_run_without_a_card_prints_no_result(tmp_path):
    """Here torch has no CUDA: the command exits non-zero with an empty
    standard output, from the checkout and from a directory holding only
    BENCHMARK.json and the benchmark's folder."""
    bare = tmp_path / "bare"
    shutil.copytree(ROOT / "cudabench", bare / "cudabench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", bare / "BENCHMARK.json")
    for root in (ROOT, bare):
        proc = subprocess.run(
            [sys.executable, "cudabench/run.py", "--workload", "solve-paper-sizes",
             "--seed", str(SEED), "--seconds", "1", "--trace", "0"],
            cwd=root, capture_output=True, text=True, timeout=120)
        assert proc.returncode != 0 and proc.stdout == "", (proc.returncode, proc.stdout)


def test_runs_import_neither_jax_nor_the_jax_package():
    """Every module a run of each cell loads, in a fresh process."""
    code = (
        "import sys, torch; sys.path[:0] = ['src', '.']\n"
        "from pathlib import Path\n"
        "from cudabench import harness\n"
        "from cudabench.tests.test_cudabench_cells import TINY\n"
        "for w in sorted(TINY):\n"
        "    cell, rec = harness.execute(Path('.'), w, 7, 0.1, True, torch.device('cpu'),"
        " overrides=TINY[w])\n"
        "    harness.result_line(cell, rec, True)\n"
        "print(harness.foreign_modules())\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip().splitlines()[-1] == "[]"
