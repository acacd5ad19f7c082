"""On the card, at each cell's own size: the program proves correct and its
control does not, on three seeds. Marked ``card``; skips without CUDA.

    python -m pytest -q -m card cudabench/tests
"""

from __future__ import annotations

from pathlib import Path

import pytest

from cudabench import harness

ROOT = Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in harness.load_benchmark(ROOT)["workloads"]]
SEEDS = (2**31 + 101, 2**31 + 202, 2**31 + 303)


@pytest.mark.card
@pytest.mark.parametrize("workload", CELLS)
def test_control_is_not_correct_at_the_cells_size(workload, cuda_device):
    for seed in SEEDS:
        _, rec = harness.execute(ROOT, workload, seed, 3.0, False, cuda_device,
                                 variant="control")
        assert not rec.correct, (seed, rec.checks)


@pytest.mark.card
@pytest.mark.parametrize("workload", CELLS)
def test_program_is_correct_at_the_cells_size(workload, cuda_device):
    _, rec = harness.execute(ROOT, workload, SEEDS[0], 3.0, False, cuda_device)
    assert rec.correct, rec.checks
