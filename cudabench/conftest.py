"""pytest settings of the benchmark's own tests (``cudabench/tests``).

Tests that need the card carry the ``card`` marker and take the
``cuda_device`` fixture, which skips them where torch sees no CUDA device;
the decision is taken when the test runs, never at import. On the card:
``python -m pytest -q -m card cudabench/tests``.
"""

from __future__ import annotations

import pytest


def pytest_configure(config: pytest.Config) -> None:
    config.addinivalue_line("markers", "card: needs an NVIDIA card (skips without CUDA)")


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the card: python -m pytest -m card cudabench/tests")
    return torch.device("cuda", 0)
