"""Architecture configs, copied from ``repro.configs`` with only the imports
changed, so ``get_config`` and ``list_archs`` give the reference's answers.

Importing this package registers every architecture; use
``repro_torch.configs.base.get_config("<arch-id>")`` or ``--arch <id>`` on
the launcher. ``paper_tridiag`` holds the paper's own workload (sizes,
m = 10, stream candidates, fp64). The reference's ``shapes.py`` (the
dry-run's input specs, built on JAX) is not copied.
"""

from repro_torch.configs.base import ArchConfig, get_config, list_archs, register

# Register all assigned architectures (import side effects).
from repro_torch.configs import (  # noqa: F401
    codeqwen15_7b,
    gemma2_27b,
    internvl2_2b,
    kimi_k2_1t_a32b,
    mamba2_13b,
    moonshot_v1_16b_a3b,
    nemotron4_340b,
    qwen3_4b,
    whisper_medium,
    zamba2_7b,
)

__all__ = ["ArchConfig", "get_config", "list_archs", "register"]
