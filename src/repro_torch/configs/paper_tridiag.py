"""The paper's own workload configuration (§2): SLAE sizes, sub-system size,
precision, stream candidates, and the (TPU-adapted) kernel tiling."""

from dataclasses import dataclass
from typing import Tuple

from repro_torch.core.streams.simulator import PAPER_SIZES
from repro_torch.core.streams.timemodel import STREAM_CANDIDATES


@dataclass(frozen=True)
class PaperTridiagConfig:
    sizes: Tuple[int, ...] = PAPER_SIZES
    sub_system_size: int = 10          # paper: m = 10
    stream_candidates: Tuple[int, ...] = STREAM_CANDIDATES  # powers of 2 ≤ 32
    precision: str = "fp64"            # FP64 primary, FP32 in §3.2
    # CUDA: 256 threads/block. TPU adaptation: 512-lane block over the
    # partition axis (DESIGN.md §2.1) — 4 sublane groups of 128 lanes.
    block_p: int = 512
    train_test_ratio: float = 0.25     # paper: 3:1 shuffled split


CONFIG = PaperTridiagConfig()
