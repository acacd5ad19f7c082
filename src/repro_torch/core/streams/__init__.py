"""Stream time-complexity models (paper Eq. 1/2/3/5/6) and the calibrated
performance simulator whose campaign the heuristic is fitted on (copied from
the reference package; NumPy only)."""

from repro_torch.core.streams.simulator import (
    PAPER_SIZES,
    RTX_2080_TI,
    RTX_A5000,
    GpuSpec,
    StreamDataset,
    StreamSimulator,
)
from repro_torch.core.streams.timemodel import (
    BATCH_CANDIDATES,
    STREAM_CANDIDATES,
    StageTimes,
    select_optimum,
)

__all__ = [
    "BATCH_CANDIDATES",
    "PAPER_SIZES",
    "RTX_2080_TI",
    "RTX_A5000",
    "STREAM_CANDIDATES",
    "GpuSpec",
    "StageTimes",
    "StreamDataset",
    "StreamSimulator",
    "select_optimum",
]
