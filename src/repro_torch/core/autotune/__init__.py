"""The paper's Eq. 4–7 fit of the optimum stream (chunk) count (copied from
the reference package; NumPy only), plus :mod:`.convert`, which carries a
heuristic fitted by the JAX package across to this one."""

from repro_torch.core.autotune.heuristic import (
    BatchedStreamHeuristic,
    StreamHeuristic,
    fit_batched_stream_heuristic,
    fit_stream_heuristic,
)

__all__ = [
    "BatchedStreamHeuristic",
    "StreamHeuristic",
    "fit_batched_stream_heuristic",
    "fit_stream_heuristic",
]
