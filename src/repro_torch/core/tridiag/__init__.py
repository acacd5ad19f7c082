"""Tridiagonal solvers of the port: Thomas, the partition method, batch and
ragged fusion, plans and the session front door (see :mod:`.api`), and the
deprecated frontends that delegate to a session
(``ChunkedPartitionSolver``, ``BatchedPartitionSolver``,
``RaggedPartitionSolver``, ``solve_ragged``)."""

from repro_torch.core.tridiag.plan import (
    clear_executable_cache,
    executable_cache_stats,
    set_executable_cache_capacity,
)
from repro_torch.core.tridiag.chunked import ChunkedPartitionSolver, measure_chunk_sweep
from repro_torch.core.tridiag.batched import BatchedPartitionSolver
from repro_torch.core.tridiag.ragged import RaggedPartitionSolver, solve_ragged

__all__ = [
    "clear_executable_cache",
    "executable_cache_stats",
    "set_executable_cache_capacity",
    "ChunkedPartitionSolver",
    "measure_chunk_sweep",
    "BatchedPartitionSolver",
    "RaggedPartitionSolver",
    "solve_ragged",
]
