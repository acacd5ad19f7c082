"""Tridiagonal solvers of the port: Thomas, the partition method, batch and
ragged fusion, plans and the session front door (see :mod:`.api`)."""

from repro_torch.core.tridiag.plan import (
    clear_executable_cache,
    executable_cache_stats,
    set_executable_cache_capacity,
)

__all__ = [
    "clear_executable_cache",
    "executable_cache_stats",
    "set_executable_cache_capacity",
]
