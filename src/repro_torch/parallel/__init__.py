"""Parallel execution context of the port (single device so far)."""

from repro_torch.parallel.ctx import ParallelCtx

__all__ = ["ParallelCtx"]
