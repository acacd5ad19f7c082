"""Parallel execution context threaded through the model code.

The counterpart of ``repro.parallel.ctx.ParallelCtx`` for one device: the
model code calls ``shard`` and ``shard_residual`` where the reference places
its sharding constraints, and here both return their input. A device mesh
(data, FSDP, tensor and expert parallelism) is not ported yet: ``mesh``
other than ``None`` raises ``NotImplementedError`` (ROADMAP, Queue 1).

There is no ``pallas_ssd`` switch. The SSD intra-chunk stage always goes
through its kernel wrapper, which launches the CUDA kernel on CUDA tensors
and runs the plain PyTorch version on CPU tensors.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional, Tuple

import torch


@dataclass(frozen=True)
class ParallelCtx:
    mesh: Optional[Any] = None
    data_axes: Tuple[str, ...] = ("data",)

    def __post_init__(self) -> None:
        if self.mesh is not None:
            raise NotImplementedError(
                "ParallelCtx(mesh=...): the port runs on one device; the "
                "sharded LM path is still to be ported (ROADMAP, Queue 1)"
            )

    @property
    def batch_axes(self) -> Tuple[str, ...]:
        return self.data_axes

    def shard(self, x: torch.Tensor, *axes: Any) -> torch.Tensor:
        """The reference's sharding constraint; the identity on one device."""
        return x

    def shard_residual(self, x: torch.Tensor) -> torch.Tensor:
        """The reference's residual-stream constraint; the identity here."""
        return x
