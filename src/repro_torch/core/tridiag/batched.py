"""Batch fusion of B same-size systems into one partition solve.

The counterpart of ``fuse_systems`` / ``split_systems`` in
``repro.core.tridiag.batched``. With the solver convention ``dl[0] =
du[n-1] = 0``, the partition method applied to the concatenation of B
systems of size n is *exactly* the B independent solves: Stage 1 is per
block, the reduced system decouples at every system boundary (zero left
spike in each first block, zero right coupling in each last block), and
Stage 3's cross-block term there is ``v·s_{p-1}`` with ``v = 0``. So the
batched solve runs the single-system pipeline on the fused ``(B·n,)``
operands, and chunks may span system boundaries.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple, TypeVar

import numpy as np
import torch

Tensor = torch.Tensor
ArrayT = TypeVar("ArrayT", np.ndarray, Tensor)


def as_tensor(a: Any, device: Optional[torch.device] = None) -> Tensor:
    """A numpy array, torch tensor or nested sequence as a tensor on
    ``device`` (default: where it already is; the CPU for host data).

    Host memory may be shared with the caller's array; the solver never
    writes into its operands, so the caller's data stays as it was.
    """
    if isinstance(a, Tensor):
        return a if device is None else a.to(device)
    return torch.as_tensor(np.ascontiguousarray(a), device=device)


def fuse_systems(
    dl: Any, d: Any, du: Any, b: Any, device: Optional[torch.device] = None
) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """(B, n) batch → one fused (B·n,) system with boundary couplings zeroed.

    Zeroing ``dl[:, 0]`` / ``du[:, n-1]`` is what makes the fused partition
    solve decouple exactly; those entries are ignored by convention in the
    unfused solve, so this loses nothing. ``dl`` and ``du`` are copied
    before zeroing, so the caller's operands are left as they were.
    """
    dl = as_tensor(dl, device).clone()
    du = as_tensor(du, device).clone()
    dl[..., :, 0] = 0.0
    du[..., :, -1] = 0.0

    def flat(a: Tensor) -> Tensor:
        return a.reshape(*a.shape[:-2], -1).contiguous()

    return flat(dl), flat(as_tensor(d, device)), flat(du), flat(as_tensor(b, device))


def split_systems(x: ArrayT, batch: int) -> ArrayT:
    """Inverse of :func:`fuse_systems` for the solution vector."""
    return x.reshape(*x.shape[:-1], batch, x.shape[-1] // batch)
