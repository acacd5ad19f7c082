"""Ragged mixed-size batch fusion: heterogeneous systems in one fused solve.

The counterpart of ``fuse_ragged`` / ``split_ragged`` in
``repro.core.tridiag.ragged``. Concatenating systems of any sizes n₁..n_B
(each a multiple of the block size m) with their boundary couplings zeroed
gives a ``Σ nᵢ``-row system whose partition solve is exactly the B
independent solves; the per-system offsets split the solution apart again.

:func:`fuse_ragged` validates every system up front: the four diagonals of a
system must be 1-D and equally long, and a malformed system is rejected with
its batch index. (Silently fusing a short diagonal would shift every later
system's rows and corrupt all their solutions, which is fatal when one bad
request rides with innocent neighbours.)
"""

from __future__ import annotations

from typing import Any, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.tridiag.batched import ArrayT, as_tensor

Tensor = torch.Tensor
System = Tuple[Any, Any, Any, Any]


def fuse_ragged(
    systems: Sequence[System], device: Optional[torch.device] = None
) -> Tuple[Tensor, Tensor, Tensor, Tensor, Tuple[int, ...]]:
    """Fuse mixed-size 1-D systems into one ``(Σ nᵢ,)`` system.

    ``systems`` is a sequence of ``(dl, d, du, b)`` tuples (numpy arrays or
    tensors). Boundary couplings (``dl[0]``, ``du[-1]`` of every system) are
    zeroed in the fused copy. Mixed dtypes promote by torch's rules. Returns
    the four fused tensors (on ``device``) plus the per-system sizes.
    """
    if not systems:
        raise ValueError("fuse_ragged needs at least one system")
    parts: List[List[Tensor]] = [[], [], [], []]
    sizes: List[int] = []
    for i, (dl, d, du, b) in enumerate(systems):
        d = as_tensor(d, device)
        if d.ndim != 1:
            raise ValueError(f"ragged fusion takes 1-D systems, got shape {tuple(d.shape)}")
        ops = {"dl": as_tensor(dl, device), "du": as_tensor(du, device), "b": as_tensor(b, device)}
        # One short/long diagonal would shift every later system in the fused
        # arrays and silently corrupt all their solutions: reject it by index.
        for name, a in ops.items():
            if a.shape != d.shape:
                raise ValueError(
                    f"system {i}: {name} has shape {tuple(a.shape)} but d has "
                    f"shape {tuple(d.shape)}; all four diagonals must be equally long"
                )
        dl_i = ops["dl"].clone()
        du_i = ops["du"].clone()
        dl_i[0] = 0.0
        du_i[-1] = 0.0
        sizes.append(int(d.shape[0]))
        for part, a in zip(parts, (dl_i, d, du_i, ops["b"])):
            part.append(a)
    fused = [torch.cat(p).contiguous() for p in parts]
    return fused[0], fused[1], fused[2], fused[3], tuple(sizes)


def split_ragged(x: ArrayT, sizes: Sequence[int]) -> List[ArrayT]:
    """Inverse of :func:`fuse_ragged` for the solution vector."""
    offsets = np.concatenate([[0], np.cumsum(sizes)]).astype(int)
    if x.shape[-1] != offsets[-1]:
        raise ValueError(f"solution has {x.shape[-1]} rows, sizes sum to {offsets[-1]}")
    return [x[..., lo:hi] for lo, hi in zip(offsets[:-1], offsets[1:])]
