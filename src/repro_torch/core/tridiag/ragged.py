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

``RaggedPartitionSolver`` and ``solve_ragged`` survive as deprecated
wrappers over ``repro_torch.api.TridiagSession(...).solve_many(systems)``.
"""

from __future__ import annotations

import warnings
from typing import TYPE_CHECKING, Any, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.tridiag.batched import ArrayT, as_tensor

if TYPE_CHECKING:  # the plan module imports this one
    from repro_torch.core.tridiag.api import TridiagSession
    from repro_torch.core.tridiag.plan import BackendLike, ChunkPolicy, ChunkTiming, SolvePlan

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


def _session_for(m: int, num_chunks: int, policy: Optional[ChunkPolicy], backend: BackendLike,
                 device: str) -> "TridiagSession":
    """The session the deprecated constructors' arguments describe, with
    ``dispatch="staged"`` (their contract is the staged numerics)."""
    from repro_torch.core.tridiag.api import SolverConfig, TridiagSession

    return TridiagSession(SolverConfig(
        m=m, num_chunks=None if policy is not None else num_chunks, policy=policy,
        backend=backend if backend is not None else "reference", dispatch="staged",
        device=device))


class RaggedPartitionSolver:
    """Deprecated: use ``repro_torch.api.TridiagSession(...).solve_many(...)``.

    ``policy`` (a :class:`~repro_torch.core.tridiag.plan.ChunkPolicy`)
    prices each batch by its effective size at solve time; a fixed
    ``num_chunks`` is the no-policy baseline. Chunks slice the fused block
    axis, so they span system boundaries. Every call delegates to a session
    (:func:`_session_for`) on ``device``.
    """

    def __init__(self, m: int = 10, num_chunks: int = 1, *,
                 policy: Optional[ChunkPolicy] = None, backend: BackendLike = None,
                 device: str = "cuda") -> None:
        warnings.warn(
            "RaggedPartitionSolver is deprecated: use repro_torch.api."
            "TridiagSession(SolverConfig(m=..., policy=... or num_chunks=..., "
            "backend=...)).solve_many(...)",
            DeprecationWarning,
            stacklevel=2,
        )
        if policy is not None and num_chunks != 1:
            raise ValueError("pass num_chunks or policy, not both")
        self.m = m
        self.num_chunks = num_chunks
        self.policy = policy
        self._session = _session_for(m, num_chunks, policy, backend, device)

    def plan_for(self, sizes: Sequence[int]) -> SolvePlan:
        return self._session.plan_for(tuple(sizes))

    def solve(self, systems: Sequence[System]) -> List[np.ndarray]:
        xs, _ = self.solve_timed(systems)
        return xs

    def solve_timed(self, systems: Sequence[System]) -> Tuple[List[np.ndarray], ChunkTiming]:
        return self._session.solve_many_timed(systems)


def solve_ragged(
    systems: Sequence[System],
    *,
    m: int = 10,
    num_chunks: int = 1,
    policy: Optional[ChunkPolicy] = None,
    backend: BackendLike = None,
    device: str = "cuda",
) -> List[np.ndarray]:
    """One-shot ragged fused solve; returns the per-system solutions.

    Deprecated: use ``repro_torch.api.TridiagSession(...).solve_many(systems)``.
    """
    warnings.warn(
        "solve_ragged is deprecated: use repro_torch.api.TridiagSession("
        "SolverConfig(...)).solve_many(systems)",
        DeprecationWarning,
        stacklevel=2,
    )
    if policy is not None and num_chunks != 1:
        raise ValueError("pass num_chunks or policy, not both")
    return _session_for(m, num_chunks, policy, backend, device).solve_many(systems)
