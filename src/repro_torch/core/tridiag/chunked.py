"""Chunked ("virtual stream") execution of the partition method, deprecated:
the counterpart of ``repro.core.tridiag.chunked``.

The paper dispatches slices of the block axis onto separate CUDA streams so
each slice's host-to-device copy, Stage 1 kernel and copy back overlap with
its neighbours'. The port's staged executor does exactly that
(:class:`~repro_torch.core.tridiag.plan.PlanExecutor`). This class is a
deprecated delegating wrapper over the one front door,
:mod:`repro_torch.core.tridiag.api`::

    TridiagSession(SolverConfig(m=10, num_chunks=4)).solve(dl, d, du, b)

replaces ``ChunkedPartitionSolver(m=10, num_chunks=4).solve(dl, d, du, b)``.
Like every entry point of the port it runs on the CUDA device unless
``device="cpu"`` is given.
"""

from __future__ import annotations

import warnings
from typing import Any, List, Sequence, Tuple

import numpy as np

from repro_torch.core.tridiag.plan import BackendLike, ChunkTiming, SolvePlan


class ChunkedPartitionSolver:
    """Deprecated: use ``repro_torch.api.TridiagSession`` with a
    ``SolverConfig``.

    ``num_chunks`` plays the role of the paper's ``num_str``: 1 is the
    non-streamed execution (Eq. 1); larger values overlap staging and
    compute (Eq. 2) at the price of per-chunk dispatch overhead.
    ``backend`` picks the stage implementation (``"reference"``, the plain
    PyTorch stages, by default; ``"cuda"``, the kernels; or a
    :class:`~repro_torch.core.tridiag.plan.StageBackend`). Every call
    delegates to a session with ``dispatch="staged"``
    (:func:`~repro_torch.core.tridiag.ragged._session_for`): the deprecated
    classes keep the staged numerics.
    """

    def __init__(self, m: int = 10, num_chunks: int = 1, *, backend: BackendLike = None,
                 device: str = "cuda") -> None:
        warnings.warn(
            "ChunkedPartitionSolver is deprecated: use repro_torch.api."
            "TridiagSession(SolverConfig(m=..., num_chunks=..., backend=...))"
            ".solve(...)",
            DeprecationWarning,
            stacklevel=2,
        )
        from repro_torch.core.tridiag.ragged import _session_for

        self.m = m
        self.num_chunks = num_chunks
        self._session = _session_for(m, num_chunks, None, backend, device)

    def plan_for(self, n: int) -> SolvePlan:
        """The single-system plan this solver executes for size ``n``."""
        return self._session.plan_for(n)

    def solve(self, dl: Any, d: Any, du: Any, b: Any) -> np.ndarray:
        x, _ = self.solve_timed(dl, d, du, b)
        return x

    def solve_timed(self, dl: Any, d: Any, du: Any, b: Any) -> Tuple[np.ndarray, ChunkTiming]:
        n = np.shape(d)[-1]
        if n % self.m:
            raise ValueError(f"system size {n} not divisible by m={self.m}")
        return self._session.solve_timed(dl, d, du, b)


def measure_chunk_sweep(
    n: int,
    chunk_counts: Sequence[int] = (1, 2, 4, 8, 16, 32),
    *,
    m: int = 10,
    dtype: Any = np.float64,
    seed: int = 0,
    repeats: int = 3,
    device: str = "cuda",
) -> List[ChunkTiming]:
    """Wall-clock chunked solves across chunk counts (autotune input): for
    each count, one untimed warm-up solve, then the best of ``repeats``."""
    from repro_torch.core.tridiag.api import SolverConfig, TridiagSession
    from repro_torch.core.tridiag.reference import make_diag_dominant_system

    dl, d, du, b, _ = make_diag_dominant_system(n, seed=seed, dtype=dtype)
    base = SolverConfig(m=m, backend="reference", device=device)
    results = []
    for k in chunk_counts:
        session = TridiagSession(base.replace(num_chunks=k))
        session.solve_timed(dl, d, du, b)  # untimed warm-up
        best = None
        for _ in range(repeats):
            _, t = session.solve_timed(dl, d, du, b)
            if best is None or t.t_total_ms < best.t_total_ms:
                best = t
        assert best is not None
        results.append(best)
    return results
