"""Wall-clock measurement campaigns: run the chunked partition solver on this
machine and build the dataset the paper's Eq. 4-7 fit reads (the port's
counterpart of ``repro.core.streams.measure``).

All three campaigns drive the session front door
(:class:`~repro_torch.core.tridiag.api.SolverConfig` /
:class:`~repro_torch.core.tridiag.api.TridiagSession`): one base config
names the solve setup (m, backend, device) and each campaign cell is
``base.replace(num_chunks=k)``, the config a fitted heuristic later serves
through. Dispatch is pinned to ``"staged"``: the dataset is the per-phase
breakdown (``sum`` = Stage 1 + Stage 3, the Eq. 5 overhead), which only the
staged path's host round trips can observe. On a CUDA device each chunk
runs on its own CUDA stream; the reduced solve runs on the host.

Not re-exported from :mod:`repro_torch.core.streams`: this module imports
the session, which imports the stream models.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.streams.simulator import StreamDataset
from repro_torch.core.streams.timemodel import STREAM_CANDIDATES, overhead_from_measurement
from repro_torch.core.tridiag.api import SolverConfig, TridiagSession
from repro_torch.core.tridiag.plan import ChunkTiming
from repro_torch.core.tridiag.reference import make_diag_dominant_system

__all__ = ["measure_batched_dataset", "measure_dataset", "measure_ragged_dataset"]


def _measure_cell(
    rows: List[Dict[str, Any]],
    run: Callable[[int], ChunkTiming],
    *,
    size: int,
    batch: Optional[int],
    candidates: Sequence[int],
    reps: int,
    mix: Optional[Tuple[int, ...]] = None,
) -> None:
    """One campaign cell: profile num_chunks=1, then sweep the candidates.

    ``run(k)`` performs one solve at k chunks and returns its timing. Every
    configuration gets one untimed warm-up solve before the timed repeats.
    The overlappable ``sum`` is the Stage-1 + Stage-3 time at num_chunks=1
    (the no-streams profile, as the paper measured its Table 1 columns).
    The serial total ``t_non`` and ``sum`` both come from the single
    best-total baseline rep: minima over different reps would mix phases of
    mismatched runs and could drive the Eq. 5 overhead negative."""
    run(1)  # untimed warm-up
    base_timings = [run(1) for _ in range(reps)]
    base_best = min(base_timings, key=lambda t: t.t_total_ms)
    t_non = base_best.t_total_ms
    s = base_best.t_stage1_ms + base_best.t_stage3_ms
    for k in candidates:
        if k == 1:
            continue
        run(k)  # untimed warm-up (new chunking: new operand shapes)
        for rep in range(reps):
            t = run(k)
            row: Dict[str, Any] = dict(
                size=size, num_str=k, rep=rep, sum=s,
                t_str=t.t_total_ms, t_non_str=t_non,
                t_overhead=overhead_from_measurement(t.t_total_ms, t_non, s, k),
                stage_times=None,
            )
            if batch is not None:
                row["batch"] = batch
            if mix is not None:
                row["mix"] = mix
            rows.append(row)


def _base_config(m: int, backend: Any, device: Any) -> SolverConfig:
    # The reference stages when no backend is named, as in the reference;
    # pass backend="cuda" to measure the kernels.
    return SolverConfig(
        m=m,
        backend=backend if backend is not None else "reference",
        dispatch="staged",
        device=device,
    )


def _timed(base: SolverConfig, k: int, verb: str, *operands: Any) -> ChunkTiming:
    with TridiagSession(base.replace(num_chunks=k)) as session:
        return getattr(session, verb)(*operands)[1]


def measure_dataset(
    sizes: Sequence[int],
    candidates: Sequence[int] = STREAM_CANDIDATES,
    *,
    m: int = 10,
    reps: int = 3,
    dtype: Any = np.float64,
    seed: int = 0,
    backend: Any = None,
    device: Any = "cuda",
) -> StreamDataset:
    """Wall-clock campaign over (size x num_chunks), one system a solve.

    ``backend`` selects the stages being profiled (the reference stages by
    default; ``"cuda"`` measures the kernels)."""
    base = _base_config(m, backend, device)
    rows: List[Dict[str, Any]] = []
    for n in sizes:
        ops = make_diag_dominant_system(n, seed=seed, dtype=dtype)[:4]
        _measure_cell(
            rows, lambda k, ops=ops: _timed(base, k, "solve_timed", *ops),
            size=n, batch=None, candidates=candidates, reps=reps,
        )
    return StreamDataset(rows)


def measure_batched_dataset(
    sizes: Sequence[int],
    batches: Sequence[int] = (1, 4, 16),
    candidates: Sequence[int] = STREAM_CANDIDATES,
    *,
    m: int = 10,
    reps: int = 3,
    dtype: Any = np.float64,
    seed: int = 0,
    backend: Any = None,
    device: Any = "cuda",
) -> StreamDataset:
    """Wall-clock campaign over the (size x batch) grid: each cell solves B
    size-n systems through ``solve_batched_timed``; rows carry the
    ``batch`` key that ``fit_batched_stream_heuristic`` reads."""
    base = _base_config(m, backend, device)
    rows: List[Dict[str, Any]] = []
    for n in sizes:
        for batch in batches:
            ops = make_diag_dominant_system(n, seed=seed, batch=(batch,), dtype=dtype)[:4]
            _measure_cell(
                rows, lambda k, ops=ops: _timed(base, k, "solve_batched_timed", *ops),
                size=n, batch=batch, candidates=candidates, reps=reps,
            )
    return StreamDataset(rows)


def measure_ragged_dataset(
    mixes: Sequence[Sequence[int]],
    candidates: Sequence[int] = STREAM_CANDIDATES,
    *,
    m: int = 10,
    reps: int = 3,
    dtype: Any = np.float64,
    seed: int = 0,
    backend: Any = None,
    device: Any = "cuda",
) -> StreamDataset:
    """Wall-clock campaign over ragged mixed-size batches: each cell fuses
    one mix into a ``solve_many_timed`` dispatch. Rows carry ``size = Σ nᵢ``
    (the effective size ragged batches are priced by) and the ``mix``."""
    base = _base_config(m, backend, device)
    rows: List[Dict[str, Any]] = []
    for mix in mixes:
        mix = tuple(int(n) for n in mix)
        systems = [
            make_diag_dominant_system(n, seed=seed + i, dtype=dtype)[:4] for i, n in enumerate(mix)
        ]
        _measure_cell(
            rows, lambda k, systems=systems: _timed(base, k, "solve_many_timed", systems),
            size=sum(mix), batch=None, candidates=candidates, reps=reps, mix=mix,
        )
    return StreamDataset(rows)
