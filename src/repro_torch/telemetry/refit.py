"""Closed-loop refit: turn serving telemetry back into the fitted heuristic
(copied from the reference package, on the port's own heuristic, time model
and plan modules; NumPy only).

The paper fits its stream-count heuristic (Eq. 4–7) *offline* from a
one-shot measurement campaign; the overhead terms it fits are
machine-dependent and drift across hardware, so a production server should
refit itself from live traffic. :class:`OnlineRefitter` is that control
loop's brain: given the :class:`~repro_torch.telemetry.ring.TelemetryBuffer`'s
accumulated :class:`~repro_torch.telemetry.ring.BatchObservation` windows it

1. rebuilds an Eq.-5 measurement table from observed ``(effective_size,
   num_chunks) → latency`` cells (:func:`dataset_from_observations` —
   median-aggregated, fp-deterministic given the same observations),
2. reruns the paper's own pipeline on it
   (:func:`~repro_torch.core.autotune.heuristic.fit_batched_stream_heuristic`),
   stamping the result's provenance as ``"refit"``, and
3. fits the Eq.-2-shaped :class:`~repro_torch.core.streams.timemodel.LatencyModel`
   the predicted-latency admission loop prices batches with.

Gating: a refit only *runs* when at least ``min_samples`` observations are
buffered AND the previous attempt is at least ``interval_s`` old (the
max-staleness threshold) — both checked against an injectable ``clock`` so
tests drive virtual time. The session's serve worker calls
:meth:`maybe_refit` on its idle time; in ``"live"`` mode the result carries
a fresh :class:`~repro_torch.core.tridiag.plan.HeuristicChunkPolicy` for the
session to swap in atomically, in ``"shadow"`` mode the would-be picks are
only *compared* against the active policy's (the agreement counters), and
in ``"off"`` mode the heuristic is left alone entirely (only the latency
model refits, for sessions that enabled admission without autotuning).

The Eq.-5 reconstruction needs a serial baseline per size bucket: only
effective sizes observed at ``num_chunks == 1`` AND at some ``k > 1``
contribute rows (the identity ``gain = t_non_str - t_str`` makes the Eq.-6
selection exact at the observed cells regardless of the assumed overlap
fraction). Buckets without a baseline are skipped, not guessed.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.autotune.heuristic import (
    BatchedStreamHeuristic,
    fit_batched_stream_heuristic,
)
from repro_torch.core.streams.simulator import StreamDataset
from repro_torch.core.streams.timemodel import (
    LatencyModel,
    overhead_from_measurement,
)
from repro_torch.core.tridiag.plan import HeuristicChunkPolicy, price_chunks
from repro_torch.telemetry.ring import BatchObservation, TelemetryBuffer

__all__ = [
    "AUTOTUNE_MODES",
    "OnlineRefitter",
    "RefitResult",
    "dataset_from_observations",
]

#: Valid ``SolverConfig.autotune`` values (= ``OnlineRefitter`` modes).
AUTOTUNE_MODES: Tuple[str, ...] = ("off", "shadow", "live")

#: Fraction of the serial baseline assumed overlappable when reconstructing
#: Eq. 5 rows from totals-only telemetry. Any constant keeps the Eq.-6
#: selection exact at the observed cells (the sum term cancels:
#: gain = t_non_str − t_str); it only shapes the fitted curves between them.
DEFAULT_OVERLAP_FRACTION = 0.5

#: Structural minima for a refit dataset: distinct eligible size buckets and
#: distinct ``num_chunks > 1`` values (the overhead fit needs a num_str axis).
MIN_REFIT_SIZES = 2
MIN_REFIT_CHUNK_LEVELS = 2


def dataset_from_observations(
    observations: Sequence[BatchObservation],
    *,
    overlap_fraction: float = DEFAULT_OVERLAP_FRACTION,
) -> Optional[StreamDataset]:
    """Rebuild an Eq.-5 measurement table from serving observations.

    Observations are bucketed by ``(effective_size, num_chunks)`` and each
    cell aggregated to its median latency (deterministic given the same
    observations). A size bucket is *eligible* when it has a serial baseline
    (a ``num_chunks == 1`` cell) and at least one streamed cell; each
    eligible ``(size, k > 1)`` cell becomes one dataset row with
    ``t_non_str`` = the baseline median, ``sum`` = ``overlap_fraction ·
    t_non_str`` and ``t_overhead`` via Eq. 5. Returns None when the table is
    structurally too thin to refit (fewer than :data:`MIN_REFIT_SIZES`
    eligible sizes or :data:`MIN_REFIT_CHUNK_LEVELS` chunk levels).
    """
    cells: Dict[Tuple[int, int], List[float]] = {}
    for obs in observations:
        key = (obs.effective_size, obs.num_chunks)
        cells.setdefault(key, []).append(obs.latency_ms)
    medians = {key: float(np.median(vals)) for key, vals in cells.items()}

    baselines = {size: t for (size, k), t in medians.items() if k == 1}
    rows: List[Dict[str, Any]] = []
    for (size, k), t_str in sorted(medians.items()):
        if k == 1 or size not in baselines:
            continue
        t_non = baselines[size]
        s = overlap_fraction * t_non
        rows.append(
            dict(
                size=size,
                num_str=k,
                rep=0,
                batch=1,
                sum=s,
                t_str=t_str,
                t_non_str=t_non,
                t_overhead=overhead_from_measurement(t_str, t_non, s, k),
            )
        )
    sizes = {r["size"] for r in rows}
    levels = {r["num_str"] for r in rows}
    if len(sizes) < MIN_REFIT_SIZES or len(levels) < MIN_REFIT_CHUNK_LEVELS:
        return None
    return StreamDataset(rows)


@dataclass(frozen=True)
class RefitResult:
    """What one refit attempt produced.

    ``heuristic`` is the freshly fitted heuristic (None when the telemetry
    window was structurally too thin, or in ``"off"`` mode); ``policy`` is
    the ready-to-swap chunk policy — populated only in ``"live"`` mode;
    ``latency_model`` is the refitted admission cost model (fitted from any
    non-empty window); ``samples`` counts the observations consumed and
    ``agreement`` is this attempt's active-vs-refit pick agreement over the
    window's distinct batch compositions (None when nothing was compared).
    """

    heuristic: Optional[BatchedStreamHeuristic]
    policy: Optional[HeuristicChunkPolicy]
    latency_model: Optional[LatencyModel]
    samples: int
    agreement: Optional[float] = None


class OnlineRefitter:
    """Config-gated periodic refit of the stream heuristic from telemetry.

    ``mode`` is one of :data:`AUTOTUNE_MODES`; ``min_samples`` and
    ``interval_s`` are the min-sample and max-staleness thresholds gating
    :meth:`due`; ``clock`` (default ``time.monotonic``) is injectable so
    deterministic tests drive virtual time. All mutable state is guarded by
    ``_lock`` (registered with the TRD001 invariant checker); the fits
    themselves run outside it. Refit failures are contained: an exception in
    the fitting math is counted (``refit_errors``) and swallowed, because
    the caller is the session's serve worker and a dead worker fails every
    outstanding future.
    """

    def __init__(
        self,
        mode: str = "shadow",
        *,
        min_samples: int = 64,
        interval_s: float = 30.0,
        overlap_fraction: float = DEFAULT_OVERLAP_FRACTION,
        clock: Callable[[], float] = time.monotonic,
    ) -> None:
        if mode not in AUTOTUNE_MODES:
            raise ValueError(
                f"mode={mode!r}: must be one of {sorted(AUTOTUNE_MODES)}"
            )
        if min_samples < 1:
            raise ValueError(f"min_samples={min_samples}: must be >= 1")
        if interval_s < 0:
            raise ValueError(f"interval_s={interval_s}: must be >= 0")
        self.mode = mode
        self.min_samples = min_samples
        self.interval_s = interval_s
        self.overlap_fraction = overlap_fraction
        self._clock = clock
        self._lock = threading.Lock()
        self._last_attempt_t: Optional[float] = None
        self._last_refit_t: Optional[float] = None
        self._attempts = 0
        self._refits = 0
        self._errors = 0
        self._agree = 0
        self._disagree = 0
        self._last_samples = 0
        self._last_heuristic: Optional[BatchedStreamHeuristic] = None
        self._last_latency_model: Optional[LatencyModel] = None

    # -- gating ---------------------------------------------------------------
    def due(self, n_observations: int, now: Optional[float] = None) -> bool:
        """True when a refit attempt should run: enough samples buffered and
        the previous attempt at least ``interval_s`` old (failed attempts
        also reset the staleness clock, so a thin window cannot busy-loop
        the worker)."""
        if n_observations < self.min_samples:
            return False
        now = self._clock() if now is None else now
        with self._lock:
            last = self._last_attempt_t
        return last is None or (now - last) >= self.interval_s

    def seconds_until_due(
        self, n_observations: int, now: Optional[float] = None
    ) -> Optional[float]:
        """How long the idle worker may sleep before the next refit could
        fire; None when the sample threshold is not met (a future submit
        will wake the worker anyway)."""
        if n_observations < self.min_samples:
            return None
        now = self._clock() if now is None else now
        with self._lock:
            last = self._last_attempt_t
        if last is None:
            return 0.0
        return max(0.0, self.interval_s - (now - last))

    # -- the refit ------------------------------------------------------------
    def refit_from(
        self, observations: Sequence[BatchObservation]
    ) -> RefitResult:
        """One refit, as a pure function of the observations (no clocks, no
        internal state) — fp-deterministic: the same observation sequence
        yields bit-identical models. Used by :meth:`maybe_refit` and directly
        testable/benchable."""
        observations = list(observations)
        heuristic: Optional[BatchedStreamHeuristic] = None
        if self.mode != "off":
            data = dataset_from_observations(
                observations, overlap_fraction=self.overlap_fraction
            )
            if data is not None:
                heuristic = fit_batched_stream_heuristic(data)
                heuristic.base.provenance = {
                    "source": "refit",
                    "samples": len(observations),
                    "rows": len(data),
                }
        latency_model: Optional[LatencyModel] = None
        if observations:
            latency_model = LatencyModel.fit(
                [o.effective_size for o in observations],
                [o.num_chunks for o in observations],
                [o.latency_ms for o in observations],
            )
        policy = (
            HeuristicChunkPolicy(heuristic)
            if heuristic is not None and self.mode == "live"
            else None
        )
        return RefitResult(
            heuristic=heuristic,
            policy=policy,
            latency_model=latency_model,
            samples=len(observations),
        )

    def maybe_refit(
        self,
        buffer: TelemetryBuffer,
        pick_active: Optional[Callable[[Tuple[int, ...]], int]] = None,
    ) -> Optional[RefitResult]:
        """Run a refit if :meth:`due`; otherwise return None.

        ``pick_active`` (the engine's current chunk pricing) is compared
        against the refit heuristic's picks over the window's distinct batch
        compositions — the shadow-vs-live agreement counters — whenever a
        heuristic was fitted, in shadow AND live mode alike (post-swap
        agreement converging to 1.0 is the live loop's health signal).
        """
        observations = buffer.snapshot()
        now = self._clock()
        if not self.due(len(observations), now):
            return None
        with self._lock:
            self._last_attempt_t = now
            self._attempts += 1
        try:
            result = self.refit_from(observations)
        except Exception:
            # The caller is the serve worker: a refit crash must never kill
            # serving. Count it and keep the previous models active.
            with self._lock:
                self._errors += 1
            return None
        agree = disagree = 0
        if result.heuristic is not None and pick_active is not None:
            compositions = sorted({o.sizes for o in observations})
            for sizes in compositions:
                refit_pick = price_chunks(result.heuristic, sizes)
                if pick_active(sizes) == refit_pick:
                    agree += 1
                else:
                    disagree += 1
        with self._lock:
            if result.heuristic is not None:
                self._refits += 1
                self._last_refit_t = now
                self._last_heuristic = result.heuristic
            if result.latency_model is not None:
                self._last_latency_model = result.latency_model
            self._last_samples = result.samples
            self._agree += agree
            self._disagree += disagree
        total = agree + disagree
        if total:
            result = RefitResult(
                heuristic=result.heuristic,
                policy=result.policy,
                latency_model=result.latency_model,
                samples=result.samples,
                agreement=agree / total,
            )
        return result

    # -- observability --------------------------------------------------------
    def last_heuristic(self) -> Optional[BatchedStreamHeuristic]:
        """The most recently fitted heuristic (shadow mode's would-be picks)."""
        with self._lock:
            return self._last_heuristic

    def last_latency_model(self) -> Optional[LatencyModel]:
        with self._lock:
            return self._last_latency_model

    def stats_snapshot(self, now: Optional[float] = None) -> Dict[str, Any]:
        """Lock-held copy of the refit counters (the ``autotune`` block of
        ``session.stats``): attempts/refits/errors, last-refit age on this
        refitter's clock, samples consumed, and the cumulative
        active-vs-refit pick agreement rate (None before any comparison)."""
        now = self._clock() if now is None else now
        with self._lock:
            total = self._agree + self._disagree
            return {
                "mode": self.mode,
                "refit_attempts": self._attempts,
                "refits": self._refits,
                "refit_errors": self._errors,
                "last_refit_age_s": (
                    None if self._last_refit_t is None else now - self._last_refit_t
                ),
                "last_refit_samples": self._last_samples,
                "pick_agree": self._agree,
                "pick_disagree": self._disagree,
                "agreement_rate": (self._agree / total) if total else None,
            }

    def __repr__(self) -> str:
        s = self.stats_snapshot()
        return (
            f"OnlineRefitter(mode={self.mode!r}, min_samples="
            f"{self.min_samples}, interval_s={self.interval_s}, "
            f"refits={s['refits']}, attempts={s['refit_attempts']})"
        )
