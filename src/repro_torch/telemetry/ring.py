"""Serving telemetry collection: the bounded per-batch observation ring
(copied from the reference package; pure Python).

Every serving dispatch (``SolveEngine._dispatch``) records one
:class:`BatchObservation` — the batch composition, the chunk pick that
priced it, the resolved backend/layout/dispatch, queue wait, dispatch
latency, and (when a fitted :class:`~repro_torch.core.streams.timemodel
.LatencyModel` is active) the predicted latency — into a
:class:`TelemetryBuffer`. The buffer is the collection layer of the
closed-loop autotune subsystem: the :class:`~repro_torch.telemetry.refit
.OnlineRefitter` consumes its snapshots to refit the stream heuristic and
the latency model from live traffic.

Hot-path discipline: ``record`` is one small-object construction plus one
lock-held deque append — no allocation proportional to batch size, no I/O.
The ring is bounded (``capacity``), so a serving process can leave telemetry
on indefinitely: old observations fall off the far end and are *counted*
(``dropped``), never silently lost. ``snapshot()`` returns an immutable
tuple, safe to analyse while the worker keeps recording; ``export_jsonl``
dumps the current window for offline analysis.
"""

from __future__ import annotations

import json
import threading
from collections import deque
from dataclasses import dataclass
from typing import Any, Deque, Dict, Optional, Tuple

__all__ = ["BatchObservation", "TelemetryBuffer"]


@dataclass(frozen=True)
class BatchObservation:
    """One served batch, as the telemetry layer saw it.

    ``t`` is the engine clock's timestamp at admission (the same injectable
    clock deadlines run on); ``sizes`` is the batch composition (one entry
    per fused system); ``num_chunks`` the chunk ("virtual stream") pick the
    plan actually used; ``backend``/``layout``/``dispatch`` are the
    *resolved* execution route (never ``"auto"``); ``latency_ms`` the wall
    time of the dispatch, ``mean_wait_ms``/``max_wait_ms`` the batch's queue
    waits; ``predicted_ms`` the active latency model's pre-dispatch
    prediction (None while no model is fitted), making
    :attr:`residual_ms` the loop's observable prediction error.
    """

    t: float
    sizes: Tuple[int, ...]
    num_chunks: int
    backend: str
    layout: str
    dispatch: str
    latency_ms: float
    mean_wait_ms: float
    max_wait_ms: float
    predicted_ms: Optional[float] = None

    @property
    def batch(self) -> int:
        return len(self.sizes)

    @property
    def effective_size(self) -> int:
        """The fused solve's element count Σ nᵢ — the heuristic's size feature."""
        return int(sum(self.sizes))

    @property
    def residual_ms(self) -> Optional[float]:
        """Predicted-vs-actual error (None while no prediction was active)."""
        if self.predicted_ms is None:
            return None
        return self.latency_ms - self.predicted_ms

    def to_record(self) -> Dict[str, Any]:
        """A JSON-serialisable dict (the JSONL export row)."""
        return {
            "t": self.t,
            "sizes": list(self.sizes),
            "batch": self.batch,
            "effective_size": self.effective_size,
            "num_chunks": self.num_chunks,
            "backend": self.backend,
            "layout": self.layout,
            "dispatch": self.dispatch,
            "latency_ms": self.latency_ms,
            "mean_wait_ms": self.mean_wait_ms,
            "max_wait_ms": self.max_wait_ms,
            "predicted_ms": self.predicted_ms,
            "residual_ms": self.residual_ms,
        }


class TelemetryBuffer:
    """Lock-protected bounded ring of :class:`BatchObservation` records.

    ``capacity`` bounds memory for ever-running servers: a full ring drops
    its *oldest* observation per record (counted in ``dropped``). Capacity 0
    disables collection entirely (``record`` returns False and counts
    nothing) — the ``autotune="off"`` configuration. All shared state is
    guarded by ``_lock`` (registered with the TRD001 invariant checker);
    ``snapshot``/``counters`` return consistent copies, never live state.
    """

    def __init__(self, capacity: int = 1024) -> None:
        if capacity < 0:
            raise ValueError(f"capacity={capacity}: must be >= 0 (0 disables)")
        self.capacity = capacity
        self._lock = threading.Lock()
        self._ring: Deque[BatchObservation] = deque()
        self._recorded = 0
        self._dropped = 0

    @property
    def enabled(self) -> bool:
        return self.capacity > 0

    def record(self, obs: BatchObservation) -> bool:
        """Append one observation (dropping the oldest if full); returns
        whether anything was recorded (False iff the buffer is disabled)."""
        if self.capacity == 0:
            return False
        with self._lock:
            if len(self._ring) >= self.capacity:
                self._ring.popleft()
                self._dropped += 1
            self._ring.append(obs)
            self._recorded += 1
        return True

    def snapshot(self) -> Tuple[BatchObservation, ...]:
        """A consistent, immutable copy of the current window (oldest first)."""
        with self._lock:
            return tuple(self._ring)

    def counters(self) -> Dict[str, int]:
        """``recorded`` (lifetime), ``dropped`` (lifetime ring evictions) and
        ``buffered`` (current window length), read under the lock."""
        with self._lock:
            return {
                "recorded": self._recorded,
                "dropped": self._dropped,
                "buffered": len(self._ring),
            }

    def clear(self) -> int:
        """Empty the window (lifetime counters keep counting); returns how
        many observations were discarded."""
        with self._lock:
            n = len(self._ring)
            self._ring.clear()
            return n

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)

    def to_jsonl(self) -> str:
        """The current window as JSON-lines text (one observation per line)."""
        lines = [json.dumps(o.to_record(), sort_keys=True) for o in self.snapshot()]
        return "\n".join(lines)

    def export_jsonl(self, path: str) -> int:
        """Write the current window to ``path`` as JSONL for offline
        analysis; returns the number of observations written."""
        snap = self.snapshot()
        with open(path, "w") as f:
            for o in snap:
                f.write(json.dumps(o.to_record(), sort_keys=True))
                f.write("\n")
        return len(snap)

    def __repr__(self) -> str:
        c = self.counters()
        return (
            f"TelemetryBuffer(capacity={self.capacity}, "
            f"buffered={c['buffered']}, recorded={c['recorded']}, "
            f"dropped={c['dropped']})"
        )
