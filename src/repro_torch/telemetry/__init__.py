"""``repro_torch.telemetry``: serving telemetry and the closed-loop refit of
the chunk heuristic, the port's counterpart of ``repro.telemetry``.

**Collection** (:mod:`.ring`)
    ``SolveEngine._dispatch`` records one :class:`BatchObservation` per
    served batch (composition, chunk pick, resolved route, queue wait,
    latency including the device's work, predicted latency) into a
    lock-protected bounded :class:`TelemetryBuffer`, exposed as
    ``session.telemetry``.

**Refit** (:mod:`.refit`)
    :class:`OnlineRefitter` (``SolverConfig.autotune = "off" | "shadow" |
    "live"``) reruns the paper's Eq. 4-7 fit on the accumulated
    observations; ``"live"`` swaps the session's chunk policy, ``"shadow"``
    only counts how often the refit's picks agree with the active ones.

**Predicted-latency admission** (:class:`LatencyModel` and
:mod:`repro_torch.core.tridiag.api`)
    The refitter also fits an Eq.-2-shaped :class:`LatencyModel`; the
    admission loop packs batches up to ``SolverConfig.max_predicted_ms`` and
    sheds requests whose predicted completion would pass their deadline
    (:class:`repro_torch.api.PredictedTimeoutError`).

This package imports the plan layer, never the session: the session imports
it, so ``import repro_torch.telemetry`` works first in a fresh interpreter.

Usage::

    cfg = SolverConfig(autotune="live", refit_min_samples=256,
                       refit_interval_s=30.0, max_predicted_ms=50.0)
    with TridiagSession(cfg) as session:
        ...serve...
        session.telemetry.export_jsonl("observations.jsonl")
        print(session.stats["autotune"])
"""

from repro_torch.core.streams.timemodel import LatencyModel
from repro_torch.telemetry.refit import (
    AUTOTUNE_MODES,
    OnlineRefitter,
    RefitResult,
    dataset_from_observations,
)
from repro_torch.telemetry.ring import BatchObservation, TelemetryBuffer

__all__ = [
    "AUTOTUNE_MODES",
    "BatchObservation",
    "LatencyModel",
    "OnlineRefitter",
    "RefitResult",
    "TelemetryBuffer",
    "dataset_from_observations",
]
