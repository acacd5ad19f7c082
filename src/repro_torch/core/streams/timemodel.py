"""The paper's time-complexity models, verbatim as code.

All times in milliseconds, matching the paper's tables.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, Sequence, Tuple

import numpy as np

# Powers of two up to the Hyper-Q hardware-queue limit (paper §2.1).
STREAM_CANDIDATES: Tuple[int, ...] = (1, 2, 4, 8, 16, 32)

# Batch sizes covered by the batched (size × batch) campaign. The batch axis
# multiplies the overlappable work (Eq. 3) — B fused systems behave like one
# B·n-element solve (repro.core.tridiag.batched), so the same Eq. 1–6 apply
# to the fused StageTimes.
BATCH_CANDIDATES: Tuple[int, ...] = (1, 2, 4, 8, 16, 32, 64)


@dataclass(frozen=True)
class StageTimes:
    """Per-operation times of one partition solve (paper Table 1 columns)."""

    t1_h2d: float
    t1_comp: float
    t1_d2h: float
    t2_comp: float
    t3_h2d: float
    t3_comp: float
    t3_d2h: float


def batched_stage_times(st: StageTimes, batch: int) -> StageTimes:
    """Eq. 1–3 operand for a fused batch of ``batch`` equal-size systems.

    Every per-operation time scales linearly — the fused solve is one
    B·n-element system, so all four overlappable components, the dominant
    transfers and the host reduced solve grow ×B. This is the latency-free
    limit; the simulator refines it with fixed per-campaign transfer latency
    and per-system host dispatch (negligible beyond small n·B).
    """
    if batch < 1:
        raise ValueError("batch must be >= 1")
    return StageTimes(
        **{f: batch * getattr(st, f) for f in st.__dataclass_fields__}
    )


def fused_stage_times(parts: Sequence[StageTimes]) -> StageTimes:
    """Eq. 1–3 operand for a fused *ragged* batch of heterogeneous systems.

    Every per-operation time of the fused Σ nᵢ-element solve is the sum of
    the constituents' — :func:`batched_stage_times` is the equal-parts
    special case (``fused_stage_times([st]*B) == batched_stage_times(st, B)``).
    Like that function this is the latency-free linear limit; the simulator
    refines it with fixed per-campaign latencies.
    """
    parts = list(parts)
    if not parts:
        raise ValueError("fused_stage_times needs at least one system")
    return StageTimes(
        **{
            f: sum(getattr(p, f) for p in parts)
            for f in StageTimes.__dataclass_fields__
        }
    )


def t_non_str(st: StageTimes) -> float:
    """Eq. (1): serial (stream-less) execution time."""
    return (
        st.t1_h2d + st.t1_comp + st.t1_d2h
        + st.t2_comp
        + st.t3_h2d + st.t3_comp + st.t3_d2h
    )


def sum_overlap(st: StageTimes) -> float:
    """Eq. (3): the non-dominant GPU operations that take part in the overlap."""
    return st.t1_comp + st.t1_d2h + st.t3_h2d + st.t3_comp


def t_str_model(st: StageTimes, num_str: int, t_overhead: float) -> float:
    """Eq. (2): lower-bound streamed execution time."""
    return (
        st.t1_h2d
        + sum_overlap(st) / num_str
        + st.t2_comp
        + st.t3_d2h
        + t_overhead
    )


def overhead_from_measurement(
    t_str: float, t_non_str_: float, sum_: float, num_str: int
) -> float:
    """Eq. (5): extract T_overhead from measured streamed/serial times."""
    return (t_str - t_non_str_) + (num_str - 1) / num_str * sum_


def gain(num_str: int, sum_: float, t_overhead: float) -> float:
    """LHS-vs-RHS margin of Eq. (6): positive ⇒ streams beat serial."""
    return (num_str - 1) / num_str * sum_ - t_overhead


@dataclass(frozen=True)
class LatencyModel:
    """Eq.-2-shaped dispatch-latency predictor, fitted from serving telemetry.

    Eq. 2 decomposes a streamed solve into a serial part (dominant transfer +
    reduced solve, linear in the effective size N) and an overlappable part
    divided across the ``num_str`` streams/chunks. The serving analogue keeps
    exactly that shape with free coefficients::

        latency_ms(N, k)  ≈  c0  +  c1 · N  +  c2 · N / k

    fitted in closed form (``numpy.linalg.lstsq`` — deterministic given the
    same observations) from per-batch ``(effective_size, num_chunks,
    latency_ms)`` telemetry. The predicted-latency admission loop
    (``SolverConfig.max_predicted_ms``) uses :meth:`predict_ms` to pack
    batches up to a latency budget and to shed requests whose predicted
    completion would blow their deadline; predicted-vs-actual residuals ride
    every subsequent ``BatchObservation``, so the model's error is itself
    observable.
    """

    coef: Tuple[float, float, float]
    samples: int = 0

    @staticmethod
    def _design(eff_sizes: np.ndarray, num_chunks: np.ndarray) -> np.ndarray:
        n = np.asarray(eff_sizes, dtype=np.float64)
        k = np.maximum(np.asarray(num_chunks, dtype=np.float64), 1.0)
        return np.stack([np.ones_like(n), n, n / k], axis=1)

    @classmethod
    def fit(
        cls,
        eff_sizes: Sequence[float],
        num_chunks: Sequence[int],
        latencies_ms: Sequence[float],
    ) -> "LatencyModel":
        """Least-squares fit of the three coefficients (rank-deficient inputs
        get the minimum-norm solution, so a single observed ``(N, k)`` cell
        still yields a usable — if flat — predictor)."""
        y = np.asarray(latencies_ms, dtype=np.float64)
        if y.size == 0:
            raise ValueError("LatencyModel.fit needs at least one observation")
        a = cls._design(np.asarray(eff_sizes), np.asarray(num_chunks))
        coef, _, _, _ = np.linalg.lstsq(a, y, rcond=None)
        return cls(coef=(float(coef[0]), float(coef[1]), float(coef[2])),
                   samples=int(y.size))

    def predict_ms(self, eff_size: float, num_chunks: int) -> float:
        """Predicted dispatch latency (ms) of one fused solve; clamped >= 0."""
        c0, c1, c2 = self.coef
        n = float(eff_size)
        k = max(1.0, float(num_chunks))
        return max(0.0, c0 + c1 * n + c2 * n / k)


def select_optimum(
    sum_: float,
    overheads: Iterable[Tuple[int, float]],
    candidates: Sequence[int] = STREAM_CANDIDATES,
) -> int:
    """The paper's selection algorithm (§2.4, Eq. 6).

    ``overheads`` provides (num_str, T_overhead) pairs for num_str > 1. The
    optimum is the candidate with the biggest positive Eq.-6 margin; if no
    margin is positive, streams do not pay for themselves and the optimum is 1.
    """
    ov = dict(overheads)
    best_n, best_gain = 1, 0.0
    for n in candidates:
        if n == 1:
            continue
        if n not in ov:
            raise KeyError(f"missing overhead sample/model value for num_str={n}")
        g = gain(n, sum_, ov[n])
        if g > best_gain:
            best_n, best_gain = n, g
    return best_n
