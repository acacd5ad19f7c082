"""Generalized overlap-granularity tuner (the paper's law beyond CUDA streams;
copied from the reference package, NumPy only).

Any pipeline of the shape

    T(n) = T_dominant + sum_overlappable / n + T_serial + overhead(n)

has a non-trivial optimum chunk count n. The paper instantiates this for CUDA
streams; the LM framework instantiates it for

  * gradient-collective bucketing (overlappable = collective time that hides
    behind the backward pass; overhead = per-collective start latency plus a
    small-message bandwidth-efficiency penalty),
  * host→device prefetch chunking of the input pipeline,
  * SSM sequence-chunk sizing (Stage-1/3 of the SSD scan vs the Stage-2
    interface recurrence — DESIGN.md §2.4).

Two modes:
  * analytic  — overhead(n) supplied as a closed form (latency model);
  * learned   — overhead(n) fitted from (size, n, t_overhead) samples exactly
    like the paper's Eq. 7 models (reusing ``autotune.curvefit``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Callable, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.streams.timemodel import gain

POW2_CANDIDATES: Tuple[int, ...] = (1, 2, 4, 8, 16, 32, 64, 128)


@dataclass(frozen=True)
class OverlapSpec:
    """One overlappable pipeline instance (all times in seconds)."""

    sum_overlappable_s: float
    # overhead(n) — defaults to an affine-in-n collective/dispatch latency
    # with a log² term for scheduler contention, the family that fitted the
    # paper's data (Figure 3).
    per_chunk_latency_s: float = 5e-6
    base_latency_s: float = 0.0
    log2_quadratic_s: float = 0.0
    candidates: Tuple[int, ...] = POW2_CANDIDATES
    # small-chunk bandwidth-efficiency knee: chunks smaller than this many
    # bytes pay a proportional efficiency penalty (link underutilization).
    bytes_total: Optional[float] = None
    bandwidth_floor_bytes: float = 4 * 1024 * 1024

    def overhead(self, n: int) -> float:
        if n <= 1:
            return 0.0
        L = math.log2(n)
        t = self.base_latency_s + self.per_chunk_latency_s * n
        t += self.log2_quadratic_s * L * L
        if self.bytes_total is not None:
            chunk = self.bytes_total / n
            if chunk < self.bandwidth_floor_bytes:
                # the residual sum/n term effectively runs at reduced bandwidth
                t += (self.bandwidth_floor_bytes / max(chunk, 1.0) - 1.0) * (
                    self.sum_overlappable_s / n
                )
        return t


def tune_overlap_granularity(spec: OverlapSpec) -> Tuple[int, float]:
    """Eq. 6 applied to the generalized pipeline: returns (n*, margin_s)."""
    best_n, best_gain = 1, 0.0
    for n in spec.candidates:
        if n == 1:
            continue
        g = gain(n, spec.sum_overlappable_s, spec.overhead(n))
        if g > best_gain:
            best_n, best_gain = n, g
    return best_n, best_gain


def tune_gradient_buckets(
    *,
    grad_bytes: float,
    link_bandwidth_Bps: float,
    backward_compute_s: float,
    per_collective_latency_s: float = 15e-6,
    candidates: Sequence[int] = POW2_CANDIDATES,
) -> Tuple[int, float]:
    """Pick the gradient all-reduce bucket count for comm/compute overlap.

    The overlappable quantity is the part of the collective that can hide
    behind the backward pass (the paper's ``sum``); the residual exposed tail
    shrinks ∝ 1/n while per-collective latency grows ∝ n.
    """
    comm_s = grad_bytes / link_bandwidth_Bps
    overlappable = min(comm_s, backward_compute_s)
    spec = OverlapSpec(
        sum_overlappable_s=overlappable,
        per_chunk_latency_s=per_collective_latency_s,
        bytes_total=grad_bytes,
        candidates=tuple(candidates),
    )
    return tune_overlap_granularity(spec)


def tune_prefetch_chunks(
    *,
    batch_bytes: float,
    host_link_Bps: float,
    step_compute_s: float,
    per_transfer_latency_s: float = 30e-6,
    candidates: Sequence[int] = (1, 2, 4, 8, 16, 32),
) -> Tuple[int, float]:
    """Pick how many chunks a global batch is split into for H2D prefetch."""
    xfer_s = batch_bytes / host_link_Bps
    spec = OverlapSpec(
        sum_overlappable_s=min(xfer_s, step_compute_s),
        per_chunk_latency_s=per_transfer_latency_s,
        bytes_total=batch_bytes,
        candidates=tuple(candidates),
    )
    return tune_overlap_granularity(spec)


def tune_ssm_chunk(
    *,
    seq_len: int,
    d_inner: int,
    ssm_state: int,
    head_dim: int,
    peak_flops: float = 197e12,
    recurrence_step_latency_s: float = 2e-6,
    candidates: Sequence[int] = (64, 128, 256, 512, 1024),
) -> Tuple[int, float]:
    """Pick the SSD chunk length Q (DESIGN.md §2.4: the partition method over
    time). Per chunk: Stage-1/3 do O(Q²·H·(hd+N)) parallel work; Stage 2 is a
    sequential S/Q-step interface recurrence whose per-step latency is pure
    overhead — exactly the paper's Eq. 2 shape with n = S/Q chunks:

        T(Q) ≈ [S·Q·H·(hd+N)·c]/peak  +  (S/Q)·step_latency

    Returns (Q*, predicted step time) minimizing the model over candidates.
    """
    nh = d_inner // head_dim
    best = None
    for q in candidates:
        if q > seq_len:
            continue
        # intra-chunk quadratic work (scores, decay, y_diag/y_off) per token
        flops = seq_len * q * nh * (head_dim + 2 * ssm_state) * 4.0
        t = flops / peak_flops + (seq_len / q) * recurrence_step_latency_s
        if best is None or t < best[1]:
            best = (q, t)
    return best


@dataclass
class LearnedOverheadTuner:
    """Paper-style learned overhead: fit T_overhead(size, n) samples, then
    apply Eq. 6 for any workload size. Used by benchmarks/overlap_autotune."""

    form: Callable
    p0: Sequence[float]
    candidates: Tuple[int, ...] = POW2_CANDIDATES
    popt: Optional[np.ndarray] = None
    metrics: dict = field(default_factory=dict)

    def fit(self, size: np.ndarray, n: np.ndarray, t_overhead: np.ndarray):
        from repro_torch.core.autotune.curvefit import curve_fit, fit_metrics

        self.popt = curve_fit(self.form, (size, n), t_overhead, self.p0)
        self.metrics = fit_metrics(self.form, (size, n), t_overhead, self.popt)
        return self

    def predict_optimum(self, size: float, sum_s: float) -> int:
        assert self.popt is not None, "call fit() first"
        best_n, best_gain = 1, 0.0
        for n in self.candidates:
            if n == 1:
                continue
            ov = float(self.form((np.array([size]), np.array([n])), *self.popt)[0])
            g = gain(n, sum_s, ov)
            if g > best_gain:
                best_n, best_gain = n, g
        return best_n
