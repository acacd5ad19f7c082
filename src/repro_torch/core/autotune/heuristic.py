"""Fit + apply the paper's heuristic for the optimum number of streams.

Pipeline (paper §2.4):
  1. measure components with NO streams → per-size ``sum`` (Eq. 3);
  2. linear-regress sum on SLAE size (Eq. 4), shuffled 3:1 split;
  3. extract T_overhead per (size, num_str) via Eq. 5;
  4. curve_fit the small/big overhead models (Eq. 7), shuffled 3:1 split;
  5. predict: optimum = Eq. 6 argmax over powers of two ≤ 32.

Also includes the Gómez-Luna et al. [6] baseline the paper refutes
(T_overhead = num_str · τ ⇒ n* = sqrt(sum/τ), reproducing Table 1's
7.8 / 8.6 / 15.8 / 45.0 / 139.8 column exactly).

Provenance: every fitted heuristic carries a ``provenance`` dict naming how
it was fitted — ``{"source": "offline-fit", "samples": N}`` from the
measurement-campaign path below, ``{"source": "refit", ...}`` when the
closed-loop :class:`~repro.telemetry.refit.OnlineRefitter` refits it from
serving telemetry — so perf records and benchmarks can attribute chunk
picks to the fit that produced them.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.autotune import models as M
from repro_torch.core.autotune.curvefit import curve_fit, fit_metrics
from repro_torch.core.autotune.linreg import LinearModel, train_test_split
from repro_torch.core.streams.simulator import StreamDataset
from repro_torch.core.streams.timemodel import STREAM_CANDIDATES, select_optimum

# τ for the RTX 2080 Ti, measured by the paper (ms per stream creation).
GOMEZ_LUNA_TAU_MS = 0.004448


def gomez_luna_optimum(sum_ms: float, tau_ms: float = GOMEZ_LUNA_TAU_MS) -> float:
    """[6]: minimize sum/n + n·τ ⇒ n* = sqrt(sum/τ) (continuous, uncapped)."""
    return math.sqrt(sum_ms / tau_ms)


@dataclass
class StreamHeuristic:
    """Fitted sum + overhead models and the Eq. 6 selection rule.

    A regime's ``popt`` is None when the campaign had no rows on its side of
    the small/big split (e.g. a small-size-only sweep); prediction then falls
    back to the populated regime's model everywhere.
    """

    sum_model: LinearModel
    popt_small: Optional[np.ndarray]
    popt_big: Optional[np.ndarray]
    split_size: float = M.SMALL_BIG_SPLIT
    candidates: Tuple[int, ...] = STREAM_CANDIDATES
    metrics: Dict[str, Dict[str, float]] = field(default_factory=dict)
    #: How this fit came to be: {"source": "offline-fit" | "refit",
    #: "samples": <rows consumed>, ...} — see the module docstring.
    provenance: Dict[str, Any] = field(default_factory=dict)

    # -- model evaluation ----------------------------------------------------
    def predict_sum(self, size: Any) -> np.ndarray:
        return self.sum_model.predict(np.atleast_1d(np.asarray(size, np.float64)))

    def predict_overhead(self, size: Any, num_str: Any) -> np.ndarray:
        size = np.atleast_1d(np.asarray(size, dtype=np.float64))
        num_str = np.broadcast_to(np.asarray(num_str, dtype=np.float64), size.shape)
        if self.popt_small is None:
            return M.overhead_big((size, num_str), *self.popt_big)
        if self.popt_big is None:
            return M.overhead_small((size, num_str), *self.popt_small)
        small = M.overhead_small((size, num_str), *self.popt_small)
        big = M.overhead_big((size, num_str), *self.popt_big)
        return np.where(size <= self.split_size, small, big)

    # -- the algorithm (paper §2.4 + Eq. 6) -----------------------------------
    def predict_optimum(self, size: float) -> int:
        s = float(self.predict_sum(size)[0])
        overheads = [
            (k, float(self.predict_overhead(size, k)[0]))
            for k in self.candidates
            if k > 1
        ]
        return select_optimum(s, overheads, self.candidates)

    def predict_optimum_fp32(self, size: float) -> int:
        """Paper §3.2 recommendation: halve the FP64 optimum for FP32."""
        return max(1, self.predict_optimum(size) // 2)


@dataclass
class BatchedStreamHeuristic:
    """Eq. 4–7 pipeline extended to the 2-D (size, batch) grid.

    A fused batch of B size-n systems (`repro.core.tridiag.batched`) presents
    the GPU with one n·B-element solve, so the fitted models take the
    *effective* size n·B as their size feature; the selection rule (Eq. 6) is
    unchanged. Fit with :func:`fit_batched_stream_heuristic` on a campaign
    that sweeps ``batches`` (``StreamSimulator.dataset(..., batches=...)`` or
    ``repro.core.streams.measure.measure_batched_dataset``).

    Ragged mixed-size batches (`repro.core.tridiag.ragged`) generalise the
    feature: the fused solve has Σ nᵢ elements, so
    :meth:`predict_optimum_ragged` prices the batch by that effective size —
    n·B is just the equal-sizes special case.
    """

    base: StreamHeuristic

    @property
    def metrics(self) -> Dict[str, Dict[str, float]]:
        return self.base.metrics

    @property
    def provenance(self) -> Dict[str, Any]:
        """The base fit's provenance (offline-fit vs refit, sample count)."""
        return self.base.provenance

    def predict_sum(self, size: Any, batch: int = 1) -> np.ndarray:
        return self.base.predict_sum(np.asarray(size, np.float64) * batch)

    def predict_overhead(
        self, size: Any, num_str: Any, batch: int = 1
    ) -> np.ndarray:
        return self.base.predict_overhead(
            np.asarray(size, np.float64) * batch, num_str
        )

    def predict_optimum(self, size: float, batch: int = 1) -> int:
        return self.base.predict_optimum(float(size) * batch)

    def predict_optimum_fp32(self, size: float, batch: int = 1) -> int:
        return max(1, self.predict_optimum(size, batch) // 2)

    def predict_optimum_ragged(self, sizes: Sequence[int]) -> int:
        """Optimum chunk count for a ragged fused batch of ``sizes``.

        The effective size of the fused solve is Σ nᵢ
        (`repro.core.tridiag.plan.effective_size`); the Eq. 6 selection rule
        is applied at that size, exactly as a same-size batch is priced at
        n·B.
        """
        return self.base.predict_optimum(float(np.sum(np.asarray(sizes, np.float64))))


def fit_batched_stream_heuristic(
    data: StreamDataset,
    *,
    split_seed: int = 0,
    test_size: float = 0.25,
    candidates: Sequence[int] = STREAM_CANDIDATES,
) -> BatchedStreamHeuristic:
    """Fit the (size × batch) heuristic: the paper's pipeline on a batched
    campaign, with every row's size feature being its effective n·batch."""
    base = fit_stream_heuristic(
        data, split_seed=split_seed, test_size=test_size, candidates=candidates
    )
    return BatchedStreamHeuristic(base=base)


def fit_stream_heuristic(
    data: StreamDataset,
    *,
    split_seed: int = 0,
    test_size: float = 0.25,
    candidates: Sequence[int] = STREAM_CANDIDATES,
) -> StreamHeuristic:
    """Run the paper's full supervised-learning pipeline on a measurement set."""
    metrics: Dict[str, Dict[str, float]] = {}

    # ---- Eq. 4: sum ~ size (linear regression) ----
    sizes, sums = data.per_size_sum()
    x_tr, x_te, y_tr, y_te = train_test_split(
        sizes, sums, test_size=test_size, seed=split_seed
    )
    sum_model = LinearModel.fit(x_tr, y_tr)
    metrics["sum_train"] = sum_model.metrics(x_tr, y_tr)
    metrics["sum_test"] = sum_model.metrics(x_te, y_te)

    # ---- Eq. 7: T_overhead ~ (size, num_str), small/big regimes ----
    # The size feature is the effective in-flight element count size·batch
    # (batch defaults to 1 on the paper's single-system campaign).
    def eff(r: Dict[str, Any]) -> float:
        return float(r["size"] * r.get("batch", 1))

    def fit_regime(
        rows: List[Dict[str, Any]],
        form: Callable[..., np.ndarray],
        p0: Sequence[float],
        tag: str,
    ) -> Optional[np.ndarray]:
        if not rows:
            return None
        size = np.array([eff(r) for r in rows], dtype=np.float64)
        nstr = np.array([r["num_str"] for r in rows], dtype=np.float64)
        t_ov = np.array([r["t_overhead"] for r in rows])
        (s_tr, s_te, n_tr, n_te, o_tr, o_te) = train_test_split(
            size, nstr, t_ov, test_size=test_size, seed=split_seed
        )
        popt = curve_fit(form, (s_tr, n_tr), o_tr, p0)
        metrics[f"{tag}_train"] = fit_metrics(form, (s_tr, n_tr), o_tr, popt)
        metrics[f"{tag}_test"] = fit_metrics(form, (s_te, n_te), o_te, popt)
        return popt

    small_rows = [r for r in data.rows if eff(r) <= M.SMALL_BIG_SPLIT]
    big_rows = [r for r in data.rows if eff(r) > M.SMALL_BIG_SPLIT]
    if not small_rows and not big_rows:
        raise ValueError("empty measurement campaign: no overhead rows to fit")
    popt_small = fit_regime(small_rows, M.overhead_small, M.OVERHEAD_SMALL_P0, "ov_small")
    popt_big = fit_regime(big_rows, M.overhead_big, M.OVERHEAD_BIG_P0, "ov_big")

    return StreamHeuristic(
        sum_model=sum_model,
        popt_small=popt_small,
        popt_big=popt_big,
        candidates=tuple(candidates),
        metrics=metrics,
        provenance={"source": "offline-fit", "samples": len(data)},
    )
