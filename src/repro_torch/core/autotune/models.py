"""Preset functional forms for the fitted models (the paper's Eq. 4 / Eq. 7).

The paper fixes the model *forms* up front ("the form of the functions is
preset; different fitting curves were tested") and fits coefficients with
curve_fit, with separate models for small (N ≤ 1e6) and big (N > 1e6) SLAE
sizes. We mirror that: both forms are logarithmic in num_str (Figure 3) with
a quadratic-in-log term; the small model carries a saturating size term
(GPU under-utilization), the big model a slowly-growing log-size term.
"""

from __future__ import annotations

import numpy as np

SMALL_BIG_SPLIT = 1_000_000  # paper: "small" ≤ 1e6, "big" > 1e6


def sum_inputs(size: np.ndarray) -> np.ndarray:
    """Feature for the Eq. 4 linear model: the SLAE size itself."""
    return np.asarray(size, dtype=np.float64)


# ---- T_overhead(N, num_str) forms ------------------------------------------
# x is a tuple (size, num_str); L = log2(num_str).

def overhead_small(x, a, b0, b1, c, k):
    """Small-size regime: under-saturation term decays with size."""
    size, num_str = x
    size = np.asarray(size, dtype=np.float64)
    L = np.log2(np.asarray(num_str, dtype=np.float64))
    return a + (b0 + b1 * np.exp(-size / (np.abs(k) + 1.0))) * L + c * L * L


OVERHEAD_SMALL_P0 = (0.3, 0.08, 0.2, 0.015, 1.5e5)


def overhead_big(x, a0, a1, p, b, c):
    """Big-size regime: overhead (Eq.-5 residual: contention + scheduling
    gaps) grows like a power of size past saturation."""
    size, num_str = x
    size = np.asarray(size, dtype=np.float64)
    L = np.log2(np.asarray(num_str, dtype=np.float64))
    return a0 + a1 * (size / 1e6) ** np.abs(p) + b * L + c * L * L


OVERHEAD_BIG_P0 = (0.3, 0.15, 1.0, 0.08, 0.015)
