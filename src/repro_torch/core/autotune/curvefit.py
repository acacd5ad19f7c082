"""Non-linear least squares: SciPy ``curve_fit`` (as the paper used) with a
pure-NumPy Levenberg–Marquardt fallback so the pipeline has no hard SciPy
dependency."""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np

from repro_torch.core.autotune.linreg import mse, r2_score


def _numeric_jacobian(f, x, p, eps=1e-6):
    p = np.asarray(p, dtype=np.float64)
    y0 = f(x, *p)
    jac = np.empty((len(y0), len(p)))
    for j in range(len(p)):
        dp = np.zeros_like(p)
        dp[j] = eps * max(1.0, abs(p[j]))
        jac[:, j] = (f(x, *(p + dp)) - y0) / dp[j]
    return jac


def lm_fit(
    f: Callable,
    x,
    y: np.ndarray,
    p0: Sequence[float],
    *,
    max_iter: int = 200,
    tol: float = 1e-12,
) -> np.ndarray:
    """Levenberg–Marquardt in ~30 lines; good enough for the paper's 4-6 param
    overhead models. Used when SciPy is unavailable and in tests as a
    cross-check of the SciPy path."""
    p = np.asarray(p0, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    lam = 1e-3
    cost = float(np.sum((f(x, *p) - y) ** 2))
    for _ in range(max_iter):
        jac = _numeric_jacobian(f, x, p)
        r = y - f(x, *p)
        jtj = jac.T @ jac
        g = jac.T @ r
        step_ok = False
        for _ in range(20):
            try:
                dp = np.linalg.solve(jtj + lam * np.diag(np.diag(jtj) + 1e-12), g)
            except np.linalg.LinAlgError:
                lam *= 10
                continue
            new_cost = float(np.sum((f(x, *(p + dp)) - y) ** 2))
            if new_cost < cost:
                p, cost, lam = p + dp, new_cost, max(lam / 3, 1e-12)
                step_ok = True
                break
            lam *= 10
        if not step_ok or np.linalg.norm(dp) < tol * (np.linalg.norm(p) + tol):
            break
    return p


def curve_fit(
    f: Callable,
    x,
    y: np.ndarray,
    p0: Sequence[float],
    *,
    use_scipy: Optional[bool] = None,
    maxfev: int = 20000,
) -> np.ndarray:
    """Fit params of ``f(x, *p)``; prefers scipy.optimize.curve_fit."""
    if use_scipy is None or use_scipy:
        try:
            import scipy.optimize

            popt, _ = scipy.optimize.curve_fit(
                f, x, np.asarray(y, dtype=np.float64), p0=list(p0), maxfev=maxfev
            )
            return np.asarray(popt)
        except ImportError:
            if use_scipy:
                raise
    return lm_fit(f, x, y, p0)


def fit_metrics(f: Callable, x, y: np.ndarray, popt: np.ndarray) -> dict:
    p = f(x, *popt)
    m = mse(y, p)
    return {"r2": r2_score(y, p), "mse": m, "rmse": float(np.sqrt(m))}
