"""Minimal supervised-learning toolkit (sklearn-equivalent pieces the paper
used: ``train_test_split`` with shuffle + 3:1 ratio, ``LinearRegression``,
R², MSE, RMSE)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np


def train_test_split(
    *arrays: np.ndarray,
    test_size: float = 0.25,
    seed: int = 0,
    shuffle: bool = True,
) -> Tuple[np.ndarray, ...]:
    """Shuffled split, ratio 3:1 by default, mirroring the paper's setup.

    Returns (a_train, a_test) for each input array, interleaved like sklearn:
    X_tr, X_te, y_tr, y_te = train_test_split(X, y).
    """
    n = len(arrays[0])
    idx = np.arange(n)
    if shuffle:
        np.random.default_rng(seed).shuffle(idx)
    n_test = max(1, int(round(n * test_size)))
    test_idx, train_idx = idx[:n_test], idx[n_test:]
    out = []
    for a in arrays:
        a = np.asarray(a)
        out.extend((a[train_idx], a[test_idx]))
    return tuple(out)


def mse(y_true: np.ndarray, y_pred: np.ndarray) -> float:
    return float(np.mean((np.asarray(y_true) - np.asarray(y_pred)) ** 2))


def r2_score(y_true: np.ndarray, y_pred: np.ndarray) -> float:
    y_true, y_pred = np.asarray(y_true), np.asarray(y_pred)
    ss_res = np.sum((y_true - y_pred) ** 2)
    ss_tot = np.sum((y_true - np.mean(y_true)) ** 2)
    return float(1.0 - ss_res / ss_tot) if ss_tot > 0 else 1.0


@dataclass
class LinearModel:
    """y = coef @ x + intercept, fitted in closed form (normal equations via
    lstsq). For the paper's Eq. 4 x is the scalar SLAE size."""

    coef: np.ndarray
    intercept: float

    @classmethod
    def fit(cls, x: np.ndarray, y: np.ndarray) -> "LinearModel":
        x = np.asarray(x, dtype=np.float64)
        if x.ndim == 1:
            x = x[:, None]
        a = np.concatenate([x, np.ones((len(x), 1))], axis=1)
        sol, *_ = np.linalg.lstsq(a, np.asarray(y, dtype=np.float64), rcond=None)
        return cls(coef=sol[:-1], intercept=float(sol[-1]))

    def predict(self, x: np.ndarray) -> np.ndarray:
        x = np.asarray(x, dtype=np.float64)
        if x.ndim == 1:
            x = x[:, None]
        return x @ self.coef + self.intercept

    def metrics(self, x: np.ndarray, y: np.ndarray) -> dict:
        p = self.predict(x)
        m = mse(y, p)
        return {"r2": r2_score(y, p), "mse": m, "rmse": float(np.sqrt(m))}
