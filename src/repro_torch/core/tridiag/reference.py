"""NumPy references and problem generators for the tridiagonal solvers."""

from __future__ import annotations

from typing import Tuple

import numpy as np


def thomas_numpy(
    dl: np.ndarray, d: np.ndarray, du: np.ndarray, b: np.ndarray
) -> np.ndarray:
    """Plain NumPy Thomas algorithm (float64 internally). Oracle of record."""
    dl = np.asarray(dl, dtype=np.float64)
    d = np.asarray(d, dtype=np.float64)
    du = np.asarray(du, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    n = d.shape[-1]
    dhat = d.copy()
    bhat = b.copy()
    for i in range(1, n):
        w = dl[..., i] / dhat[..., i - 1]
        dhat[..., i] = d[..., i] - w * du[..., i - 1]
        bhat[..., i] = bhat[..., i] - w * bhat[..., i - 1]
    x = np.empty_like(bhat)
    x[..., n - 1] = bhat[..., n - 1] / dhat[..., n - 1]
    for i in range(n - 2, -1, -1):
        x[..., i] = (bhat[..., i] - du[..., i] * x[..., i + 1]) / dhat[..., i]
    return x


def tridiag_matvec(
    dl: np.ndarray, d: np.ndarray, du: np.ndarray, x: np.ndarray
) -> np.ndarray:
    """r = A @ x for the tridiagonal A (NumPy, batched on leading dims)."""
    r = d * x
    r[..., 1:] += dl[..., 1:] * x[..., :-1]
    r[..., :-1] += du[..., :-1] * x[..., 1:]
    return r


def tridiag_to_dense(dl: np.ndarray, d: np.ndarray, du: np.ndarray) -> np.ndarray:
    n = d.shape[-1]
    a = np.zeros(d.shape + (n,), dtype=d.dtype)
    idx = np.arange(n)
    a[..., idx, idx] = d
    a[..., idx[1:], idx[:-1]] = dl[..., 1:]
    a[..., idx[:-1], idx[1:]] = du[..., :-1]
    return a


def make_diag_dominant_system(
    n: int,
    *,
    seed: int = 0,
    batch: Tuple[int, ...] = (),
    dtype=np.float64,
    dominance: float = 2.5,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Random strictly diagonally dominant system (the paper's setting).

    Returns (dl, d, du, b, x_true) with b = A @ x_true, so solvers can be
    checked against a known solution rather than only via residuals.
    """
    rng = np.random.default_rng(seed)
    shape = tuple(batch) + (n,)
    dl = rng.uniform(-1.0, 1.0, size=shape)
    du = rng.uniform(-1.0, 1.0, size=shape)
    dl[..., 0] = 0.0
    du[..., n - 1] = 0.0
    mag = np.abs(dl) + np.abs(du)
    sign = np.where(rng.uniform(size=shape) < 0.5, -1.0, 1.0)
    d = sign * (mag * dominance + rng.uniform(0.5, 1.5, size=shape))
    x_true = rng.standard_normal(shape)
    b = tridiag_matvec(dl, d, du, x_true)
    def to(a):
        return np.asarray(a, dtype=dtype)

    return to(dl), to(d), to(du), to(b), to(x_true)
