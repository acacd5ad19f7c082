"""Thomas algorithm (serial tridiagonal solve) in plain PyTorch.

The counterpart of ``repro.core.tridiag.thomas``: a Python loop over rows,
vectorised over any leading batch dims. It serves as (a) the reference
backend's Stage-2 reduced solve, (b) the per-block interior solver of the
plain Stage 1 (three right-hand sides sharing one factorization), and (c) an
oracle for the partition method and the CUDA kernels.

Conventions
-----------
A system of size n is given by three diagonals and a right-hand side:

  dl[i] * x[i-1] + d[i] * x[i] + du[i] * x[i+1] = b[i],   i = 0..n-1

with dl[0] and du[n-1] ignored (treated as 0). Every operand may carry
leading batch dims, and ``b`` may carry a trailing right-hand-side axis,
shape (..., n, k).
"""

from __future__ import annotations

from typing import Tuple

import torch

Tensor = torch.Tensor


def thomas_factor(dl: Tensor, d: Tensor, du: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    """Factor the tridiagonal matrix once: returns (w, dhat, du).

    ``w[i] = dl[i] / dhat[i-1]`` are the elimination weights (``w[0] = 0``)
    and ``dhat`` the modified diagonal; both transform any right-hand side.
    """
    n = d.shape[-1]
    w = torch.zeros_like(d)
    dhat = torch.empty_like(d)
    dhat[..., 0] = d[..., 0]
    for i in range(1, n):
        w[..., i] = dl[..., i] / dhat[..., i - 1]
        dhat[..., i] = d[..., i] - w[..., i] * du[..., i - 1]
    return w, dhat, du


def thomas_solve_factored(factors: Tuple[Tensor, Tensor, Tensor], b: Tensor) -> Tensor:
    """Solve given precomputed factors. ``b``: (..., n) or (..., n, k)."""
    w, dhat, du = factors
    vec = b.ndim == w.ndim  # single right-hand side
    if vec:
        b = b[..., None]
    n = b.shape[-2]
    bhat = b.clone()
    for i in range(1, n):
        bhat[..., i, :] = b[..., i, :] - w[..., i, None] * bhat[..., i - 1, :]
    x = torch.empty_like(bhat)
    x[..., n - 1, :] = bhat[..., n - 1, :] / dhat[..., n - 1, None]
    for i in range(n - 2, -1, -1):
        x[..., i, :] = (bhat[..., i, :] - du[..., i, None] * x[..., i + 1, :]) / dhat[
            ..., i, None
        ]
    return x[..., 0] if vec else x


def thomas(dl: Tensor, d: Tensor, du: Tensor, b: Tensor) -> Tensor:
    """One-shot Thomas solve. Supports batch dims and multi-RHS ``b``."""
    dl, d, du = torch.broadcast_tensors(dl, d, du)
    return thomas_solve_factored(thomas_factor(dl, d, du), b)
