"""The plain reference of a tridiagonal solve: a manufactured solution.

The benchmark draws each system's diagonals and its solution ``x`` from the
seed, and the reference makes the right-hand side ``b = A x`` by a plain
PyTorch product in float64. The program is handed (dl, d, du, b) and its
answer is held against ``x``. The configuration's systems are strictly
diagonally dominant (|d| ≥ 4, |dl|, |du| ≤ 1), so the exact solution of the
rounded system lies within a few float64 roundings of ``x``: a float64
solve reads about 1e-16 to 1e-15, a float32 one about 1e-7.

Convention of the port and of this file: row i reads
``dl[i]·x[i-1] + d[i]·x[i] + du[i]·x[i+1]``; ``dl[..., 0]`` and
``du[..., -1]`` are zero.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch

Tensor = torch.Tensor


def make_system(gen: torch.Generator, shape: Sequence[int], spec: Dict,
                device: torch.device) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """(dl, d, du, x) of ``shape`` in float64 on ``device``, from ``gen``:
    ``d`` uniform in ``spec["diag"]``, ``dl`` and ``du`` in ``spec["off"]``,
    ``x`` in ``spec["x"]``, in one draw."""
    shape = tuple(shape)
    u = torch.rand((4,) + shape, generator=gen, dtype=torch.float64, device=device)
    lo = torch.tensor([spec["off"][0], spec["diag"][0], spec["off"][0], spec["x"][0]],
                      dtype=torch.float64, device=device)
    hi = torch.tensor([spec["off"][1], spec["diag"][1], spec["off"][1], spec["x"][1]],
                      dtype=torch.float64, device=device)
    view = (4,) + (1,) * len(shape)
    dl, d, du, x = (lo.view(view) + (hi - lo).view(view) * u).unbind(0)
    dl[..., 0] = 0.0
    du[..., -1] = 0.0
    return dl, d, du, x


def matvec(dl: Tensor, d: Tensor, du: Tensor, x: Tensor) -> Tensor:
    """``A x`` for the tridiagonal ``A`` (float64, plain PyTorch)."""
    b = d * x
    b[..., 1:] += dl[..., 1:] * x[..., :-1]
    b[..., :-1] += du[..., :-1] * x[..., 1:]
    return b


def rel_err(x: np.ndarray, x_true: np.ndarray) -> float:
    """The worst system's max-norm error relative to its solution's max
    norm (a non-finite answer reads infinity)."""
    x = np.asarray(x, dtype=np.float64).reshape(-1, x_true.shape[-1])
    t = np.asarray(x_true, dtype=np.float64).reshape(-1, x_true.shape[-1])
    err = np.max(np.abs(x - t), axis=-1) / np.max(np.abs(t), axis=-1)
    worst = float(np.max(err))
    return worst if np.isfinite(worst) else float("inf")
