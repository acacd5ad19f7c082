"""Tridiagonal matvec r = A·x in plain PyTorch, the counterpart of
``repro.kernels.tridiag_matvec.ref.tridiag_matvec_ref``.

The residual check of a solve: ``tridiag_matvec(dl, d, du, x) - b``. It is
the plain version of the CUDA kernel ``csrc/tridiag_matvec.cu``. ``dl[..., 0]``
and ``du[..., -1]`` are ignored; leading batch dims are allowed.
"""

from __future__ import annotations

import torch

Tensor = torch.Tensor


def tridiag_matvec(dl: Tensor, d: Tensor, du: Tensor, x: Tensor) -> Tensor:
    r = d * x
    r[..., 1:] += dl[..., 1:] * x[..., :-1]
    r[..., :-1] += du[..., :-1] * x[..., 1:]
    return r
