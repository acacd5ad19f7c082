"""Tridiagonal matvec r = A·x: CUDA kernel wrapper.

Replaces ``repro.kernels.tridiag_matvec`` (the ``_matvec_kernel`` Pallas body
and the shifted, lane-padded copies that ``tridiag_matvec_pallas`` builds
around it). The kernel is ``csrc/tridiag_matvec.cu``: one thread per row,
reading its neighbours of ``x`` directly. The plain version is
:func:`repro_torch.core.tridiag.matvec.tridiag_matvec`. The residual check
of a solve is ``tridiag_matvec_cuda(dl, d, du, x) - b``.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core.tridiag.matvec import tridiag_matvec
from repro_torch.kernels import common

MATVEC_LAUNCHES = common.LaunchCounter("tridiag_matvec")

_ARGS = (ctypes.c_void_p,) * 5 + (ctypes.c_longlong, ctypes.c_void_p)

Tensor = torch.Tensor


def tridiag_matvec_cuda(dl: Tensor, d: Tensor, du: Tensor, x: Tensor) -> Tensor:
    """r = A·x for one (N,) tridiagonal system, fp32 or fp64."""
    if d.ndim != 1:
        raise ValueError(f"tridiag_matvec takes one (N,) system, got {tuple(d.shape)}")
    for name, a in (("dl", dl), ("du", du), ("x", x)):
        if a.shape != d.shape:
            raise ValueError(f"{name} has shape {tuple(a.shape)}, d has {tuple(d.shape)}")
    if not common.on_cuda(dl, d, du, x):
        return tridiag_matvec(dl, d, du, x)
    n = d.shape[0]
    suffix = common.check_kernel_operands("tridiag_matvec", (dl, d, du, x), [(n,)] * 4)
    r = torch.empty_like(d)
    common.call(
        "tridiag_matvec", "tridiag_matvec", f"tridiag_matvec_{suffix}", _ARGS, d.device,
        [t.data_ptr() for t in (dl, d, du, x, r)] + [n],
    )
    MATVEC_LAUNCHES.add()
    return r
