"""Stage 3 of the partition method: CUDA kernel wrapper.

Replaces ``repro.kernels.partition_stage3`` (the ``_stage3_kernel`` Pallas
body and the ``s_left`` shift of ``_stage3_impl`` / ``_stage3_impl_batched``).
The kernel is ``csrc/partition_stage3.cu``: one thread per output element.
Its plain version is the reference stage,
:func:`repro_torch.core.tridiag.partition.partition_stage3`.

:func:`partition_stage3_cuda_wide` replaces ``_stage3_kernel_wide`` and the
``s_left`` shift of ``_stage3_impl_wide`` on the interleaved layout. Its
kernel is ``csrc/partition_stage3_wide.cu``, one thread per output element
with the systems fastest, and its plain version
:func:`repro_torch.core.tridiag.layout.partition_stage3_wide`.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.core.tridiag.layout import partition_stage3_wide
from repro_torch.core.tridiag.partition import PartitionCoeffs, partition_stage3
from repro_torch.kernels import build, common

STAGE3_LAUNCHES = common.LaunchCounter("partition_stage3")
STAGE3_WIDE_LAUNCHES = common.LaunchCounter("partition_stage3_wide")

Tensor = torch.Tensor


def _launch(y: Tensor, v: Tensor, w: Tensor, s: Tensor, left: Tensor) -> Tensor:
    lead, p, mi = tuple(y.shape[:-2]), y.shape[-2], y.shape[-1]
    m = mi + 1
    suffix = common.check_kernel_operands(
        "partition_stage3", (y, v, w, s, left), [y.shape] * 3 + [lead + (p,), lead]
    )
    lib = build.load("partition_stage3")
    fn = getattr(lib, f"partition_stage3_{suffix}")
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    x = torch.empty(lead + (p * m,), dtype=y.dtype, device=y.device)
    with torch.cuda.device(y.device):
        code = fn(
            *(common.ptr(t) for t in (y, v, w, s, left, x)),
            math.prod(lead), p, m, common.current_stream(y.device),
        )
    common.raise_on_error("partition_stage3", code, lib)
    STAGE3_LAUNCHES.add()
    return x


def _stage3(coeffs: PartitionCoeffs, s: Tensor, left: Optional[Tensor], ndim: int) -> Tensor:
    y = coeffs.y
    # Back substitution runs in the spikes' precision.
    s = s.to(dtype=y.dtype)
    if s.ndim != ndim or y.ndim != ndim + 1:
        raise ValueError(
            f"expected {ndim}-D interface values and {ndim + 1}-D spikes, got "
            f"s {tuple(s.shape)} and y {tuple(y.shape)}"
        )
    if tuple(s.shape) != tuple(y.shape[:-1]):
        raise ValueError(f"s has shape {tuple(s.shape)}, spikes {tuple(y.shape)}")
    if left is None:
        left = torch.zeros(s.shape[:-1], dtype=y.dtype, device=y.device)
    left = left.to(dtype=y.dtype)
    if common.on_cuda(coeffs.y, coeffs.v, coeffs.w, s, left):
        return _launch(coeffs.y, coeffs.v, coeffs.w, s, left)
    return partition_stage3(coeffs, s, left)


def partition_stage3_cuda(
    coeffs: PartitionCoeffs, s: Tensor, left: Optional[Tensor] = None
) -> Tensor:
    """Back-substitute (P,) interface values into (P, m-1) spikes → (P·m,).

    ``left`` (a 0-d tensor) is s_{p-1} of the first block: zero by default,
    the neighbouring chunk's last interface value for one chunk of a longer
    system."""
    return _stage3(coeffs, s, left, ndim=1)


def partition_stage3_cuda_batched(
    coeffs: PartitionCoeffs, s: Tensor, left: Optional[Tensor] = None
) -> Tensor:
    """Batched back substitution: (B, P, m-1) spikes, (B, P) s → (B, P·m);
    ``left`` has shape (B,)."""
    return _stage3(coeffs, s, left, ndim=2)


def _launch_wide(y: Tensor, v: Tensor, w: Tensor, s: Tensor) -> Tensor:
    p, mi, bsz = y.shape
    suffix = common.check_kernel_operands(
        "partition_stage3_wide", (y, v, w, s), [y.shape] * 3 + [(p, bsz)]
    )
    lib = build.load("partition_stage3_wide")
    fn = getattr(lib, f"partition_stage3_wide_{suffix}")
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    x = torch.empty((p, mi + 1, bsz), dtype=y.dtype, device=y.device)
    with torch.cuda.device(y.device):
        code = fn(
            *(common.ptr(t) for t in (y, v, w, s, x)),
            p, bsz, mi + 1, common.current_stream(y.device),
        )
    common.raise_on_error("partition_stage3_wide", code, lib)
    STAGE3_WIDE_LAUNCHES.add()
    return x


def partition_stage3_cuda_wide(coeffs: PartitionCoeffs, s: Tensor) -> Tensor:
    """Back-substitute (P, B) interface values into (P, m-1, B) spikes →
    (P, m, B). ``s`` is cast to the spikes' precision."""
    y = coeffs.y
    s = s.to(dtype=y.dtype)
    if y.ndim != 3 or s.ndim != 2:
        raise ValueError(
            f"expected (P, m-1, B) spikes and (P, B) interface values, got "
            f"y {tuple(y.shape)} and s {tuple(s.shape)}"
        )
    if tuple(s.shape) != (y.shape[0], y.shape[2]):
        raise ValueError(f"s has shape {tuple(s.shape)}, spikes {tuple(y.shape)}")
    if common.on_cuda(coeffs.y, coeffs.v, coeffs.w, s):
        return _launch_wide(coeffs.y, coeffs.v, coeffs.w, s)
    return partition_stage3_wide(coeffs, s)
