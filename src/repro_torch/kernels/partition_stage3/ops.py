"""Stage 3 of the partition method: CUDA kernel wrapper.

Replaces ``repro.kernels.partition_stage3`` (the ``_stage3_kernel`` Pallas
body and the ``s_left`` shift of ``_stage3_impl`` / ``_stage3_impl_batched``).
The kernel is ``csrc/partition_stage3.cu``: one CUDA block per span of
partition blocks, whose spikes are staged into shared memory with 16-byte
copies and whose outputs go out as 16-byte stores, in the same order of
operations as one thread per element (so results keep their bits). Its
plain version is the reference stage,
:func:`repro_torch.core.tridiag.partition.partition_stage3`.

:func:`partition_stage3_cuda_wide` replaces ``_stage3_kernel_wide`` and the
``s_left`` shift of ``_stage3_impl_wide`` on the interleaved layout. Its
kernel is ``csrc/partition_stage3_wide.cu``: 16-byte groups of lanes where
alignment allows, s_p and s_{p-1} read once per (block, lane), and one
thread per (block, lane group) looping over the block's rows, or up to 16
sharing them where the launch has few such columns (the reduced solve's
levels); no index is divided, and each element keeps the bits of one
thread per element. Its plain version is
:func:`repro_torch.core.tridiag.layout.partition_stage3_wide`.

:func:`run_stage3` and :func:`run_stage3_wide` launch the kernels without
counting: the levels of the reduced solve (``kernels/thomas/ops.py``) run
through them, and count as that solve's one launch.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.core.tridiag.layout import partition_stage3_wide
from repro_torch.core.tridiag.partition import PartitionCoeffs, partition_stage3
from repro_torch.kernels import common

STAGE3_LAUNCHES = common.LaunchCounter("partition_stage3")
STAGE3_WIDE_LAUNCHES = common.LaunchCounter("partition_stage3_wide")

Tensor = torch.Tensor


_P = ctypes.c_void_p
_ARGS = (_P,) * 6 + (ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, _P)
_WIDE_ARGS = (_P,) * 5 + (ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, _P)


def run_stage3(
    y: Tensor, v: Tensor, w: Tensor, s: Tensor, left: Tensor, *, stream: Optional[int] = None
) -> Tensor:
    """Launch system-major Stage 3 on contiguous CUDA tensors, uncounted.
    ``stream``: see :func:`repro_torch.kernels.common.call`."""
    lead, p, mi = tuple(y.shape[:-2]), y.shape[-2], y.shape[-1]
    m = mi + 1
    suffix = common.check_kernel_operands(
        "partition_stage3", (y, v, w, s, left), [y.shape] * 3 + [lead + (p,), lead]
    )
    x = torch.empty(lead + (p * m,), dtype=y.dtype, device=y.device)
    common.call(
        "partition_stage3", "partition_stage3", f"partition_stage3_{suffix}", _ARGS, y.device,
        [t.data_ptr() for t in (y, v, w, s, left, x)] + [math.prod(lead), p, m], stream,
    )
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
        x = run_stage3(coeffs.y, coeffs.v, coeffs.w, s, left)
        STAGE3_LAUNCHES.add()
        return x
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


def run_stage3_wide(
    y: Tensor, v: Tensor, w: Tensor, s: Tensor, *, stream: Optional[int] = None
) -> Tensor:
    """Launch wide Stage 3 on contiguous CUDA tensors, uncounted.
    ``stream``: see :func:`repro_torch.kernels.common.call`."""
    p, mi, bsz = y.shape
    suffix = common.check_kernel_operands(
        "partition_stage3_wide", (y, v, w, s), [y.shape] * 3 + [(p, bsz)]
    )
    x = torch.empty((p, mi + 1, bsz), dtype=y.dtype, device=y.device)
    common.call(
        "partition_stage3_wide", "partition_stage3_wide", f"partition_stage3_wide_{suffix}",
        _WIDE_ARGS, y.device, [t.data_ptr() for t in (y, v, w, s, x)] + [p, bsz, mi + 1], stream,
    )
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
        x = run_stage3_wide(coeffs.y, coeffs.v, coeffs.w, s)
        STAGE3_WIDE_LAUNCHES.add()
        return x
    return partition_stage3_wide(coeffs, s)
