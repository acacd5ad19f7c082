"""Stage 1 of the partition method: CUDA kernel wrapper.

Replaces ``repro.kernels.partition_stage1`` (the ``_stage1_kernel`` Pallas
body and the reduced-row glue of ``_stage1_impl`` / ``_stage1_impl_batched``).
The kernel is ``csrc/partition_stage1.cu``: one thread per partition block,
then the reduced rows. Its plain version is the reference stage,
:func:`repro_torch.core.tridiag.partition.partition_stage1`.

:func:`partition_stage1_cuda_wide` replaces ``_stage1_kernel_wide`` and its
glue ``_stage1_impl_wide`` on the interleaved layout. Its kernel is
``csrc/partition_stage1_wide.cu``, one thread per (block, system), and its
plain version :func:`repro_torch.core.tridiag.layout.partition_stage1_wide`.
"""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.core.tridiag.layout import partition_stage1_wide
from repro_torch.core.tridiag.partition import PartitionCoeffs, partition_stage1
from repro_torch.kernels import build, common

STAGE1_LAUNCHES = common.LaunchCounter("partition_stage1")
STAGE1_WIDE_LAUNCHES = common.LaunchCounter("partition_stage1_wide")

Tensor = torch.Tensor


def _launch(dl: Tensor, d: Tensor, du: Tensor, b: Tensor, m: int) -> PartitionCoeffs:
    lead, n = tuple(d.shape[:-1]), d.shape[-1]
    p = n // m
    suffix = common.check_kernel_operands(
        "partition_stage1", (dl, d, du, b), [d.shape] * 4
    )
    lib = build.load("partition_stage1")
    fn = getattr(lib, f"partition_stage1_{suffix}")
    fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    y, v, w = (torch.empty(lead + (p, m - 1), dtype=d.dtype, device=d.device) for _ in range(3))
    red = [torch.empty(lead + (p,), dtype=d.dtype, device=d.device) for _ in range(4)]
    with torch.cuda.device(d.device):
        code = fn(
            *(common.ptr(t) for t in (dl, d, du, b, y, v, w, *red)),
            math.prod(lead), p, m, common.current_stream(d.device),
        )
    common.raise_on_error("partition_stage1", code, lib)
    STAGE1_LAUNCHES.add()
    return PartitionCoeffs(y, v, w, *red)


def _stage1(dl: Tensor, d: Tensor, du: Tensor, b: Tensor, m: int, ndim: int) -> PartitionCoeffs:
    if m < 2:
        raise ValueError("sub-system size m must be >= 2")
    if d.ndim != ndim:
        raise ValueError(f"expected {ndim}-D operands, got shape {tuple(d.shape)}")
    for name, a in (("dl", dl), ("du", du), ("b", b)):
        if a.shape != d.shape:
            raise ValueError(f"{name} has shape {tuple(a.shape)}, d has {tuple(d.shape)}")
    n = d.shape[-1]
    if n % m:
        raise ValueError(f"system size {n} not divisible by m={m}")
    if common.on_cuda(dl, d, du, b):
        return _launch(dl, d, du, b, m)
    return partition_stage1(dl, d, du, b, m)


def partition_stage1_cuda(dl: Tensor, d: Tensor, du: Tensor, b: Tensor, *, m: int = 10) -> PartitionCoeffs:
    """Stage 1 for one (n,) system: spikes (P, m-1), reduced rows (P,)."""
    return _stage1(dl, d, du, b, m, ndim=1)


def partition_stage1_cuda_batched(
    dl: Tensor, d: Tensor, du: Tensor, b: Tensor, *, m: int = 10
) -> PartitionCoeffs:
    """Stage 1 for a (B, n) batch: spikes (B, P, m-1), reduced rows (B, P).
    The next-block shift of the reduced rows stops at each system's end."""
    return _stage1(dl, d, du, b, m, ndim=2)


def _launch_wide(dlw: Tensor, dw: Tensor, duw: Tensor, bw: Tensor, m: int) -> PartitionCoeffs:
    p, _, bsz = dw.shape
    suffix = common.check_kernel_operands(
        "partition_stage1_wide", (dlw, dw, duw, bw), [dw.shape] * 4
    )
    lib = build.load("partition_stage1_wide")
    fn = getattr(lib, f"partition_stage1_wide_{suffix}")
    fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    y, v, w = (torch.empty((p, m - 1, bsz), dtype=dw.dtype, device=dw.device) for _ in range(3))
    red = [torch.empty((p, bsz), dtype=dw.dtype, device=dw.device) for _ in range(4)]
    with torch.cuda.device(dw.device):
        code = fn(
            *(common.ptr(t) for t in (dlw, dw, duw, bw, y, v, w, *red)),
            p, bsz, m, common.current_stream(dw.device),
        )
    common.raise_on_error("partition_stage1_wide", code, lib)
    STAGE1_WIDE_LAUNCHES.add()
    return PartitionCoeffs(y, v, w, *red)


def partition_stage1_cuda_wide(
    dlw: Tensor, dw: Tensor, duw: Tensor, bw: Tensor, *, m: int = 10
) -> PartitionCoeffs:
    """Stage 1 on interleaved (P, m, B) operands: spikes (P, m-1, B), reduced
    rows (P, B). The next-block shift runs along P and is zero at P-1."""
    if m < 2:
        raise ValueError("sub-system size m must be >= 2")
    if dw.ndim != 3 or dw.shape[1] != m:
        raise ValueError(f"expected interleaved (P, m={m}, B) operands, got shape {tuple(dw.shape)}")
    for name, a in (("dlw", dlw), ("duw", duw), ("bw", bw)):
        if a.shape != dw.shape:
            raise ValueError(f"{name} has shape {tuple(a.shape)}, dw has {tuple(dw.shape)}")
    if common.on_cuda(dlw, dw, duw, bw):
        return _launch_wide(dlw, dw, duw, bw, m)
    return partition_stage1_wide(dlw, dw, duw, bw, m=m)
