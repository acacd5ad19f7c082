"""Stage 1 of the partition method: CUDA kernel wrapper.

Replaces ``repro.kernels.partition_stage1`` (the ``_stage1_kernel`` Pallas
body and the reduced-row glue of ``_stage1_impl`` / ``_stage1_impl_batched``).
The kernel is ``csrc/partition_stage1.cu``: one CUDA block per span of
consecutive partition blocks, staged through shared memory, each thread
walking one block; the reduced rows come from a one-block halo in the same
kernel (blocks of more than 64 rows are walked from device memory, their
reduced rows assembled by a second kernel). Its plain version is the
reference stage, :func:`repro_torch.core.tridiag.partition.partition_stage1`.

:func:`partition_stage1_cuda_wide` replaces ``_stage1_kernel_wide`` and its
glue ``_stage1_impl_wide`` on the interleaved layout. Its kernel is
``csrc/partition_stage1_wide.cu``: one CUDA block per tile of consecutive
partition blocks by one 128-byte line of lanes, loaded into shared memory
with 16-byte copies, each thread walking one (block, lane) column in place;
each spike is written once, the reduced rows come from a one-block halo in
the same kernel, and rows past a lane's row count are identity rows that
are never loaded (blocks of more than 64 rows are walked from device
memory, their reduced rows assembled by a second kernel). Its plain version
is :func:`repro_torch.core.tridiag.layout.partition_stage1_wide`.

:func:`run_stage1` and :func:`run_stage1_wide` launch the kernels without
counting: the levels of the reduced solve (``kernels/thomas/ops.py``) run
through them, and count as that solve's one launch.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.core.tridiag.layout import partition_stage1_wide
from repro_torch.core.tridiag.partition import PartitionCoeffs, partition_stage1
from repro_torch.kernels import build, common

STAGE1_LAUNCHES = common.LaunchCounter("partition_stage1")
STAGE1_WIDE_LAUNCHES = common.LaunchCounter("partition_stage1_wide")

Tensor = torch.Tensor


_P = ctypes.c_void_p
_LL = ctypes.c_longlong
_I = ctypes.c_int
_ARGS = (_P,) * 11 + (_LL, _LL, _LL, _I, _I, _P)
_WIDE_ARGS = (_P,) * 11 + (_LL, _LL, _LL, _LL, _I, _I, _P)


def run_stage1(
    dl: Tensor, d: Tensor, du: Tensor, b: Tensor, m: int, *,
    red_rows: Optional[int] = None, zero_ends: bool = False, stream: Optional[int] = None,
) -> PartitionCoeffs:
    """Launch system-major Stage 1 on contiguous (..., P*m) CUDA operands,
    uncounted. With ``red_rows``, each system's reduced rows are the first P
    of ``red_rows``, the rest identity rows the kernel writes: a level's next
    operands. ``zero_ends`` reads each system's dl[0] and du[n-1] as zero;
    ``stream``: see :func:`repro_torch.kernels.common.call`."""
    lead, n = tuple(d.shape[:-1]), d.shape[-1]
    p = n // m
    rows = p if red_rows is None else red_rows
    suffix = common.check_kernel_operands(
        "partition_stage1", (dl, d, du, b), [d.shape] * 4
    )
    spikes = torch.empty((3,) + lead + (p, m - 1), dtype=d.dtype, device=d.device)
    red = torch.empty((4,) + lead + (rows,), dtype=d.dtype, device=d.device)
    y, v, w = spikes.unbind(0)
    reds = red.unbind(0)
    args = [t.data_ptr() for t in (dl, d, du, b, y, v, w, *reds)]
    common.call(
        "partition_stage1", "partition_stage1", f"partition_stage1_{suffix}", _ARGS, d.device,
        args + [math.prod(lead), p, rows, m, int(zero_ends)], stream,
    )
    return PartitionCoeffs(y, v, w, *reds)


def span_blocks(m: int, dtype: torch.dtype) -> int:
    """Partition blocks per CUDA block of the system-major kernel at this m
    and dtype (0 where blocks are walked from device memory)."""
    fn = build.entry("partition_stage1", "partition_stage1_span_blocks", (_I, _I))
    return int(fn(m, torch.empty((), dtype=dtype).element_size()))


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
        coeffs = run_stage1(dl, d, du, b, m)
        STAGE1_LAUNCHES.add()
        return coeffs
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


def run_stage1_wide(
    dl: Tensor, d: Tensor, du: Tensor, b: Tensor, m: int, *,
    red_rows: Optional[int] = None, zero_ends: bool = False, stream: Optional[int] = None,
) -> PartitionCoeffs:
    """Launch wide Stage 1 on contiguous CUDA operands, uncounted: (n, B)
    rows of any row count n, or (P, m, B) blocks (n = P·m), cut into P =
    ⌈n/m⌉ blocks of m rows, the rows past n read as identity rows and never
    loaded. With ``red_rows``, the (P, B) reduced rows are the first P of
    ``red_rows`` rows, the rest identity rows the kernel writes: a level's
    next operands. ``zero_ends`` reads each lane's dl[0] and du[n-1] as
    zero; ``stream``: see :func:`repro_torch.kernels.common.call`."""
    bsz = d.shape[-1]
    n = math.prod(d.shape[:-1])
    p = common.cdiv(n, m)
    rows = p if red_rows is None else red_rows
    if rows < p:
        raise ValueError(f"red_rows={rows} is fewer than the {p} blocks")
    suffix = common.check_kernel_operands(
        "partition_stage1_wide", (dl, d, du, b), [d.shape] * 4
    )
    spikes = torch.empty((3, p, m - 1, bsz), dtype=d.dtype, device=d.device)
    red = torch.empty((4, rows, bsz), dtype=d.dtype, device=d.device)
    y, v, w = spikes.unbind(0)
    reds = red.unbind(0)
    args = [t.data_ptr() for t in (dl, d, du, b, y, v, w, *reds)]
    common.call(
        "partition_stage1_wide", "partition_stage1_wide", f"partition_stage1_wide_{suffix}",
        _WIDE_ARGS, d.device, args + [p, bsz, n, rows, m, int(zero_ends)], stream,
    )
    return PartitionCoeffs(y, v, w, *reds)


def wide_tile_blocks(m: int) -> int:
    """Partition blocks per tile of the wide kernel at this m, its halo
    included (0 where blocks are walked from device memory)."""
    return int(build.entry("partition_stage1_wide", "partition_stage1_wide_tile_blocks", (_I,))(m))


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
        coeffs = run_stage1_wide(dlw, dw, duw, bw, m)
        STAGE1_WIDE_LAUNCHES.add()
        return coeffs
    return partition_stage1_wide(dlw, dw, duw, bw, m=m)
