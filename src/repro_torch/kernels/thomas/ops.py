"""Batched Thomas solve: CUDA kernel wrapper.

Replaces ``repro.kernels.thomas`` (the ``_thomas_kernel`` Pallas body as
reached from ``thomas_pallas`` and ``thomas_pallas_wide``). The kernel is
``csrc/thomas.cu``: one thread per system, with a row and a system stride so
one body serves both routes. On the main path it is the fused executor's
device Stage 2, the reduced solve: :func:`thomas_cuda` on (B, n) rows (a 1-D
system runs as a batch of one), :func:`thomas_cuda_wide` on the interleaved
layout's (P, B) rows. The two routes count their launches apart. The plain
versions are :func:`repro_torch.core.tridiag.thomas.thomas` and
:func:`repro_torch.core.tridiag.layout.thomas_wide`.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core.tridiag.layout import thomas_wide
from repro_torch.core.tridiag.thomas import thomas
from repro_torch.kernels import build, common

THOMAS_LAUNCHES = common.LaunchCounter("thomas")
THOMAS_WIDE_LAUNCHES = common.LaunchCounter("thomas_wide")

Tensor = torch.Tensor


def _launch(
    dl: Tensor, d: Tensor, du: Tensor, b: Tensor, nsys: int, n: int, wide: bool
) -> Tensor:
    name = "thomas_wide" if wide else "thomas"
    suffix = common.check_kernel_operands(name, (dl, d, du, b), [d.shape] * 4)
    lib = build.load("thomas")
    fn = getattr(lib, f"thomas_{suffix}")
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_longlong] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    # (n, B) rows: row stride B, system stride 1; (B, n): 1 and n.
    rs, ss = (nsys, 1) if wide else (1, n)
    x = torch.empty_like(d)
    dhat = torch.empty_like(d)  # scratch: the modified diagonal
    with torch.cuda.device(d.device):
        code = fn(
            *(common.ptr(t) for t in (dl, d, du, b, x, dhat)),
            nsys, n, rs, ss, common.current_stream(d.device),
        )
    common.raise_on_error(name, code, lib)
    (THOMAS_WIDE_LAUNCHES if wide else THOMAS_LAUNCHES).add()
    return x


def _check(dl: Tensor, d: Tensor, du: Tensor, b: Tensor, n: int) -> None:
    for name, a in (("dl", dl), ("du", du), ("b", b)):
        if a.shape != d.shape:
            raise ValueError(f"{name} has shape {tuple(a.shape)}, d has {tuple(d.shape)}")
    if n < 1:
        raise ValueError("thomas needs at least one row")


def thomas_cuda(dl: Tensor, d: Tensor, du: Tensor, b: Tensor) -> Tensor:
    """Solve one (n,) system or B independent (B, n) systems."""
    if d.ndim not in (1, 2):
        raise ValueError(f"thomas takes (n,) or (B, n) operands, got {tuple(d.shape)}")
    _check(dl, d, du, b, d.shape[-1])
    if common.on_cuda(dl, d, du, b):
        nsys, n = (1, d.shape[0]) if d.ndim == 1 else tuple(d.shape)
        return _launch(dl, d, du, b, nsys, n, wide=False)
    return thomas(dl, d, du, b)


def thomas_cuda_wide(dl: Tensor, d: Tensor, du: Tensor, b: Tensor) -> Tensor:
    """Solve B independent systems laid out as (n, B) rows, along axis 0:
    the interleaved layout's reduced solve on (P, B) rows."""
    if d.ndim != 2:
        raise ValueError(f"thomas_wide takes interleaved (n, B) operands, got {tuple(d.shape)}")
    _check(dl, d, du, b, d.shape[0])
    if common.on_cuda(dl, d, du, b):
        n, nsys = tuple(d.shape)
        return _launch(dl, d, du, b, nsys, n, wide=True)
    return thomas_wide(dl, d, du, b)
