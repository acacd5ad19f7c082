"""Batched Thomas solve: CUDA kernel wrapper.

Replaces ``repro.kernels.thomas`` (the ``_thomas_kernel`` Pallas body as
reached from ``thomas_pallas``). The kernel is ``csrc/thomas.cu``: one thread
per system. On the main path it is the fused executor's device Stage 2, the
reduced solve; a 1-D system runs as a batch of one. Its plain version is
:func:`repro_torch.core.tridiag.thomas.thomas`.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core.tridiag.thomas import thomas
from repro_torch.kernels import build, common

THOMAS_LAUNCHES = common.LaunchCounter("thomas")

Tensor = torch.Tensor


def _launch(dl: Tensor, d: Tensor, du: Tensor, b: Tensor) -> Tensor:
    nsys, n = (1, d.shape[0]) if d.ndim == 1 else tuple(d.shape)
    suffix = common.check_kernel_operands("thomas", (dl, d, du, b), [d.shape] * 4)
    lib = build.load("thomas")
    fn = getattr(lib, f"thomas_{suffix}")
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    x = torch.empty_like(d)
    dhat = torch.empty_like(d)  # scratch: the modified diagonal
    with torch.cuda.device(d.device):
        code = fn(
            *(common.ptr(t) for t in (dl, d, du, b, x, dhat)),
            nsys, n, common.current_stream(d.device),
        )
    common.raise_on_error("thomas", code, lib)
    THOMAS_LAUNCHES.add()
    return x


def thomas_cuda(dl: Tensor, d: Tensor, du: Tensor, b: Tensor) -> Tensor:
    """Solve one (n,) system or B independent (B, n) systems."""
    if d.ndim not in (1, 2):
        raise ValueError(f"thomas takes (n,) or (B, n) operands, got {tuple(d.shape)}")
    for name, a in (("dl", dl), ("du", du), ("b", b)):
        if a.shape != d.shape:
            raise ValueError(f"{name} has shape {tuple(a.shape)}, d has {tuple(d.shape)}")
    if d.shape[-1] < 1:
        raise ValueError("thomas needs at least one row")
    if common.on_cuda(dl, d, du, b):
        return _launch(dl, d, du, b)
    return thomas(dl, d, du, b)
