"""SSD Stage 1 (Mamba-2's intra-chunk stage): CUDA kernel wrapper, and the
chunked scan around it.

Replaces ``repro.kernels.ssd_stage1`` (the ``_ssd1_kernel`` Pallas body,
reached through ``ssd1_tiled`` from ``ssd_scan_pallas``). The kernel is
``csrc/ssd_stage1.cu``, on the tensor cores in split TF32: each fp32
operand is split into a TF32 high part and a TF32 remainder, and each
product is taken as three TF32 products (lo·hi + hi·lo + hi·hi) with fp32
accumulation. That holds the fp32 ladder; one TF32 product alone would not
(``tests/test_torch_ssd_split.py``). Its C entry runs three kernels: the
scores C·Bᵀ (tiles on or below the diagonal) into a scratch with 16-byte
rows, the chunk states (two heads a block), and the intra-chunk outputs
(one block per cell, head and 64 columns of the head dim), which apply the
decay in fp32 before splitting. Its plain version is
:func:`repro_torch.models.layers.ssm.ssd_stage1`.

:func:`ssd_scan_kernel` is the counterpart of ``ssd_scan_pallas``: the same
signature and semantics as the plain
:func:`repro_torch.models.layers.ssm.ssd_scan`, with Stage 1 through
:func:`ssd_stage1_cuda`; Stages 2 and 3 stay tensor ops.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import common
from repro_torch.models.layers.ssm import chunked_ssd, ssd_stage1

SSD_STAGE1_LAUNCHES = common.LaunchCounter("ssd_stage1")
#: The longest chunk the kernel takes (its shared-memory prefix sum).
MAX_CHUNK = 1024

_ARGS = (ctypes.c_void_p,) * 7 + (ctypes.c_longlong,) + (ctypes.c_int,) * 4 + (ctypes.c_void_p,)

Tensor = torch.Tensor


def ssd_stage1_cuda(u: Tensor, dac: Tensor, b: Tensor, c: Tensor) -> Tuple[Tensor, Tensor]:
    """u: [G, Q, H, P]; dac: [G, Q, H]; b/c: [G, Q, N], all fp32 on the card.
    Returns (y_diag [G, Q, H, P], states [G, H, P, N])."""
    if u.ndim != 4:
        raise ValueError(f"ssd_stage1 takes u of shape [G, Q, H, P], got {tuple(u.shape)}")
    g, q, nh, p = u.shape
    n = b.shape[-1]
    shapes = [(g, q, nh, p), (g, q, nh), (g, q, n), (g, q, n)]
    for name, t, shape in zip(("u", "dac", "b", "c"), (u, dac, b, c), shapes):
        if tuple(t.shape) != shape:
            raise ValueError(f"ssd_stage1: {name} has shape {tuple(t.shape)}, expected {shape}")
    if not common.on_cuda(u, dac, b, c):
        return ssd_stage1(u, dac, b, c)
    for name, t in zip(("u", "dac", "b", "c"), (u, dac, b, c)):
        if t.dtype != torch.float32:
            raise TypeError(f"ssd_stage1: the kernel takes float32, {name} is {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"ssd_stage1: {name} must be contiguous")
    if not 1 <= q <= MAX_CHUNK:
        raise ValueError(f"ssd_stage1: chunk length {q} outside 1..{MAX_CHUNK}")
    y = torch.empty_like(u)
    s = torch.empty(g, nh, p, n, dtype=torch.float32, device=u.device)
    # Scratch for C·Bᵀ, rows padded to a multiple of 4 floats (16 bytes).
    scores = torch.empty(g, q, common.round_up(q, 4), dtype=torch.float32, device=u.device)
    common.call(
        "ssd_stage1", "ssd_stage1", "ssd_stage1_f32", _ARGS, u.device,
        [t.data_ptr() for t in (u, dac, b, c, y, s, scores)] + [g, q, nh, p, n],
    )
    SSD_STAGE1_LAUNCHES.add()
    return y, s


def ssd_scan_kernel(
    x: Tensor,
    dt: Tensor,
    a: Tensor,
    b_in: Tensor,
    c_in: Tensor,
    *,
    chunk: int,
    h0: Optional[Tensor] = None,
) -> Tuple[Tensor, Tensor]:
    """Drop-in for ``ssm.ssd_scan`` with Stage 1 through the kernel wrapper.
    Returns (y [B, S, H, P], final_state [B, H, P, N]); raises
    ``ValueError`` unless S is a multiple of ``min(chunk, S)``."""
    return chunked_ssd(ssd_stage1_cuda, x, dt, a, b_in, c_in, chunk=chunk, h0=h0)
