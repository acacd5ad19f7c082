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

The gradient is the port's own kernel, ``csrc/ssd_stage1_bwd.cu`` (the TPU
kernel has no backward), on the tensor cores in split TF32 as the forward
(the two share ``csrc/ssd_tf32.cuh``): three kernels behind one C entry, the
decays applied in fp32 before the split, every sum in a fixed order. It is
behind :func:`ssd_stage1_backward_cuda`, whose plain version is
:func:`repro_torch.models.layers.ssm.ssd_stage1_backward`.
:class:`SSDStage1Function` ties the two wrappers together for autograd: on
CUDA tensors its forward and backward launch the kernels, on CPU tensors
they run the plain versions.

Each kernel runs inside a custom op (``repro_torch::ssd_stage1`` and
``repro_torch::ssd_stage1_bwd``), which routes to the kernel on CUDA tensors
and to the plain version on CPU tensors, and answers fake tensors with the
outputs' shapes. Each op carries one FLOP formula (2 × the multiply-adds of
:func:`ssd_stage1_cost` / :func:`ssd_stage1_bwd_cost`, the work before the
split's × 3) and one byte formula (each fp32 input read once, each output
written once), charged by ``repro_torch.roofline.counting`` on every route
alike: the plain version's einsums are not counted beside it.

:func:`ssd_scan_kernel` is the counterpart of ``ssd_scan_pallas``: the same
signature and semantics as the plain
:func:`repro_torch.models.layers.ssm.ssd_scan`, with Stage 1 through
:func:`ssd_stage1_cuda`; Stages 2 and 3 stay tensor ops.
"""

from __future__ import annotations

import ctypes
from typing import Any, Optional, Tuple

import torch

from repro_torch.kernels import common
from repro_torch.models.layers.ssm import _work_dtype, chunked_ssd, ssd_stage1, ssd_stage1_backward
from repro_torch.roofline import counting

SSD_STAGE1_LAUNCHES = common.LaunchCounter("ssd_stage1")
SSD_STAGE1_BWD_LAUNCHES = common.LaunchCounter("ssd_stage1_bwd")
#: The longest chunk the kernel takes (its shared-memory prefix sum).
MAX_CHUNK = 1024

_ARGS = (ctypes.c_void_p,) * 7 + (ctypes.c_longlong,) + (ctypes.c_int,) * 4 + (ctypes.c_void_p,)
_BWD_ARGS = (ctypes.c_void_p,) * 19 + (ctypes.c_longlong,) + (ctypes.c_int,) * 6 + (ctypes.c_void_p,)
# The backward's split of its work over heads: groups of at most
# _HEADS_PER_GROUP heads share a dS tile's work (kHG in
# csrc/ssd_stage1_bwd.cu, which takes no more), and at most _STATE_GROUPS
# groups of at least _HEADS_PER_STATE_GROUP heads the state term of dB; each
# sum over the groups is taken in a fixed order.
_HEADS_PER_GROUP = 8
_HEADS_PER_STATE_GROUP = 4
_STATE_GROUPS = 16

Tensor = torch.Tensor


def _check_shapes(what: str, names: Tuple[str, ...], tensors: Tuple[Tensor, ...]) -> None:
    """u [G, Q, H, P], dac [G, Q, H], b and c [G, Q, N], then (backward)
    dy [G, Q, H, P] and ds [G, H, P, N]."""
    u, b = tensors[0], tensors[2]
    if u.ndim != 4:
        raise ValueError(f"{what} takes u of shape [G, Q, H, P], got {tuple(u.shape)}")
    g, q, nh, p = u.shape
    n = b.shape[-1]
    shapes = [(g, q, nh, p), (g, q, nh), (g, q, n), (g, q, n), (g, q, nh, p), (g, nh, p, n)]
    for name, t, shape in zip(names, tensors, shapes):
        if tuple(t.shape) != shape:
            raise ValueError(f"{what}: {name} has shape {tuple(t.shape)}, expected {shape}")


def _check_kernel_operands(what: str, names: Tuple[str, ...], tensors: Tuple[Tensor, ...]) -> None:
    for name, t in zip(names, tensors):
        if t.dtype != torch.float32:
            raise TypeError(f"{what}: the kernel takes float32, {name} is {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
    q = tensors[0].shape[1]
    if not 1 <= q <= MAX_CHUNK:
        raise ValueError(f"{what}: chunk length {q} outside 1..{MAX_CHUNK}")


def ssd_stage1_cost(g: int, q: int, nh: int, p: int, n: int) -> Tuple[int, int]:
    """Bytes (each fp32 input read once, each output written once) and
    multiply-adds of SSD Stage 1 (the causal half of the scores and of y,
    and the states)."""
    causal = q * (q + 1) // 2  # the (q, k <= q) pairs
    macs = g * (causal * n + nh * causal * p + nh * q * p * n)
    nbytes = 4 * g * (2 * q * nh * p + q * nh + 2 * q * n + nh * p * n)
    return nbytes, macs


def ssd_stage1_bwd_cost(g: int, q: int, nh: int, p: int, n: int) -> Tuple[int, int]:
    """Bytes (inputs u, dac, b, c, dy, ds read once, du, ddac, db, dc
    written once, fp32) and multiply-adds of the backward: the causal half
    of the scores, of dC and of dSᵀ·C (3 Q²N/2), of W and of the dy term of
    du (2 H Q² P/2), and ds·B and uᵀ·ds (2 H Q P N)."""
    causal = q * (q + 1) // 2
    macs = g * (3 * causal * n + 2 * nh * causal * p + 2 * nh * q * p * n)
    nbytes = 4 * g * (3 * q * nh * p + 2 * q * nh + 4 * q * n + nh * p * n)
    return nbytes, macs


def _dims(u_shape: Any, b_shape: Any) -> Tuple[int, int, int, int, int]:
    g, q, nh, p = u_shape
    return g, q, nh, p, b_shape[-1]


def ssd_stage1_cuda(u: Tensor, dac: Tensor, b: Tensor, c: Tensor) -> Tuple[Tensor, Tensor]:
    """u: [G, Q, H, P]; dac: [G, Q, H]; b/c: [G, Q, N], all fp32 on the card.
    Returns (y_diag [G, Q, H, P], states [G, H, P, N])."""
    _check_shapes("ssd_stage1", ("u", "dac", "b", "c"), (u, dac, b, c))
    return torch.ops.repro_torch.ssd_stage1(u, dac, b, c)


@torch.library.custom_op("repro_torch::ssd_stage1", mutates_args=(),
                         schema="(Tensor u, Tensor dac, Tensor b, Tensor c) -> (Tensor, Tensor)")
def _ssd_stage1_op(u: Tensor, dac: Tensor, b: Tensor, c: Tensor) -> Tuple[Tensor, Tensor]:
    if not common.on_cuda(u, dac, b, c):
        # Contiguous, as the kernel's outputs are: the ops after it run the same.
        y, s = ssd_stage1(u, dac, b, c)
        return y.contiguous(), s.contiguous()
    names = ("u", "dac", "b", "c")
    _check_kernel_operands("ssd_stage1", names, (u, dac, b, c))
    g, q, nh, p = u.shape
    n = b.shape[-1]
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


@_ssd_stage1_op.register_fake
def _ssd_stage1_fake(u: Tensor, dac: Tensor, b: Tensor, c: Tensor) -> Tuple[Tensor, Tensor]:
    g, q, nh, p, n = _dims(u.shape, b.shape)
    wt = _work_dtype(u)
    return u.new_empty((g, q, nh, p), dtype=wt), u.new_empty((g, nh, p, n), dtype=wt)


counting.register_kernel(
    "ssd_stage1", torch.ops.repro_torch.ssd_stage1,
    flops=lambda u, dac, b, c: 2 * ssd_stage1_cost(*_dims(u, b))[1],
    nbytes=lambda u, dac, b, c: ssd_stage1_cost(*_dims(u, b))[0])


def _head_groups(nh: int, count: int) -> int:
    """The number of groups when ``nh`` heads are cut into about ``count``
    groups of ceil(nh / count) heads each (the kernel's split, which gives
    every group but the last that many): as few as leave no group empty,
    and at least 1."""
    return common.cdiv(nh, common.cdiv(nh, count)) if nh else 1


def ssd_stage1_backward_cuda(u: Tensor, dac: Tensor, b: Tensor, c: Tensor, dy: Tensor,
                             ds: Tensor) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """The gradient of SSD Stage 1: the forward's inputs and the incoming
    gradients dy [G, Q, H, P] and ds [G, H, P, N], all fp32 on the card.
    Returns (du, ddac, db, dc) of the inputs' shapes."""
    _check_shapes("ssd_stage1_backward", ("u", "dac", "b", "c", "dy", "ds"),
                  (u, dac, b, c, dy, ds))
    return torch.ops.repro_torch.ssd_stage1_bwd(u, dac, b, c, dy, ds)


@torch.library.custom_op(
    "repro_torch::ssd_stage1_bwd", mutates_args=(),
    schema="(Tensor u, Tensor dac, Tensor b, Tensor c, Tensor dy, Tensor ds)"
           " -> (Tensor, Tensor, Tensor, Tensor)")
def _ssd_stage1_bwd_op(u: Tensor, dac: Tensor, b: Tensor, c: Tensor, dy: Tensor,
                       ds: Tensor) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    if not common.on_cuda(u, dac, b, c, dy, ds):
        du, ddac, db, dc = ssd_stage1_backward(u, dac, b, c, dy, ds)
        return du.contiguous(), ddac.contiguous(), db.contiguous(), dc.contiguous()
    names = ("u", "dac", "b", "c", "dy", "ds")
    _check_kernel_operands("ssd_stage1_backward", names, (u, dac, b, c, dy, ds))
    g, q, nh, p = u.shape
    n = b.shape[-1]
    t = common.cdiv(q, 64)  # the kernel's q and k tiles
    ld = common.round_up(q, 4)  # 16-byte rows of the [Q, Q] scratch
    hs = _head_groups(nh, common.cdiv(nh, _HEADS_PER_GROUP))
    js = _head_groups(nh, min(_STATE_GROUPS, common.cdiv(nh, _HEADS_PER_STATE_GROUP)))

    def f32(*shape: int) -> Tensor:
        return torch.empty(shape, dtype=torch.float32, device=u.device)

    du, ddac, db, dc = torch.empty_like(u), torch.empty_like(dac), torch.empty_like(b), torch.empty_like(c)
    # Scratch: cum and e [G, Q, H], C·Bᵀ and its gradient [G, Q, ld], the
    # head groups' parts of that gradient [G, HS, Q, ld], the row and column
    # sums of G over half tiles [G, 2T, H, Q], r [G, Q, H] and the head
    # groups' parts of dB's state term [G, JS, Q, N].
    scratch = (f32(g, q, nh), f32(g, q, nh), f32(g, q, ld), f32(g, q, ld), f32(g, hs, q, ld),
               f32(g, 2 * t, nh, q), f32(g, 2 * t, nh, q), f32(g, q, nh), f32(g, js, q, n))
    common.call(
        "ssd_stage1_bwd", "ssd_stage1_bwd", "ssd_stage1_bwd_f32", _BWD_ARGS, u.device,
        [x.data_ptr() for x in (u, dac, b, c, dy, ds, du, ddac, db, dc, *scratch)]
        + [g, q, nh, p, n, hs, js],
    )
    SSD_STAGE1_BWD_LAUNCHES.add()
    return du, ddac, db, dc


@_ssd_stage1_bwd_op.register_fake
def _ssd_stage1_bwd_fake(u: Tensor, dac: Tensor, b: Tensor, c: Tensor, dy: Tensor,
                         ds: Tensor) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    wt = _work_dtype(u)
    return tuple(u.new_empty(t.shape, dtype=wt) for t in (u, dac, b, c))  # type: ignore[return-value]


counting.register_kernel(
    "ssd_stage1_bwd", torch.ops.repro_torch.ssd_stage1_bwd,
    flops=lambda u, dac, b, c, dy, ds: 2 * ssd_stage1_bwd_cost(*_dims(u, b))[1],
    nbytes=lambda u, dac, b, c, dy, ds: ssd_stage1_bwd_cost(*_dims(u, b))[0])


class SSDStage1Function(torch.autograd.Function):
    """SSD Stage 1 with its gradient: forward :func:`ssd_stage1_cuda`,
    backward :func:`ssd_stage1_backward_cuda` (each the kernel on CUDA
    tensors, the plain version on CPU tensors). Saves the four inputs; an
    output without a gradient gets zeros."""

    @staticmethod
    def forward(ctx: Any, u: Tensor, dac: Tensor, b: Tensor, c: Tensor) -> Tuple[Tensor, Tensor]:
        y, s = ssd_stage1_cuda(u, dac, b, c)
        ctx.save_for_backward(u, dac, b, c)
        return y, s

    @staticmethod
    def backward(ctx: Any, dy: Optional[Tensor],
                 ds: Optional[Tensor]) -> Tuple[Optional[Tensor], ...]:
        u, dac, b, c = ctx.saved_tensors
        g, q, nh, p = u.shape
        n = b.shape[-1]
        dy = torch.zeros_like(u) if dy is None else dy.contiguous()
        ds = (u.new_zeros(g, nh, p, n) if ds is None else ds.contiguous())
        grads = ssd_stage1_backward_cuda(u, dac, b, c, dy, ds)
        return tuple(gr if need else None for gr, need in zip(grads, ctx.needs_input_grad))


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
    return chunked_ssd(SSDStage1Function.apply, x, dt, a, b_in, c_in, chunk=chunk, h0=h0)
