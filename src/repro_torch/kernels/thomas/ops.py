"""Batched Thomas solve: CUDA kernel wrapper, a recursive partition solve.

Replaces ``repro.kernels.thomas`` (the ``_thomas_kernel`` Pallas body as
reached from ``thomas_pallas`` and ``thomas_pallas_wide``). On the main path
it is the fused executor's device Stage 2, the reduced solve:
:func:`thomas_cuda` on (B, n) rows (a 1-D system runs as a batch of one),
:func:`thomas_cuda_wide` on the interleaved layout's (P, B) rows. The two
routes count their launches apart. The plain versions are
:func:`repro_torch.core.tridiag.thomas.thomas` and
:func:`repro_torch.core.tridiag.layout.thomas_wide`.

A chain of 2n dependent steps on one thread per system is what bounds a
Thomas solve on this card, so on CUDA tensors a system of more than
:data:`N0` rows is solved by the partition method applied to itself
(:func:`solve_levels`): Stage 1 with m = :data:`R` (``csrc/partition_stage1
.cu``, or ``partition_stage1_wide.cu`` on (n, B) rows), the reduced rows
recursively, then Stage 3 with m = R. ``csrc/thomas.cu``'s one-thread body
solves the last level of at most N0 rows. The answer agrees with Thomas's to
rounding; it is not the same sequence of operations. Each call, all levels
included, adds one to its route's launch counter and nothing to the Stage 1
or Stage 3 counters.

Neither route copies the caller's rows when r divides n: both Stage 1
kernels read each system's dl[0] and du[n-1] as zero. The wide Stage 1 also
takes a row count, reading the rows past n as identity rows without loading
them, so the wide route never copies them: at one level (n ≤ R·N0) a call is
three launches, Stage 1, the base and Stage 3.
"""

from __future__ import annotations

import ctypes
from typing import Any, Callable, List, Optional, Sequence, Tuple

import torch

from repro_torch.core.tridiag.layout import thomas_wide
from repro_torch.core.tridiag.thomas import thomas
from repro_torch.kernels import common
from repro_torch.kernels.partition_stage1.ops import run_stage1, run_stage1_wide
from repro_torch.kernels.partition_stage3.ops import run_stage3, run_stage3_wide

THOMAS_LAUNCHES = common.LaunchCounter("thomas")
THOMAS_WIDE_LAUNCHES = common.LaunchCounter("thomas_wide")

#: Rows per sub-block at every level of the reduced solve.
R = 32
#: Base size: a level of at most N0 rows goes to the one-thread chain. A
#: level costs about as much as the chain of some 600-800 rows (its
#: launches, with the host's work of enqueuing them), so below that the
#: chain alone is faster (chip_smoke.py's n0 sweep).
N0 = 512

Tensor = torch.Tensor


def padded_rows(n: int, r: int = R, n0: int = N0) -> int:
    """Rows a level of ``n`` rows occupies: a multiple of ``r`` when it is
    cut again (``n > n0``), else ``n``."""
    return common.round_up(n, r) if n > n0 else n


def level_sizes(n: int, r: int = R, n0: int = N0) -> List[int]:
    """Rows per system at each level, the caller's first, the base's last:
    1e6 → 31250 → 977 → 31 at r = 32, n0 = 512."""
    sizes = [n]
    while sizes[-1] > n0:
        sizes.append(common.cdiv(sizes[-1], r))
    return sizes


def _level0(ops: Sequence[Tensor], rows: int) -> List[Tensor]:
    """The caller's (B, n) operands copied into ``rows`` rows a system: the
    rows past n are identity rows (d = 1, the rest 0), and dl[0] and du[n-1],
    which Thomas ignores but the partition couples through, are zero. The
    caller's tensors are never written."""
    dl, d, du, b = ops
    bsz, n = d.shape
    buf = d.new_zeros((4, bsz, rows))
    buf[0, :, 1:n].copy_(dl[:, 1:])
    buf[1, :, :n].copy_(d)
    buf[2, :, : n - 1].copy_(du[:, : n - 1])
    buf[3, :, :n].copy_(b)
    if rows > n:
        buf[1, :, n:] = 1.0
    return list(buf)


def _pad_rows(red: Sequence[Tensor], rows: int) -> List[Tensor]:
    """A level's (B, P) reduced rows as the next level's operands of
    ``rows`` rows a system. Rows that a stage wrote already padded are
    taken as they are; shorter ones are copied above identity rows."""
    bsz, p = red[1].shape
    if p == rows:
        return list(red)
    buf = red[1].new_zeros((4, bsz, rows))
    for dst, src in zip(buf, red):
        dst[:, :p].copy_(src)
    buf[1, :, p:] = 1.0
    return list(buf)


def solve_levels(
    dl: Tensor,
    d: Tensor,
    du: Tensor,
    b: Tensor,
    *,
    stage1: Callable[..., Any],
    stage3: Callable[[Any, Tensor], Tensor],
    base: Callable[[Tensor, Tensor, Tensor, Tensor], Tensor],
    wide: bool,
    r: int = R,
    n0: int = N0,
    ends_ignored: bool = False,
) -> Tensor:
    """Solve B tridiagonal systems by the partition method applied to itself.

    Operands are (B, n) rows, or (n, B) rows with ``wide``. While a level
    has more than ``n0`` rows it goes through Stage 1 with m = ``r``, whose
    reduced rows are the next level; ``base(dl, d, du, b)`` solves the last
    level, and ``stage3(coeffs, s)`` — (B, N), or (N/r, r, B) — climbs
    back.

    - System-major: ``stage1(dl, d, du, b, m=r)`` on (B, N) operands, N a
      multiple of r, whose reduced rows (P per system, or already padded)
      are padded with identity rows for the next level. Only the first
      level copies the caller's operands: always, or with ``ends_ignored``
      (``stage1`` reads each system's dl[0] and du[n-1] as zero, as Thomas
      ignores them) only when n needs padding.
    - Wide: ``stage1(dl, d, du, b, m=r, zero_ends=True)`` on (n, B) rows of
      any n: ⌈n/r⌉ blocks, the rows past n identity rows, dl[0] and du[n-1]
      read as zero. The caller's rows go in as they are, and each level's
      reduced rows (P, or more already padded with identity rows) are the
      next level's rows: no level copies.

    The systems must not need pivoting, as in Stage 1: a strictly
    diagonally dominant system has a strictly diagonally dominant reduced
    system.
    """
    axis = 0 if wide else 1
    n = d.shape[axis]
    if n <= n0:
        return base(dl, d, du, b)
    if wide:
        ops = [dl, d, du, b]
    else:
        rows = common.round_up(n, r)
        ops = [dl, d, du, b] if ends_ignored and rows == n else _level0((dl, d, du, b), rows)
    levels: List[Tuple[Any, int]] = []
    while n > n0:
        if wide:
            p = common.cdiv(n, r)
            coeffs = stage1(*ops, m=r, zero_ends=True)
            ops = list(coeffs[3:])
        else:
            p = ops[1].shape[1] // r
            coeffs = stage1(*ops, m=r)
            ops = _pad_rows(coeffs[3:], padded_rows(p, r, n0))
        levels.append((coeffs, n))
        n = p
    x = base(*ops)
    for coeffs, rows in reversed(levels):
        x = stage3(coeffs, x)
        if wide:
            x = x.reshape(-1, x.shape[-1])
        x = x.narrow(axis, 0, rows).contiguous()
    return x


_P = ctypes.c_void_p
_BASE_ARGS = (_P,) * 6 + (ctypes.c_longlong,) * 4 + (_P,)


def _launch_base(
    dl: Tensor, d: Tensor, du: Tensor, b: Tensor, wide: bool, stream: Optional[int] = None
) -> Tensor:
    """csrc/thomas.cu's one-thread-per-system body on contiguous (B, n) or,
    with ``wide``, (n, B) CUDA operands, uncounted. ``stream``: see
    :func:`repro_torch.kernels.common.call`."""
    name = "thomas_wide" if wide else "thomas"
    suffix = common.check_kernel_operands(name, (dl, d, du, b), [d.shape] * 4)
    # (n, B) rows: row stride B, system stride 1; (B, n): 1 and n.
    (n, nsys) = tuple(d.shape) if wide else tuple(d.shape)[::-1]
    rs, ss = (nsys, 1) if wide else (1, n)
    x, dhat = torch.empty((2,) + tuple(d.shape), dtype=d.dtype, device=d.device).unbind(0)
    common.call(
        name, "thomas", f"thomas_{suffix}", _BASE_ARGS, d.device,
        [t.data_ptr() for t in (dl, d, du, b, x, dhat)] + [nsys, n, rs, ss], stream,
    )
    return x


def thomas_levels_cuda(
    dl: Tensor, d: Tensor, du: Tensor, b: Tensor, *, wide: bool, r: int = R, n0: int = N0
) -> Tensor:
    """The reduced solve on CUDA operands, (B, n) or with ``wide`` (n, B),
    through the Stage 1, Stage 3 and base kernels, uncounted: every launch on
    the device's current stream, looked up once."""
    common.check_kernel_operands("thomas_wide" if wide else "thomas", (dl, d, du, b), [d.shape] * 4)
    with torch.cuda.device(d.device):
        stream = torch.cuda.current_stream(d.device).cuda_stream
        if wide:
            def stage1(dl: Tensor, d: Tensor, du: Tensor, b: Tensor, *, m: int,
                       zero_ends: bool) -> Any:
                return run_stage1_wide(dl, d, du, b, m,
                                       red_rows=padded_rows(common.cdiv(d.shape[0], m), r, n0),
                                       zero_ends=zero_ends, stream=stream)

            def stage3(c: Any, s: Tensor) -> Tensor:
                return run_stage3_wide(c.y, c.v, c.w, s, stream=stream)
        else:
            left = d.new_zeros(d.shape[0])

            def stage1(dl: Tensor, d: Tensor, du: Tensor, b: Tensor, *, m: int) -> Any:
                return run_stage1(dl, d, du, b, m, red_rows=padded_rows(d.shape[-1] // m, r, n0),
                                  zero_ends=True, stream=stream)

            def stage3(c: Any, s: Tensor) -> Tensor:
                return run_stage3(c.y, c.v, c.w, s, left, stream=stream)

        def base(dl: Tensor, d: Tensor, du: Tensor, b: Tensor) -> Tensor:
            return _launch_base(dl, d, du, b, wide, stream)

        return solve_levels(dl, d, du, b, stage1=stage1, stage3=stage3, base=base, wide=wide,
                            r=r, n0=n0, ends_ignored=True)


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
        x = thomas_levels_cuda(*(a.reshape(-1, a.shape[-1]) for a in (dl, d, du, b)), wide=False)
        THOMAS_LAUNCHES.add()
        return x.reshape(d.shape)
    return thomas(dl, d, du, b)


def thomas_cuda_wide(dl: Tensor, d: Tensor, du: Tensor, b: Tensor) -> Tensor:
    """Solve B independent systems laid out as (n, B) rows, along axis 0:
    the interleaved layout's reduced solve on (P, B) rows."""
    if d.ndim != 2:
        raise ValueError(f"thomas_wide takes interleaved (n, B) operands, got {tuple(d.shape)}")
    _check(dl, d, du, b, d.shape[0])
    if common.on_cuda(dl, d, du, b):
        x = thomas_levels_cuda(dl, d, du, b, wide=True)
        THOMAS_WIDE_LAUNCHES.add()
        return x
    return thomas_wide(dl, d, du, b)
