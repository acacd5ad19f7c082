"""Operand layouts for the fused batch axis: system-major or interleaved.

The counterpart of ``repro.core.tridiag.layout``. The executors take a batch
of tridiagonal systems as four fused 1-D operands (``Σ nᵢ`` rows, systems
one after another; see :func:`~repro_torch.core.tridiag.ragged.fuse_ragged`).
That *system-major* order keeps each system contiguous, which is what the
chunked path slices. The *interleaved* layout regathers the operands to

    wide[p, r, i]  =  operand of system ``i``, block ``p``, in-block row ``r``

of shape ``(P, m, B)``, with the systems on the fastest axis. On the card a
warp's 32 threads then work 32 systems at the same local row and read 32
adjacent values, and the Stage-2 reduced solve becomes B parallel scans of
length P on ``(P, B)`` rows instead of one serial scan of ``Σ Pᵢ`` rows.

Ragged batches pad each system to ``P_max`` blocks with identity blocks
(dl = 0, d = 1, du = 0, b = 0). The padding is exact: fused ragged operands
have each system's boundary couplings zeroed, so an identity block gives
zero spikes, a decoupled unit row in the reduced system, and s = 0.

:func:`resolve_layout` is shared by both executors: ``"auto"`` interleaves
only on the fused path, only flat (unstacked) batches of at least
:data:`AUTO_INTERLEAVE_MIN_BATCH` systems, and only while ragged padding
inflates the footprint by at most :data:`AUTO_INTERLEAVE_MAX_WASTE`.
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.tridiag import partition
from repro_torch.core.tridiag.partition import PartitionCoeffs
from repro_torch.core.tridiag.thomas import thomas

Tensor = torch.Tensor

LAYOUTS = ("system-major", "interleaved", "auto")

#: ``"auto"`` interleaves a fused batch only at B >= this many systems (the
#: reference's value, kept for parity).
AUTO_INTERLEAVE_MIN_BATCH = 32

#: ... and only while identity-padding ragged systems to ``P_max`` blocks
#: inflates the operands by at most this factor (the reference's value).
AUTO_INTERLEAVE_MAX_WASTE = 1.5


def resolve_layout(
    layout: str,
    sizes: Sequence[int],
    m: int,
    *,
    fused: bool,
    lead_ndim: int = 0,
    batch_shards: int = 1,
) -> str:
    """Resolve a config layout to a concrete one for a given batch.

    ``fused`` says which executor asks; ``lead_ndim`` counts the stacked
    leading dims of the operands (``solve`` on (K, n) inputs). The
    transforms are defined on flat fused operands only, so stacked inputs
    stay system-major, and asking for ``"interleaved"`` with them is an
    error. ``batch_shards`` is the lane-axis shard count of a mesh (1
    without one): ``"auto"`` compares the per-shard lane count.
    """
    if layout not in LAYOUTS:
        raise ValueError(f"layout must be one of {LAYOUTS}, got {layout!r}")
    if batch_shards < 1:
        raise ValueError(f"batch_shards must be >= 1, got {batch_shards}")
    if layout == "system-major":
        return "system-major"
    if layout == "interleaved":
        if lead_ndim:
            raise ValueError(
                "layout='interleaved' requires flat fused operands; got "
                f"{lead_ndim} stacked leading dim(s): use solve_batched/"
                "solve_many or layout='system-major'"
            )
        return "interleaved"
    if lead_ndim or not fused:
        return "system-major"
    bsz = len(sizes)
    if bsz // batch_shards < AUTO_INTERLEAVE_MIN_BATCH:
        return "system-major"
    total = sum(sizes)
    padded = max(n // m for n in sizes) * m * bsz
    if padded > AUTO_INTERLEAVE_MAX_WASTE * total:
        return "system-major"
    return "interleaved"


def _check_sizes(sizes: Sequence[int], m: int) -> Tuple[int, ...]:
    sizes = tuple(int(n) for n in sizes)
    if not sizes:
        raise ValueError("sizes must name at least one system")
    for n in sizes:
        if n <= 0 or n % m:
            raise ValueError(f"system size {n} not divisible by m={m}")
    return sizes


@functools.lru_cache(maxsize=512)
def _index_maps(sizes: Tuple[int, ...], m: int) -> Tuple[np.ndarray, np.ndarray]:
    """Gather maps for one ragged fused batch shape.

    Returns ``(fwd, inv)``: ``fwd`` is (P_max, m, B) into the fused array
    extended by one fill slot at index ``total``; ``inv`` is (total,) into
    the flattened (P_max·m·B,) wide array. Cached: serving replays a small
    set of batch shapes.
    """
    sizes = _check_sizes(sizes, m)
    bsz = len(sizes)
    total = sum(sizes)
    p_max = max(n // m for n in sizes)
    fwd = np.full((p_max * m, bsz), total, dtype=np.int64)
    inv = np.empty(total, dtype=np.int64)
    off = 0
    for i, n in enumerate(sizes):
        rows = np.arange(n, dtype=np.int64)
        fwd[:n, i] = off + rows
        # the wide flat index of (p, r, i) is (p·m + r)·B + i = row·B + i
        inv[off : off + n] = rows * bsz + i
        off += n
    return fwd.reshape(p_max, m, bsz), inv


@functools.lru_cache(maxsize=64)
def _device_maps(sizes: Tuple[int, ...], m: int, device: torch.device) -> Tuple[Tensor, Tensor]:
    """``(fwd, inv)`` of :func:`_index_maps` as tensors on ``device``, kept
    so that a repeated ragged batch shape copies its maps host→device once.
    Fewer entries than the host LRU: each holds about 2·B·P_max·m int64
    values of device memory."""
    fwd, inv = _index_maps(sizes, m)
    return torch.from_numpy(fwd).to(device), torch.from_numpy(inv).to(device)


def _uniform(sizes: Tuple[int, ...]) -> bool:
    # Same-size batches interleave by a reshape and a permute: no maps.
    return len(set(sizes)) == 1


Maps = Optional[Tuple[Tensor, Tensor]]


def gather_maps(sizes: Sequence[int], m: int, device: torch.device) -> Maps:
    """The ``(fwd, inv)`` maps that :func:`interleave` and
    :func:`deinterleave` read on ``device`` for this batch shape, None for a
    same-size batch. A caller that captures the gathers into a CUDA graph
    passes them in and holds them for the graph's life: the LRU behind them
    may drop its entry, and the graph reads their addresses."""
    sizes = _check_sizes(sizes, m)
    return None if _uniform(sizes) else _device_maps(sizes, m, device)


def interleave(
    a: Tensor, sizes: Sequence[int], m: int, *, fill: float = 0.0, maps: Maps = None
) -> Tensor:
    """Regather one fused (Σnᵢ,) operand to a contiguous wide (P_max, m, B).

    Ragged systems are padded with ``fill`` (1.0 for the diagonal, so padded
    blocks are identity rows and never divide by zero). ``maps``: see
    :func:`gather_maps` (looked up when not given).
    """
    sizes = _check_sizes(sizes, m)
    if _uniform(sizes):
        return a.reshape(len(sizes), sizes[0] // m, m).permute(1, 2, 0).contiguous()
    fwd, _ = maps if maps is not None else _device_maps(sizes, m, a.device)
    a_ext = torch.cat([a, a.new_full((1,), fill)])
    return a_ext[fwd]


def interleave_operands(
    dl: Tensor, d: Tensor, du: Tensor, b: Tensor, sizes: Sequence[int], m: int, *,
    maps: Maps = None,
) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """Interleave all four fused operands; padding forms identity blocks."""
    return (
        interleave(dl, sizes, m, fill=0.0, maps=maps),
        interleave(d, sizes, m, fill=1.0, maps=maps),
        interleave(du, sizes, m, fill=0.0, maps=maps),
        interleave(b, sizes, m, fill=0.0, maps=maps),
    )


def deinterleave(xw: Tensor, sizes: Sequence[int], m: int, *, maps: Maps = None) -> Tensor:
    """Regather a wide (P_max, m, B) solution back to a fused (Σnᵢ,) one.
    ``maps``: see :func:`gather_maps`."""
    sizes = _check_sizes(sizes, m)
    if _uniform(sizes):
        return xw.permute(2, 0, 1).reshape(sum(sizes))
    _, inv = maps if maps is not None else _device_maps(sizes, m, xw.device)
    return xw.reshape(-1)[inv]


# ------------------------------------------------------ plain wide stages --
# The same algebra as :mod:`.partition` on (P, m, B) operands, built on the
# system-major reference stages through transposes. They are the default
# wide stages of every backend and the plain versions of the wide kernels.
def _to_systems(a: Tensor) -> Tensor:
    """(P, k, B) → (B, P·k): each lane's rows in order."""
    p, k, bsz = a.shape
    return a.permute(2, 0, 1).reshape(bsz, p * k)


def partition_stage1_wide(
    dlw: Tensor, dw: Tensor, duw: Tensor, bw: Tensor, *, m: int, zero_ends: bool = False
) -> PartitionCoeffs:
    """Stage 1 on wide operands: spikes (P, m-1, B), reduced rows (P, B).

    Operands are (P, m, B) blocks, or (n, B) rows of any row count n, cut
    into P = ⌈n/m⌉ blocks whose rows past n are identity rows (d = 1, the
    rest 0). ``zero_ends`` reads each lane's dl[0] and du[n-1] as zero, as a
    Thomas solve ignores them. Both act on copies; the operands are never
    written. The next-block shift of the reduced rows runs along P and is
    zero at p = P-1, as on each system-major system.
    """
    if dw.ndim == 3:
        dlw, dw, duw, bw = (a.reshape(-1, a.shape[-1]) for a in (dlw, dw, duw, bw))
    n, bsz = dw.shape
    p = -(-n // m)
    if n < p * m or zero_ends:

        def rows(a: Tensor, fill: float) -> Tensor:
            out = a.new_full((p * m, bsz), fill)
            out[:n] = a
            return out

        dlw, dw, duw, bw = rows(dlw, 0.0), rows(dw, 1.0), rows(duw, 0.0), rows(bw, 0.0)
        if zero_ends:
            dlw[0] = 0.0
            duw[n - 1] = 0.0
    dlw, dw, duw, bw = (a.reshape(p, m, bsz) for a in (dlw, dw, duw, bw))
    c = partition.partition_stage1(*(_to_systems(a) for a in (dlw, dw, duw, bw)), m)
    return PartitionCoeffs(
        *(a.permute(1, 2, 0) for a in (c.y, c.v, c.w)),
        *(a.T for a in (c.red_dl, c.red_d, c.red_du, c.red_b)),
    )


def thomas_wide(red_dl: Tensor, red_d: Tensor, red_du: Tensor, red_b: Tensor) -> Tensor:
    """Reduced solve on (P, B) rows: B independent Thomas solves along axis 0."""
    return thomas(red_dl.T, red_d.T, red_du.T, red_b.T).T


def partition_stage3_wide(coeffs: PartitionCoeffs, s: Tensor) -> Tensor:
    """Back substitution on wide coeffs and (P, B) interface values →
    (P, m, B). Row 0 of every lane is a system's first block, so s_{p-1} is
    zero there. ``s`` is cast to the spikes' precision."""
    p, mi, bsz = coeffs.y.shape
    sys_coeffs = PartitionCoeffs(
        *(a.permute(2, 0, 1) for a in coeffs[:3]), *(a.T for a in coeffs[3:])
    )
    x = partition.partition_stage3(sys_coeffs, s.to(coeffs.y.dtype).T)
    return x.reshape(bsz, p, mi + 1).permute(1, 2, 0)
