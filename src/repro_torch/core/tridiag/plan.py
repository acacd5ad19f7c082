"""Plan/execute layer of the port: one execution path for every solve.

The counterpart of ``repro.core.tridiag.plan``. A
:class:`SolvePlan` is an immutable layout decision: which systems are fused
onto the block axis, where the chunk ("stream") boundaries fall, which halo
block each chunk carries, and where each system's solution lives in the
fused vector; a shard-aligned plan also splits the block axis into equal
spans, one a device. The chunk count is given explicitly or priced by a
:class:`ChunkPolicy` (:func:`price_chunks` is the one pricing rule, shared
with the serving path).

Two executors run a plan, and both return the solution with a
:class:`ChunkTiming`:

- :class:`FusedExecutor` runs it on one device, or sharded over a device
  list (``mesh=``, :func:`_fused_sharded`), with no host round trip
  between the stages. System-major: per chunk, Stage 1 on the chunk plus its
  halo block; one reduced (Stage-2) solve of all chunks' reduced rows on the
  device; per chunk, Stage 3 with the left neighbour's interface value
  passed in. Interleaved (:mod:`.layout`): interleave, wide Stage 1, B
  parallel reduced solves, wide Stage 3, deinterleave; the plan's chunks do
  not apply there. Only the total time is observable.
- :class:`PlanExecutor` is the staged path of the paper: each chunk's rows
  go host→device and through Stage 1 on the chunk's own CUDA stream without
  blocking, the reduced rows come back to the host, which solves the reduced
  system in fp64, and Stage 3 runs per chunk on its stream again. Its
  :class:`ChunkTiming` carries the per-phase times of the Eq. 5 model.

*How* the stages run is a :class:`StageBackend`: :class:`ReferenceBackend`
(the plain PyTorch stages of :mod:`.partition` and :mod:`.layout`) or
:class:`CudaBackend` (the hand-written kernels of :mod:`repro_torch.kernels`).
``"auto"`` resolves to the kernels on a CUDA device and to the reference
stages on the CPU.

Plans are memoised by their ``(sizes, m, num_chunks, shards)`` signature in
a bounded, lock-protected LRU: a session solves from its worker thread and its caller's
thread at once, and serving traffic repeats batch compositions. Beside it, a
second LRU keeps the fused path's executables (on a CUDA device, a CUDA graph
of its stages; see :func:`executable_cache_stats`).
"""

from __future__ import annotations

import contextlib
import ctypes
import threading
import time
from collections import OrderedDict
from dataclasses import dataclass
from functools import partial
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.core.tridiag import layout as layout_mod
from repro_torch.core.tridiag import partition
from repro_torch.core.tridiag.batched import as_tensor
from repro_torch.core.tridiag.layout import resolve_layout
from repro_torch.core.tridiag.reference import thomas_numpy
from repro_torch.core.tridiag.thomas import thomas
from repro_torch.device import resolve_device
from repro_torch.parallel.solver import mesh_signature, resolve_mesh_devices, shard_count

Sizes = Union[int, Sequence[int]]
Tensor = torch.Tensor


@dataclass
class ChunkTiming:
    """Host-clock phase breakdown of one planned solve (milliseconds).

    The staged executor fills every phase; the fused one only
    ``t_total_ms`` (its stages run with no host round trip between them)."""

    num_chunks: int
    t_stage1_ms: float
    t_stage2_ms: float
    t_stage3_ms: float
    t_total_ms: float
    n: int = 0

    @property
    def phases(self) -> Tuple[float, float, float]:
        return (self.t_stage1_ms, self.t_stage2_ms, self.t_stage3_ms)


def effective_size(sizes: Sizes) -> int:
    """Effective element count ``Σ nᵢ`` of a (possibly ragged) fused batch:
    the size feature the stream heuristic prices it by."""
    if isinstance(sizes, (int, np.integer)):
        return int(sizes)
    return int(sum(int(n) for n in sizes))


# ------------------------------------------------------------ stage backends --
class StageBackend:
    """How the executor's device stages are implemented.

    ``make_stage1(m)`` returns ``(dl, d, du, b) -> PartitionCoeffs``;
    ``make_stage3()`` returns ``(coeffs, s, left) -> x``, where ``left`` is
    s_{p-1} of each system's first block; ``make_reduced_solve()`` returns
    the device Stage-2 solver ``(red_dl, red_d, red_du, red_b) -> s``. All
    take operands with an optional leading batch axis.

    The ``make_wide_*`` trio are their counterparts on the interleaved
    layout (:mod:`.layout`): wide Stage 1 takes (P, m, B) diagonals and
    returns spikes (P, m-1, B) and reduced rows (P, B); the wide reduced
    solve runs B independent solves on (P, B) rows; wide Stage 3 returns the
    (P, m, B) solution. The defaults are the plain wide stages, so every
    backend serves ``layout="interleaved"``.

    ``capturable``: the fused executor may capture the backend's stages
    into a CUDA graph. Only a backend whose stages launch a fixed set of
    kernels and never wait on the device may say so.
    """

    name = "abstract"
    capturable = False

    def make_stage1(self, m: int) -> Callable[..., partition.PartitionCoeffs]:
        raise NotImplementedError

    def make_stage3(self) -> Callable[..., Tensor]:
        raise NotImplementedError

    def make_reduced_solve(self) -> Callable[..., Tensor]:
        return thomas

    def make_wide_stage1(self, m: int) -> Callable[..., partition.PartitionCoeffs]:
        return partial(layout_mod.partition_stage1_wide, m=m)

    def make_wide_stage3(self) -> Callable[..., Tensor]:
        return layout_mod.partition_stage3_wide

    def make_wide_reduced_solve(self) -> Callable[..., Tensor]:
        return layout_mod.thomas_wide


@dataclass(frozen=True)
class ReferenceBackend(StageBackend):
    """Plain PyTorch stages (:mod:`repro_torch.core.tridiag.partition`).

    Not capturable: its reduced solve is a Python loop over the rows, a few
    launches a row, so a graph of it would hold tens of thousands of nodes
    a signature; it serves as the plain version the kernels are held to."""

    name = "reference"

    def make_stage1(self, m: int) -> Callable[..., partition.PartitionCoeffs]:
        return partial(partition.partition_stage1, m=m)

    def make_stage3(self) -> Callable[..., Tensor]:
        return partition.partition_stage3


@dataclass(frozen=True)
class CudaBackend(StageBackend):
    """The hand-written kernels (:mod:`repro_torch.kernels`).

    Operands with a leading batch axis go to the batched wrappers (the fused
    executor flattens several leading dims to one before). On CUDA
    tensors every wrapper launches its kernel or raises; on CPU tensors it
    runs its plain version, which is how the CPU tests drive this backend.
    """

    name = "cuda"
    capturable = True

    def make_stage1(self, m: int) -> Callable[..., partition.PartitionCoeffs]:
        from repro_torch.kernels.partition_stage1.ops import (
            partition_stage1_cuda,
            partition_stage1_cuda_batched,
        )

        def stage1(dl: Tensor, d: Tensor, du: Tensor, b: Tensor) -> partition.PartitionCoeffs:
            if d.ndim == 1:
                return partition_stage1_cuda(dl, d, du, b, m=m)
            if d.ndim == 2:
                return partition_stage1_cuda_batched(dl, d, du, b, m=m)
            raise ValueError(
                f"CudaBackend stage 1 takes (n,) or (batch, n) operands, got {d.ndim}-D"
            )

        return stage1

    def make_stage3(self) -> Callable[..., Tensor]:
        from repro_torch.kernels.partition_stage3.ops import (
            partition_stage3_cuda,
            partition_stage3_cuda_batched,
        )

        def stage3(coeffs: partition.PartitionCoeffs, s: Tensor, left: Optional[Tensor] = None) -> Tensor:
            if s.ndim == 1:
                return partition_stage3_cuda(coeffs, s, left)
            if s.ndim == 2:
                return partition_stage3_cuda_batched(coeffs, s, left)
            raise ValueError(
                f"CudaBackend stage 3 takes (P,) or (batch, P) interface values, got {s.ndim}-D"
            )

        return stage3

    def make_reduced_solve(self) -> Callable[..., Tensor]:
        from repro_torch.kernels.thomas.ops import thomas_cuda

        return thomas_cuda

    def make_wide_stage1(self, m: int) -> Callable[..., partition.PartitionCoeffs]:
        from repro_torch.kernels.partition_stage1.ops import partition_stage1_cuda_wide

        return partial(partition_stage1_cuda_wide, m=m)

    def make_wide_stage3(self) -> Callable[..., Tensor]:
        from repro_torch.kernels.partition_stage3.ops import partition_stage3_cuda_wide

        return partition_stage3_cuda_wide

    def make_wide_reduced_solve(self) -> Callable[..., Tensor]:
        from repro_torch.kernels.thomas.ops import thomas_cuda_wide

        return thomas_cuda_wide


@dataclass(frozen=True)
class AutoBackend(StageBackend):
    """Device-resolved backend: the kernels on a CUDA device, the reference
    stages on the CPU. :func:`resolve_backend` unwraps it."""

    name = "auto"

    def resolve(self, device: torch.device) -> StageBackend:
        return BACKENDS["cuda" if device.type == "cuda" else "reference"]


#: Registry consulted when ``backend=`` is given as a string.
BACKENDS: Dict[str, StageBackend] = {
    b.name: b for b in (ReferenceBackend(), CudaBackend(), AutoBackend())
}

BackendLike = Union[StageBackend, str, None]


def resolve_backend(backend: BackendLike, device: Optional[torch.device] = None) -> StageBackend:
    """Normalise a ``backend=`` argument: None → reference, str → registry,
    ``"auto"`` → the kernels on a CUDA ``device``, the reference stages on
    the CPU (or with no device given)."""
    if backend is None:
        return BACKENDS["reference"]
    if isinstance(backend, str):
        try:
            backend = BACKENDS[backend]
        except KeyError:
            raise ValueError(
                f"unknown stage backend {backend!r}; known: {sorted(BACKENDS)}"
            ) from None
    if isinstance(backend, AutoBackend):
        return backend.resolve(device if device is not None else torch.device("cpu"))
    if isinstance(backend, StageBackend):
        return backend
    raise TypeError(f"backend must be a StageBackend, name or None, got {backend!r}")


# ------------------------------------------------------------ chunk policies --
def price_chunks(heuristic: Any, sizes: Sizes, *, fp32: bool = False) -> int:
    """THE chunk-pricing rule: one heuristic call for every entry point.

    Heuristics exposing ``predict_optimum_ragged`` are preferred; plain 1-D
    heuristics are priced at the batch's effective size ``Σ nᵢ``. The
    paper's FP32 rule (§3.2: halve the FP64 optimum) applies on top. The
    result is clamped to ``>= 1``.
    """
    if isinstance(sizes, (int, np.integer)):
        sizes = (int(sizes),)
    sizes = tuple(int(n) for n in sizes)
    if fp32 and hasattr(heuristic, "predict_optimum_fp32"):
        k = int(heuristic.predict_optimum_fp32(float(effective_size(sizes))))
    elif hasattr(heuristic, "predict_optimum_ragged"):
        k = int(heuristic.predict_optimum_ragged(sizes))
        if fp32:
            k //= 2
    else:
        k = int(heuristic.predict_optimum(float(effective_size(sizes))))
        if fp32:
            k //= 2
    return max(1, k)


class ChunkPolicy:
    """Strategy choosing the chunk ("stream") count for a plan; `build_plan`
    clamps the answer to ``[1, num_blocks]``."""

    def num_chunks(self, sizes: Tuple[int, ...], m: int) -> int:
        raise NotImplementedError


@dataclass(frozen=True)
class FixedChunkPolicy(ChunkPolicy):
    """Always use ``k`` chunks (the paper's fixed-``num_str`` baseline)."""

    k: int

    def num_chunks(self, sizes: Tuple[int, ...], m: int) -> int:
        return self.k


@dataclass(frozen=True)
class HeuristicChunkPolicy(ChunkPolicy):
    """Price the batch by its effective size through a fitted heuristic
    (a ``StreamHeuristic`` or ``BatchedStreamHeuristic``), via
    :func:`price_chunks`."""

    heuristic: object
    fp32: bool = False

    def num_chunks(self, sizes: Tuple[int, ...], m: int) -> int:
        return price_chunks(self.heuristic, sizes, fp32=self.fp32)


# ----------------------------------------------------------------- the plan --
@dataclass(frozen=True)
class SolvePlan:
    """Immutable layout of one fused chunked partition solve.

    ``sizes`` lists the fused systems in order; ``chunk_bounds`` are
    half-open block-index ranges over the fused block axis; ``halo_bounds``
    extend each chunk by its one right halo block (a chunk's last reduced row
    references the next block's spikes); ``offsets`` is the per-system
    element offset table (length B+1).

    ``shards`` is the shard-aligned mode (``build_plan(..., shards=S)``): the
    block axis is split into ``S`` equal spans (``S`` divides ``num_blocks``
    and ``num_chunks``), every span boundary is a chunk boundary, and every
    span carries the same chunk layout, so each device of a mesh can own one
    span, needs only the next span's first block as its halo, and runs the
    same chunk loop (:attr:`local_chunk_bounds`). ``shards=1`` is the
    unsharded plan.
    """

    m: int
    sizes: Tuple[int, ...]
    chunk_bounds: Tuple[Tuple[int, int], ...]
    halo_bounds: Tuple[Tuple[int, int], ...]
    offsets: Tuple[int, ...]
    shards: int = 1

    @property
    def total_size(self) -> int:
        return self.offsets[-1]

    @property
    def num_blocks(self) -> int:
        return self.total_size // self.m

    @property
    def num_chunks(self) -> int:
        return len(self.chunk_bounds)

    @property
    def blocks_per_shard(self) -> int:
        return self.num_blocks // self.shards

    @property
    def local_chunk_bounds(self) -> Tuple[Tuple[int, int], ...]:
        """One shard's chunk bounds, relative to the shard's first block:
        the same in every shard by construction."""
        return self.chunk_bounds[: self.num_chunks // self.shards]


# ------------------------------------------------------------- plan cache --
# _CACHE_LOCK guards the plan LRU, its counters and its capacity: sessions
# plan from their worker thread and their callers' threads at once.
_CACHE_LOCK = threading.RLock()
_PLAN_CACHE_CAPACITY = 1024
_PLAN_CACHE: "OrderedDict[Tuple[Tuple[int, ...], int, int, int], SolvePlan]" = OrderedDict()
_PLAN_STATS = {"hits": 0, "misses": 0}


def plan_cache_stats() -> Dict[str, int]:
    """Hit/miss counters of the build_plan memo (plus its current size)."""
    with _CACHE_LOCK:
        return {**_PLAN_STATS, "size": len(_PLAN_CACHE)}


def clear_plan_cache() -> None:
    """Empty the plan memo and reset its counters (test isolation hook)."""
    with _CACHE_LOCK:
        _PLAN_CACHE.clear()
        _PLAN_STATS["hits"] = 0
        _PLAN_STATS["misses"] = 0


def set_plan_cache_capacity(capacity: int) -> None:
    """Resize the plan LRU (process-wide); 0 disables plan memoisation.
    Plans beyond the new capacity are evicted oldest-first."""
    global _PLAN_CACHE_CAPACITY
    if capacity < 0:
        raise ValueError(f"plan cache capacity must be >= 0, got {capacity}")
    with _CACHE_LOCK:
        _PLAN_CACHE_CAPACITY = int(capacity)
        while len(_PLAN_CACHE) > _PLAN_CACHE_CAPACITY:
            _PLAN_CACHE.popitem(last=False)


def build_plan(
    sizes: Sizes,
    m: int = 10,
    *,
    num_chunks: Optional[int] = None,
    policy: Optional[ChunkPolicy] = None,
    shards: int = 1,
) -> SolvePlan:
    """Build the :class:`SolvePlan` for a batch of systems of ``sizes``.

    ``sizes`` is one int (single solve) or a sequence (fused batch, possibly
    ragged). At most one of ``num_chunks``/``policy`` may be given; with
    neither, the plan is unchunked. The chunk count is clamped into
    ``[1, num_blocks]`` (a policy may round to 0 on tiny sizes; an explicit
    ``num_chunks < 1`` is a caller error). Blocks are split as evenly as
    possible, remainder blocks to the leading chunks.

    ``shards`` asks for the shard-aligned mode: the count snaps down to the
    largest divisor of ``num_blocks`` within the request (a block count
    prime to every usable count gives the unsharded plan), the chunk count
    snaps to a multiple of it, and every shard gets the same chunk layout.
    ``shards=1`` is the unsharded plan. Plans are memoised by their
    ``(sizes, m, num_chunks, shards)`` signature.
    """
    if isinstance(sizes, (int, np.integer)):
        sizes = (int(sizes),)
    sizes = tuple(int(n) for n in sizes)
    if not sizes:
        raise ValueError("empty plan: at least one system required")
    if m < 2:
        raise ValueError("sub-system size m must be >= 2")
    for n in sizes:
        if n < m or n % m:
            raise ValueError(f"system size {n} not divisible by m={m}")
    if num_chunks is not None and policy is not None:
        raise ValueError("pass num_chunks or policy, not both")
    if policy is not None:
        k = max(1, int(policy.num_chunks(sizes, m)))
    else:
        k = 1 if num_chunks is None else int(num_chunks)
        if k < 1:
            raise ValueError("num_chunks must be >= 1")

    if shards < 1:
        raise ValueError(f"shards must be >= 1, got {shards}")

    num_blocks = sum(sizes) // m
    k = min(k, num_blocks)
    # Shard-aligned mode: equal spans, each span boundary a chunk boundary.
    shards = shard_count(num_blocks, int(shards))
    if shards > 1:
        per_shard_blocks = num_blocks // shards
        per_shard_chunks = max(1, min(per_shard_blocks, round(k / shards)))
        k = per_shard_chunks * shards

    key = (sizes, m, k, shards)
    with _CACHE_LOCK:
        cached = _PLAN_CACHE.get(key)
        if cached is not None:
            _PLAN_CACHE.move_to_end(key)
            _PLAN_STATS["hits"] += 1
            return cached
        _PLAN_STATS["misses"] += 1

    # k/shards chunks over num_blocks/shards blocks, repeated per shard
    # (one shard: the whole axis), remainder blocks to the leading chunks.
    cps, bps = k // shards, num_blocks // shards
    bounds: List[Tuple[int, int]] = []
    start = 0
    for _ in range(shards):
        for i in range(cps):
            size = bps // cps + (1 if i < bps % cps else 0)
            bounds.append((start, start + size))
            start += size
    halos = tuple((lo, min(hi + 1, num_blocks)) for lo, hi in bounds)
    offsets = [0]
    for n in sizes:
        offsets.append(offsets[-1] + n)
    plan = SolvePlan(
        m=m,
        sizes=sizes,
        chunk_bounds=tuple(bounds),
        halo_bounds=halos,
        offsets=tuple(offsets),
        shards=shards,
    )
    with _CACHE_LOCK:
        # A racing thread may have built the same plan meanwhile; keep its
        # entry so hits keep returning one shared object.
        existing = _PLAN_CACHE.get(key)
        if existing is not None:
            return existing
        _PLAN_CACHE[key] = plan
        while len(_PLAN_CACHE) > _PLAN_CACHE_CAPACITY:
            _PLAN_CACHE.popitem(last=False)
    return plan


# ------------------------------------------------------- executable cache --
# The fused path keeps one executable per (plan, backend, resolved layout,
# device, operand dtype, leading shape) signature (:class:`_FusedExecutable`),
# and a sharded one also by the mesh signature of the devices it shards over.
# The reference's key also names buffer donation, which the port does not
# have. With a capturable backend on a CUDA device, an unsharded entry
# captures its stages into a CUDA graph when its signature is seen the second
# time, and from then on holds device memory (static operands, the graph's
# private pool); every other entry holds the eager stages. So the LRU is bounded in
# entries and, per device, in the bytes its graphs hold: at most
# _EXEC_CACHE_MEMORY_SHARE of the card. Both are guarded by _CACHE_LOCK
# (sessions reach the cache from their worker and caller threads at once).
_EXEC_CACHE_CAPACITY = 128
# A quarter: an evicted graph costs one eager call and a capture when its
# signature comes back, while a card that runs out of memory fails a solve.
# So the graphs leave three quarters of the card to what must fit: eager
# misses, the staged path and the caller's own tensors. On an 80 GB card a
# quarter still holds about 25 graphs of the largest system the paper
# solves (n = 1e7 fp64, about 0.8 GB an entry).
_EXEC_CACHE_MEMORY_SHARE = 0.25
_EXEC_CACHE: "OrderedDict[Tuple[Any, ...], _FusedExecutable]" = OrderedDict()
_EXEC_STATS = {"hits": 0, "misses": 0, "evictions": 0}
_EXEC_BYTES: Dict[torch.device, int] = {}
# Devices whose cached graphs were dropped since the last release. A dropped
# graph's pool stays reserved by torch's allocator, which frees such pools
# only when asked (empty_cache) or when a cudaMalloc fails outside a capture:
# one that fails inside a capture raises. So a capture releases them first.
_EXEC_DROPPED: "set[torch.device]" = set()


def executable_cache_stats() -> Dict[str, int]:
    """Hit/miss/eviction counters of the fused-executable LRU, plus its
    ``size``: the reference's keys. ``bytes`` is the port's own, beside
    them: the device memory its CUDA graphs hold (0 on the CPU)."""
    with _CACHE_LOCK:
        return {**_EXEC_STATS, "size": len(_EXEC_CACHE), "bytes": sum(_EXEC_BYTES.values())}


def clear_executable_cache() -> None:
    """Empty the fused-executable LRU and reset its counters (test hook).
    The graphs dropped give their memory back to torch's allocator once no
    call is replaying them."""
    with _CACHE_LOCK:
        _EXEC_DROPPED.update(dev for dev, nbytes in _EXEC_BYTES.items() if nbytes)
        _EXEC_CACHE.clear()
        _EXEC_BYTES.clear()
        _EXEC_STATS["hits"] = 0
        _EXEC_STATS["misses"] = 0
        _EXEC_STATS["evictions"] = 0


def set_executable_cache_capacity(capacity: int) -> None:
    """Resize the fused-executable LRU (process-wide); 0 disables caching
    (every fused dispatch then runs its stages eagerly and captures nothing:
    only useful to bound device memory under never-repeating traffic).
    Executables beyond the new capacity are evicted oldest-first."""
    global _EXEC_CACHE_CAPACITY
    if capacity < 0:
        raise ValueError(f"executable cache capacity must be >= 0, got {capacity}")
    with _CACHE_LOCK:
        _EXEC_CACHE_CAPACITY = int(capacity)
        while len(_EXEC_CACHE) > _EXEC_CACHE_CAPACITY:
            _evict(next(iter(_EXEC_CACHE)))


def _evict(key: Tuple[Any, ...]) -> None:
    """Drop one entry and its bytes, and count the eviction."""
    with _CACHE_LOCK:  # reentrant: the callers hold it already
        entry = _EXEC_CACHE.pop(key)
        if entry.nbytes:
            _EXEC_BYTES[entry.device] -= entry.nbytes
            _EXEC_DROPPED.add(entry.device)
        _EXEC_STATS["evictions"] += 1


def _release_dropped(device: torch.device) -> None:
    """Give the pools of the graphs dropped on ``device`` back to the card
    (``empty_cache``, which also frees the allocator's other unused cached
    blocks). Called under _CAPTURE_LOCK, so no capture of this process is
    under way; a graph still being replayed by a call gives its pool back at
    a later release."""
    with _CACHE_LOCK:
        dropped = device in _EXEC_DROPPED
        _EXEC_DROPPED.discard(device)
    if dropped:
        torch.cuda.empty_cache()


def _byte_budget(device: torch.device) -> int:
    """The bytes the cached graphs on ``device`` may hold together."""
    total = torch.cuda.get_device_properties(device).total_memory
    return int(_EXEC_CACHE_MEMORY_SHARE * total)


def _charge(entry: "_FusedExecutable", nbytes: int) -> None:
    """Count a graph just captured against its device's byte budget, then
    evict the oldest graph-holding entries on that device until the
    cache is within it: the new entry too, last, when it alone exceeds the
    budget (its call still completes; the signature misses next time). An
    entry evicted while it captured is not counted, but its device is
    marked as holding a dropped graph: its pool goes back at the next
    release after its call ends."""
    budget = _byte_budget(entry.device)
    with _CACHE_LOCK:
        if _EXEC_CACHE.get(entry.key) is not entry:
            _EXEC_DROPPED.add(entry.device)
            return
        entry.nbytes = nbytes
        _EXEC_BYTES[entry.device] = _EXEC_BYTES.get(entry.device, 0) + nbytes
        while _EXEC_BYTES[entry.device] > budget:
            _evict(next(k for k, e in _EXEC_CACHE.items() if e.device == entry.device and e.nbytes))


# -------------------------------------------------------- the fused executor --
_RED_FIELDS = ("red_dl", "red_d", "red_du", "red_b")


def _trim_halo(c: partition.PartitionCoeffs, nb: int) -> partition.PartitionCoeffs:
    """Drop the halo block's rows: its reduced row belongs to the next chunk
    (which recomputes it as an owner), and its spikes only exist to close the
    owner rows' right-neighbour references."""
    return partition.PartitionCoeffs(
        y=c.y[..., :nb, :],
        v=c.v[..., :nb, :],
        w=c.w[..., :nb, :],
        red_dl=c.red_dl[..., :nb],
        red_d=c.red_d[..., :nb],
        red_du=c.red_du[..., :nb],
        red_b=c.red_b[..., :nb],
    )


def _stage3_with_ghost(
    stage3_fn: Callable[..., Tensor],
    coeffs: partition.PartitionCoeffs,
    s_chunk: Tensor,
    s_left_edge: Tensor,
) -> Tensor:
    """Run stage 3 on a chunk whose left neighbour lives in another chunk.

    The reference splices the neighbour's last interface value in as a
    zeroed ghost block prepended to the chunk. Here the stage takes that
    value directly as s_{p-1} of the chunk's first block (``left``), which
    gives the same numbers without copying the chunk's spikes.
    """
    spikes = [a.contiguous() for a in coeffs[:3]]
    return stage3_fn(
        partition.PartitionCoeffs(*spikes, *coeffs[3:]),
        s_chunk.contiguous(),
        s_left_edge.contiguous(),
    )


def _fused(plan: SolvePlan, backend: StageBackend, dl: Tensor, d: Tensor, du: Tensor, b: Tensor) -> Tensor:
    """The system-major three-stage solve of ``plan`` on the operands' device.

    Operands are (n,) or carry leading batch dims; more than one leading dim
    is flattened to one batch axis for the stages and restored after.
    """
    if d.ndim > 2:
        flat = [a.reshape(-1, a.shape[-1]) for a in (dl, d, du, b)]
        return _fused(plan, backend, *flat).reshape(d.shape)
    m = plan.m
    stage1 = backend.make_stage1(m)
    stage3 = backend.make_stage3()
    reduced_solve = backend.make_reduced_solve()

    coeffs = []
    for (lo, hi), (_, hi_halo) in zip(plan.chunk_bounds, plan.halo_bounds):
        chunk = [a[..., lo * m : hi_halo * m].contiguous() for a in (dl, d, du, b)]
        coeffs.append(_trim_halo(stage1(*chunk), hi - lo))
    red = [
        torch.cat([getattr(c, f) for c in coeffs], dim=-1)
        if len(coeffs) > 1
        else getattr(coeffs[0], f).contiguous()
        for f in _RED_FIELDS
    ]
    s = reduced_solve(*red)
    outs = []
    for (lo, hi), c in zip(plan.chunk_bounds, coeffs):
        s_left_edge = torch.zeros_like(s[..., 0]) if lo == 0 else s[..., lo - 1]
        outs.append(_stage3_with_ghost(stage3, c, s[..., lo:hi], s_left_edge))
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=-1)


def _fused_sharded(
    plan: SolvePlan, backend: StageBackend, devices: Sequence[torch.device],
    dl: Tensor, d: Tensor, du: Tensor, b: Tensor,
) -> Tensor:
    """The system-major solve of a shard-aligned ``plan`` over ``devices``,
    one shard of ``plan.blocks_per_shard`` blocks on each; the counterpart of
    the reference's ``_sharded_fused_callable``, in its structure.

    The operands are 1-D, on ``devices[0]``. Shard i takes its span plus one
    halo block, the first block of shard i+1 (the reference's ``ppermute``);
    the last shard takes none, like the last chunk of :func:`_fused`, so it
    needs no identity block. Stage 1 runs over ``plan.local_chunk_bounds``.
    Each device gathers every chunk's reduced rows once, in order (the
    ``all_gather``), and each shard solves the reduced system on its
    device's copy. Stage 3 takes
    its left ghost from that copy, zero for shard 0's first chunk, and the
    solution is gathered on ``devices[0]`` in shard order. With the plan's
    chunks, stages and reduced rows unchanged, the answer is
    :func:`_fused`'s on the same plan, bit for bit. On one device every
    ``.to()`` is a no-op: logical shards copy nothing, and repeat only the
    reduced solve.
    """
    m, bps, nb = plan.m, plan.blocks_per_shard, plan.num_blocks
    stage1 = backend.make_stage1(m)
    stage3 = backend.make_stage3()
    reduced_solve = backend.make_reduced_solve()

    shard_coeffs: List[List[partition.PartitionCoeffs]] = []
    for i, dev in enumerate(devices):
        span = [a[i * bps * m : min((i + 1) * bps + 1, nb) * m].to(dev) for a in (dl, d, du, b)]
        span_blocks = span[1].shape[-1] // m
        coeffs = []
        for lo, hi in plan.local_chunk_bounds:
            hi_halo = min(hi + 1, span_blocks)
            chunk = [a[lo * m : hi_halo * m].contiguous() for a in span]
            coeffs.append(_trim_halo(stage1(*chunk), hi - lo))
        shard_coeffs.append(coeffs)

    gathered: Dict[torch.device, List[Tensor]] = {}
    outs = []
    for i, (dev, coeffs) in enumerate(zip(devices, shard_coeffs)):
        if dev not in gathered:
            gathered[dev] = [
                torch.cat([getattr(c, f).to(dev) for cs in shard_coeffs for c in cs])
                for f in _RED_FIELDS
            ]
        s = reduced_solve(*gathered[dev])
        base = i * bps
        for (lo, hi), c in zip(plan.local_chunk_bounds, coeffs):
            left = torch.zeros_like(s[0]) if base + lo == 0 else s[base + lo - 1]
            outs.append(_stage3_with_ghost(stage3, c, s[base + lo : base + hi], left).to(devices[0]))
    return torch.cat(outs)


def _fused_interleaved(
    plan: SolvePlan, backend: StageBackend, dl: Tensor, d: Tensor, du: Tensor, b: Tensor, *,
    maps: layout_mod.Maps = None, devices: Optional[Sequence[torch.device]] = None,
) -> Tensor:
    """The interleaved three-stage solve of ``plan`` on the operands' device:
    interleave, wide Stage 1, wide reduced solve, wide Stage 3, deinterleave.
    The plan's chunks do not apply: the B systems are the parallel axis.
    ``maps``: see :func:`~.layout.gather_maps`.

    ``devices`` (the reference's ``mesh_devices`` branch) splits the lane
    axis into ``len(devices)`` equal contiguous slices, each made contiguous
    on its device (the wide kernels take whole (rows, B) tensors), and runs
    the three wide stages per slice with no transfer in between; the lanes
    are concatenated on the operands' device, then deinterleaved (a ragged
    batch's maps belong to the whole batch)."""
    m, sizes = plan.m, plan.sizes
    wide = layout_mod.interleave_operands(dl, d, du, b, sizes, m, maps=maps)
    stage1 = backend.make_wide_stage1(m)
    reduced_solve = backend.make_wide_reduced_solve()
    stage3 = backend.make_wide_stage3()

    def pipeline(ops: Sequence[Tensor]) -> Tensor:
        c = stage1(*ops)
        return stage3(c, reduced_solve(c.red_dl, c.red_d, c.red_du, c.red_b))

    if devices is None:
        xw = pipeline(wide)
    else:
        lanes = len(sizes) // len(devices)
        xw = torch.cat([
            pipeline([a[..., i * lanes : (i + 1) * lanes].contiguous().to(dev) for a in wide]).to(dl.device)
            for i, dev in enumerate(devices)
        ], dim=-1)
    return layout_mod.deinterleave(xw, sizes, m, maps=maps)


def _check_layout(layout: str) -> str:
    if layout not in layout_mod.LAYOUTS:
        raise ValueError(f"layout must be one of {layout_mod.LAYOUTS}, got {layout!r}")
    return layout


def _operand_dtype(plan: SolvePlan, ops: Sequence[Tensor]) -> torch.dtype:
    """The one floating dtype the four operands are solved in (torch's
    promotion rules), after checking them for equal shapes and for the
    plan's row count."""
    dtype = ops[0].dtype
    for a in ops[1:]:
        dtype = torch.promote_types(dtype, a.dtype)
    if not dtype.is_floating_point:
        raise TypeError(f"the solver runs in floating point, got {dtype} operands")
    shape = ops[1].shape
    for a in ops:
        if a.shape != shape:
            raise ValueError(f"operand shapes differ: {tuple(a.shape)} vs {tuple(shape)}")
    n = int(shape[-1])
    if n != plan.total_size:
        raise ValueError(f"operands have {n} rows but the plan lays out {plan.total_size}")
    return dtype


def _promote(plan: SolvePlan, ops: List[Tensor]) -> List[Tensor]:
    """The four operands in their :func:`_operand_dtype`."""
    dtype = _operand_dtype(plan, ops)
    return [a.to(dtype) for a in ops]


# One graph capture at a time in the process (CUDA graphs' rule), on a
# stream of its own per device; _CAPTURE_LOCK guards that stream table too.
_CAPTURE_LOCK = threading.RLock()
_CAPTURE_STREAMS: Dict[int, Any] = {}
_CU_STREAM_NON_BLOCKING = 1


def _capture_stream(device: torch.device) -> Any:
    """This process's capture stream on ``device``. It is made by
    ``cuStreamCreate``, not taken from torch's stream pool, which other
    threads draw on (the staged executor takes one stream a chunk) and
    whose work would then land in the capture; and it is non-blocking, so
    that other threads' work on the legacy default stream has no implicit
    tie to it."""
    with _CAPTURE_LOCK:
        stream = _CAPTURE_STREAMS.get(device.index)
        if stream is None:
            create = ctypes.CDLL("libcuda.so.1").cuStreamCreate
            create.argtypes = [ctypes.POINTER(ctypes.c_void_p), ctypes.c_uint]
            create.restype = ctypes.c_int
            handle = ctypes.c_void_p()
            with torch.cuda.device(device):
                err = create(ctypes.byref(handle), _CU_STREAM_NON_BLOCKING)
            if err != 0:
                raise RuntimeError(f"cuStreamCreate failed on {device}: CUresult {err}")
            stream = torch.cuda.ExternalStream(handle.value, device=device)
            _CAPTURE_STREAMS[device.index] = stream
        return stream


class _FusedExecutable:
    """One signature of the fused path: its eager stages and, once captured,
    a CUDA graph of them.

    The call that misses the cache runs the stages eagerly (:meth:`eager`),
    as a call with no cache would; nothing is allocated for the entry. A
    hit (:meth:`__call__`) with a capturable backend on a CUDA device
    captures the graph the first time: the operands go into static buffers,
    (4, *shape) in ``dtype``, the stages run eagerly on them (the warm-up:
    it loads the kernels, sets their attributes and gives this call's
    answer), then the same stages are captured over those buffers, and the
    bytes the entry now holds are charged to the cache (:func:`_charge`).
    Every later hit copies the operands in (a host operand straight from the
    host, cast there first when its dtype is not ``dtype``; a device operand
    on the device), replays the graph on the current stream, adds the
    launches the capture recorded to the kernels' ``replayed`` counts, and
    copies the solution to the host. A hit runs under this entry's own lock,
    so threads sharing it never overwrite each other's buffers. Everything
    the graph reads or wrote stays referenced here (the static tensors, the
    graph and its memory pool, the layout's gather maps) until the entry is
    dropped; the next capture on the device gives dropped graphs' pools
    back (:func:`_release_dropped`). A failed capture raises. Elsewhere a
    hit runs the eager stages.

    A sharded entry (its key ends in the mesh signature of the devices it
    shards over) is never captured in this version: a graph over several
    devices needs a graph per device and events between them. It is cached
    and counted like any other, and runs its stages eagerly on every hit.
    """

    def __init__(self, key: Tuple[Any, ...], backend: StageBackend) -> None:
        plan, _, layout, device, dtype, lead, *mesh = key
        self.key = key
        self.plan, self.layout, self.device, self.dtype = plan, layout, device, dtype
        self.shape = lead + (plan.total_size,)
        self.backend = backend
        self.shard_devices: Optional[Tuple[torch.device, ...]] = (
            tuple(torch.device(t, i) for t, i in mesh[0]) if mesh else None
        )
        self.capturable = device.type == "cuda" and backend.capturable and not mesh
        self.nbytes = 0
        self._lock = threading.Lock()
        self.graph: Optional[Any] = None
        self._run: Optional[Callable[..., Tensor]] = None  # holds the gather maps
        self._static: Optional[Tensor] = None
        self._out: Optional[Tensor] = None
        self._launches: Dict[Any, int] = {}

    def _stages(self, maps: layout_mod.Maps = None) -> Callable[..., Tensor]:
        if self.layout == "interleaved":
            return partial(_fused_interleaved, self.plan, self.backend, maps=maps,
                           devices=self.shard_devices)
        if self.shard_devices is not None:
            return partial(_fused_sharded, self.plan, self.backend, self.shard_devices)
        return partial(_fused, self.plan, self.backend)

    def eager(self, ops: Sequence[Tensor]) -> np.ndarray:
        """The stages run eagerly on the operands, moved to the device."""
        x = self._stages()(*(a.to(device=self.device, dtype=self.dtype) for a in ops))
        return x.cpu().numpy()

    def __call__(self, ops: Sequence[Tensor]) -> np.ndarray:
        if not self.capturable:
            return self.eager(ops)
        with self._lock, torch.cuda.device(self.device):
            if self.graph is None:
                x, nbytes = self._capture(ops)
            else:
                assert self._static is not None and self._out is not None
                _fill(self._static, ops)
                self.graph.replay()
                for counter, n in self._launches.items():
                    counter.add_replayed(n)
                return self._out.cpu().numpy()
        _charge(self, nbytes)
        return x

    def _capture(self, ops: Sequence[Tensor]) -> Tuple[np.ndarray, int]:
        """The warm-up and the capture (see the class); returns the eager
        answer and the device bytes the entry holds from now on: the static
        operands, and what ``memory_reserved`` rose by during the capture,
        at least the solution (the graph's private pool starts empty, so
        every byte it allocates is a new segment; another thread's
        allocation in that window counts too, which only overstates)."""
        from repro_torch.kernels import common

        maps = None
        if self.layout == "interleaved":
            # The graph reads these by address: held for its life, and any
            # host-to-device copy that makes them happens now, not inside.
            maps = layout_mod.gather_maps(self.plan.sizes, self.plan.m, self.device)
        run = self._stages(maps)
        static = torch.empty((4,) + self.shape, dtype=self.dtype, device=self.device)
        _fill(static, ops)
        x = run(*static.unbind(0)).cpu().numpy()
        graph = torch.cuda.CUDAGraph()
        with _CAPTURE_LOCK:
            stream = _capture_stream(self.device)
            _release_dropped(self.device)
            before = torch.cuda.memory_reserved(self.device)
            with torch.cuda.stream(stream), common.recording() as launches:
                graph.capture_begin(capture_error_mode="thread_local")
                try:
                    out = run(*static.unbind(0))
                finally:
                    graph.capture_end()
            grown = torch.cuda.memory_reserved(self.device) - before
        # Kept only now: a capture that raised leaves the entry as it was.
        self._run, self._static, self._out, self._launches = run, static, out, launches
        self.graph = graph
        return x, static.nbytes + max(grown, out.nbytes)


def _fill(static: Tensor, ops: Sequence[Tensor]) -> None:
    """Copy the four operands into an entry's (4, *shape) static buffer: a
    host operand straight from the host, promoted there first (as
    :func:`_promote` does); a device operand on the device."""
    for dst, a in zip(static, ops):
        if a.device.type == "cpu":
            a = a.to(static.dtype)
        dst.copy_(a)


class FusedExecutor:
    """Runs a :class:`SolvePlan` on one device, all three stages there, or
    sharded over a device list.

    Operands (numpy arrays or tensors; 1-D over ``plan.total_size`` or with
    leading batch dims) are moved to ``device`` (the card unless the caller
    asks for the CPU; a missing card raises) in one dtype: the input's,
    with mixed inputs promoted by torch's rules. The caller's arrays and
    tensors are never written to or consumed (no buffer donation). The
    solution comes back as a numpy array; nothing crosses to the host before
    that. The :class:`ChunkTiming` carries only the total time.

    ``layout`` ("system-major" | "interleaved" | "auto") picks the operand
    layout per plan through :func:`~.layout.resolve_layout`; "auto"
    interleaves flat fused batches of at least
    ``layout.AUTO_INTERLEAVE_MIN_BATCH`` systems. The resolved layout is
    part of the executable-cache key.

    Executables are cached in the module-level LRU
    (:func:`executable_cache_stats`) under ``_CACHE_LOCK``, one entry per
    (plan, backend name, resolved layout, device, promoted operand dtype,
    leading shape); a hit or a miss is counted before the stages run. The
    call that misses runs the stages eagerly and keeps an entry that holds
    no device memory. On a CUDA device with a capturable backend (the
    kernels') the first hit captures the stages into a CUDA graph, which
    every later hit replays (:class:`_FusedExecutable`); other entries run
    eagerly on every hit. Entries are evicted oldest-first past the
    capacity, and graph-holding entries oldest-first past the device's byte
    budget (``_EXEC_CACHE_MEMORY_SHARE`` of the card); an evicted graph's
    pool goes back to the card before the next capture. At capacity 0
    every call runs eagerly and nothing is kept.

    ``mesh`` (any :func:`repro_torch.parallel.solver.resolve_mesh_devices`
    spec; default None) shards the solve over a device list, whose first
    device is then the executor's ``device`` (a ``device`` of another type
    raises ``ValueError``). System-major solves shard the fused block axis
    over ``plan.shards`` devices (:func:`_fused_sharded`; so pass a
    shard-aligned plan, ``build_plan(..., shards=...)``), interleaved ones
    the lane axis over the largest device count dividing the batch, and
    ``"auto"`` compares the lanes per shard with the interleave threshold.
    Only 1-D fused operands shard: leading batch dims run the single-device
    path. The mesh signature of the devices a solve shards over joins its
    cache key, so sharded and unsharded entries (or two device lists) never
    collide; sharded entries run eagerly on every hit (no CUDA graph). With
    ``mesh=None`` the path and its keys are the single-device ones.
    """

    def __init__(
        self,
        backend: BackendLike = "auto",
        *,
        device: Union[str, torch.device] = "cuda",
        layout: str = "auto",
        mesh: Any = None,
    ) -> None:
        self.mesh_devices = resolve_mesh_devices(mesh)
        if self.mesh_devices is not None:
            if torch.device(device).type != self.mesh_devices[0].type:
                raise ValueError(
                    f"device={str(device)!r} but the mesh's devices are "
                    f"{self.mesh_devices[0].type!r}: pass a device of the mesh's type"
                )
            for dev in self.mesh_devices:
                resolve_device(dev)  # a CUDA mesh without a card raises here
            device = self.mesh_devices[0]
        self.device = resolve_device(device)
        self.backend = resolve_backend(backend, self.device)
        self.layout = _check_layout(layout)

    @property
    def operand_device(self) -> Optional[torch.device]:
        """Where a caller should fuse operands for this executor: its device
        (with a mesh, the mesh's first device)."""
        return self.device

    def batch_shards(self, plan: SolvePlan, lead_ndim: int = 0) -> int:
        """The lane-axis shard count of an interleaved solve of ``plan`` (1
        without a mesh or with leading batch dims)."""
        if self.mesh_devices is None or lead_ndim != 0:
            return 1
        return shard_count(len(plan.sizes), len(self.mesh_devices))

    def resolved_layout(self, plan: SolvePlan, lead_ndim: int = 0) -> str:
        """The concrete layout this executor runs ``plan`` in."""
        return resolve_layout(self.layout, plan.sizes, plan.m, fused=True, lead_ndim=lead_ndim,
                              batch_shards=self.batch_shards(plan, lead_ndim))

    def shard_devices(self, plan: SolvePlan, layout: str, lead_ndim: int = 0) -> Optional[Tuple[torch.device, ...]]:
        """The devices a solve of ``plan`` in ``layout`` shards over (None:
        one device): the lane shards of an interleaved solve, the plan's
        shards of a system-major one."""
        if self.mesh_devices is None or lead_ndim != 0:
            return None
        if layout == "interleaved":
            lanes = self.batch_shards(plan)
            return self.mesh_devices[:lanes] if lanes > 1 else None
        if 1 < plan.shards <= len(self.mesh_devices):
            return self.mesh_devices[: plan.shards]
        return None

    def _key(self, plan: SolvePlan, ops: Sequence[Tensor]) -> Tuple[Any, ...]:
        lead = tuple(ops[1].shape[:-1])
        layout = self.resolved_layout(plan, len(lead))
        key = (plan, self.backend.name, layout, self.device, _operand_dtype(plan, ops), lead)
        shard_devices = self.shard_devices(plan, layout, len(lead))
        return key if shard_devices is None else key + (mesh_signature(shard_devices),)

    def execute(self, plan: SolvePlan, dl: Any, d: Any, du: Any, b: Any) -> Tuple[np.ndarray, ChunkTiming]:
        t0 = time.perf_counter()
        ops = [as_tensor(a) for a in (dl, d, du, b)]  # where they are; host data is not copied
        key = self._key(plan, ops)
        with _CACHE_LOCK:
            entry = _EXEC_CACHE.get(key)
            if entry is not None:
                _EXEC_CACHE.move_to_end(key)
                _EXEC_STATS["hits"] += 1
            else:
                _EXEC_STATS["misses"] += 1
        if entry is not None:
            out = entry(ops)
        else:
            entry = _FusedExecutable(key, self.backend)
            out = entry.eager(ops)
            with _CACHE_LOCK:
                # A racing thread's miss is harmless: the first entry in stays.
                if key not in _EXEC_CACHE and _EXEC_CACHE_CAPACITY > 0:
                    _EXEC_CACHE[key] = entry
                    while len(_EXEC_CACHE) > _EXEC_CACHE_CAPACITY:
                        _evict(next(iter(_EXEC_CACHE)))
        return out, ChunkTiming(
            num_chunks=plan.num_chunks,
            t_stage1_ms=0.0,
            t_stage2_ms=0.0,
            t_stage3_ms=0.0,
            t_total_ms=(time.perf_counter() - t0) * 1e3,
            n=plan.total_size,
        )


class PlanExecutor:
    """The staged path of the paper: per-chunk device stages on their own
    CUDA streams, the reduced solve on the host in fp64, and per-phase
    host-clock times in the returned :class:`ChunkTiming`.

    System-major (the default, and what ``"auto"`` resolves to here): for
    each chunk of the plan, in order and without blocking, on the chunk's own
    ``torch.cuda.Stream``: its rows plus one halo block go host→device
    through a pinned staging buffer, Stage 1 runs, and its reduced rows go
    device→host into a pinned buffer, with an event recorded. So chunk k's
    copy overlaps chunk k-1's kernels. The host waits on the events, solves
    the reduced system with ``thomas_numpy`` in fp64, and each chunk runs
    Stage 3 on its stream with its left neighbour's interface value passed
    in; the solution comes back through a pinned buffer. Operands that are
    already CUDA tensors are sliced in place, with no host copy.

    Interleaved (an explicit ``layout="interleaved"``): one wide Stage 1 on
    the device, the (P, B) reduced rows to the host, ``thomas_numpy`` on the
    transposed rows, one wide Stage 3 and the deinterleave. The plan's
    chunks do not apply.

    On ``device="cpu"`` the same code runs without streams or pinned memory.
    The solution always comes back in the operands' dtype: Stage 3 casts the
    fp64 interface values to the spikes' precision.
    """

    def __init__(
        self,
        backend: BackendLike = "auto",
        *,
        layout: str = "auto",
        device: Union[str, torch.device] = "cuda",
    ) -> None:
        self.device = resolve_device(device)
        self.backend = resolve_backend(backend, self.device)
        self.layout = _check_layout(layout)

    @property
    def operand_device(self) -> Optional[torch.device]:
        """Where a caller should fuse operands for this executor: None, where
        they are. Host operands are then copied chunk by chunk on the chunks'
        streams, and device operands are sliced in place."""
        return None

    def resolved_layout(self, plan: SolvePlan, lead_ndim: int = 0) -> str:
        """The concrete layout this executor runs ``plan`` in."""
        return resolve_layout(self.layout, plan.sizes, plan.m, fused=False, lead_ndim=lead_ndim)

    def execute(self, plan: SolvePlan, dl: Any, d: Any, du: Any, b: Any) -> Tuple[np.ndarray, ChunkTiming]:
        # Host operands stay on the host for the chunks' staged copies; any
        # device operand is taken on this executor's device.
        ops = [as_tensor(a) for a in (dl, d, du, b)]
        ops = _promote(plan, [a if a.device.type == "cpu" else a.to(self.device) for a in ops])
        if self.resolved_layout(plan, ops[1].ndim - 1) == "interleaved":
            return self._execute_interleaved(plan, ops)
        if ops[1].ndim > 2:
            lead = ops[1].shape[:-1]
            x, timing = self._execute_system_major(plan, [a.reshape(-1, a.shape[-1]) for a in ops])
            return x.reshape(*lead, -1), timing
        return self._execute_system_major(plan, ops)

    def _execute_system_major(self, plan: SolvePlan, ops: List[Tensor]) -> Tuple[np.ndarray, ChunkTiming]:
        m = plan.m
        stage1 = self.backend.make_stage1(m)
        stage3 = self.backend.make_stage3()
        cuda = self.device.type == "cuda"
        staged = cuda and ops[1].device.type == "cpu"  # host operands copied per chunk
        dtype, lead, p = ops[1].dtype, tuple(ops[1].shape[:-1]), plan.num_blocks
        if cuda:
            caller = torch.cuda.current_stream(self.device)
            streams: List[Any] = [torch.cuda.Stream(self.device) for _ in plan.chunk_bounds]
            for st in streams:
                st.wait_stream(caller)  # device operands may still be in the making
                if not staged:
                    for a in ops:
                        a.record_stream(st)
        else:
            streams = [None] * plan.num_chunks

        def on(st: Any) -> Any:
            return torch.cuda.stream(st) if st is not None else contextlib.nullcontext()

        def host_buffer(*shape: int) -> Tensor:
            return torch.empty(shape, dtype=dtype, pin_memory=cuda)

        # Every pinned buffer lives until the call returns, so none is reused
        # while a copy from or to it may be in flight.
        keep: List[Tensor] = []
        events: List[Any] = [None] * plan.num_chunks

        def record(k: int) -> None:
            if cuda:
                events[k] = torch.cuda.Event()
                events[k].record(streams[k])

        def wait_all() -> None:
            for e in events:
                if e is not None:
                    e.synchronize()

        t0 = time.perf_counter()
        # ---- Stage 1, per chunk on its stream, without blocking. Each chunk
        # carries one halo block: its last reduced row needs the next block's
        # spikes; the halo's own reduced row belongs to the next chunk.
        red = host_buffer(4, *lead, p)
        coeffs: List[partition.PartitionCoeffs] = []
        for k, ((lo, hi), (_, hi_halo)) in enumerate(zip(plan.chunk_bounds, plan.halo_bounds)):
            with on(streams[k]):
                if staged:
                    buf = host_buffer(4, *lead, (hi_halo - lo) * m)
                    for j, a in enumerate(ops):
                        buf[j].copy_(a[..., lo * m : hi_halo * m])
                    keep.append(buf)
                    chunk = list(buf.to(self.device, non_blocking=True).unbind(0))
                else:
                    chunk = [a[..., lo * m : hi_halo * m].contiguous() for a in ops]
                c = _trim_halo(stage1(*chunk), hi - lo)
                for j, f in enumerate(_RED_FIELDS):
                    red[j][..., lo:hi].copy_(getattr(c, f), non_blocking=True)
                record(k)
            coeffs.append(c)
        wait_all()
        t1 = time.perf_counter()

        # ---- Stage 2: the reduced solve on the host, in fp64 (the paper's
        # CPU stage).
        s_host = host_buffer(*lead, p)
        s_host.copy_(torch.from_numpy(thomas_numpy(*red.numpy())))
        t2 = time.perf_counter()

        # ---- Stage 3, per chunk on its stream: chunk k needs s_{lo-1}..s_{hi-1}.
        x_host = host_buffer(*lead, plan.total_size)
        for k, ((lo, hi), c) in enumerate(zip(plan.chunk_bounds, coeffs)):
            with on(streams[k]):
                first = max(lo - 1, 0)
                seg = s_host[..., first:hi].to(self.device, non_blocking=True)
                left = seg[..., 0] if lo > 0 else seg.new_zeros(lead)
                x = _stage3_with_ghost(stage3, c, seg[..., lo - first :], left)
                x_host[..., lo * m : hi * m].copy_(x, non_blocking=True)
                record(k)
        wait_all()
        if cuda:
            for st in streams:
                caller.wait_stream(st)
        out = x_host.numpy().copy() if cuda else x_host.numpy()
        t3 = time.perf_counter()
        return out, ChunkTiming(
            num_chunks=plan.num_chunks,
            t_stage1_ms=(t1 - t0) * 1e3,
            t_stage2_ms=(t2 - t1) * 1e3,
            t_stage3_ms=(t3 - t2) * 1e3,
            t_total_ms=(t3 - t0) * 1e3,
            n=plan.total_size,
        )

    def _execute_interleaved(self, plan: SolvePlan, ops: List[Tensor]) -> Tuple[np.ndarray, ChunkTiming]:
        m, sizes = plan.m, plan.sizes
        t0 = time.perf_counter()
        wide = layout_mod.interleave_operands(*(a.to(self.device) for a in ops), sizes, m)
        c = self.backend.make_wide_stage1(m)(*wide)
        red = [getattr(c, f).cpu().numpy() for f in _RED_FIELDS]  # (P, B) each
        t1 = time.perf_counter()

        # ---- Stage 2 on the host: B independent fp64 solves of P rows.
        s = thomas_numpy(*(r.T for r in red)).T
        t2 = time.perf_counter()

        s_dev = torch.from_numpy(np.ascontiguousarray(s)).to(device=self.device, dtype=c.y.dtype)
        xw = self.backend.make_wide_stage3()(c, s_dev)
        out = layout_mod.deinterleave(xw, sizes, m).cpu().numpy()
        t3 = time.perf_counter()
        return out, ChunkTiming(
            num_chunks=plan.num_chunks,
            t_stage1_ms=(t1 - t0) * 1e3,
            t_stage2_ms=(t2 - t1) * 1e3,
            t_stage3_ms=(t3 - t2) * 1e3,
            t_total_ms=(t3 - t0) * 1e3,
            n=plan.total_size,
        )
