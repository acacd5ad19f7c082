"""Collectives of the sharded LM path, the counterpart of
``repro.parallel.collectives``.

The reference leaves its collectives to GSPMD (sharding constraints); the
port runs explicit SPMD on ``torch.distributed``, so every collective is
written where GSPMD would place it. Two kinds live here:

- the bucketed gradient all-reduce (:class:`BucketedAllReduce`): the
  gradients a rank holds are cut into ``n`` size-balanced buckets
  (:func:`plan_buckets`); a bucket is flattened (one buffer a dtype, each
  gradient summed in its own dtype, as the reference's ``psum``) and
  all-reduced asynchronously as soon as the backward has produced all of
  its gradients, so it travels while the backward goes on; ``n`` is the
  paper's heuristic applied to gradient buckets
  (:func:`tuned_bucket_count`, Eq. 6 through
  ``core.autotune.overlap.tune_gradient_buckets``), fed with the link's
  measured rate and latency (:func:`measure_link`);
- the autograd-aware primitives, ``torch.autograd.Function`` s over one
  process group: :func:`copy_to` (Megatron's "f": identity forward,
  all-reduce backward), :func:`reduce_from` ("g": all-reduce forward,
  identity backward), :func:`all_gather` (backward: a reduce-scatter, or
  this rank's slice where the gathered value feeds replicated work),
  :func:`reduce_scatter` (backward: an all-gather), :func:`split` (this
  rank's slice; backward: an all-gather) and :func:`int8_all_gather` (the
  reference's ``_int8_allgather``: an int8 payload with per-(expert,
  source-shard) scales and a straight-through backward that
  reduce-scatters).

A reduce-scatter is an all-reduce and this rank's slice of its result, and
an all-gather is ``all_gather`` into a list and one concatenation: one
path on every device (gloo also has ``reduce_scatter_tensor`` and
``all_gather_into_tensor`` on CUDA tensors; they are not used). A
group of one rank makes every primitive the identity.

Every collective of the port goes through this module. While a tally is
active (:func:`tallied`, used by ``repro_torch.roofline.counting``), each
primitive reports its op name (the reference's HLO names: ``all-reduce``,
``all-gather``, ``reduce-scatter``), its group and its payload, the larger
of its operand and its result; the autograd primitives report through the
plain ones their forward and backward call. :func:`measure_link`'s timed
all-reduces measure the link and are not reported. With no tally active
the cost is one check.
"""

from __future__ import annotations

import contextlib
import time
from typing import Any, Dict, Iterator, List, Mapping, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.core.autotune.overlap import tune_gradient_buckets

Tensor = torch.Tensor
Group = Optional[dist.ProcessGroup]

#: The active tallies (``repro_torch.roofline.counting.CollectiveTally``),
#: process-wide: a backward on the card runs in autograd's device thread.
_TALLIES: List[Any] = []


@contextlib.contextmanager
def tallied(tally: Any) -> Iterator[Any]:
    """Report every collective of the block to ``tally``
    (``tally.add(op, group, payload_bytes)``)."""
    _TALLIES.append(tally)
    try:
        yield tally
    finally:
        _TALLIES.remove(tally)


def _report(op: str, group: Group, payload: int) -> None:
    for tally in list(_TALLIES):
        tally.add(op, group, payload)


# ------------------------------------------------------------- buckets -------
def _nbytes(t: Any) -> int:
    return int(t.numel()) * int(t.element_size())


def plan_buckets(leaves: Sequence[Any], *, n_buckets: int) -> List[List[int]]:
    """Greedy size-balanced assignment of leaves (anything with ``numel``
    and ``element_size``) to at most ``n_buckets`` buckets, largest first,
    each to the bucket with the smallest load; empty buckets are dropped.
    The reference's ``plan_buckets`` over a list instead of a pytree."""
    sizes = [_nbytes(t) for t in leaves]
    order = sorted(range(len(leaves)), key=lambda i: -sizes[i])
    buckets: List[List[int]] = [[] for _ in range(n_buckets)]
    loads = [0] * n_buckets
    for i in order:
        j = loads.index(min(loads))
        buckets[j].append(i)
        loads[j] += sizes[i]
    return [b for b in buckets if b]


def tuned_bucket_count(
    leaves: Sequence[Any],
    *,
    link_bandwidth_Bps: float = 50e9,
    backward_compute_s: float,
    per_collective_latency_s: float = 15e-6,
) -> Tuple[int, float]:
    """Paper-heuristic bucket count for these gradient leaves: (n, margin_s)."""
    return tune_gradient_buckets(
        grad_bytes=float(sum(_nbytes(t) for t in leaves)),
        link_bandwidth_Bps=link_bandwidth_Bps,
        backward_compute_s=backward_compute_s,
        per_collective_latency_s=per_collective_latency_s,
    )


def measure_link(group: Group, device: torch.device) -> Tuple[float, float]:
    """(bytes a second, seconds a call) of an all-reduce over ``group`` on
    ``device``: the median of three timed all-reduces of one fp32 value
    (the latency) and of 4 MiB (the rate, once the latency is taken off),
    after one untimed of each; the device is synchronised around every
    call. Every rank of ``group`` calls it alike."""
    nbytes = 1 << 22

    def median_s(numel: int) -> float:
        t = torch.zeros(numel, dtype=torch.float32, device=device)
        times = []
        for i in range(4):
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            t0 = time.perf_counter()
            dist.all_reduce(t, group=group)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            if i:
                times.append(time.perf_counter() - t0)
        return sorted(times)[len(times) // 2]

    latency = median_s(1)
    big = median_s(nbytes // 4)
    return nbytes / max(big - latency, 1e-9), latency


class BucketedAllReduce:
    """The sum over ``group`` of the gradients of the leaves ``like`` (by
    name; their shapes and dtypes are the gradients'), in ``n_buckets``
    size-balanced buckets. :meth:`add` takes one gradient (from a gradient
    hook, while the backward runs); once a bucket holds all of its
    gradients it is flattened, one buffer a dtype, and all-reduced
    asynchronously. :meth:`result` issues the buckets still short (a
    gradient that never came is zero: its leaf was unused), waits for every
    call and returns the sums. A group of one rank sums nothing."""

    def __init__(self, like: Mapping[str, Tensor], group: Group, n_buckets: int):
        self.group = group
        self.like = dict(like)
        names = list(self.like)
        self.buckets = [[names[i] for i in b] for b in
                        plan_buckets([self.like[k] for k in names], n_buckets=max(1, n_buckets))]
        self.bucket_of = {k: i for i, b in enumerate(self.buckets) for k in b}
        self.got: Dict[str, Tensor] = {}
        self.left = [len(b) for b in self.buckets]
        self.pending: List[Tuple[List[str], Tensor, Any]] = []

    def add(self, name: str, grad: Tensor) -> None:
        self.got[name] = grad.detach()
        i = self.bucket_of[name]
        self.left[i] -= 1
        if self.left[i] == 0:
            self._issue(i)

    def _issue(self, i: int) -> None:
        self.left[i] = -1  # issued
        by_dtype: Dict[torch.dtype, List[Tuple[str, Tensor]]] = {}
        for k in self.buckets[i]:
            g = self.got[k] if k in self.got else torch.zeros_like(self.like[k])
            by_dtype.setdefault(g.dtype, []).append((k, g))
        for items in by_dtype.values():
            flat = torch.cat([g.reshape(-1) for _, g in items])
            work = None
            if _size(self.group) > 1:
                if _TALLIES:
                    _report("all-reduce", self.group, _nbytes(flat))
                work = dist.all_reduce(flat, group=self.group, async_op=True)
            self.pending.append(([k for k, _ in items], flat, work))

    def result(self) -> Dict[str, Tensor]:
        for i, left in enumerate(self.left):
            if left >= 0:
                self._issue(i)
        out: Dict[str, Tensor] = {}
        for keys, flat, work in self.pending:
            if work is not None:
                work.wait()
            at = 0
            for k in keys:
                n = self.like[k].numel()
                out[k] = flat[at:at + n].view(self.like[k].shape)
                at += n
        return out


# ---------------------------------------------------------- plain ops -------
def _size(group: Group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def all_reduce_(t: Tensor, group: Group, op: Any = dist.ReduceOp.SUM) -> Tensor:
    """In-place all-reduce (no autograd); the identity for one rank."""
    if _size(group) > 1:
        if _TALLIES:
            _report("all-reduce", group, _nbytes(t))
        dist.all_reduce(t, op=op, group=group)
    return t


def takes_host_tensors(group: Group) -> bool:
    """Whether ``group``'s backend runs collectives on host tensors (gloo,
    MPI; NCCL does not)."""
    return _size(group) == 1 or any(b in str(dist.get_backend(group)) for b in ("gloo", "mpi"))


def any_rank(flag: bool, group: Group) -> bool:
    """Whether ``flag`` is set on any rank of ``group``: a MAX all-reduce of
    one value (on the host where the group's backend takes host tensors),
    for a decision every rank must take alike. ``flag`` itself for one
    rank."""
    if _size(group) == 1:
        return bool(flag)
    dev = (torch.device("cpu") if takes_host_tensors(group)
           else torch.device("cuda", torch.cuda.current_device()))
    return bool(all_reduce_(torch.tensor([int(flag)], device=dev), group,
                            dist.ReduceOp.MAX).item())


def gather_tensor(t: Tensor, group: Group, dim: int) -> Tensor:
    """The group's tensors concatenated along ``dim`` in group-rank order
    (no autograd)."""
    n = _size(group)
    if n == 1:
        return t
    t = t.contiguous()
    if _TALLIES:
        _report("all-gather", group, n * _nbytes(t))
    parts = [torch.empty_like(t) for _ in range(n)]
    dist.all_gather(parts, t, group=group)
    return torch.cat(parts, dim=dim)


def _rank(group: Group) -> int:
    return 0 if group is None else dist.get_rank(group)


def slice_of(t: Tensor, group: Group, dim: int) -> Tensor:
    """This rank's equal slice of ``t`` along ``dim``."""
    n = _size(group)
    if n == 1:
        return t
    if t.shape[dim] % n:
        raise ValueError(f"dim {dim} of size {t.shape[dim]} does not split over {n} ranks")
    return t.chunk(n, dim=dim)[_rank(group)].contiguous()


def scatter_sum(t: Tensor, group: Group, dim: int) -> Tensor:
    """The group's sum of ``t``, this rank's slice along ``dim`` (a
    reduce-scatter; no autograd)."""
    if _size(group) == 1:
        return t
    if _TALLIES:
        _report("reduce-scatter", group, _nbytes(t))
    full = t.contiguous().clone()
    dist.all_reduce(full, group=group)
    return slice_of(full, group, dim)


# ------------------------------------------------------------- autograd -----
class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx: Any, x: Tensor, group: Group) -> Tensor:
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx: Any, g: Tensor) -> Tuple[Tensor, None]:
        return all_reduce_(g.contiguous().clone(), ctx.group), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx: Any, x: Tensor, group: Group) -> Tensor:
        return all_reduce_(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx: Any, g: Tensor) -> Tuple[Tensor, None]:
        return g, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx: Any, x: Tensor, group: Group, dim: int, scatter_back: bool) -> Tensor:
        ctx.group, ctx.dim, ctx.scatter_back = group, dim, scatter_back
        return gather_tensor(x, group, dim)

    @staticmethod
    def backward(ctx: Any, g: Tensor) -> Tuple[Tensor, None, None, None]:
        if ctx.scatter_back:
            return scatter_sum(g, ctx.group, ctx.dim), None, None, None
        return slice_of(g, ctx.group, ctx.dim), None, None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx: Any, x: Tensor, group: Group, dim: int) -> Tensor:
        ctx.group, ctx.dim = group, dim
        return scatter_sum(x, group, dim)

    @staticmethod
    def backward(ctx: Any, g: Tensor) -> Tuple[Tensor, None, None]:
        return gather_tensor(g, ctx.group, ctx.dim), None, None


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx: Any, x: Tensor, group: Group, dim: int) -> Tensor:
        ctx.group, ctx.dim = group, dim
        return slice_of(x, group, dim)

    @staticmethod
    def backward(ctx: Any, g: Tensor) -> Tuple[Tensor, None, None]:
        return gather_tensor(g, ctx.group, ctx.dim), None, None


def copy_to(x: Tensor, group: Group) -> Tensor:
    """Megatron's "f": ``x`` forward; the backward all-reduces the gradient.
    Put where a value every rank holds alike enters work split over
    ``group``, each rank's gradient then holding only its split's part."""
    return x if _size(group) == 1 else _CopyTo.apply(x, group)


def reduce_from(x: Tensor, group: Group) -> Tensor:
    """Megatron's "g": the group's sum forward; the gradient passes as it is
    (every rank's downstream work is the same)."""
    return x if _size(group) == 1 else _ReduceFrom.apply(x, group)


def all_reduce_both(x: Tensor, group: Group) -> Tensor:
    """The group's sum forward, and its gradient summed too: a sum whose
    result feeds split work on every rank (the gated norm's mean square)."""
    return copy_to(reduce_from(x, group), group)


def all_gather(x: Tensor, group: Group, dim: int, *, scatter_back: bool = True) -> Tensor:
    """The group's ``x`` concatenated along ``dim``. Backward: the gradient
    reduce-scattered over the group (``scatter_back``: the gathered value
    feeds split work, each rank's gradient a part) or this rank's slice of
    it (the gathered value feeds work every rank does alike)."""
    return x if _size(group) == 1 else _AllGather.apply(x, group, dim, scatter_back)


def reduce_scatter(x: Tensor, group: Group, dim: int) -> Tensor:
    """The group's sum, this rank's slice along ``dim``; backward: the
    gradient all-gathered."""
    return x if _size(group) == 1 else _ReduceScatter.apply(x, group, dim)


def split(x: Tensor, group: Group, dim: int) -> Tensor:
    """This rank's slice along ``dim``; backward: the gradient all-gathered."""
    return x if _size(group) == 1 else _Split.apply(x, group, dim)


class _Int8AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx: Any, w: Tensor, group: Group, dim: int) -> Tensor:
        ctx.group, ctx.dim = group, dim
        w32 = w.float()
        red = tuple(i for i in range(w.ndim) if i != 0)
        scale = torch.clamp(w32.abs().amax(dim=red), min=1e-8) / 127.0  # [E_loc]
        q = torch.clamp(torch.round(w32 / scale.reshape((-1,) + (1,) * (w.ndim - 1))),
                        -127, 127).to(torch.int8)
        qs = gather_tensor(q, group, dim)                     # int8 payload
        ss = gather_tensor(scale[None], group, 0)             # [n, E_loc]
        n = ss.shape[0]
        shard = qs.shape[dim] // n
        split_shape = qs.shape[:dim] + (n, shard) + qs.shape[dim + 1:]
        smap_shape = [1] * (w.ndim + 1)
        smap_shape[0] = ss.shape[1]
        smap_shape[dim] = n
        smap = ss.movedim(0, 1).reshape(smap_shape)
        deq = qs.reshape(split_shape).float() * smap
        return deq.reshape(qs.shape).to(w.dtype)

    @staticmethod
    def backward(ctx: Any, g: Tensor) -> Tuple[Tensor, None, None]:
        return scatter_sum(g, ctx.group, ctx.dim), None, None


def int8_all_gather(w: Tensor, group: Group, dim: int) -> Tensor:
    """The reference's ``_int8_allgather`` (``repro/models/layers/moe.py``):
    ``w`` [E_loc, ...] quantized to int8 with one scale per local expert
    (its largest magnitude over 127), gathered along ``dim`` with the
    scales, and dequantized per (expert, source shard). Backward: the
    gradient reduce-scattered, a straight-through estimator for the
    quantization."""
    return w if _size(group) == 1 else _Int8AllGather.apply(w, group, dim)
