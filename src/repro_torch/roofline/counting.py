"""Counts of one step from what it dispatches, the counterpart of
``repro.roofline.hlo_parse``.

The reference reads FLOPs, bytes and collectives off compiled HLO text. The
port has no compiled module: its steps run op by op, so the counts are taken
while a step runs, by :func:`count_step`, which lays four counts over it:

- **FLOPs**: ``torch.utils.flop_counter.FlopCounterMode``. It counts matrix
  products, convolutions and attention, so the compute term is tensor-core
  work; elementwise work shows in the bytes. A hand-written kernel is
  invisible to it, so each kernel registers one FLOP formula and one byte
  formula (:func:`register_kernel`) on the custom op that wraps it, charged
  alike on every route (the kernel on CUDA tensors, its plain version on CPU
  tensors, shapes only on fake tensors). A kernel launched under a count
  without a formula raises (:func:`check_launch`).
- **Bytes moved**: a ``TorchDispatchMode`` that sums, for each aten op,
  the bytes of its tensor inputs (reads) and of its fresh outputs and the
  arguments it writes in place (writes); an in-place op counts its operand
  as a read and a write, a ``_foreach_*`` op every tensor of its lists.
  An indexed op moves the rows it touches: a lookup (``index``,
  ``embedding``, ``gather``, ``index_select``, ``take``) reads its output's
  size of the source, an indexed write in place (``index_put_``,
  ``index_copy_``, ``index_add_``, ``scatter_*``, ...) reads the values and
  writes the elements it selects (reading them too where it accumulates);
  each reads its indices. Views, metadata ops, allocations that write nothing and the collectives
  (tallied apart) count nothing. A tensor's bytes are its elements' bytes,
  at most its storage's (a broadcast reads its storage once). In eager mode
  every op's operands go through HBM, so this is what the port moves, with
  caches aside.
- **Peak live bytes**: the same mode keeps each storage from the op that
  first outputs it to its last reference (a ``weakref.finalize`` on the
  storage), views sharing a storage counted once. The step's arguments
  (given to :func:`count_step`, or found as inputs of an op) count from the
  start; the peak is their bytes plus the most the step held at once.
  Storages a kernel wrapper allocates inside its custom op (scratch) are
  not seen.
- **Collectives**: a :class:`CollectiveTally` that every primitive of
  :mod:`repro_torch.parallel.collectives` reports to while it is active:
  ``(total, by_op, counts)`` as the reference's ``collective_bytes``
  returns them, plus bytes by group size and by link.

Counting works alike on real tensors and on ``FakeTensorMode``'s fake ones
(enter the fake mode first, so the counts see each op before it is faked).
"""

from __future__ import annotations

import contextlib
import math
import threading
import weakref
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode, register_flop_formula

Tensor = torch.Tensor

#: The hand-written kernels whose cost is charged by formula, by the name
#: their wrapper passes to ``kernels.common.call``.
KERNELS: Dict[str, Any] = {}
#: Byte formulas by custom op (its overload packet): ``f(*shapes) -> int``.
_BYTE_FORMULAS: Dict[Any, Callable[..., int]] = {}
#: The counts running now (a count may run inside another's thread's
#: backward, so this is process-wide, not thread-local).
_ACTIVE: List["_Counter"] = []
# Ops that allocate without writing, and the collectives' namespaces.
_NO_TRAFFIC = {
    torch.ops.aten.empty.memory_format, torch.ops.aten.empty_strided.default,
    torch.ops.aten.empty_like.default, torch.ops.aten.new_empty.default,
    torch.ops.aten.new_empty_strided.default,
}
_COLLECTIVE_NAMESPACES = ("c10d", "_c10d_functional")


def register_kernel(name: str, op: Any, *, flops: Callable[..., int],
                    nbytes: Callable[..., int]) -> None:
    """Charge the kernel ``name`` (launched inside the custom op ``op``, a
    ``torch.ops`` overload packet) by formula: ``flops(*shapes)`` and
    ``nbytes(*shapes)`` of the op's tensor arguments' shapes."""
    def flop_formula(*shapes: Any, out_shape: Any = None, **kwargs: Any) -> int:
        return int(flops(*shapes))

    register_flop_formula(op)(flop_formula)
    _BYTE_FORMULAS[op] = nbytes
    KERNELS[name] = op


def check_launch(name: str) -> None:
    """Raise when a kernel without a formula launches under a count: the
    counts would miss its work."""
    if _ACTIVE and name not in KERNELS:
        raise RuntimeError(f"kernel {name!r} launched under count_step but has no FLOP and "
                           f"byte formula (repro_torch.roofline.counting.register_kernel)")


def tensor_bytes(t: Tensor) -> int:
    """The bytes an op reads or writes of ``t``: its elements', at most its
    storage's."""
    return min(t.numel() * t.element_size(), t.untyped_storage().nbytes())


def _tensors(tree: Any) -> List[Tensor]:
    return [x for x in tree_flatten(tree)[0] if isinstance(x, Tensor)]


def _bind(func: Any, args: Tuple[Any, ...], kwargs: Dict[str, Any]) -> Dict[str, Any]:
    """The op's arguments by name, defaults filled in."""
    bound: Dict[str, Any] = {}
    for i, a in enumerate(func._schema.arguments):
        if a.name in kwargs:
            bound[a.name] = kwargs[a.name]
        elif i < len(args) and not a.kwarg_only:
            bound[a.name] = args[i]
        elif a.has_default_value():
            bound[a.name] = a.default_value
    return bound


def _index_bytes(*trees: Any) -> int:
    return sum(tensor_bytes(t) for tree in trees for t in _tensors(tree))


# Indexed ops move the rows they touch, not the tensors they index: a
# read of ``out``'s elements from the source (``index``, ``embedding``,
# ``gather``, ...), or, written in place, the elements the index selects
# (read too where they accumulate) and the values written. Each rule
# returns (bytes read, bytes written), from shapes alone.
def _read_rows(source: str, index: str) -> Callable[..., Tuple[int, int]]:
    def rule(func: Any, a: Dict[str, Any], out: Any) -> Tuple[int, int]:
        (o,) = _tensors(out)
        return (_index_bytes(a[index]) + o.numel() * a[source].element_size(),
                tensor_bytes(o))
    return rule


def _put_rows(func: Any, a: Dict[str, Any], out: Any) -> Tuple[int, int]:
    """``self[indices] = values`` (``accumulate``: ``+=``). The selected
    elements: the index tensors' broadcast shape times the dims no index
    covers; under a mask (its count is data) the values' count."""
    target, indices, values = a["self"], list(a["indices"]), a["values"]
    idx = [i for i in indices if i is not None]
    if any(i.dtype in (torch.bool, torch.uint8) for i in idx):
        n = values.numel()
    else:
        rest = [d for k, d in enumerate(target.shape) if k >= len(indices) or indices[k] is None]
        n = math.prod(torch.broadcast_shapes(*(i.shape for i in idx))) * math.prod(rest)
    written = n * target.element_size()
    reads = _index_bytes(idx, values) + (written if a["accumulate"] else 0)
    return reads, written


def _dim_rows(accumulates: bool) -> Callable[..., Tuple[int, int]]:
    """``index_copy_`` / ``index_fill_`` / ``index_add_`` / ``index_reduce_``:
    the slices at ``index`` along ``dim``."""
    def rule(func: Any, a: Dict[str, Any], out: Any) -> Tuple[int, int]:
        target, index = a["self"], a["index"]
        slice_numel = target.numel() // target.shape[a["dim"]] if target.ndim else 1
        written = index.numel() * slice_numel * target.element_size()
        reads = _index_bytes(index, a.get("source"), a.get("value"))
        return reads + (written if accumulates else 0), written
    return rule


def _scatter(func: Any, a: Dict[str, Any], out: Any) -> Tuple[int, int]:
    """``scatter_`` and its reductions: one element of ``self`` for each of
    ``index``'s, from ``src`` at the same place."""
    target, index, src = a["self"], a["index"], a.get("src")
    written = index.numel() * target.element_size()
    reads = tensor_bytes(index) + (index.numel() * src.element_size()
                                   if isinstance(src, Tensor) else 0)
    accumulates = (func.overloadpacket is not torch.ops.aten.scatter_
                   or func._overloadname in ("reduce", "value_reduce"))
    return reads + (written if accumulates else 0), written


_A = torch.ops.aten
_INDEXED: Dict[Any, Callable[..., Tuple[int, int]]] = {
    _A.index: _read_rows("self", "indices"),
    _A.index_select: _read_rows("self", "index"),
    _A.gather: _read_rows("self", "index"),
    _A.take: _read_rows("self", "index"),
    _A.embedding: _read_rows("weight", "indices"),
    _A.index_put_: _put_rows,
    _A._index_put_impl_: _put_rows,
    _A.index_copy_: _dim_rows(False),
    _A.index_fill_: _dim_rows(False),
    _A.index_add_: _dim_rows(True),
    _A.index_reduce_: _dim_rows(True),
    _A.scatter_: _scatter,
    _A.scatter_add_: _scatter,
    _A.scatter_reduce_: _scatter,
}


class CollectiveTally:
    """Collectives reported by :mod:`repro_torch.parallel.collectives`: bytes
    and calls by (op, the group's global ranks). The payload of a call is
    the larger of its operand and its result (the reference's rule)."""

    def __init__(self) -> None:
        self._bytes: Dict[Tuple[str, Tuple[int, ...]], int] = defaultdict(int)
        self._calls: Dict[Tuple[str, Tuple[int, ...]], int] = defaultdict(int)
        self._ranks: Dict[int, Tuple[Any, Tuple[int, ...]]] = {}
        self._lock = threading.Lock()

    def add(self, op: str, group: Any, payload: int) -> None:
        with self._lock:
            known = self._ranks.get(id(group))
            if known is None or known[0] is not group:
                known = (group, tuple(dist.get_process_group_ranks(group)))
                self._ranks[id(group)] = known
            key = (op, known[1])
            self._bytes[key] += int(payload)
            self._calls[key] += 1

    def collective_bytes(self) -> Tuple[int, Dict[str, int], Dict[str, int]]:
        """(total bytes, bytes by op, calls by op)."""
        by_op: Dict[str, int] = defaultdict(int)
        counts: Dict[str, int] = defaultdict(int)
        for (op, _), b in self._bytes.items():
            by_op[op] += b
            counts[op] += self._calls[(op, _)]
        return sum(by_op.values()), dict(by_op), dict(counts)

    def bytes_by_group_size(self) -> Dict[int, int]:
        out: Dict[int, int] = defaultdict(int)
        for (_, ranks), b in self._bytes.items():
            out[len(ranks)] += b
        return dict(out)

    def bytes_by_link(self, hw: Dict[str, float]) -> Dict[str, int]:
        """Bytes by the slowest link each group crosses
        (:func:`repro_torch.roofline.analysis.link_of`)."""
        from repro_torch.roofline.analysis import link_of

        out: Dict[str, int] = defaultdict(int)
        for (_, ranks), b in self._bytes.items():
            out[link_of(ranks, hw)] += b
        return dict(out)


@dataclass
class StepCounts:
    """One rank's counts of one step (filled when :func:`count_step` exits)."""
    flops: int = 0
    bytes: int = 0
    peak_bytes: int = 0
    argument_bytes: int = 0
    output_bytes: int = 0
    flops_by_op: Dict[str, int] = field(default_factory=dict)
    collectives: CollectiveTally = field(default_factory=CollectiveTally)


class _Counter:
    """Bytes moved and live storages of one count."""

    def __init__(self) -> None:
        self.bytes = 0
        self.live: Dict[int, int] = {}  # storage (its StorageImpl address) -> bytes
        self.live_bytes = 0
        self.peak = 0
        self.argument_bytes = 0
        self.finalizers: List[Any] = []
        self.lock = threading.Lock()

    def track(self, t: Tensor, argument: bool) -> None:
        st = t.untyped_storage()
        key = st._cdata
        with self.lock:
            if key in self.live:
                return
            n = st.nbytes()
            self.live[key] = n
            self.live_bytes += n
            if argument:
                self.argument_bytes += n
            self.peak = max(self.peak, self.live_bytes)
        self.finalizers.append(weakref.finalize(st, self.free, key))

    def free(self, key: int) -> None:
        with self.lock:
            self.live_bytes -= self.live.pop(key, 0)

    def close(self) -> int:
        """Stop tracking; the bytes still live that the step made."""
        for f in self.finalizers:
            f.detach()
        return self.live_bytes - self.argument_bytes

    def op(self, func: Any, args: Tuple[Any, ...], kwargs: Dict[str, Any], out: Any) -> None:
        if func.namespace in _COLLECTIVE_NAMESPACES:
            return
        inputs = _tensors((args, kwargs))
        for t in inputs:
            self.track(t, argument=True)
        outputs = _tensors(out)
        for t in outputs:
            self.track(t, argument=False)
        if func in _NO_TRAFFIC:
            return
        formula = _BYTE_FORMULAS.get(func.overloadpacket)
        if formula is not None:
            self.bytes += int(formula(*(t.shape for t in inputs)))
            return
        rule = _INDEXED.get(func.overloadpacket)
        if rule is not None:
            reads, writes = rule(func, _bind(func, args, kwargs), out)
            self.bytes += reads + writes
            return
        schema = func._schema
        written = [a.name for a in schema.arguments
                   if a.alias_info is not None and a.alias_info.is_write]
        outs = out if isinstance(out, tuple) and len(schema.returns) > 1 else (out,)
        fresh = [t for r, value in zip(schema.returns, outs) if r.alias_info is None
                 for t in _tensors(value)]
        if not written and not fresh:
            return  # a view or a metadata op
        reads = sum(tensor_bytes(t) for t in inputs)
        writes = sum(tensor_bytes(t) for t in fresh)
        if written:
            names = [a.name for a in schema.arguments]
            for name in written:
                i = names.index(name)
                value = kwargs[name] if name in kwargs else (args[i] if i < len(args) else None)
                writes += sum(tensor_bytes(t) for t in _tensors(value))
        self.bytes += reads + writes


class _Traffic(TorchDispatchMode):
    def __init__(self, counter: _Counter) -> None:
        super().__init__()
        self.counter = counter

    def __torch_dispatch__(self, func: Any, types: Any, args: Tuple[Any, ...] = (),
                           kwargs: Optional[Dict[str, Any]] = None) -> Any:
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.counter.op(func, args, kwargs, out)
        return out


@contextlib.contextmanager
def count_step(arguments: Any = ()) -> Iterator[StepCounts]:
    """Count what runs inside the block: FLOPs, bytes moved, peak live bytes
    and collectives (module docstring). ``arguments`` (any tree of tensors,
    modules' parameters included by the caller) are live from the start and
    make ``argument_bytes``. The counts are filled when the block exits."""
    # Every kernel's formulas registered before the FLOP counter copies the
    # registry (a layer may import its kernel module on its first call).
    import repro_torch.kernels  # noqa: F401
    from repro_torch.parallel import collectives as C

    counts = StepCounts()
    counter = _Counter()
    for t in _tensors(arguments):
        counter.track(t, argument=True)
    flop_mode = FlopCounterMode(display=False)
    _ACTIVE.append(counter)
    try:
        with C.tallied(counts.collectives), flop_mode, _Traffic(counter):
            yield counts
    finally:
        _ACTIVE.remove(counter)
        counts.flops = int(flop_mode.get_total_flops())
        counts.flops_by_op = {str(k): int(v) for k, v in
                              flop_mode.get_flop_counts().get("Global", {}).items()}
        counts.bytes = counter.bytes
        counts.peak_bytes = counter.peak
        counts.argument_bytes = counter.argument_bytes
        counts.output_bytes = counter.close()
