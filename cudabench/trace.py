"""The traced run's device timeline, read from ``torch.profiler``.

A run with ``--trace 1`` measures its window under the profiler, which
records the card's activity alone (kernels, copies, sets): recording every
host-side op as well slowed a training step about twofold. The harness's
own ranges (the window, and each call into the program inside it) are
taken on the host's wall clock (``time.time_ns``), the clock the profiler
puts its device timestamps on, so an idle gap on the device can be named
by what the harness was doing. Before the window a pad of
``torch.cuda._sleep(0)`` launches runs (device entries named
``spin_kernel``, which no path of the program launches): on the card's
hosts a trace loses its first few device entries, and the pad takes that
loss.

:class:`Timeline` is the reduction the per-layer readers take: the device
entries inside the window, by name and kind, and the harness's ranges.
"""

from __future__ import annotations

import contextlib
import sys
import time
from dataclasses import dataclass, field
from typing import Iterator, List, Optional, Tuple

import torch

#: The harness's range of the measured window.
WINDOW = "window"
#: ``torch.cuda._sleep(0)`` launches before the window.
PAD = 64
#: The profiler's device activity kinds that are work on the device.
DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")

Interval = Tuple[float, float]


@dataclass
class DeviceOp:
    start: float  # seconds, the trace's clock
    end: float
    name: str
    kind: str  # "kernel", "gpu_memcpy" or "gpu_memset"


@dataclass
class Timeline:
    window: Interval
    ops: List[DeviceOp] = field(default_factory=list)
    ranges: List[Tuple[float, float, str]] = field(default_factory=list)
    pad_seen: int = 0

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def busy_s(self, kinds: Tuple[str, ...] = DEVICE_KINDS) -> float:
        """Seconds of the window in which the device ran an op of ``kinds``
        (the union of their intervals: overlapping ops count once)."""
        return sum(e - s for s, e in union(
            (op.start, op.end) for op in self.ops if op.kind in kinds))

    def time_of(self, kinds: Tuple[str, ...] = ("kernel",), names: Tuple[str, ...] = ()) -> float:
        """Summed device seconds of the ops of ``kinds`` whose name holds
        one of ``names`` (every op of ``kinds`` without ``names``)."""
        return sum(op.end - op.start for op in self.ops if op.kind in kinds
                   and (not names or any(n in op.name for n in names)))

    def gaps(self) -> List[Interval]:
        """The idle intervals of the window, longest first."""
        busy = union((op.start, op.end) for op in self.ops)
        out, at = [], self.window[0]
        for s, e in busy:
            if s > at:
                out.append((at, s))
            at = max(at, e)
        if at < self.window[1]:
            out.append((at, self.window[1]))
        return sorted(out, key=lambda g: g[0] - g[1])

    def doing_at(self, t: float) -> str:
        """The innermost harness range open at ``t`` ("outside" if none)."""
        inner = None
        for s, e, name in self.ranges:
            if s <= t <= e and name != WINDOW and (inner is None or s >= inner[0]):
                inner = (s, name)
        return inner[1] if inner else "outside"

    def breakdown(self, top: int = 10) -> dict:
        """The device ops that took most time and the longest idle gaps,
        each gap named by the harness range it fell in (seconds)."""
        by_name: dict = {}
        for op in self.ops:
            by_name[op.name] = by_name.get(op.name, 0.0) + op.end - op.start
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        gaps = [[self.doing_at((s + e) / 2), e - s] for s, e in self.gaps()[:top]]
        return {"device_ops": [[n[:200], t] for n, t in ops], "idle_gaps": gaps}


def union(intervals: Iterator[Interval]) -> List[Interval]:
    """Merged, sorted intervals."""
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


class Tracer:
    """``span(name)`` marks a call into the program; with tracing on the
    window runs under ``torch.profiler`` (the card's activity) and
    :attr:`timeline` holds its reduction after :meth:`window` exits. Off,
    every method costs nothing."""

    def __init__(self, enabled: bool, device: torch.device) -> None:
        self.enabled = enabled
        self.device = device
        self.timeline: Optional[Timeline] = None
        self._ranges: List[Tuple[float, float, str]] = []

    @contextlib.contextmanager
    def _range(self, name: str) -> Iterator[None]:
        start = time.time_ns()
        try:
            yield
        finally:
            self._ranges.append((start / 1e9, time.time_ns() / 1e9, name))

    def span(self, name: str) -> contextlib.AbstractContextManager:
        return self._range(name) if self.enabled else contextlib.nullcontext()

    @contextlib.contextmanager
    def window(self) -> Iterator[None]:
        if not self.enabled:
            yield
            return
        if self.device.type != "cuda":  # nothing to trace: the ranges alone
            with self._range(WINDOW):
                yield
            self.timeline = Timeline(self._ranges[-1][:2], [], self._ranges)
            return
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(PAD):
                torch.cuda._sleep(0)
            torch.cuda.synchronize(self.device)
            with self._range(WINDOW):
                yield
        self.timeline = reduce_trace(prof, self._ranges)


def kind_of(name: str) -> str:
    """A device entry's kind by the name CUPTI gives it: copies are
    ``Memcpy ...``, sets ``Memset ...``, the rest kernels."""
    if name.startswith("Memcpy"):
        return "gpu_memcpy"
    if name.startswith("Memset"):
        return "gpu_memset"
    return "kernel"


def reduce_trace(prof: "torch.profiler.profile",
                 ranges: List[Tuple[float, float, str]]) -> Timeline:
    """The window's device entries (seconds, the wall clock) and the
    harness's ranges."""
    window = next((s, e) for s, e, name in ranges if name == WINDOW)
    raw, pad = [], 0
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() != torch.autograd.DeviceType.CUDA:
            continue
        name = ev.name()
        if "spin_kernel" in name:
            pad += 1
            continue
        start = ev.start_ns() / 1e9
        raw.append(DeviceOp(start, start + ev.duration_ns() / 1e9, name, kind_of(name)))
    ops = [DeviceOp(max(op.start, window[0]), min(op.end, window[1]), op.name, op.kind)
           for op in raw if op.end > window[0] and op.start < window[1]]
    print(f"cudabench: trace: {len(ops)} of {len(raw)} device entries in the window "
          f"({sum(o.kind == 'kernel' for o in ops)} kernels), {pad} of {PAD} pad entries",
          file=sys.stderr)
    if raw and not ops:
        raise RuntimeError("no device entry of the trace lies in the window: the profiler's "
                           "clock is not the host's wall clock")
    return Timeline(window, ops, ranges, pad)
