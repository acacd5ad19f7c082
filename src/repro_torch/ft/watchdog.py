"""Straggler / hang detection (copied from the reference package; the
standard library only).

At 1000+ node scale the common failure is not a crash but a slow or wedged
worker. The watchdog tracks per-step wall times, flags steps beyond
``k_mad`` median-absolute-deviations (straggler events, logged for the
scheduler to act on), and fires ``on_hang`` if no step completes within
``hang_timeout_s`` — the launcher responds by checkpoint-exit so the job
reschedules instead of burning allocation.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Callable, Deque, List, Optional


class StepWatchdog:
    def __init__(
        self,
        *,
        window: int = 50,
        k_mad: float = 5.0,
        hang_timeout_s: float = 1800.0,
        on_straggler: Optional[Callable[[int, float, float], None]] = None,
        on_hang: Optional[Callable[[], None]] = None,
    ):
        self.window: Deque[float] = deque(maxlen=window)
        self.k_mad = k_mad
        self.hang_timeout_s = hang_timeout_s
        self.on_straggler = on_straggler
        self.on_hang = on_hang
        self.straggler_events: List[dict] = []
        self._last_beat = time.monotonic()
        self._stop = threading.Event()
        self._monitor = threading.Thread(target=self._watch, daemon=True)
        self._monitor.start()

    # called by the train loop after every step
    def beat(self, step: int, step_time_s: float) -> bool:
        """Returns True if this step is flagged as a straggler."""
        self._last_beat = time.monotonic()
        flagged = False
        if len(self.window) >= 10:
            med = sorted(self.window)[len(self.window) // 2]
            mad = sorted(abs(t - med) for t in self.window)[len(self.window) // 2]
            thresh = med + self.k_mad * max(mad, 0.01 * med)
            if step_time_s > thresh:
                flagged = True
                evt = {"step": step, "t": step_time_s, "median": med}
                self.straggler_events.append(evt)
                if self.on_straggler:
                    self.on_straggler(step, step_time_s, med)
        self.window.append(step_time_s)
        return flagged

    def _watch(self):
        while not self._stop.is_set():
            time.sleep(min(5.0, self.hang_timeout_s / 10))
            if time.monotonic() - self._last_beat > self.hang_timeout_s:
                if self.on_hang:
                    self.on_hang()
                self._last_beat = time.monotonic()

    def close(self):
        self._stop.set()
        self._monitor.join(timeout=1)
