"""SIGTERM/SIGINT preemption handling: request a final checkpoint + clean
exit at the next step boundary (cloud preemptions send SIGTERM with a grace
window). Copied from the reference package (the standard library only)."""

from __future__ import annotations

import signal
import threading


class PreemptionHandler:
    def __init__(self, *, signals=(signal.SIGTERM,)):
        self._requested = threading.Event()
        self._prev = {}
        for sig in signals:
            self._prev[sig] = signal.signal(sig, self._handle)

    def _handle(self, signum, frame):
        self._requested.set()

    @property
    def requested(self) -> bool:
        return self._requested.is_set()

    def restore(self):
        for sig, prev in self._prev.items():
            signal.signal(sig, prev)
