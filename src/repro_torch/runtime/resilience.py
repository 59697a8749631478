"""Step-time monitoring and preemption handling (counterpart of
``src/repro/runtime/resilience.py``).

``StepMonitor`` keeps a robust per-step-time median and flags outliers (a
slow host to drain and replace); ``PreemptionGuard`` traps SIGTERM so the
trainer can stop cleanly at the next step boundary.  ``elastic_plan``
comes with the multi-rank work (ROADMAP queue 1, item 10).
"""
from __future__ import annotations

import signal
import time

import numpy as np


class StepMonitor:
    """Robust step-time tracker with straggler/outlier flagging."""

    def __init__(self, window: int = 50, threshold: float = 1.5):
        self.window = window
        self.threshold = threshold
        self.times: list[float] = []
        self.flagged: list[tuple[int, float, float]] = []
        self._t0 = None
        self._step = 0

    def start(self):
        self._t0 = time.perf_counter()

    def lap(self, n: int = 1):
        """Record ``n`` steps at their amortized wall time since the last
        ``start``/``lap``: a loop that syncs only every few steps observes
        step time only at its syncs."""
        if self._t0 is None:
            raise RuntimeError("StepMonitor.lap before start")
        now = time.perf_counter()
        dt = (now - self._t0) / max(n, 1)
        self._t0 = now
        for _ in range(n):
            self._step += 1
            self.record(self._step, dt)
        return dt

    def record(self, step: int, dt: float):
        hist = self.times[-self.window:]
        if len(hist) >= 8:
            med = float(np.median(hist))
            if dt > self.threshold * med:
                self.flagged.append((step, dt, med))
        self.times.append(dt)

    @property
    def median(self) -> float:
        return float(np.median(self.times[-self.window:])) if self.times \
            else 0.0

    def report(self) -> dict:
        return {"steps": len(self.times), "median_s": self.median,
                "stragglers": list(self.flagged)}


class PreemptionGuard:
    """SIGTERM-triggered graceful-shutdown flag.  ``install`` keeps the
    handlers it displaces and ``uninstall`` puts them back."""

    def __init__(self, signals=(signal.SIGTERM,)):
        self.requested = False
        self._installed = False
        self._signals = signals
        self._previous: dict = {}

    def install(self):
        if self._installed:
            return
        for s in self._signals:
            try:
                self._previous[s] = signal.signal(s, self._handler)
            except ValueError:
                pass  # not in the main thread
        self._installed = True

    def uninstall(self):
        """Restore the handlers ``install`` displaced."""
        if not self._installed:
            return
        for s, prev in self._previous.items():
            try:
                signal.signal(s, prev)
            except ValueError:
                pass
        self._previous = {}
        self._installed = False

    def _handler(self, signum, frame):
        self.requested = True
