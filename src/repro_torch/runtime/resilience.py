"""Fleet resilience: straggler detection, preemption, elastic plans
(counterpart of ``src/repro/runtime/resilience.py``).

* hard loss: checkpoint and restart (``runtime/checkpoint.py``) with the
  step-indexed data skip (``data/pipeline.py``): a run resumes from
  (checkpoint, step);
* stragglers: ``StepMonitor`` keeps a robust per-step-time median and
  flags outliers, a slow host to drain and replace;
* preemption: ``PreemptionGuard`` traps SIGTERM, and the trainer saves a
  final checkpoint at a step boundary every rank agrees on;
* elastic rescale: checkpoints restore through the target plan's layout,
  so N -> M chips is a reshard at restore time; ``elastic_plan`` picks a
  ``ParallelConfig`` for a new chip count.
"""
from __future__ import annotations

import signal
import time

import numpy as np

from repro_torch.core.topology import ParallelConfig


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

    def stop(self):
        """Record one step at the wall time since ``start``."""
        if self._t0 is None:
            raise RuntimeError("StepMonitor.stop before start")
        dt = time.perf_counter() - self._t0
        self._t0 = None
        self._step += 1
        self.record(self._step, dt)
        return dt

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


def elastic_plan(n_chips: int, *, kv_heads: int, n_heads: int,
                 placement: str = "head_first") -> ParallelConfig:
    """A ``ParallelConfig`` for any healthy chip count: the model (sp)
    extent stays at 16 where it can (so restored layouts keep their
    shape) and the change in chip count goes into dp, the usual elastic
    move: lose a node, shrink dp, keep each chip's memory."""
    sp = 16
    while sp > 1 and (n_chips % sp or n_heads % min(sp, 8)):
        sp //= 2
    dp = max(n_chips // sp, 1)
    hp = min(kv_heads, sp, 8)
    while sp % hp or n_heads % hp:
        hp //= 2
    hp = max(hp, 1)
    cp = sp // hp
    inner = min(cp, 4)
    return ParallelConfig(dp=dp, hp=hp, cp_outer=cp // inner, cp_inner=inner,
                          placement=placement)
