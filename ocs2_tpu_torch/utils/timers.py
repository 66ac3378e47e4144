"""Benchmark timers.

Counterpart of ``ocs2_tpu/utils/timers.py``: min/avg/max/total over recorded
intervals, used to instrument MPC ticks.  ``last`` holds the latest interval,
so a caller can read each tick's time as it happens.
"""
from __future__ import annotations

import time


class RepeatedTimer:
    def __init__(self) -> None:
        self.count = 0
        self.total = 0.0
        self.min = float("inf")
        self.max = 0.0
        self.last = 0.0
        self._tic: float | None = None

    def start(self) -> None:
        self._tic = time.perf_counter()

    def stop(self) -> float:
        assert self._tic is not None, "stop() without start()"
        dt = time.perf_counter() - self._tic
        self._tic = None
        self.record(dt)
        return dt

    def record(self, dt: float) -> None:
        self.count += 1
        self.total += dt
        self.min = min(self.min, dt)
        self.max = max(self.max, dt)
        self.last = dt

    @property
    def average(self) -> float:
        return self.total / self.count if self.count else 0.0

    def summary(self, name: str = "") -> str:
        if not self.count:
            return f"{name}: no samples"
        return (
            f"{name}: n={self.count} avg={self.average*1e3:.2f}ms "
            f"min={self.min*1e3:.2f}ms max={self.max*1e3:.2f}ms "
            f"total={self.total:.3f}s"
        )
