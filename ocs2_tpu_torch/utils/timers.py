"""Benchmark timers and the solver's phase spans.

Counterpart of ``ocs2_tpu/utils/timers.py``: min/avg/max/total over recorded
intervals, used to instrument MPC ticks.  ``last`` holds the latest interval,
so a caller can read each tick's time as it happens.

The same module records the consecutive phases of a solve (``SpanRecorder``;
``solvers/sqp.solve`` marks its loop as ``sqp.*`` spans, ``solvers/ipm.solve``
its loop as ``ipm.*`` spans: ``ipm.host_read``, ``ipm.approx``,
``ipm.condense``, ``ipm.projection``, ``ipm.riccati``, ``ipm.forward``,
``ipm.line_search``, ``ipm.update``).  A mark closes the open phase and
opens the next, so the phases tile the loop.  Each phase keeps its host
interval (``time.perf_counter_ns``) and its device interval: the stretch of
the stream's timeline between two CUDA events recorded at its boundaries,
idle time included.  On the CPU the host interval stands in for the device
interval.  Events are read only where the solve has already synchronised
(a mark with ``synced=True``) or when a reader asks, so recording adds no
synchronise.  Each phase also opens a ``torch.profiler.record_function``
range under its name, which puts it on the profiler's timeline beside the
kernels it launched.

Recording is on while a ``torch.profiler`` session records and inside
``with recording():``; off, a solve's marks do nothing.  Per span name the
recorder keeps a ``RepeatedTimer`` of host and one of device time, and the
records of the last solve only.  One thread records at a time::

    from ocs2_tpu_torch.utils import observers, timers
    with timers.recording():
        sqp.solve(...)
    print(observers.benchmark_report(timers.SPANS.timers("device")))
"""
from __future__ import annotations

import contextlib
import dataclasses
import itertools
import threading
import time
from typing import Any, Dict, List, NamedTuple, Optional

import torch


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


@dataclasses.dataclass
class SpanRecord:
    """One phase of one solve."""

    name: str
    parent: str  # the solve's name, e.g. "sqp.solve"
    solve: int  # shared by every span of one call
    iteration: int
    host_start_ns: int
    host_end_ns: int = 0
    device_s: Optional[float] = None  # None until its events are read


class _Phase(NamedTuple):
    """The open phase of a solve."""

    record: SpanRecord
    range: Any  # its torch.autograd.profiler.record_function
    event: Any  # the CUDA event at its start; None on the CPU


class SolveSpans:
    """The marks of one solve; made by ``SpanRecorder.solve``."""

    def __init__(self, recorder: "SpanRecorder", parent: str, solve_id: int, device):
        self._rec = recorder
        self._parent = parent
        self._id = solve_id
        self._stream = (torch.cuda.current_stream(device)
                        if torch.device(device).type == "cuda" else None)
        self._open: Optional[_Phase] = None
        self._iteration = 0

    def mark(self, name: str, iteration: Optional[int] = None, synced: bool = False) -> None:
        """Close the open phase and open ``name``.  ``iteration`` holds for
        this and later marks; ``synced`` says that the host has just read
        the device on this solve's stream, so every event recorded before
        this mark has completed."""
        if iteration is not None:
            self._iteration = iteration
        if synced:
            self._rec._synced()
        # The ranges follow one another: the last one ends before the next
        # begins, and the boundary's event is recorded inside the next.
        if self._open is not None:
            self._open.range.__exit__(None, None, None)
        range_ = torch.autograd.profiler.record_function(name)
        range_.__enter__()
        event = self._rec._event(self._stream)
        now = time.perf_counter_ns()
        self._close(event, now, owns_end=False)
        self._open = _Phase(
            SpanRecord(name, self._parent, self._id, self._iteration, now), range_, event)

    def drop(self) -> None:
        """Close the open phase's range and record nothing of it (the host
        read that ends the loop belongs to no iteration)."""
        phase, self._open = self._open, None
        if phase is not None:
            phase.range.__exit__(None, None, None)
            self._rec._drop(phase.event)

    def end(self) -> None:
        """Close the open phase, if any: the closing mark of the solve."""
        if self._open is not None:
            self._open.range.__exit__(None, None, None)
            self._close(self._rec._event(self._stream), time.perf_counter_ns(), owns_end=True)

    def _close(self, event, now: int, owns_end: bool) -> None:
        """Record the open phase, ending at ``event`` and ``now``."""
        phase, self._open = self._open, None
        if phase is not None:
            phase.record.host_end_ns = now
            self._rec._closed(phase, event, owns_end)


class _Off:
    """The marks of a solve while recording is off."""

    def mark(self, name: str, iteration: Optional[int] = None, synced: bool = False) -> None:
        pass

    def drop(self) -> None:
        pass

    def end(self) -> None:
        pass


OFF = _Off()


class SpanRecorder:
    """Aggregates per span name, the records of the last solve, and the
    CUDA events not yet read (with a pool of spent ones)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._depth = 0
        self._ids = itertools.count()
        self.reset()

    def reset(self) -> None:
        """Forget every aggregate and record."""
        with self._lock:
            self.host: Dict[str, RepeatedTimer] = {}
            self.device: Dict[str, RepeatedTimer] = {}
            self.last_solve: List[SpanRecord] = []
            self._last_id = -1
            # [record, start event, end event, whether the end event is no
            # other phase's start], in the order the phases closed.
            self._pending: list = []
            self._pool: list = []

    @contextlib.contextmanager
    def recording(self):
        """Record the solves inside the block."""
        with self._lock:
            self._depth += 1
        try:
            yield self
        finally:
            with self._lock:
                self._depth -= 1

    def is_recording(self) -> bool:
        return self._depth > 0 or torch.autograd._profiler_enabled()

    def solve(self, parent: str, device):
        """The marks of a new solve: ``OFF`` unless recording is on."""
        if not self.is_recording():
            return OFF
        with self._lock:
            self._last_id = next(self._ids)
            self.last_solve = []
            return SolveSpans(self, parent, self._last_id, device)

    def timers(self, clock: str = "device") -> Dict[str, RepeatedTimer]:
        """The aggregates of ``clock`` ("host" or "device") by span name,
        every event read first (this waits for the device)."""
        self.flush()
        return dict(self.host if clock == "host" else self.device)

    def mean_ms(self, name: str, clock: str = "device") -> Optional[float]:
        """Milliseconds of span ``name`` per occurrence, or None where none
        was recorded."""
        t = self.timers(clock).get(name)
        return 1e3 * t.average if t is not None and t.count else None

    def flush(self) -> None:
        """Read every recorded event, waiting for each."""
        with self._lock:
            for pending in self._pending:
                pending[2].synchronize()
            self._resolve()

    # -- called by SolveSpans ---------------------------------------------

    def _event(self, stream):
        if stream is None:
            return None
        with self._lock:
            ev = self._pool.pop() if self._pool else torch.cuda.Event(enable_timing=True)
        ev.record(stream)
        return ev

    def _closed(self, phase: _Phase, end_event, owns_end: bool) -> None:
        rec = phase.record
        host_s = (rec.host_end_ns - rec.host_start_ns) * 1e-9
        with self._lock:
            if rec.solve == self._last_id:
                self.last_solve.append(rec)
            self.host.setdefault(rec.name, RepeatedTimer()).record(host_s)
            if phase.event is None:
                rec.device_s = host_s
                self.device.setdefault(rec.name, RepeatedTimer()).record(host_s)
            else:
                self._pending.append([rec, phase.event, end_event, owns_end])

    def _drop(self, event) -> None:
        if event is None:
            return
        with self._lock:
            # The dropped phase started where the last closed one ended.
            if self._pending and self._pending[-1][2] is event:
                self._pending[-1][3] = True
            else:
                self._pool.append(event)

    def _synced(self) -> None:
        with self._lock:
            self._resolve()

    def _resolve(self) -> None:
        """Read the pending phases up to the first whose end event has not
        completed (``query`` waits for nothing); the caller holds the lock."""
        n = 0
        for rec, start, end, owns_end in self._pending:
            if not end.query():
                break
            n += 1
            rec.device_s = start.elapsed_time(end) * 1e-3
            self.device.setdefault(rec.name, RepeatedTimer()).record(rec.device_s)
            # Phases close in order, so the one that ended at `start` has
            # been read already.
            self._pool.append(start)
            if owns_end:
                self._pool.append(end)
        del self._pending[:n]


SPANS = SpanRecorder()


def recording():
    """``with recording():`` records the solves inside the block into
    ``SPANS``."""
    return SPANS.recording()
