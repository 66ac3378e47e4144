"""A short traced window under ``torch.profiler`` (host and device
activities) and what the per-layer metrics read from it: the device's busy
time, the kernels by name, the launches, and the idle gaps by the host
operation that was running."""
from __future__ import annotations

import bisect
import dataclasses
from collections import defaultdict

import torch

from .window import sync

WINDOW = "benchmark_traced_window"
NOT_KERNELS = ("Memcpy", "Memset")
NAME_CHARS = 160


@dataclasses.dataclass
class Trace:
    window_s: float
    busy_s: float
    launches: int  # kernels the device ran in the window
    iterations_run: int
    kernels: dict  # name -> [count, seconds]
    device_ops: list  # [[name, seconds]] the ten that took most time
    idle_gaps: list  # [[host operation, seconds]] the ten that left the device idlest

    def kernel(self, fragment: str):
        """(launches, seconds) of the kernels whose name holds ``fragment``,
        or None."""
        hits = [v for k, v in self.kernels.items() if fragment in k]
        if not hits:
            return None
        return sum(h[0] for h in hits), sum(h[1] for h in hits)


def _merge(intervals):
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def run(scenario, starts, first: int, batches: int, device) -> Trace:
    """Profile ``batches`` more batch solves (host and device activities) and
    reduce the profiler's raw events (not its function-event tree, which
    takes minutes to build for a window of some 10^5 launches)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    its = []
    sync(device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(WINDOW):
            for j in range(batches):
                sol = scenario.solve(starts.batch(first + j))
                its.append(sol.iterations.max())
                del sol
            sync(device)
    cuda = torch.autograd.DeviceType.CUDA
    # The window's own annotation shows on both timelines; on the device's
    # it is a range, not an operation.
    rows = [(e.name(), e.device_type() == cuda, e.start_ns(), e.start_ns() + e.duration_ns(),
             e.start_thread_id()) for e in prof.profiler.kineto_results.events()
            if not (e.device_type() == cuda and (e.name() == WINDOW or e.is_user_annotation()))]
    win = next(r for r in rows if r[0] == WINDOW and not r[1])
    w0, w1 = win[2], win[3]
    device_iv, kernels = [], defaultdict(lambda: [0, 0.0])
    for name, on_device, s, t, _ in rows:
        if not on_device:
            continue
        s, t = max(s, w0), min(t, w1)
        if t <= s:
            continue
        device_iv.append((s, t))
        key = name[:NAME_CHARS]
        kernels[key][1] += (t - s) * 1e-9
        if not name.startswith(NOT_KERNELS):
            kernels[key][0] += 1
    busy = _merge(device_iv)
    busy_s = sum(t - s for s, t in busy) * 1e-9

    # The outermost host operations inside the window on its thread name the
    # idle gaps of the device.
    tops, reach = [], w0
    for name, on_device, s, t, thread in sorted(
            (r for r in rows if not r[1] and r[4] == win[4] and w0 <= r[2] < w1
             and r[0] != WINDOW), key=lambda r: r[2]):
        if s >= reach:
            tops.append((s, t, name))
            reach = t
    tops_start = [t[0] for t in tops]
    gaps = defaultdict(float)
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    for s, t in zip(edges[0::2], edges[1::2]):
        if t <= s:
            continue
        mid = 0.5 * (s + t)
        k = bisect.bisect_right(tops_start, mid) - 1
        name = tops[k][2] if k >= 0 and tops[k][1] >= mid else "host between operations"
        gaps[name[:NAME_CHARS]] += (t - s) * 1e-9
    top = lambda d: sorted(([k, v] for k, v in d.items()), key=lambda kv: -kv[1])[:10]  # noqa: E731
    return Trace(
        window_s=(w1 - w0) * 1e-9, busy_s=busy_s,
        launches=sum(v[0] for v in kernels.values()),
        iterations_run=int(torch.stack(its).sum()) if its else 0,
        kernels=dict(kernels), device_ops=top({k: v[1] for k, v in kernels.items()}),
        idle_gaps=top(gaps))
