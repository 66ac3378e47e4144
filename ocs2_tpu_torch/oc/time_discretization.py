"""Horizon time grid with event alignment — static node count.

Counterpart of ``ocs2_tpu/oc/time_discretization.py``.  The grid *data* is
built on the host with numpy per solve (O(N) on ~100 floats); event times
inside the horizon appear as duplicated grid times, and the transition out of
a pre-event node is the jump map (dt = 0) instead of integration.
``TimeGrid.device()`` gives the tensor view a solver indexes on the device.
The traced event-grid construction is not ported yet.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class TimeGrid(NamedTuple):
    """Fixed-size discretization of [t0, tf].

    times: [N+1] node times, non-decreasing; event nodes are duplicated times.
    is_jump: [N] float mask — 1.0 where transition k -> k+1 is a state jump.
    modes: [N+1] integer active mode per node (post-jump mode at event nodes).

    Leaves are numpy arrays on a host-built grid and tensors after
    ``device()``.
    """

    times: np.ndarray | torch.Tensor
    is_jump: np.ndarray | torch.Tensor
    modes: np.ndarray | torch.Tensor

    @property
    def num_intervals(self) -> int:
        return self.is_jump.shape[0]

    @property
    def dts(self):
        return self.times[1:] - self.times[:-1]

    def device(self, device="cuda") -> "TimeGrid":
        """Tensor view of the grid on ``device`` (float32 times and mask,
        int64 modes so they can index)."""
        return TimeGrid(
            times=torch.as_tensor(self.times, dtype=torch.float32, device=device),
            is_jump=torch.as_tensor(self.is_jump, dtype=torch.float32, device=device),
            modes=torch.as_tensor(self.modes, device=device).to(torch.int64),
        )


def make_time_grid(
    t0: float,
    tf: float,
    num_intervals: int,
    event_times=(),
    mode_sequence=None,
) -> TimeGrid:
    """Host-side grid construction.

    Events strictly inside (t0, tf) are snapped onto the grid as duplicated
    node pairs; remaining nodes are spread uniformly across the sub-intervals
    proportionally to their length.
    """
    t0 = float(t0)
    tf = float(tf)
    events = [float(e) for e in event_times if t0 < float(e) < tf and np.isfinite(e)]
    events = sorted(events)
    n_jump = len(events)
    n_integrate = num_intervals - n_jump
    if n_integrate < len(events) + 1:
        raise ValueError(
            f"num_intervals={num_intervals} too small for {n_jump} events"
        )

    # Segment boundaries between consecutive events.
    bounds = [t0] + events + [tf]
    seg_lens = np.diff(bounds)
    # Allocate integration intervals proportionally (>= 1 per segment).
    alloc = np.maximum(1, np.floor(n_integrate * seg_lens / seg_lens.sum()).astype(int))
    while alloc.sum() > n_integrate:
        alloc[np.argmax(alloc)] -= 1
    while alloc.sum() < n_integrate:
        alloc[np.argmax(seg_lens / alloc)] += 1

    times = [t0]
    is_jump = []
    for seg, n_seg in enumerate(alloc):
        seg_grid = np.linspace(bounds[seg], bounds[seg + 1], n_seg + 1)[1:]
        times.extend(seg_grid.tolist())
        is_jump.extend([0.0] * n_seg)
        if seg < len(events):  # duplicate the event node: jump transition
            times.append(bounds[seg + 1])
            is_jump.append(1.0)

    times = np.asarray(times, np.float32)
    is_jump = np.asarray(is_jump, np.float32)
    assert times.shape[0] == num_intervals + 1, (times.shape, num_intervals)

    # Mode per node: mode_sequence[i] is active between events i-1 and i.
    modes = np.zeros((num_intervals + 1,), np.int32)
    if mode_sequence is not None:
        mode_sequence = np.asarray(mode_sequence, np.int32)
        # Count events at-or-before each node; duplicated pre-event node keeps
        # the previous mode, the post-event node takes the next.
        jump_count = np.concatenate([[0], np.cumsum(is_jump.astype(int))])
        modes = mode_sequence[np.minimum(jump_count, len(mode_sequence) - 1)]

    return TimeGrid(
        times=times,
        is_jump=is_jump,
        modes=np.asarray(modes, np.int32),
    )


def uniform_grid(t0: float, tf: float, num_intervals: int) -> TimeGrid:
    return make_time_grid(t0, tf, num_intervals)
