"""Horizon time grid with event alignment — static node count.

Counterpart of ``ocs2_tpu/oc/time_discretization.py``.  The grid *data* is
built on the host with numpy per solve (O(N) on ~100 floats); event times
inside the horizon appear as duplicated grid times, and the transition out of
a pre-event node is the jump map (dt = 0) instead of integration.
``TimeGrid.device()`` gives the tensor view a solver indexes on the device.
``make_event_grid_traced`` builds a grid from event times held in tensors
(state-triggered solving): shapes are static, values are data.
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


def make_event_grid_traced(
    t0,
    tf,
    num_base_intervals: int,
    event_times,  # [E] detected event times; inactive slots >= tf (or inf)
    mode_sequence,  # [E+1] integer mode between consecutive events
    dtype=torch.float32,
    device="cuda",
) -> TimeGrid:
    """Grid construction from event times held in tensors, with no host
    read: a fixed budget of E = len(event_times) event slots, each active
    event a duplicated node pair (a zero-length jump interval), each inactive
    slot (outside (t0, tf)) a zero-length NON-jump pair parked at tf (a no-op
    for integration, cost and Riccati).  N = num_base_intervals + 2 E
    whatever fired.  An event on a base node is nudged off it by 2e-6 of the
    horizon, so that a duplicated time marks exactly one jump.  Leaves are
    tensors on ``device`` (modes int64)."""
    ev_in = torch.as_tensor(event_times, device=device)
    e = ev_in.shape[0]
    t0 = torch.as_tensor(t0, dtype=dtype, device=device)
    tf = torch.as_tensor(tf, dtype=dtype, device=device)
    base = torch.linspace(0.0, 1.0, num_base_intervals + 1, dtype=dtype, device=device)
    base = t0 + (tf - t0) * base
    eps = 1e-6 * (tf - t0)
    active = (ev_in > t0 + eps) & (ev_in < tf - eps)
    ev = torch.where(active, ev_in.to(dtype), tf)
    # torch.round, like jnp.round, rounds half to even.
    snap = torch.round((ev - t0) / torch.clamp((tf - t0) / num_base_intervals, min=1e-12))
    on_node = torch.abs(ev - (t0 + snap * (tf - t0) / num_base_intervals)) < eps
    ev = torch.where(active & on_node, ev + 2 * eps, ev)

    times = torch.sort(torch.cat([base, ev, ev])).values
    dts = times[1:] - times[:-1]
    dup = dts <= 0.0
    interior = times[:-1] < tf - eps
    first_of_run = torch.cat([dup[:1], dup[1:] & ~dup[:-1]])
    is_jump = (dup & interior & first_of_run).to(dtype)

    jump_count = torch.cat([
        torch.zeros((1,), dtype=torch.int64, device=device),
        torch.cumsum(is_jump.to(torch.int64), dim=0),
    ])
    mode_sequence = torch.as_tensor(mode_sequence, device=device).to(torch.int64)
    modes = mode_sequence[torch.clamp(jump_count, max=e)]
    return TimeGrid(times=times, is_jump=is_jump, modes=modes)
