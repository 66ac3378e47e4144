"""Trajectory spreading: mode-consistent warm-start remapping.

Counterpart of ``ocs2_tpu/oc/spreading.py``.  When the reference manager
shifts the mode schedule between MPC ticks, naively interpolating the previous
solution onto the new grid smears pre- and post-event samples across the
*new* event times.  Spreading builds a piecewise-linear time warp anchored at
matched event-time pairs (old schedule <-> new schedule) and samples the old
solution through the warp, so every new node reads the old solution from the
same gait phase.

The matching is numpy on the host (it runs between solves, on the schedules'
host arrays); the warp and the interpolation run on the device of the stored
trajectories.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..core.interpolation import interpolate_batch
from ..core.reference import ModeSchedule

Tensor = torch.Tensor


def match_event_times(
    old_ms: ModeSchedule,
    new_ms: ModeSchedule,
    t_lo: float,
    t_hi: float,
) -> Tuple[np.ndarray, np.ndarray]:
    """Matched (new_event_time, old_event_time) anchor pairs inside the window.

    Finds the shift of the old mode sequence that maximizes the leading
    common run with the new sequence, then pairs event j of the new schedule
    with event (shift+j) of the old one.  Returns two equal-length ascending
    arrays (possibly empty when the schedules share no modes in the window).
    """
    old_e = np.asarray(old_ms.event_times, np.float64)
    new_e = np.asarray(new_ms.event_times, np.float64)
    old_m = np.asarray(old_ms.mode_sequence, np.int64)
    new_m = np.asarray(new_ms.mode_sequence, np.int64)
    old_k = int(old_ms.num_events)
    new_k = int(new_ms.num_events)
    old_m = old_m[: old_k + 1]
    new_m = new_m[: new_k + 1]

    best_shift, best_len = 0, 0
    for s in range(len(old_m)):
        run = 0
        while (
            run < len(new_m)
            and s + run < len(old_m)
            and old_m[s + run] == new_m[run]
        ):
            run += 1
        if run > best_len:
            best_shift, best_len = s, run
    if best_len == 0:
        return np.zeros((0,)), np.zeros((0,))

    anchors_new, anchors_old = [], []
    # Event j sits between modes j and j+1 of the new sequence; under the
    # shift it corresponds to old event best_shift + j.
    for j in range(min(best_len - 1, new_k)):
        oi = best_shift + j
        if oi >= old_k:
            break
        tn, to = new_e[j], old_e[oi]
        if t_lo < tn < t_hi and np.isfinite(to):
            anchors_new.append(tn)
            anchors_old.append(to)
    return np.asarray(anchors_new), np.asarray(anchors_old)


def _interp(x: Tensor, xp: Tensor, fp: Tensor) -> Tensor:
    """``numpy.interp`` semantics (the arithmetic of ``jnp.interp``): linear
    between the sample points, clamped to the end values outside them."""
    i = torch.clamp(torch.searchsorted(xp, x, right=True), 1, xp.shape[0] - 1)
    df = fp[i] - fp[i - 1]
    dx = xp[i] - xp[i - 1]
    delta = x - xp[i - 1]
    eps = float(np.spacing(np.finfo(np.float32).eps))
    dx0 = torch.abs(dx) <= eps
    f = torch.where(dx0, fp[i - 1], fp[i - 1] + (delta / torch.where(dx0, 1.0, dx)) * df)
    f = torch.where(x < xp[0], fp[0], f)
    return torch.where(x > xp[-1], fp[-1], f)


def warp_times(query: Tensor, anchors_new, anchors_old) -> Tensor:
    """Piecewise-linear map new-timeline -> old-timeline, on query's device.

    The start of the query window is "now": the present state is at the
    present time under both schedules, so the warp is pinned to identity
    there.  Between anchors: linear interpolation; beyond the last anchor:
    rigid shift by its offset.  Identity when there are no anchors.
    """
    if len(anchors_new) == 0:
        return query
    f32 = lambda v: torch.as_tensor(  # noqa: E731
        np.asarray(v, np.float32), device=query.device)
    anchors_new, anchors_old = f32(anchors_new), f32(anchors_old)
    q0 = torch.minimum(torch.min(query), anchors_new[0] - 1e-6)
    xp = torch.cat([q0[None], anchors_new])
    fp = torch.cat([q0[None], anchors_old])
    inside = _interp(query, xp, fp)
    hi_shift = anchors_old[-1] - anchors_new[-1]
    return torch.where(query > anchors_new[-1], query + hi_shift, inside)


def spread_trajectories(
    prev_times: Tensor,  # [M+1] node times of the stored solution
    prev_xs: Tensor,  # [M+1, nx]
    prev_us: Tensor,  # [M, nu]
    old_ms: ModeSchedule,
    new_ms: ModeSchedule,
    new_times,  # [N+1] target node times (host array or tensor)
):
    """Sample (xs, us) at new_times through the event-anchored warp.
    Returns (xs [N+1, nx], us [N, nu]) on prev_xs's device."""
    if not isinstance(new_times, torch.Tensor):
        new_times = np.asarray(new_times, np.float32)
    a_new, a_old = match_event_times(
        old_ms, new_ms, float(new_times[0]), float(new_times[-1]))
    new_times = torch.as_tensor(new_times, dtype=torch.float32, device=prev_xs.device)
    tq_x = warp_times(new_times, a_new, a_old)
    xs = interpolate_batch(prev_times, prev_xs, tq_x)
    us = interpolate_batch(prev_times[:-1], prev_us, tq_x[:-1])
    return xs, us


def mode_schedules_differ(old_ms: ModeSchedule, new_ms: ModeSchedule) -> bool:
    """Host-side check whether spreading is needed at all."""
    if int(old_ms.num_events) != int(new_ms.num_events):
        return True
    k = int(old_ms.num_events)
    return bool(
        np.any(
            np.asarray(old_ms.event_times[:k]) != np.asarray(new_ms.event_times[:k])
        )
        or np.any(
            np.asarray(old_ms.mode_sequence[: k + 1])
            != np.asarray(new_ms.mode_sequence[: k + 1])
        )
    )
