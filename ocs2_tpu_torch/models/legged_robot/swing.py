"""Swing trajectory planner: per-leg foot height/velocity references.

Counterpart of ``ocs2_tpu/models/legged_robot/swing.py``: cubic splines
liftoff -> apex -> touchdown; the swing normal-velocity constraint tracks the
spline's vertical velocity.

Host-side construction (numpy, O(N*legs) on tiny arrays, per MPC tick),
producing fixed-shape per-node arrays.  ``interface.make_params`` moves them
to the device; the swing constraints gather their node's row by the injected
node index.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np

from .gait import contact_flags_static
from .model import NUM_LEGS


class SwingReference(NamedTuple):
    """Per-node references: z position [N+1, 4] and vertical velocity
    [N+1, 4] of each foot (world z, terrain at z=0), numpy float32."""

    z: np.ndarray
    vz: np.ndarray


def _cubic_swing(phase: np.ndarray, height: float, duration: float):
    """Symmetric swing profile z(s) on s in [0,1]: two cubics through the
    apex.  Returns (z, dz/dt)."""
    s = np.clip(phase, 0.0, 1.0)
    # z(s) = h * 16 s^2 (1-s)^2 normalized to peak h at s=0.5.
    z = height * 16.0 * s**2 * (1.0 - s) ** 2
    dz_ds = height * 16.0 * (2.0 * s * (1 - s) ** 2 - 2.0 * s**2 * (1 - s))
    return z, dz_ds / max(duration, 1e-6)


def plan_swing_references(
    node_times: np.ndarray,
    node_modes: np.ndarray,
    swing_height: float = 0.1,
) -> SwingReference:
    """Build per-node (z, vz) references from the discretized mode sequence.

    Contact phases are read directly off the node modes; swing windows are
    the maximal runs of non-contact nodes, with liftoff/touchdown at the run
    boundaries (events are grid-aligned, so this equals reading them off the
    event times up to grid resolution).
    """
    node_times = np.asarray(node_times, np.float64)
    node_modes = np.asarray(node_modes)
    n1 = node_times.shape[0]
    z = np.zeros((n1, NUM_LEGS), np.float32)
    vz = np.zeros((n1, NUM_LEGS), np.float32)

    flags = np.stack([contact_flags_static(int(m)) for m in node_modes])  # [N+1, 4]
    for leg in range(NUM_LEGS):
        in_swing = flags[:, leg] < 0.5
        k = 0
        while k < n1:
            if not in_swing[k]:
                k += 1
                continue
            start = k
            while k < n1 and in_swing[k]:
                k += 1
            end = k  # nodes [start, end) are swing
            t_lo = node_times[max(start - 1, 0)]
            t_td = node_times[min(end, n1 - 1)]
            duration = max(t_td - t_lo, 1e-3)
            phase = (node_times[start:end] - t_lo) / duration
            # Swing windows clipped by the horizon boundary use the partial
            # phase: the spline is evaluated at the in-horizon phases.
            zz, vv = _cubic_swing(phase, swing_height, duration)
            z[start:end, leg] = zz
            vz[start:end, leg] = vv
    return SwingReference(z=z, vz=vz)
