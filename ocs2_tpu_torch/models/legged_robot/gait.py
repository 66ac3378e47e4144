"""Gait machinery: contact-flag mode encoding, gait templates, and the
gait -> mode-schedule expansion.

Counterpart of ``ocs2_tpu/models/legged_robot/gait.py`` (the static part:
gait adaptation, early touchdown, ``GaitSequenceSchedule`` and
``GaitReceiver`` wait for the MPC-runtime slice).  Modes are 4-bit contact
masks (bit i = leg i in contact).

Host-side (numpy) expansion produces the padded ModeSchedule consumed by the
static-shape solver; consumers on the device decode contact flags from the
integer mode with bit ops.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from ...core.reference import ModeSchedule
from .model import NUM_LEGS

Tensor = torch.Tensor

# Leg order: LF RF LH RH (bit 0..3).
STANCE = 15


def mode_number(contact_flags: Sequence[int]) -> int:
    """[LF, RF, LH, RH] bools -> mode int."""
    return sum((1 << i) for i, c in enumerate(contact_flags) if c)


def contact_flags_static(mode: int) -> np.ndarray:
    return np.array([(mode >> i) & 1 for i in range(NUM_LEGS)], np.float32)


def contact_flags(mode: Tensor) -> Tensor:
    """Decode on the device: float flags [..., 4] from integer modes [...]."""
    flags = [torch.bitwise_and(torch.bitwise_right_shift(mode, i), 1) for i in range(NUM_LEGS)]
    return torch.stack(flags, dim=-1).to(torch.float32)


@dataclasses.dataclass(frozen=True)
class ModeSequenceTemplate:
    """One gait cycle: switching times within the cycle + the mode active in
    each sub-interval."""

    switching_times: tuple  # [K+1] ascending, first=0, last=cycle duration
    mode_sequence: tuple  # [K] modes

    @property
    def duration(self) -> float:
        return self.switching_times[-1]


def stance_gait() -> ModeSequenceTemplate:
    return ModeSequenceTemplate((0.0, 1.0), (STANCE,))


def trot_gait(cycle: float = 0.7) -> ModeSequenceTemplate:
    """Diagonal trot: LF+RH then RF+LH."""
    lf_rh = mode_number([1, 0, 0, 1])
    rf_lh = mode_number([0, 1, 1, 0])
    half = cycle / 2.0
    return ModeSequenceTemplate((0.0, half, cycle), (lf_rh, rf_lh))


def static_walk_gait(cycle: float = 1.2) -> ModeSequenceTemplate:
    """Four-beat walk: one swing leg at a time."""
    seq = []
    for swing_leg in (0, 3, 1, 2):  # LF, RH, RF, LH
        flags = [1, 1, 1, 1]
        flags[swing_leg] = 0
        seq.append(mode_number(flags))
    times = tuple(np.linspace(0.0, cycle, 5).tolist())
    return ModeSequenceTemplate(times, tuple(seq))


def pace_gait(cycle: float = 0.7) -> ModeSequenceTemplate:
    left = mode_number([1, 0, 1, 0])
    right = mode_number([0, 1, 0, 1])
    return ModeSequenceTemplate((0.0, cycle / 2, cycle), (right, left))


GAIT_MAP = {
    "stance": stance_gait,
    "trot": trot_gait,
    "static_walk": static_walk_gait,
    "pace": pace_gait,
}


class GaitSchedule:
    """Periodic gait -> ModeSchedule over a queried horizon: template cycles
    are inserted ahead of the horizon; ``set_template`` swaps the gait at a
    cycle boundary."""

    def __init__(self, template: ModeSequenceTemplate, phase: float = 0.0,
                 capacity: int = 16):
        self.template = template
        self.phase = phase  # template start time offset
        self.capacity = capacity
        self._pending: ModeSequenceTemplate | None = None

    def set_template(self, template: ModeSequenceTemplate) -> None:
        """Queue a gait change; applied at the next cycle boundary."""
        self._pending = template

    def mode_schedule(self, t0: float, tf: float) -> ModeSchedule:
        tpl = self.template
        if self._pending is not None:
            # Swap at the next cycle boundary after t0.
            k = np.ceil((t0 - self.phase) / tpl.duration)
            self.phase = self.phase + k * tpl.duration
            self.template = tpl = self._pending
            self._pending = None
        dur = tpl.duration
        sw = np.asarray(tpl.switching_times[:-1])
        modes_cycle = np.asarray(tpl.mode_sequence)
        # Unroll cycles covering [t0, tf].
        k0 = int(np.floor((t0 - self.phase) / dur))
        events, modes = [], []
        k = k0
        while self.phase + k * dur < tf + dur:
            cycle_start = self.phase + k * dur
            for j, s in enumerate(sw):
                t_evt = cycle_start + s
                events.append(t_evt)
                modes.append(int(modes_cycle[j]))
            k += 1
        events = np.asarray(events)
        modes = np.asarray(modes)
        # Keep events strictly inside (t0, tf); the mode before the first
        # kept event is the one whose interval contains t0.
        keep = (events > t0) & (events < tf)
        first_after = int(np.searchsorted(events, t0, side="right"))
        lead_mode = modes[max(first_after - 1, 0)]
        kept_events = events[keep]
        kept_modes = modes[keep]
        mode_seq = np.concatenate([[lead_mode], kept_modes])
        if len(kept_events) > self.capacity:
            kept_events = kept_events[: self.capacity]
            mode_seq = mode_seq[: self.capacity + 1]
        return ModeSchedule.create(
            kept_events, mode_seq, capacity=self.capacity
        )
