"""Gait machinery: contact-flag mode encoding, gait templates, the
gait -> mode-schedule expansion, contact-driven gait adaptation (early
touchdown), gait sequences and asynchronous gait commands.

Counterpart of ``ocs2_tpu/models/legged_robot/gait.py``.  Modes are 4-bit
contact masks (bit i = leg i in contact).

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


def time_until_next_touchdown(ms: ModeSchedule, t: float, leg: int) -> float:
    """Time from t until the leg's next planned swing->contact transition
    (+inf when none inside the schedule)."""
    events = np.asarray(ms.event_times, np.float64)
    modes = np.asarray(ms.mode_sequence)
    k = int(np.searchsorted(events, t, side="right"))
    in_contact = bool((int(modes[k]) >> leg) & 1)
    for j in range(k, min(len(events), int(ms.num_events))):
        nxt = bool((int(modes[j + 1]) >> leg) & 1)
        if not in_contact and nxt:
            return float(events[j] - t)
        in_contact = nxt
    return np.inf


def apply_early_touchdown(ms: ModeSchedule, t: float, early_legs) -> ModeSchedule:
    """Force the contact bit ON for the flagged legs from t until each leg's
    next planned touchdown: the first swing phase of every flagged leg is
    removed."""
    events = np.asarray(ms.event_times, np.float64)
    modes = np.asarray(ms.mode_sequence, np.int64).copy()
    k0 = int(np.searchsorted(events, t, side="right"))
    n_ev = int(ms.num_events)
    for leg in np.nonzero(np.asarray(early_legs))[0]:
        in_contact_now = bool((int(modes[k0]) >> int(leg)) & 1)
        if in_contact_now:
            continue
        j = k0
        while j <= n_ev:
            if (int(modes[j]) >> int(leg)) & 1:
                break  # planned touchdown reached
            modes[j] |= 1 << int(leg)
            j += 1
    return ModeSchedule(
        event_times=np.asarray(ms.event_times),
        mode_sequence=modes.astype(np.int32),
        num_events=np.asarray(ms.num_events),
    )


@dataclasses.dataclass
class GaitAdaptationSettings:
    """Window before a planned touchdown in which a measured contact counts
    as an early touchdown."""

    early_touchdown_window: float = 0.1


class GaitAdaptation:
    """Contact-measurement-driven gait adaptation.

    A leg planned to SWING but
    MEASURED in contact within `early_touchdown_window` of its planned
    touchdown is flagged early-contact — its remaining swing is removed from
    the schedule, so the solver immediately treats it as a stance leg.  A
    leg must have lifted off since its last stance before a new touchdown
    can be recognized."""

    def __init__(
        self,
        settings: GaitAdaptationSettings = GaitAdaptationSettings(),
        num_legs: int = 4,
    ):
        self.settings = settings
        self._lifted = [False] * num_legs

    def advance(self, ms: ModeSchedule, measured_contacts, t: float) -> ModeSchedule:
        """One tick: update liftoff tracking and return the (possibly)
        adapted mode schedule."""
        desired = contact_flags_static(int(ms.mode_at_time(np.float32(t))))
        early = [False] * len(self._lifted)
        for leg in range(len(self._lifted)):
            planned_contact = desired[leg] > 0.5
            measured = bool(measured_contacts[leg])
            if not planned_contact and not measured:
                self._lifted[leg] = True
            if planned_contact and measured:
                self._lifted[leg] = False
            if (
                not planned_contact
                and measured
                and self._lifted[leg]
                and time_until_next_touchdown(ms, t, leg)
                <= self.settings.early_touchdown_window
            ):
                early[leg] = True
                self._lifted[leg] = False
        if any(early):
            return apply_early_touchdown(ms, t, early)
        return ms


# ---------------------------------------------------------------------------
# Gait sequences + asynchronous gait commands.
# ---------------------------------------------------------------------------


class GaitSequenceSchedule:
    """Deque-of-gaits schedule with phase tracking: the LAST gait repeats
    indefinitely; scheduled gaits are consumed as time passes.

    Unlike the periodic `GaitSchedule` above (one template + pending swap),
    this holds an explicit timeline of (start_time, gait) entries, supporting
    setNextGait / setGaitAtTime / setGaitAfterTime / gait sequences.
    """

    def __init__(self, time: float, gait: ModeSequenceTemplate, capacity: int = 16):
        self.time = float(time)
        self.capacity = capacity
        # Timeline: list of (start_time, gait); gaits[i] is active on
        # [start[i], start[i+1]); the last repeats forever.
        self._timeline: list[tuple[float, ModeSequenceTemplate]] = [
            (float(time), gait)
        ]

    # -- queries ------------------------------------------------------------
    def _active_index(self, t: float) -> int:
        i = 0
        for j, (s, _) in enumerate(self._timeline):
            if s <= t:
                i = j
        return i

    def current_gait(self, t=None) -> ModeSequenceTemplate:
        return self._timeline[self._active_index(self.time if t is None else t)][1]

    def current_phase(self, t=None) -> float:
        """Normalized phase in [0, 1) of the active gait."""
        t = self.time if t is None else t
        i = self._active_index(t)
        start, gait = self._timeline[i]
        return ((t - start) % gait.duration) / gait.duration

    def time_left_in_gait(self, t=None) -> float:
        t = self.time if t is None else t
        i = self._active_index(t)
        start, gait = self._timeline[i]
        return gait.duration - ((t - start) % gait.duration)

    def _cycle_boundary_after(self, t: float) -> float:
        """First completed-cycle boundary of the active gait at/after t."""
        i = self._active_index(t)
        start, gait = self._timeline[i]
        k = np.ceil((t - start) / gait.duration - 1e-12)
        return float(start + max(k, 0.0) * gait.duration)

    # -- mutations ------------------------------------------------------------
    def advance_to_time(self, t: float) -> None:
        """Drop timeline entries completed before t."""
        assert t >= self.time - 1e-9, "time must be increasing"
        self.time = float(t)
        while len(self._timeline) > 1 and self._timeline[1][0] <= t:
            self._timeline.pop(0)

    def set_next_gait(self, gait: ModeSequenceTemplate) -> None:
        self.set_gait_sequence_after_current((gait,))

    def set_gait_sequence_after_current(self, gaits) -> None:
        """Append after the CURRENT gait completes its cycle; later scheduled
        gaits are dropped."""
        boundary = self._cycle_boundary_after(self.time)
        if boundary <= self.time:
            boundary += self.current_gait().duration
        i = self._active_index(self.time)
        self._timeline = self._timeline[: i + 1]
        t = boundary
        for g in gaits:
            self._timeline.append((t, g))
            t += g.duration

    def set_gait_at_time(self, gait: ModeSequenceTemplate, t: float) -> None:
        """Insert at exactly t, shrinking the gait active there and dropping
        everything later."""
        self.set_gait_sequence_at_time((gait,), t)

    def set_gait_sequence_at_time(self, gaits, t: float) -> None:
        i = self._active_index(t)
        self._timeline = self._timeline[: i + 1]
        tt = float(t)
        for g in gaits:
            self._timeline.append((tt, g))
            tt += g.duration

    def set_gait_after_time(self, gait: ModeSequenceTemplate, t: float) -> None:
        """Insert at the first cycle boundary after t (cycle durations are
        not adapted)."""
        self.set_gait_sequence_after_time((gait,), t)

    def set_gait_sequence_after_time(self, gaits, t: float) -> None:
        boundary = self._cycle_boundary_after(max(t, self.time))
        if boundary <= t:
            i = self._active_index(t)
            boundary += self._timeline[i][1].duration
        self.set_gait_sequence_at_time(gaits, boundary)

    # -- expansion ----------------------------------------------------------
    def mode_schedule(self, t0: float, tf: float) -> ModeSchedule:
        """Stitch the timeline into a padded ModeSchedule over [t0, tf]."""
        events, modes = [], []
        i = self._active_index(t0)
        timeline = self._timeline[i:]
        for j, (start, gait) in enumerate(timeline):
            seg_end = timeline[j + 1][0] if j + 1 < len(timeline) else tf + gait.duration
            sw = np.asarray(gait.switching_times[:-1], np.float64)
            mseq = np.asarray(gait.mode_sequence)
            k = int(np.floor((max(t0, start) - start) / gait.duration))
            cycle_start = start + k * gait.duration
            while cycle_start < min(seg_end, tf) + gait.duration:
                for jj, s in enumerate(sw):
                    t_evt = cycle_start + s
                    if t_evt >= seg_end:
                        break
                    events.append(t_evt)
                    modes.append(int(mseq[jj]))
                cycle_start += gait.duration
            if seg_end > tf:
                break
        events = np.asarray(events, np.float64)
        modes_arr = np.asarray(modes)
        order = np.argsort(events, kind="stable")
        events, modes_arr = events[order], modes_arr[order]
        keep = (events > t0) & (events < tf)
        first_after = int(np.searchsorted(events, t0, side="right"))
        lead = modes_arr[max(first_after - 1, 0)] if len(modes_arr) else STANCE
        kept_e = events[keep][: self.capacity]
        kept_m = modes_arr[keep][: self.capacity]
        return ModeSchedule.create(
            kept_e, np.concatenate([[lead], kept_m]), capacity=self.capacity
        )


def is_standing(schedule: GaitSequenceSchedule, horizon: float = 0.0) -> bool:
    """True when every mode over [t, t+horizon] is full stance."""
    ms = schedule.mode_schedule(schedule.time, schedule.time + max(horizon, 1e-6))
    n = int(ms.num_events)
    return bool(np.all(np.asarray(ms.mode_sequence)[: n + 1] == STANCE))


class GaitReceiver:
    """Asynchronous gait command channel applied pre-solve: a thread-safe
    command queue drained in ``pre_solver_run``."""

    def __init__(self, schedule: GaitSequenceSchedule):
        import threading

        self.schedule = schedule
        self._lock = threading.Lock()
        self._pending: list = []

    # Command surface.
    def command_gait(self, gait_or_name, at_time: float | None = None) -> None:
        gait = (
            GAIT_MAP[gait_or_name]()
            if isinstance(gait_or_name, str)
            else gait_or_name
        )
        with self._lock:
            self._pending.append(("gait", gait, at_time))

    def command_gait_sequence(self, gaits, at_time: float | None = None) -> None:
        gaits = tuple(
            GAIT_MAP[g]() if isinstance(g, str) else g for g in gaits
        )
        with self._lock:
            self._pending.append(("sequence", gaits, at_time))

    def pre_solver_run(self, t0: float, tf: float, x0) -> None:
        del tf, x0
        with self._lock:
            pending, self._pending = self._pending, []
        self.schedule.advance_to_time(t0)
        for kind, payload, at_time in pending:
            if kind == "gait":
                if at_time is None:
                    self.schedule.set_next_gait(payload)
                else:
                    self.schedule.set_gait_after_time(payload, at_time)
            else:
                if at_time is None:
                    self.schedule.set_gait_sequence_after_current(payload)
                else:
                    self.schedule.set_gait_sequence_after_time(payload, at_time)
