"""Reference containers: mode schedules and target trajectories.

Counterpart of ``ocs2_tpu/core/reference.py``.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .interpolation import interpolate

Tensor = torch.Tensor

# Padding sentinel for unused event slots: +inf keeps searchsorted semantics
# correct (an unused event never triggers).
_INF = np.inf


class ModeSchedule(NamedTuple):
    """Padded mode schedule, host data (numpy leaves).

    event_times: [K] ascending, padded with +inf.
    mode_sequence: [K+1] int32 modes, entry i active on
        (event_times[i-1], event_times[i]).  Padded tail repeats the last mode.
    num_events: [] int32 — number of valid entries in event_times.
    """

    event_times: np.ndarray
    mode_sequence: np.ndarray
    num_events: np.ndarray

    @staticmethod
    def create(event_times, mode_sequence, capacity: int | None = None):
        event_times = np.asarray(event_times, np.float32).reshape(-1)
        mode_sequence = np.asarray(mode_sequence, np.int32).reshape(-1)
        k = event_times.shape[0]
        if capacity is None:
            capacity = k
        assert mode_sequence.shape[0] == k + 1, "need one more mode than events"
        pad_t = np.full((capacity - k,), _INF, event_times.dtype)
        pad_m = np.full((capacity - k,), mode_sequence[-1], np.int32)
        return ModeSchedule(
            event_times=np.concatenate([event_times, pad_t]),
            mode_sequence=np.concatenate([mode_sequence, pad_m]),
            num_events=np.asarray(k, np.int32),
        )

    @staticmethod
    def single_mode(mode: int = 0, capacity: int = 0):
        return ModeSchedule(
            event_times=np.full((capacity,), _INF, np.float32),
            mode_sequence=np.full((capacity + 1,), mode, np.int32),
            num_events=np.asarray(0, np.int32),
        )

    def mode_at_time(self, t):
        """Active mode at time t: a tensor on t's device for a tensor t, a
        numpy value for a host t."""
        if isinstance(t, torch.Tensor):
            events = torch.as_tensor(self.event_times, device=t.device)
            modes = torch.as_tensor(self.mode_sequence, device=t.device)
            return modes[torch.searchsorted(events, t.to(events.dtype), right=True)]
        return self.mode_sequence[np.searchsorted(self.event_times, t, side="right")]

    @property
    def capacity(self) -> int:
        return self.event_times.shape[0]


class TargetTrajectories(NamedTuple):
    """Time-stamped desired state/input trajectories.

    times: [M]; states: [M, nx]; inputs: [M, nu].
    """

    times: Tensor
    states: Tensor
    inputs: Tensor

    @staticmethod
    def create(times, states, inputs, device="cuda"):
        f32 = lambda v: torch.as_tensor(  # noqa: E731
            np.asarray(v, np.float32), device=device
        )
        return TargetTrajectories(
            f32(times).reshape(-1),
            torch.atleast_2d(f32(states)),
            torch.atleast_2d(f32(inputs)),
        )

    @staticmethod
    def constant(state, input, t0: float = 0.0, device="cuda"):
        state = torch.as_tensor(state, dtype=torch.float32, device=device)
        input = torch.as_tensor(input, dtype=torch.float32, device=device)
        return TargetTrajectories(
            times=torch.tensor([t0], dtype=torch.float32, device=device),
            states=state[None, :],
            inputs=input[None, :],
        )

    def state_at(self, t) -> Tensor:
        return interpolate(self.times, self.states, t)

    def input_at(self, t) -> Tensor:
        return interpolate(self.times, self.inputs, t)
