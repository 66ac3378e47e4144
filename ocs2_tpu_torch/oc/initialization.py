"""Initializers: producing (xs, us) when no warm start exists.

Counterpart of ``ocs2_tpu/oc/initialization.py``.  An initializer maps
(grid, x0, nu) -> (xs [N+1, nx], us [N, nu]) tensors on x0's device, which
the solvers consume as xs_init / us_init; the MPC runtime uses the default
one on cold starts.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..core.interpolation import interpolate_batch
from .time_discretization import TimeGrid

Tensor = torch.Tensor


class Initializer:
    """Base contract."""

    def __call__(self, grid: TimeGrid, x0: Tensor, nu: int):
        raise NotImplementedError


class DefaultInitializer(Initializer):
    """Constant state, zero input — what the solvers do internally when no
    initializer is given."""

    def __call__(self, grid: TimeGrid, x0: Tensor, nu: int):
        n = grid.num_intervals
        x0 = torch.as_tensor(x0, dtype=torch.float32)
        xs = x0[None].expand(n + 1, x0.shape[-1]).clone()
        us = torch.zeros((n, nu), dtype=xs.dtype, device=xs.device)
        return xs, us


class OperatingPoints(Initializer):
    """Time-stamped operating trajectories interpolated onto the grid.  A
    single (state, input) pair gives the constant-operating-point behaviour;
    the initial node is always pinned to the measured x0."""

    def __init__(self, times, states, inputs, device="cuda"):
        f32 = lambda v: torch.as_tensor(np.asarray(v, np.float32), device=device)  # noqa: E731
        self.times = torch.atleast_1d(f32(times))
        self.states = torch.atleast_2d(f32(states))
        self.inputs = torch.atleast_2d(f32(inputs))

    @staticmethod
    def constant(state, input, device="cuda"):
        return OperatingPoints([0.0], [np.asarray(state)], [np.asarray(input)], device=device)

    def __call__(self, grid: TimeGrid, x0: Tensor, nu: int):
        times = torch.as_tensor(grid.times, dtype=torch.float32, device=self.times.device)
        xs = interpolate_batch(self.times, self.states, times)
        us = interpolate_batch(self.times, self.inputs, times[:-1])
        x0 = torch.as_tensor(x0, dtype=xs.dtype, device=xs.device)
        return torch.cat([x0[None], xs[1:]], dim=0), us


class CustomInitializer(Initializer):
    """Wrap any (grid, x0, nu) -> (xs, us) callable (e.g. the legged robot's
    weight-compensating-input initializer)."""

    def __init__(self, fn: Callable):
        self.fn = fn

    def __call__(self, grid: TimeGrid, x0: Tensor, nu: int):
        return self.fn(grid, x0, nu)
