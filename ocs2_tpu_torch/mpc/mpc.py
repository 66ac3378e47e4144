"""Receding-horizon MPC runtime.

Counterpart of ``ocs2_tpu/mpc/mpc.py``.  ``Mpc.run(t, x)`` solves the horizon
[t, t + T]: the host builds the event-aligned grid from the reference
manager's mode schedule, shifts the previous solution onto it as the warm
start (through trajectory spreading when the mode schedule moved), carries
the augmented-Lagrangian multipliers, and calls ``sqp.solve`` / ``ipm.solve``
/ ``slp.solve`` / ``ddp.solve`` for a batch of one directly (the JAX package
jits that call; here it is the solver's own loop of device work).  The
policy is a ``LinearController`` of tensors on the Mpc's device, consumed by
the MRT side (``mrt.py``) without host round-trips.  The multiple-shooting family (``"sqp"``, ``"ipm"``,
``"slp"``) gets the shifted states and inputs and the AL state; IPM's slacks
and duals are not carried across ticks (each solve initializes them from its
warm start), as in the JAX package.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from ..core.controllers import LinearController
from ..core.interpolation import interpolate_batch
from ..core.reference import ModeSchedule, TargetTrajectories
from ..core.types import PerformanceIndex
from ..oc.approx import example_params
from ..oc.problem import OptimalControlProblem
from ..oc.spreading import mode_schedules_differ, spread_trajectories
from ..oc.time_discretization import TimeGrid, make_time_grid
from ..solvers import ddp as ddp_mod
from ..solvers import ipm as ipm_mod
from ..solvers import slp as slp_mod
from ..solvers import sqp as sqp_mod
from ..solvers.al import AlState
from ..utils.timers import RepeatedTimer

Tensor = torch.Tensor

DEFAULT_SETTINGS = {
    "sqp": sqp_mod.SqpSettings,
    "ipm": ipm_mod.IpmSettings,
    "slp": slp_mod.SlpSettings,
    "ddp": ddp_mod.DdpSettings,
}
# The multiple-shooting family: solve(problem, grid, x0, params, xs_init=,
# us_init=, al_init=, settings=, device=).
_MULTIPLE_SHOOTING = {"sqp": sqp_mod.solve, "ipm": ipm_mod.solve, "slp": slp_mod.solve}


@dataclasses.dataclass(frozen=True)
class MpcSettings:
    time_horizon: float = 1.0
    num_intervals: int = 64
    solver: str = "sqp"  # "sqp" | "ipm" | "slp" | "ddp"
    cold_start: bool = False
    # Warm-start carry of AL multipliers across solves.
    carry_multipliers: bool = True


class ReferenceManager:
    """Holds TargetTrajectories + ModeSchedule with swap-on-solve semantics:
    targets and schedules set between ticks take effect at the next
    ``pre_solver_run`` (the host loop is single-threaded, so plain buffered
    assignment gives the swap)."""

    def __init__(
        self,
        target: TargetTrajectories,
        mode_schedule: Optional[ModeSchedule] = None,
    ):
        self._target = target
        self._mode_schedule = mode_schedule or ModeSchedule.single_mode(0)
        self._target_buffer: Optional[TargetTrajectories] = None
        self._mode_buffer: Optional[ModeSchedule] = None

    def set_target(self, target: TargetTrajectories) -> None:
        self._target_buffer = target

    def set_mode_schedule(self, mode_schedule: ModeSchedule) -> None:
        self._mode_buffer = mode_schedule

    def pre_solver_run(self, t0: float, tf: float, x0: Tensor) -> None:
        if self._target_buffer is not None:
            self._target = self._target_buffer
            self._target_buffer = None
        if self._mode_buffer is not None:
            self._mode_schedule = self._mode_buffer
            self._mode_buffer = None

    @property
    def target(self) -> TargetTrajectories:
        return self._target

    @property
    def mode_schedule(self) -> ModeSchedule:
        return self._mode_schedule

    def augment_params(self, grid: TimeGrid, params: dict) -> dict:
        """Hook for grid-dependent reference data (e.g. swing trajectories
        planned on the concrete node times); identity by default."""
        return params


class MpcPolicy:
    """Solved policy handed to the MRT side: the controller, the solution
    (xs [N+1, nx], us [N, nu] at node times [N+1], all on the device), its
    performance (one scenario) and the mode schedule it was solved for."""

    def __init__(self, controller: LinearController, xs, us, times, performance,
                 mode_schedule: ModeSchedule):
        self.controller = controller
        self.xs = xs
        self.us = us
        self.times = times
        self.performance = performance
        self.mode_schedule = mode_schedule


class Mpc:
    """``run(t, x)`` solves the horizon [t, t + T] for one scenario.

    ``solve_timer`` times the solve (ending in a synchronise of the card),
    ``tick_timer`` the whole of ``run``; their difference is the tick's host
    work (reference manager, grid, swing plan, warm start).  After a tick,
    ``last_solution`` is the solver's result (every field with a leading
    [1], iterations included) and ``last_solve_inputs`` the exact arguments
    the solver was given (grid, x0, warm start, AL state, params), so a
    caller can re-solve a tick by another route."""

    def __init__(
        self,
        problem: OptimalControlProblem,
        params: dict,
        settings: MpcSettings = MpcSettings(),
        solver_settings=None,
        reference_manager: Optional[ReferenceManager] = None,
        device="cuda",
    ):
        if settings.solver not in DEFAULT_SETTINGS:
            raise ValueError(
                f"unknown solver {settings.solver!r}; one of {sorted(DEFAULT_SETTINGS)}")
        self.problem = problem
        self.base_params = dict(params)
        self.settings = settings
        self.device = torch.device(device)
        self.reference_manager = reference_manager or ReferenceManager(
            params.get("target")
        )
        self.solver_settings = solver_settings or DEFAULT_SETTINGS[settings.solver]()
        self._prev: Optional[MpcPolicy] = None
        self._prev_al: Optional[AlState] = None
        self.solve_timer = RepeatedTimer()
        self.tick_timer = RepeatedTimer()
        self.spread_count = 0  # warm starts that went through spread_trajectories
        self.last_solution = None
        self.last_solve_inputs: Optional[dict] = None
        # Multipliers of the first tick: the shapes every later tick carries.
        dims = problem.constraint_dims(example_params(dict(params), self.device),
                                       device=self.device)
        rho0 = getattr(self.solver_settings, "al_rho_init", 10.0)
        self._al_zero = AlState.init(
            dims, settings.num_intervals, rho0, batch=(1,), device=self.device)

    def _solve(self, grid: TimeGrid, x0, warm_xs, warm_us, al, params):
        if self.settings.solver == "ddp":
            return ddp_mod.solve(
                self.problem, grid, x0[None], params, us_init=warm_us, al_init=al,
                settings=self.solver_settings, device=self.device,
            )
        return _MULTIPLE_SHOOTING[self.settings.solver](
            self.problem, grid, x0, params, xs_init=warm_xs, us_init=warm_us,
            al_init=al, settings=self.solver_settings, device=self.device,
        )

    def run(self, t: float, x) -> MpcPolicy:
        """One MPC tick."""
        self.tick_timer.start()
        t = float(t)
        tf = t + self.settings.time_horizon
        x = torch.as_tensor(x, dtype=torch.float32, device=self.device)
        self.reference_manager.pre_solver_run(t, tf, x)
        ms = self.reference_manager.mode_schedule
        grid = make_time_grid(
            t, tf, self.settings.num_intervals,
            event_times=np.asarray(ms.event_times),
            mode_sequence=np.asarray(ms.mode_sequence),
        )
        warm_xs, warm_us = self._warm_start(grid, x)
        al = (
            self._prev_al
            if (self.settings.carry_multipliers and self._prev_al is not None)
            else self._al_zero
        )
        params = dict(self.base_params, target=self.reference_manager.target)
        params = self.reference_manager.augment_params(grid, params)
        self.last_solve_inputs = dict(
            grid=grid, x0=x, xs_init=warm_xs, us_init=warm_us, al_init=al, params=params)

        tic = time.perf_counter()
        sol = self._solve(grid, x, warm_xs, warm_us, al, params)
        times = torch.as_tensor(grid.times, device=self.device)
        controller = LinearController(
            times=times[:-1], uff=sol.us[0], gains=sol.gains[0], x_nom=sol.xs[0, :-1]
        )
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.solve_timer.record(time.perf_counter() - tic)

        policy = MpcPolicy(
            controller=controller, xs=sol.xs[0], us=sol.us[0], times=times,
            performance=PerformanceIndex(*(v[0] for v in sol.performance)),
            mode_schedule=ms,
        )
        self._prev = policy
        self._prev_al = sol.al
        self.last_solution = sol
        self.tick_timer.stop()
        return policy

    def _warm_start(self, grid: TimeGrid, x: Tensor):
        """Shift the previous solution onto the new grid; on a cold start or
        the first call, constant state and zero input.  When the mode
        schedule moved between ticks the interpolation goes through the
        trajectory-spreading time warp, so warm starts stay mode-consistent.
        Returns (xs [N+1, nx], us [N, nu])."""
        n = grid.num_intervals
        if self.settings.cold_start or self._prev is None:
            xs = x[None].expand(n + 1, x.shape[-1]).contiguous()
            us = torch.zeros((n, self.problem.nu), dtype=xs.dtype, device=xs.device)
            return xs, us
        prev = self._prev
        new_ms = self.reference_manager.mode_schedule
        if mode_schedules_differ(prev.mode_schedule, new_ms):
            self.spread_count += 1
            return spread_trajectories(
                prev.times, prev.xs, prev.us, prev.mode_schedule, new_ms, grid.times,
            )
        times = torch.as_tensor(grid.times, device=self.device)
        xs = interpolate_batch(prev.times, prev.xs, times)
        us = interpolate_batch(prev.times[:-1], prev.us, times[:-1])
        return xs, us

    @property
    def last_policy(self) -> Optional[MpcPolicy]:
        """The most recent MpcPolicy produced by run(), or None before the
        first tick."""
        return self._prev

    def reset(self) -> None:
        self._prev = None
        self._prev_al = None
        self.solve_timer = RepeatedTimer()
        self.tick_timer = RepeatedTimer()
        self.spread_count = 0
