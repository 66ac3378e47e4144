"""State-triggered hybrid DDP: optimize through guard-surface mode changes.

Counterpart of ``ocs2_tpu/solvers/hybrid_ddp.py``.  The solve is split into a
small fixed number of outer rounds; each round

  1. rolls the current policy through the guarded hybrid system
     (``oc/hybrid_rollout.py``: fixed steps, bisection root refinement),
  2. extracts up to ``max_events`` crossing times and post-jump modes,
  3. builds a grid with duplicated nodes at the detected times
     (``oc/time_discretization.make_event_grid_traced``: event times are
     tensors, the node count is fixed),
  4. runs the DDP solve (``solvers/ddp.py``) on that grid, warm-started from
     the previous round's policy evaluated along the detected trajectory.

One scenario: the detected events set the grid, which the DDP batch shares,
so a solve is a batch of one (on the card the sweep is the Riccati kernel
with strict pivots).  The final rollout is returned so that the grid's events
can be held against the events the optimized policy triggers.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..core.controllers import LinearController
from ..core.interpolation import interpolate
from ..oc.hybrid_rollout import HybridSystem, HybridTrajectory, rollout_state_triggered
from ..oc.problem import OptimalControlProblem
from ..oc.time_discretization import TimeGrid, make_event_grid_traced
from . import ddp

Tensor = torch.Tensor


class HybridDdpSolution(NamedTuple):
    ddp: ddp.DdpSolution  # a batch of one
    grid: TimeGrid
    event_times: Tensor  # [E] detected crossing times (inf where unused)
    mode_sequence: Tensor  # [E+1] int64
    rollout: HybridTrajectory  # final-policy state-triggered rollout
    # Per outer round, max |event time - previous round's| over the events
    # active in both (NaN for round 0 and rounds not run, inf where the count
    # of events changed): the outer loop's convergence measure.
    event_drift: Tensor  # [outer_rounds]
    rounds_run: int


def _detect_events(traj: HybridTrajectory, max_events: int, mode0):
    """First ``max_events`` guard crossings (sorted by time, stable; inactive
    slots +inf) and the post-jump mode sequence."""
    inf = torch.full_like(traj.event_times, float("inf"))
    masked = torch.where(traj.event_mask > 0.0, traj.event_times, inf)
    order = torch.argsort(masked, stable=True)[:max_events]
    ev = masked[order]
    post_modes = traj.modes[1:][order]
    mode0 = torch.as_tensor(mode0, device=ev.device).to(torch.int64).reshape(1)
    return ev, torch.cat([mode0, post_modes.to(torch.int64)])


def solve_state_triggered(
    system: HybridSystem,
    problem: OptimalControlProblem,
    t0,
    tf,
    x0,
    params: dict,
    num_base_intervals: int = 60,
    max_events: int = 4,
    outer_rounds: int = 3,
    rollout_steps: Optional[int] = None,
    mode0: int = 0,
    settings: ddp.DdpSettings = ddp.DdpSettings(),
    event_tol: float = 0.0,
    device="cuda",
    force_plain_riccati: bool = False,
) -> HybridDdpSolution:
    """State-triggered solve of one scenario, x0 [nx].

    ``problem`` must express the same dynamics / jump as ``system`` with the
    active mode read from ``params["mode"]`` (the per-node mode the grid
    injects): ``system`` drives detection, ``problem`` optimization.
    ``event_tol`` > 0 ends the outer loop once the detected event times move
    less than the tolerance between rounds (the reference does so outside
    jit); with 0 every round runs.  ``force_plain_riccati`` is the DDP test
    hook."""
    x0 = torch.as_tensor(x0, dtype=torch.float32, device=device).reshape(-1)
    dev, dtype = x0.device, x0.dtype
    steps = rollout_steps or 2 * num_base_intervals
    dt_roll = (float(tf) - float(t0)) / steps
    n = num_base_intervals + 2 * max_events
    nu = problem.nu

    us = torch.zeros((steps, nu), dtype=dtype, device=dev)

    def open_loop(t, x, k):
        return us[min(k, steps - 1)]

    policy = open_loop
    sol = grid = ev = mode_seq = prev_grid = prev_mode_seq = None
    drift = torch.full((outer_rounds,), float("nan"), dtype=dtype, device=dev)
    rounds_run = 0

    for round_i in range(outer_rounds):
        traj = rollout_state_triggered(system, t0, x0, policy, dt_roll, steps, params, mode0=mode0)
        ev_prev = ev
        ev, mode_seq = _detect_events(traj, max_events, mode0)
        rounds_run = round_i + 1
        if ev_prev is not None:
            # Drift over events active in both rounds; a change in the count
            # of events registers as +inf.
            both = torch.isfinite(ev) & torch.isfinite(ev_prev)
            moved = torch.where(both, torch.abs(ev - ev_prev), torch.zeros_like(ev))
            count_changed = torch.any(torch.isfinite(ev) != torch.isfinite(ev_prev))
            d = torch.where(count_changed, torch.full_like(moved[0], float("inf")),
                            torch.amax(moved))
            drift[round_i] = d
            if event_tol > 0.0 and bool(d < event_tol):
                # Events stationary: the previous round's solve is already
                # consistent with these events.
                ev, mode_seq, grid = ev_prev, prev_mode_seq, prev_grid
                break
        prev_mode_seq = mode_seq
        grid = make_event_grid_traced(t0, tf, num_base_intervals, ev, mode_seq,
                                      dtype=dtype, device=dev)
        # Warm start: the current policy along the detected trajectory at the
        # new grid's nodes.
        if sol is None:
            us_init = torch.zeros((n, nu), dtype=dtype, device=dev)
        else:
            ctrl = LinearController(times=prev_grid.times[:-1], uff=sol.us[0],
                                    gains=sol.gains[0], x_nom=sol.xs[0, :-1])
            xs_at = interpolate(traj.times, traj.xs, grid.times[:-1])
            us_init = ctrl(grid.times[:-1], xs_at)
        sol = ddp.solve(problem, grid, x0[None], params, us_init=us_init, settings=settings,
                        device=dev, force_plain_riccati=force_plain_riccati)
        prev_grid = grid
        ctrl = LinearController(times=grid.times[:-1], uff=sol.us[0], gains=sol.gains[0],
                                x_nom=sol.xs[0, :-1])
        policy = lambda t, x, k, _c=ctrl: _c(t, x)  # noqa: E731

    final_traj = rollout_state_triggered(system, t0, x0, policy, dt_roll, steps, params,
                                         mode0=mode0)
    return HybridDdpSolution(
        ddp=sol, grid=grid, event_times=ev, mode_sequence=mode_seq, rollout=final_traj,
        event_drift=drift, rounds_run=rounds_run,
    )
