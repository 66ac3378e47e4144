"""Switch-time optimization: gradients of the optimal cost w.r.t. event times.

Counterpart of ``ocs2_tpu/solvers/switch_time.py``.  At a converged solution
the switching-time optimality condition gives

    dJ / d t_event = H^-(t_e) - H^+(t_e)

the jump of the control Hamiltonian H = l(t,x,u) + lambda' f(t,x,u) across
the switch, with the costate lambda = V_x taken from the solver's value
function.  One mapped evaluation per jump node replaces the reference's
per-event sensitivity solves.  The upper-level loop is projected gradient
descent on the event times with an isotonic (ordering) projection in place
of the reference's Frank-Wolfe LP.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from ..oc.approx import node_params
from ..oc.problem import OptimalControlProblem
from ..oc.time_discretization import TimeGrid, make_time_grid

Tensor = torch.Tensor


def switch_time_gradients(
    problem: OptimalControlProblem,
    grid: TimeGrid,
    xs: Tensor,
    us: Tensor,
    value_s: Tensor,
    params,
) -> Tensor:
    """Per-jump-node Hamiltonian jumps dJ/dt_e of a batch, [B, N] (zero at
    non-jump transitions).  xs [B, N+1, nx], us [B, N, nu] and the solver's
    cost-to-go gradient value_s [B, N+1, nx] (``DdpSolution.value_s`` /
    ``SqpSolution.value_s``); ``params`` shared."""
    grid = grid.device(xs.device)
    n = grid.num_intervals
    k = torch.arange(n, device=xs.device)
    k_pre = torch.clamp(k - 1, min=0)  # input just before the event
    k_post = torch.clamp(k + 1, max=n - 1)  # input just after

    def node_h(kk, t, x, u, lam):
        p = node_params(params, grid, kk)
        return problem.cost(t, x, u, p) + lam @ problem.dynamics(t, x, u, p)

    def per_scenario(xs_b, us_b, vs_b):
        # Jump transition k: pre state xs[k] (mode before), post state
        # xs[k+1] (mode after).
        h = torch.func.vmap(node_h)
        h_pre = h(k, grid.times[:-1], xs_b[:-1], us_b[k_pre], vs_b[:-1])
        h_post = h(k + 1, grid.times[1:], xs_b[1:], us_b[k_post], vs_b[1:])
        return grid.is_jump * (h_pre - h_post)

    return torch.func.vmap(per_scenario)(xs, us, value_s)


def _isotonic_project(theta: np.ndarray, lo: float, hi: float, min_gap: float):
    """Order-preserving projection onto {lo < t_1 <= ... <= t_K < hi}."""
    theta = np.sort(theta)
    theta = np.clip(theta, lo + min_gap, hi - min_gap)
    for i in range(1, len(theta)):
        theta[i] = max(theta[i], theta[i - 1] + min_gap)
    theta = np.clip(theta, lo + min_gap, hi - min_gap)
    for i in range(len(theta) - 2, -1, -1):
        theta[i] = min(theta[i], theta[i + 1])
    return theta


class SwitchTimeResult(NamedTuple):
    event_times: np.ndarray
    cost: float
    history: list


def optimize_switch_times(
    problem: OptimalControlProblem,
    solve_fn: Callable,  # (grid, x0, params) -> a batch-of-one solution with
    #                       .performance.cost, .xs, .us, .value_s
    x0,
    params,
    t0: float,
    tf: float,
    num_intervals: int,
    event_times0,
    mode_sequence,
    iterations: int = 20,
    step_size: float = 0.1,
    min_gap: float = 1e-2,
) -> SwitchTimeResult:
    """Upper-level loop: alternate full lower-level solves with projected
    gradient steps on the event times (host numpy, float64); returns the best
    event times seen, their cost and every iteration's (times, cost)."""
    theta = np.asarray(event_times0, np.float64).copy()
    history = []
    best = (None, np.inf)
    for _ in range(iterations):
        grid = make_time_grid(
            t0, tf, num_intervals, event_times=theta, mode_sequence=mode_sequence
        )
        sol = solve_fn(grid, x0, params)
        cost = float(sol.performance.cost.reshape(-1)[0])
        grads_nodes = switch_time_gradients(
            problem, grid, sol.xs[:1], sol.us[:1], sol.value_s[:1], params
        )[0]
        # Per-event gradients in event order from the jump nodes.
        is_jump = np.asarray(grid.is_jump) > 0.5
        g = grads_nodes.detach().cpu().numpy()[is_jump]
        history.append((theta.copy(), cost))
        if cost < best[1]:
            best = (theta.copy(), cost)
        theta = _isotonic_project(
            theta - step_size * g[: len(theta)], t0, tf, min_gap
        )
    return SwitchTimeResult(event_times=best[0], cost=best[1], history=history)
