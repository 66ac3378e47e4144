"""Forward rollout of the (possibly switched) system dynamics.

Counterpart of ``ocs2_tpu/oc/rollout.py``.  A Python loop over the horizon
advances all trajectories of a batch together: ``x0`` carries any leading
batch dims ``[..., nx]`` and the policy returns inputs with the same leading
dims.  Jump transitions are masked blends on the duplicated event nodes of
the TimeGrid.  ``evaluate_rollout`` prices a trajectory by the rectangle
rule (the solvers' merit, ``oc/metrics.py``, uses the trapezoidal rule).
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from ..core.integrate import discretize
from .approx import node_params
from .problem import OptimalControlProblem
from .time_discretization import TimeGrid

Tensor = torch.Tensor
# policy(t, x, k) -> u ; k is the node index (a Python int).
Policy = Callable[[Tensor, Tensor, int], Tensor]


def rollout(
    problem: OptimalControlProblem,
    grid: TimeGrid,
    x0: Tensor,
    policy: Policy,
    params: Any,
    method: str = "rk4",
    substeps: int = 1,
):
    """Closed-loop rollout of x0 [..., nx].
    Returns (xs [..., N+1, nx], us [..., N, nu])."""
    grid = grid.device(x0.device)
    times = grid.times.unbind(0)
    jumps = grid.is_jump.unbind(0)

    x = x0
    xs, us = [x0], []
    for k in range(grid.num_intervals):
        t = times[k]
        dt = times[k + 1] - t
        p = node_params(params, grid, k)
        p_next = node_params(params, grid, k + 1)
        u = policy(t, x, k)
        flow = discretize(
            lambda tt, xx, uu: problem.dynamics(tt, xx, uu, p), method, substeps
        )
        x_int = flow(t, x, u, dt)
        x_jmp = problem.apply_jump(t, x, p_next)
        m = jumps[k]
        x = (1.0 - m) * x_int + m * x_jmp
        xs.append(x)
        us.append(u)
    return torch.stack(xs, dim=-2), torch.stack(us, dim=-2)


def open_loop_policy(us: Tensor) -> Policy:
    """us [..., N, nu] (leading dims broadcast against the state's)."""
    return lambda t, x, k: us[..., k, :].expand(x.shape[:-1] + us.shape[-1:])


def _apply_gain(gain: Tensor, dx: Tensor) -> Tensor:
    """gain [..., nu, nx] @ dx [..., nx] -> [..., nu]."""
    return (gain @ dx.unsqueeze(-1)).squeeze(-1)


def linear_policy(us_ff: Tensor, gains: Tensor, xs_nom: Tensor) -> Policy:
    """u_k = uff_k + K_k (x - x_nom_k); arrays [..., N, ...]."""

    def policy(t, x, k):
        return us_ff[..., k, :] + _apply_gain(
            gains[..., k, :, :], x - xs_nom[..., k, :]
        )

    return policy


def ddp_search_policy(
    us_nom: Tensor, duff: Tensor, gains: Tensor, xs_nom: Tensor, alpha
) -> Policy:
    """u_k = u_nom_k + alpha * duff_k + K_k (x - x_nom_k).

    Arrays are [..., N, ...].  With a scalar ``alpha`` the state has the
    arrays' leading dims.  With a step-size grid ``alpha`` [A] the whole line
    search is one rollout: a candidate axis follows the batch dims, the state
    is [..., A, nx] and the inputs come back [..., A, nu]."""
    if isinstance(alpha, torch.Tensor) and alpha.ndim == 1:
        us_nom, duff, xs_nom = (
            a.unsqueeze(-3) for a in (us_nom, duff, xs_nom)
        )
        gains = gains.unsqueeze(-4)
        alpha = alpha.unsqueeze(-1)

    def policy(t, x, k):
        return us_nom[..., k, :] + alpha * duff[..., k, :] + _apply_gain(
            gains[..., k, :, :], x - xs_nom[..., k, :]
        )

    return policy


class RolloutMetrics(NamedTuple):
    """Cost and constraint-violation accumulators of a rollout, [...] over
    the trajectory's leading dims."""

    cost: Tensor
    eq_sse: Tensor
    ineq_sse: Tensor  # sum of squared *violations* min(0, h)


def evaluate_rollout(
    problem: OptimalControlProblem,
    grid: TimeGrid,
    xs: Tensor,  # [..., N+1, nx]
    us: Tensor,  # [..., N, nu]
    params: Any,
) -> RolloutMetrics:
    """Total cost (rectangle rule, pre-jump cost on jump transitions, final
    cost) and the constraint violations of a state/input trajectory."""
    grid = grid.device(xs.device)
    n = grid.num_intervals
    nodes = torch.arange(n, device=xs.device)
    t = grid.times[:-1]
    dt = grid.times[1:] - t
    x_k = xs[..., :-1, :]
    p = node_params(params, grid, nodes)
    sq = lambda v: torch.sum(torch.square(v), dim=-1)  # noqa: E731
    viol = lambda h: sq(torch.clamp(h, max=0.0))  # noqa: E731

    c = dt * problem.cost(t, x_k, us, p)
    if problem.pre_jump_cost_terms:
        c = c + grid.is_jump * problem.pre_jump_cost(t, x_k, p)
    eq = torch.zeros_like(c)
    if problem.equality_terms:
        eq = eq + sq(problem.equality(t, x_k, us, p))
    if problem.state_equality_terms:
        eq = eq + sq(problem.state_equality(t, x_k, p))
    ineq = torch.zeros_like(c)
    if problem.inequality_terms:
        ineq = ineq + viol(problem.inequality(t, x_k, us, p))
    if problem.state_inequality_terms:
        ineq = ineq + viol(problem.state_inequality(t, x_k, p))

    tn, xn = grid.times[n], xs[..., n, :]
    pn = node_params(params, grid, n)
    cost = torch.sum(c, dim=-1) + problem.final_cost(tn, xn, pn)
    eq_sse = torch.sum(eq, dim=-1)
    ineq_sse = torch.sum(ineq, dim=-1)
    if problem.state_equality_terms:
        eq_sse = eq_sse + sq(problem.state_equality(tn, xn, pn))
    if problem.final_equality_terms:
        eq_sse = eq_sse + sq(problem.final_equality(tn, xn, pn))
    if problem.state_inequality_terms:
        ineq_sse = ineq_sse + viol(problem.state_inequality(tn, xn, pn))
    return RolloutMetrics(cost=cost, eq_sse=eq_sse, ineq_sse=ineq_sse)
