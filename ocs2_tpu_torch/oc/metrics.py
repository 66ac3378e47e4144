"""Trajectory evaluation: cost and raw constraint values in one fused pass.

Counterpart of ``ocs2_tpu/oc/metrics.py``.  One sweep, vectorized over the
nodes and over any leading batch dims of the trajectory, produces everything
downstream consumers need:
* merit under any augmented-Lagrangian multipliers (elementwise reduction —
  no re-evaluation of constraint functions when multipliers change),
* constraint SSE for convergence tests and PerformanceIndex,
* dual-ascent multiplier updates.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch

from ..core import penalties as pen
from .approx import node_params
from .problem import OptimalControlProblem
from .time_discretization import TimeGrid

Tensor = torch.Tensor

_EQ_PEN = pen.al_quadratic_equality()
_INEQ_PEN = pen.al_hinge_inequality()


class TrajectoryMetrics(NamedTuple):
    """cost: true total cost (running + jump + final), [...] over the
    trajectory's leading batch dims.
    Constraint value arrays (None when the family is absent):
      g_eq [..., N, ne], g_state_eq [..., N+1, nse], h_ineq [..., N, ni],
      h_state_ineq [..., N+1, nsi], g_final_eq [..., nfe].
    """

    cost: Tensor
    g_eq: Optional[Tensor]
    g_state_eq: Optional[Tensor]
    h_ineq: Optional[Tensor]
    h_state_ineq: Optional[Tensor]
    g_final_eq: Optional[Tensor]

    @property
    def eq_sse(self) -> Tensor:
        total = torch.zeros_like(self.cost)
        for g in (self.g_eq, self.g_state_eq):
            if g is not None:
                total = total + torch.sum(torch.square(g), dim=(-2, -1))
        if self.g_final_eq is not None:
            total = total + torch.sum(torch.square(self.g_final_eq), dim=-1)
        return total

    @property
    def ineq_sse(self) -> Tensor:
        total = torch.zeros_like(self.cost)
        for h in (self.h_ineq, self.h_state_ineq):
            if h is not None:
                total = total + torch.sum(
                    torch.square(torch.clamp(h, max=0.0)), dim=(-2, -1)
                )
        return total


def evaluate_trajectory(
    problem: OptimalControlProblem,
    grid: TimeGrid,
    xs: Tensor,  # [..., N+1, nx]
    us: Tensor,  # [..., N, nu]
    params: Any,
) -> TrajectoryMetrics:
    grid = grid.device(xs.device)
    n = grid.num_intervals
    nodes = torch.arange(n + 1, device=xs.device)
    t0, t1 = grid.times[:-1], grid.times[1:]
    dt = t1 - t0
    x_k, x_k1 = xs[..., :-1, :], xs[..., 1:, :]
    p_k = node_params(params, grid, nodes[:-1])
    p_k1 = node_params(params, grid, nodes[1:])

    # Trapezoidal cost quadrature under zero-order-hold inputs — second-order
    # accurate, where the rectangle rule is ~1% off at dt=0.02.  Both
    # endpoints use THIS interval's input u_k: a shifted-sum single-evaluation
    # variant would re-price the boundary inputs (u_0 at dt/2, the
    # jump-interval's unused input at dt/2).  Transcription/LQ keeps the
    # rectangle rule.
    c = 0.5 * dt * (
        problem.cost(t0, x_k, us, p_k) + problem.cost(t1, x_k1, us, p_k1)
    )
    if problem.pre_jump_cost_terms:
        c = c + grid.is_jump * problem.pre_jump_cost(t0, x_k, p_k)
    g_eq = problem.equality(t0, x_k, us, p_k) if problem.equality_terms else None
    h_ineq = (
        problem.inequality(t0, x_k, us, p_k) if problem.inequality_terms else None
    )

    p_all = node_params(params, grid, nodes)
    g_seq = (
        problem.state_equality(grid.times, xs, p_all)
        if problem.state_equality_terms
        else None
    )
    h_sineq = (
        problem.state_inequality(grid.times, xs, p_all)
        if problem.state_inequality_terms
        else None
    )

    tN = grid.times[n]
    xN = xs[..., n, :]
    pN = node_params(params, grid, n)
    cost = torch.sum(c, dim=-1) + problem.final_cost(tN, xN, pN)
    g_feq = (
        problem.final_equality(tN, xN, pN) if problem.final_equality_terms else None
    )
    return TrajectoryMetrics(
        cost=cost,
        g_eq=g_eq,
        g_state_eq=g_seq,
        h_ineq=h_ineq,
        h_state_ineq=h_sineq,
        g_final_eq=g_feq,
    )


def _rho_like(rho: Tensor, values: Tensor) -> Tensor:
    """rho [...] broadcast against constraint values [..., (N,) m]."""
    return rho.reshape(rho.shape + (1,) * (values.ndim - rho.ndim))


def al_merit(metrics: TrajectoryMetrics, al) -> Tensor:
    """merit = cost + AL terms, computed from stored constraint values.  The
    leading dims of ``al`` broadcast against those of ``metrics``."""
    merit = metrics.cost
    node_families = (
        (_EQ_PEN, al.lmbd_eq, metrics.g_eq),
        (_EQ_PEN, al.lmbd_state_eq, metrics.g_state_eq),
        (_INEQ_PEN, al.lmbd_ineq, metrics.h_ineq),
        (_INEQ_PEN, al.lmbd_state_ineq, metrics.h_state_ineq),
    )
    for apen, lmbd, vals in node_families:
        if vals is not None:
            merit = merit + torch.sum(
                apen.value(lmbd, _rho_like(al.rho, lmbd), vals), dim=(-2, -1)
            )
    if metrics.g_final_eq is not None:
        merit = merit + torch.sum(
            _EQ_PEN.value(
                al.lmbd_final_eq, _rho_like(al.rho, al.lmbd_final_eq),
                metrics.g_final_eq,
            ),
            dim=-1,
        )
    return merit


def al_dual_ascent(metrics: TrajectoryMetrics, al):
    """Multiplier updates from stored constraint values (LANCELOT inner)."""
    upd = {}
    families = (
        ("lmbd_eq", _EQ_PEN, metrics.g_eq),
        ("lmbd_state_eq", _EQ_PEN, metrics.g_state_eq),
        ("lmbd_ineq", _INEQ_PEN, metrics.h_ineq),
        ("lmbd_state_ineq", _INEQ_PEN, metrics.h_state_ineq),
        ("lmbd_final_eq", _EQ_PEN, metrics.g_final_eq),
    )
    for name, apen, vals in families:
        if vals is not None:
            lmbd = getattr(al, name)
            upd[name] = apen.multiplier_update(lmbd, _rho_like(al.rho, lmbd), vals)
    return al._replace(**upd)
