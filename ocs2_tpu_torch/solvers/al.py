"""Augmented-Lagrangian constraint handling.

Counterpart of ``ocs2_tpu/solvers/al.py``.  Constraints are folded into the
cost through AL terms whose per-node multipliers live in the *parameter*
dict (key "al"), so the solver's LQ approximation differentiates them
exactly and multiplier updates are pure tensor ops.

The node index is injected into params (key "node") by the LQ approximator /
trajectory evaluator so AL terms can gather their node's multiplier row.
The solvers update multipliers from stored constraint values
(``oc/metrics.al_dual_ascent``); ``update_multipliers`` does it from a
trajectory.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from ..core import penalties as pen
from ..oc.metrics import al_dual_ascent, evaluate_trajectory
from ..oc.problem import GaussNewtonCost, OptimalControlProblem
from ..oc.time_discretization import TimeGrid

Tensor = torch.Tensor


class AlState(NamedTuple):
    """Per-node multipliers and the shared penalty scale.

    Shapes (zero-size arrays when a constraint family is absent), each with
    the leading dims ``batch`` given to ``init`` (a solver uses ``(B,)``):
      lmbd_eq       [N,  ne]   state-input equality
      lmbd_state_eq [N+1, nse] state-only equality
      lmbd_ineq     [N,  ni]   state-input inequality (>= 0)
      lmbd_state_ineq [N+1, nsi]
      lmbd_final_eq [nfe]
      rho           []         penalty coefficient
    """

    lmbd_eq: Tensor
    lmbd_state_eq: Tensor
    lmbd_ineq: Tensor
    lmbd_state_ineq: Tensor
    lmbd_final_eq: Tensor
    rho: Tensor

    @staticmethod
    def init(dims: dict, num_intervals: int, rho: float = 10.0, batch=(),
             dtype=torch.float32, device="cuda"):
        n = num_intervals
        batch = tuple(batch)
        z = lambda *s: torch.zeros(batch + s, dtype=dtype, device=device)  # noqa: E731
        return AlState(
            lmbd_eq=z(n, dims["ne"]),
            lmbd_state_eq=z(n + 1, dims["nse"]),
            lmbd_ineq=z(n, dims["ni"]),
            lmbd_state_ineq=z(n + 1, dims["nsi"]),
            lmbd_final_eq=z(dims["nfe"]),
            rho=torch.full(batch, rho, dtype=dtype, device=device),
        )


_EQ_PEN = pen.al_quadratic_equality()
_INEQ_PEN = pen.al_hinge_inequality()


def _node_rows(lmbd: Tensor, p) -> Tensor:
    """Multiplier rows [..., N, m] of the node(s) named by p["node"].  A node
    past the last row reads the last row, as the reference's gather clamps
    (the SLQ rate quadratization evaluates the running cost at node N)."""
    node, last = p["node"], lmbd.shape[-2] - 1
    node = node.clamp(max=last) if isinstance(node, torch.Tensor) else min(node, last)
    return lmbd[..., node, :]


def augment_problem(
    problem: OptimalControlProblem, project_equalities: bool = False
) -> OptimalControlProblem:
    """Return an unconstrained problem whose cost includes the AL terms.

    The augmented terms read AlState from params["al"] and the node index from
    params["node"].  If ``project_equalities`` the state-input equalities are
    left out (they are handled exactly by null-space projection instead).
    """
    extra_cost = []
    extra_state_cost = []
    extra_final = []

    def pen_fn(apen, lmbd_of):
        def penalty_fn(h, p):
            al: AlState = p["al"]
            rho = al.rho.reshape(al.rho.shape + (1,) * (h.ndim - al.rho.ndim))
            return apen.derivatives(lmbd_of(al, p), rho, h)

        return penalty_fn

    # Each AL term is a structured Gauss-Newton cost: the LQ approximator
    # consumes psi', psi'' and the constraint Jacobian directly.
    if problem.equality_terms and not project_equalities:
        extra_cost.append(GaussNewtonCost(
            problem.equality,
            pen_fn(_EQ_PEN, lambda al, p: _node_rows(al.lmbd_eq, p)),
        ))

    if problem.inequality_terms:
        extra_cost.append(GaussNewtonCost(
            problem.inequality,
            pen_fn(_INEQ_PEN, lambda al, p: _node_rows(al.lmbd_ineq, p)),
        ))

    if problem.state_equality_terms:
        extra_state_cost.append(GaussNewtonCost(
            problem.state_equality,
            pen_fn(_EQ_PEN, lambda al, p: _node_rows(al.lmbd_state_eq, p)),
            with_input=False,
        ))

    if problem.state_inequality_terms:
        extra_state_cost.append(GaussNewtonCost(
            problem.state_inequality,
            pen_fn(_INEQ_PEN, lambda al, p: _node_rows(al.lmbd_state_ineq, p)),
            with_input=False,
        ))

    if problem.final_equality_terms:
        extra_final.append(GaussNewtonCost(
            problem.final_equality,
            pen_fn(_EQ_PEN, lambda al, p: al.lmbd_final_eq),
            with_input=False,
        ))

    return dataclasses.replace(
        problem,
        cost_terms=problem.cost_terms + tuple(extra_cost),
        state_cost_terms=problem.state_cost_terms + tuple(extra_state_cost),
        final_cost_terms=problem.final_cost_terms + tuple(extra_final),
        equality_terms=() if not project_equalities else problem.equality_terms,
        state_equality_terms=(),
        inequality_terms=(),
        state_inequality_terms=(),
        final_equality_terms=(),
    )


def update_multipliers(
    problem: OptimalControlProblem,
    grid: TimeGrid,
    xs: Tensor,
    us: Tensor,
    params,
    al: AlState,
    rho_growth: float = 1.0,
    rho_max: float = 1e6,
) -> AlState:
    """Dual ascent on all multipliers at the trajectory xs [..., N+1, nx],
    us [..., N, nu] (leading dims those of ``al``), and the penalty grown by
    ``rho_growth`` up to ``rho_max``."""
    new = al_dual_ascent(evaluate_trajectory(problem, grid, xs, us, params), al)
    return new._replace(rho=torch.clamp(al.rho * rho_growth, max=rho_max))
