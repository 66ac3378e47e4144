"""Sequential linear programming solver (SLP) with the PIPG inner solver.

Counterpart of ``ocs2_tpu/solvers/slp.py``.  SLP *is* the SQP skeleton with
``qp_solver="pipg"``: transcription, filter line search, AL outer loop and
convergence logic are those of ``solvers/sqp.py``; the inner solve swaps the
Riccati recursion for Ruiz equilibration and the PIPG iteration
(``ops/pipg.py``).  PIPG has no feedback-gain byproduct, so the returned
policy is feedforward.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from ..oc.problem import OptimalControlProblem
from ..oc.time_discretization import TimeGrid
from . import sqp as _sqp
from .al import AlState

SlpSolution = _sqp.SqpSolution


@dataclasses.dataclass(frozen=True)
class SlpSettings(_sqp.SqpSettings):
    qp_solver: str = "pipg"
    pipg_iterations: int = 3000
    ruiz_iterations: int = 5
    use_feedback_policy: bool = False


def solve(
    problem: OptimalControlProblem,
    grid: TimeGrid,
    x0,
    params: Any,
    xs_init: Optional[torch.Tensor] = None,
    us_init: Optional[torch.Tensor] = None,
    al_init: Optional[AlState] = None,
    settings: SlpSettings = SlpSettings(),
    device="cuda",
) -> SlpSolution:
    """``sqp.solve`` with the SLP settings; the same batch conventions."""
    return _sqp.solve(
        problem, grid, x0, params, xs_init=xs_init, us_init=us_init, al_init=al_init,
        settings=settings, device=device,
    )
