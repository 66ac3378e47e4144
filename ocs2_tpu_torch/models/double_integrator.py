"""Double integrator — the minimal LQ MPC demo.

Counterpart of ``ocs2_tpu/models/double_integrator.py`` (STATE_DIM 2,
INPUT_DIM 1); the runtime's cheap parity fixture.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.reference import TargetTrajectories
from ..oc.problem import OptimalControlProblem, quadratic_cost, quadratic_final_cost

NX = 2
NU = 1

Q = np.diag(np.array([1.0, 1.0], np.float32))
R = np.diag(np.array([1.0], np.float32))
QF = np.diag(np.array([10.0, 10.0], np.float32))


def dynamics(t, x, u, p):
    del t, p
    return torch.cat([x[..., 1:2], u[..., 0:1]], dim=-1)


def make_problem(device="cuda") -> OptimalControlProblem:
    return OptimalControlProblem(
        dynamics=dynamics,
        cost_terms=(quadratic_cost(Q, R, device=device),),
        final_cost_terms=(quadratic_final_cost(QF, device=device),),
        nx=NX,
        nu=NU,
    )


def make_params(target_state=(0.0, 0.0), device="cuda"):
    return {
        "target": TargetTrajectories.constant(
            np.asarray(target_state, np.float32), np.zeros((NU,), np.float32), device=device
        )
    }
