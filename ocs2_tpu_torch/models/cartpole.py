"""Cartpole swing-up with input constraints.

Counterpart of ``ocs2_tpu/models/cartpole.py`` (the reference's
ocs2_cartpole: STATE_DIM 4, INPUT_DIM 1, the relaxed-barrier input bound
|F| <= 6 handled as a soft or a hard inequality).

State x = [theta, p, theta_dot, p_dot] (pole angle from upright, cart
position), input u = [force].
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..core import penalties as pen
from ..core.reference import TargetTrajectories
from ..oc.problem import (
    OptimalControlProblem,
    quadratic_cost,
    quadratic_final_cost,
    soft_constraint,
)

NX = 4
NU = 1

CART_MASS = 1.0
POLE_MASS = 0.1
POLE_LENGTH = 0.5  # half-length in the classic formulation
GRAVITY = 9.81
MAX_FORCE = 6.0


def dynamics(t, x, u, p):
    """x [..., 4], u [..., 1] -> dx/dt [..., 4] (width-1 slices: see
    ``oc/problem.py``)."""
    del t, p
    theta, dtheta, dpos = x[..., 0:1], x[..., 2:3], x[..., 3:4]
    force = u[..., 0:1]
    sin_t = torch.sin(theta)
    cos_t = torch.cos(theta)
    total = CART_MASS + POLE_MASS
    # Standard cartpole (pole pivoting on cart), theta measured from upright.
    temp = (force + POLE_MASS * POLE_LENGTH * dtheta**2 * sin_t) / total
    denom = POLE_LENGTH * (4.0 / 3.0 - POLE_MASS * cos_t**2 / total)
    ddtheta = (GRAVITY * sin_t - cos_t * temp) / denom
    ddpos = temp - POLE_MASS * POLE_LENGTH * ddtheta * cos_t / total
    return torch.cat([dtheta, dpos, ddtheta, ddpos], dim=-1)


def input_bounds(t, x, u, p):
    """h(u) >= 0 box: [u + max, max - u]."""
    del t, x, p
    force = u[..., 0:1]
    return torch.cat([force + MAX_FORCE, MAX_FORCE - force], dim=-1)


Q = np.diag(np.array([2.0, 1.0, 0.2, 0.2], np.float32))
R = np.diag(np.array([0.1], np.float32))
QF = np.diag(np.array([40.0, 20.0, 4.0, 4.0], np.float32))


def make_problem(constraint_mode: str = "soft", device="cuda") -> OptimalControlProblem:
    """constraint_mode: 'soft' (relaxed barrier in the cost, the reference's
    default), 'hard' (an inequality term for AL / IPM), or 'none'."""
    base = OptimalControlProblem(
        dynamics=dynamics,
        cost_terms=(quadratic_cost(Q, R, device=device),),
        final_cost_terms=(quadratic_final_cost(QF, device=device),),
        nx=NX,
        nu=NU,
    )
    if constraint_mode == "soft":
        barrier = pen.relaxed_barrier(mu=0.1, delta=1e-3)
        return base.add(cost_terms=(soft_constraint(input_bounds, barrier),))
    if constraint_mode == "hard":
        return base.add(inequality_terms=(input_bounds,))
    return base


def make_params(device="cuda"):
    return {
        "target": TargetTrajectories.constant(
            np.zeros((NX,), np.float32), np.zeros((NU,), np.float32), device=device
        )
    }


def initial_state_down(device="cuda"):
    """Pole hanging down: the swing-up task's initial condition."""
    return torch.tensor([math.pi, 0.0, 0.0, 0.0], dtype=torch.float32, device=device)
