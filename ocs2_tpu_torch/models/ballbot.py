"""Ballbot — ball-balancing robot, 10 states / 3 inputs.

Counterpart of ``ocs2_tpu/models/ballbot.py``: equations of motion derived
analytically for a ball + pendulum-body model in both lean axes with yaw.

  q = [x_ball, y_ball, yaw, pitch, roll]   (base Euler angles zyx)
  dq = d/dt q
  u = [tau_x_wheel, tau_y_wheel, tau_z]    (omni-wheel torques mapped to
                                            ball accelerations + yaw torque)
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.reference import TargetTrajectories
from ..oc.problem import (
    OptimalControlProblem,
    quadratic_cost,
    quadratic_final_cost,
)

NX = 10
NU = 3

BALL_RADIUS = 0.125
BALL_MASS = 2.65
BODY_MASS = 8.0
BODY_COM_HEIGHT = 0.32  # above ball center
BODY_INERTIA = 0.4
YAW_INERTIA = 0.1
GRAVITY = 9.81


def _lean_axis_accel(theta, dtheta, tau):
    """Ball-pendulum EoM for one lean axis.

    Ball position q1 and body lean theta couple through the contact:
    returns (ddq_ball, ddtheta) for wheel torque tau applied at the ball.
    """
    m_total = BALL_MASS + BODY_MASS
    ml = BODY_MASS * BODY_COM_HEIGHT
    i_b = BODY_INERTIA + BODY_MASS * BODY_COM_HEIGHT**2
    sin_t = torch.sin(theta)
    cos_t = torch.cos(theta)
    force = tau / BALL_RADIUS
    # [m_total, ml*cos; ml*cos, i_b] [ddq; ddth] = [F + ml*dth^2*sin; ml*g*sin - tau]
    a11 = m_total
    a12 = ml * cos_t
    a22 = i_b
    b1 = force + ml * dtheta * dtheta * sin_t
    b2 = ml * GRAVITY * sin_t - tau
    det = a11 * a22 - a12 * a12
    ddq = (a22 * b1 - a12 * b2) / det
    ddth = (a11 * b2 - a12 * b1) / det
    return ddq, ddth


def dynamics(t, x, u, p):
    """x [..., 10], u [..., 3] -> dx/dt [..., 10].

    Entries are taken as width-1 slices, not 0-dim selects: see the note on
    Python scalars in ``oc/problem.py``."""
    del t, p
    # q = [x, y, yaw, pitch, roll], dq likewise.
    dq = x[..., 5:10]
    pitch, roll = x[..., 3:4], x[..., 4:5]
    dpitch, droll = x[..., 8:9], x[..., 9:10]
    ddx, ddpitch = _lean_axis_accel(pitch, dpitch, u[..., 0:1])
    ddy, ddroll = _lean_axis_accel(roll, droll, u[..., 1:2])
    ddyaw = u[..., 2:3] / YAW_INERTIA
    return torch.cat([dq, ddx, ddy, ddyaw, ddpitch, ddroll], dim=-1)


# Weights mirror ocs2_ballbot/config/mpc/task.info Q/R diagonals.
Q = np.diag(np.array([20.0, 20.0, 10.0, 50.0, 50.0, 2.0, 2.0, 1.0, 5.0, 5.0], np.float32))
R = np.diag(np.array([1.0, 1.0, 1.0], np.float32))
QF = 2.0 * Q


def make_problem(device="cuda") -> OptimalControlProblem:
    return OptimalControlProblem(
        dynamics=dynamics,
        cost_terms=(quadratic_cost(Q, R, device=device),),
        final_cost_terms=(quadratic_final_cost(QF, device=device),),
        nx=NX,
        nu=NU,
    )


def make_params(target_position=(0.0, 0.0, 0.0), device="cuda"):
    target = np.zeros(NX, np.float32)
    target[:3] = target_position
    return {
        "target": TargetTrajectories.constant(
            target, np.zeros(NU, np.float32), device=device
        )
    }
