"""Motion-tracking cost, torque approximation, soft torque limits and knee
collision avoidance for the quadruped.

Counterpart of ``ocs2_tpu/models/legged_robot/motion_tracking.py``: the
``motion_tracking``, ``torque_limits`` and ``collision_avoidance`` options of
``foothold_planner.make_segmented_perceptive_problem`` (SRBD model).  Every
function is batch-polymorphic (``x [..., 24]``, ``u [..., 24]``).  The
torque approximation uses the model's closed-form leg Jacobian where the
JAX package takes ``jacfwd`` of the leg kinematics.
"""
from __future__ import annotations

import numpy as np
import torch

from ...core import penalties as pen
from ...oc.problem import ResidualGaussNewtonCost, soft_constraint
from . import model
from .model import (
    NUM_LEGS,
    base_euler,
    base_position,
    contact_forces,
    euler_zyx_rotation,
    foot_positions_world,
    foot_velocities_world,
    joint_angles,
    joint_velocities,
)

Tensor = torch.Tensor

# Default weights of the motion-tracking cost.
DEFAULT_WEIGHTS = {
    "euler": (100.0, 200.0, 200.0),
    "base_position": (1000.0, 1000.0, 1500.0),
    "angular_velocity": (5.0, 10.0, 10.0),
    "linear_velocity": (15.0, 15.0, 30.0),
    "joint_position": (2.0, 2.0, 1.0),
    "foot_position": (60.0, 60.0, 60.0),
    "joint_velocity": (0.02, 0.02, 0.01),
    "foot_velocity": (1.0, 1.0, 1.0),
    "contact_force": (0.001, 0.001, 0.001),
}


def _weight_vector(weights: dict) -> np.ndarray:
    w = dict(DEFAULT_WEIGHTS, **(weights or {}))
    per_leg = lambda key: np.tile(np.asarray(w[key], np.float32), NUM_LEGS)  # noqa: E731
    return np.concatenate(
        [
            np.asarray(w["euler"], np.float32),
            np.asarray(w["base_position"], np.float32),
            np.asarray(w["angular_velocity"], np.float32),
            np.asarray(w["linear_velocity"], np.float32),
            per_leg("joint_position"),
            per_leg("foot_position"),
            per_leg("joint_velocity"),
            per_leg("foot_velocity"),
            per_leg("contact_force"),
        ]
    )


def _flat_legs(v: Tensor) -> Tensor:
    return v.reshape(v.shape[:-2] + (-1,))


def motion_tracking_residual(t, x, u, p):
    """[..., 72] residual of the state and input tracking errors.  Foot
    position / velocity references come from ``p["mt_foot_pos_ref"]`` /
    ``p["mt_foot_vel_ref"]`` when present, else the FK of the target state
    and zero velocity."""
    target = p["target"]
    x_ref = target.state_at(t)
    u_ref = target.input_at(t)
    foot_pos_ref = p.get("mt_foot_pos_ref")
    if foot_pos_ref is None:
        foot_pos_ref = foot_positions_world(x_ref)
    foot_vel_ref = p.get("mt_foot_vel_ref")
    if foot_vel_ref is None:
        foot_vel_ref = torch.zeros((NUM_LEGS, 3), dtype=x.dtype, device=x.device)
    return torch.cat(
        [
            base_euler(x) - base_euler(x_ref),
            base_position(x) - base_position(x_ref),
            x[..., 3:6] - x_ref[..., 3:6],
            x[..., 0:3] - x_ref[..., 0:3],
            joint_angles(x) - joint_angles(x_ref),
            _flat_legs(foot_positions_world(x) - foot_pos_ref),
            joint_velocities(u) - joint_velocities(u_ref),
            _flat_legs(foot_velocities_world(x, u) - foot_vel_ref),
            _flat_legs(contact_forces(u) - contact_forces(u_ref)),
        ],
        dim=-1,
    )


def motion_tracking_cost(weights: dict | None = None, device="cuda"):
    """The motion-tracking term (state-input, Gauss-Newton, PSD)."""
    return ResidualGaussNewtonCost(motion_tracking_residual, _weight_vector(weights or {}),
                                   device=device)


# ---------------------------------------------------------------------------
# Torque approximation and limits.
# ---------------------------------------------------------------------------


def torque_approximation(x, u) -> Tensor:
    """[..., 12] joint torques tau = -J(q)' R_wb' f_world per leg (contact
    forces mapped through the foot Jacobian, leg dynamics neglected)."""
    k = model._constants(x.device, x.dtype)
    q = model._per_leg(joint_angles(x))  # [..., 4, 3]
    # R' f for every leg, as row vectors: (f R)_i = (R' f)_i.
    f_body = contact_forces(u) @ euler_zyx_rotation(base_euler(x))
    eye = torch.eye(3, dtype=x.dtype, device=x.device)
    # Column j of the leg Jacobian is its velocity map applied to e_j.
    cols = [model._feet_velocity_base(q, eye[j], k.lateral) for j in range(3)]
    tau = torch.stack([-torch.sum(c * f_body, dim=-1) for c in cols], dim=-1)
    return _flat_legs(tau)


DEFAULT_TORQUE_LIMITS = np.full(12, 80.0, np.float32)  # Nm


def make_torque_limits_soft(limits=DEFAULT_TORQUE_LIMITS, mu: float = 0.1,
                            delta: float = 5.0, device="cuda"):
    """Relaxed barrier on the double-sided rows [tau_max - tau; tau + tau_max]
    >= 0."""
    limits = torch.as_tensor(np.asarray(limits, np.float32), device=device)

    def rows(t, x, u, p):
        del t, p
        tau = torque_approximation(x, u)
        return torch.cat([limits - tau, tau + limits], dim=-1)

    return soft_constraint(rows, pen.relaxed_barrier(mu=mu, delta=delta))


# ---------------------------------------------------------------------------
# Collision avoidance (knee spheres vs terrain clearance).
# ---------------------------------------------------------------------------

KNEE_RADIUS = 0.06
FOOT_RADIUS = 0.02


def _knee_positions_world(x) -> Tensor:
    """[..., 4, 3] knee (HFE -> KFE junction) world positions."""
    k = model._constants(x.device, x.dtype)
    q = model._per_leg(joint_angles(x))
    haa, hfe = q[..., 0:1], q[..., 1:2]
    x_p = -model.THIGH_LENGTH * torch.sin(hfe)
    z_p = -model.THIGH_LENGTH * torch.cos(hfe)
    c, s = torch.cos(haa), torch.sin(haa)
    knee_b = k.hip_offsets + torch.cat(
        [x_p, c * k.lateral - s * z_p, s * k.lateral + c * z_p], dim=-1)
    r_wb = euler_zyx_rotation(base_euler(x))
    return base_position(x).unsqueeze(-2) + model._rotate(r_wb, knee_b)


def collision_clearance(t, x, p):
    """[..., 4] knee-sphere clearances above the terrain (>= 0 feasible).
    The terrain height is bilinear on ``p["em_heights"]`` / ``p["em_origin"]``
    / ``p["em_res"]`` when present, else flat ground z = 0."""
    del t
    knees = _knee_positions_world(x)
    heights = p.get("em_heights")
    if heights is None:
        terrain_z = torch.zeros_like(knees[..., 2])
    else:
        ij = (knees[..., :2] - p["em_origin"]) / p["em_res"]
        hi = torch.tensor(heights.shape[:2], device=x.device) - 2
        i0 = torch.minimum(torch.clamp(torch.floor(ij).to(torch.int64), min=0), hi)
        frac = ij - i0.to(ij.dtype)
        flat = heights.reshape(-1)
        w = heights.shape[1]
        g = lambda di, dj: flat[(i0[..., 0] + di) * w + i0[..., 1] + dj]  # noqa: E731
        fx, fy = frac[..., 0], frac[..., 1]
        terrain_z = (
            g(0, 0) * (1 - fx) * (1 - fy)
            + g(1, 0) * fx * (1 - fy)
            + g(0, 1) * (1 - fx) * fy
            + g(1, 1) * fx * fy
        )
    return knees[..., 2] - terrain_z - KNEE_RADIUS


def make_collision_avoidance_cost(mu: float = 0.5, delta: float = 0.05):
    """State-only relaxed barrier on the knee-sphere clearance."""
    return soft_constraint(collision_clearance, pen.relaxed_barrier(mu=mu, delta=delta),
                           with_input=False)
