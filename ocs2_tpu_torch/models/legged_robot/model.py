"""Quadruped centroidal model (ANYmal-class): state/input layout, leg
kinematics, and single-rigid-body centroidal dynamics.

Counterpart of ``ocs2_tpu/models/legged_robot/model.py``.

State  x (24) = [ h_com/m (6: v_com, normalized angular momentum),
                  base pose (6: position, euler zyx),
                  joint angles (12: LF RF LH RH x (HAA HFE KFE)) ]
Input  u (24) = [ contact forces (12: 3 per foot), joint velocities (12) ]

Every function is batch-polymorphic (``x [..., 24]``, ``u [..., 24]``) and
works on the four legs at once: leg quantities are ``[..., 4, 3]``.  The
rotations and the leg Jacobian are written in closed form, entry by entry,
from width-1 slices (see the note on 0-dim tensors in ``oc/problem.py``);
the foot velocity uses the analytic leg Jacobian where the reference takes
``jacfwd`` of the leg kinematics, which gives the same numbers without a
nested transform inside functions that are themselves differentiated.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

Tensor = torch.Tensor

NX = 24
NU = 24
NUM_LEGS = 4
NUM_JOINTS = 12

MASS = 30.0
GRAVITY = 9.81
# SRBD rotational inertia about the CoM (body frame), ANYmal-like.
INERTIA = np.array([1.0, 2.1, 2.2], np.float32)

# Hip (HAA) mounting points in the base frame: LF, RF, LH, RH.
HIP_OFFSETS = np.array(
    [
        [0.3, 0.2, 0.0],
        [0.3, -0.2, 0.0],
        [-0.3, 0.2, 0.0],
        [-0.3, -0.2, 0.0],
    ],
    np.float32,
)
THIGH_LENGTH = 0.25
SHANK_LENGTH = 0.33
HIP_LATERAL = 0.08  # HAA to leg plane offset (toward body side sign)

# Default standing configuration (x-shaped: knees inward), per leg
# (HAA, HFE, KFE).
DEFAULT_JOINTS = np.array(
    [
        [0.0, 0.4, -0.8],
        [0.0, 0.4, -0.8],
        [0.0, -0.4, 0.8],
        [0.0, -0.4, 0.8],
    ],
    np.float32,
).reshape(-1)
# Floor of cos(pitch) in the Euler-rate matrix (keeps it finite at +-90 deg).
EULER_RATE_COS_FLOOR = 1e-3
# Kinematically consistent with DEFAULT_JOINTS: (thigh + shank)*cos(0.4) so
# the default stance puts the feet exactly on the ground plane (terrain
# constraints depend on this; a mismatch makes every stance foot hover).
STAND_HEIGHT = float((THIGH_LENGTH + SHANK_LENGTH) * np.cos(0.4))


def leg_side_sign(leg: int) -> float:
    """+1 for left legs (LF, LH), -1 for right (RF, RH)."""
    return 1.0 if leg in (0, 2) else -1.0


class _Constants(NamedTuple):
    hip_offsets: Tensor  # [4, 3]
    lateral: Tensor  # [4, 1] signed HAA-to-leg-plane offset
    inertia: Tensor  # [3]
    gravity: Tensor  # [3]


@functools.lru_cache(maxsize=None)
def _constants(device: torch.device, dtype: torch.dtype) -> _Constants:
    """The model's constant tensors, made once per device."""
    new = lambda v: torch.tensor(np.asarray(v), dtype=dtype, device=device)  # noqa: E731
    return _Constants(
        hip_offsets=new(HIP_OFFSETS),
        lateral=new([[leg_side_sign(leg) * HIP_LATERAL] for leg in range(NUM_LEGS)]),
        inertia=new(INERTIA),
        gravity=new([0.0, 0.0, GRAVITY]),
    )


def _leg_plane(q: Tensor):
    """Sagittal-plane foot position (x_p, z_p) of legs q [..., 3] after
    HFE/KFE, and its derivatives with respect to (hfe, kfe); width-1 columns."""
    hfe, kfe = q[..., 1:2], q[..., 2:3]
    s1, c1 = torch.sin(hfe), torch.cos(hfe)
    s12, c12 = torch.sin(hfe + kfe), torch.cos(hfe + kfe)
    x_p = -THIGH_LENGTH * s1 - SHANK_LENGTH * s12
    z_p = -THIGH_LENGTH * c1 - SHANK_LENGTH * c12
    # d x_p / d hfe = z_p, d z_p / d hfe = -x_p.
    return x_p, z_p, -SHANK_LENGTH * c12, SHANK_LENGTH * s12


def foot_position_base(leg: int, q_leg: Tensor) -> Tensor:
    """Foot position in the base frame for one leg's (HAA, HFE, KFE) angles
    q_leg [..., 3].

    Chain: hip offset -> HAA rotation about x -> lateral offset -> HFE about
    y -> thigh -> KFE about y -> shank."""
    k = _constants(q_leg.device, q_leg.dtype)
    return _feet_base(q_leg, k.lateral[leg], k.hip_offsets[leg])


def _feet_base(q: Tensor, lateral: Tensor, hip: Tensor) -> Tensor:
    haa = q[..., 0:1]
    x_p, z_p, _, _ = _leg_plane(q)
    c, s = torch.cos(haa), torch.sin(haa)
    # HAA roll about x applied to (x_p, lateral, z_p).
    return hip + torch.cat([x_p, c * lateral - s * z_p, s * lateral + c * z_p], dim=-1)


def _feet_velocity_base(q: Tensor, dq: Tensor, lateral: Tensor) -> Tensor:
    """J_leg(q) dq for legs q, dq [..., 3]: the leg Jacobian of
    ``foot_position_base`` in closed form."""
    haa = q[..., 0:1]
    dhaa, dhfe, dkfe = dq[..., 0:1], dq[..., 1:2], dq[..., 2:3]
    x_p, z_p, dx_dkfe, dz_dkfe = _leg_plane(q)
    c, s = torch.cos(haa), torch.sin(haa)
    vx = z_p * dhfe + dx_dkfe * dkfe
    vz_plane = -x_p * dhfe + dz_dkfe * dkfe
    return torch.cat([
        vx,
        (-s * lateral - c * z_p) * dhaa - s * vz_plane,
        (c * lateral - s * z_p) * dhaa + c * vz_plane,
    ], dim=-1)


def _rows(rows) -> Tensor:
    """[..., 3, 3] from three rows of three width-1 entries [..., 1]."""
    return torch.stack([torch.cat(r, dim=-1) for r in rows], dim=-2)


def euler_zyx_rotation(euler: Tensor) -> Tensor:
    """Rz(yaw) Ry(pitch) Rx(roll) for euler [..., 3] -> [..., 3, 3]."""
    yaw, pitch, roll = euler[..., 0:1], euler[..., 1:2], euler[..., 2:3]
    cy, sy = torch.cos(yaw), torch.sin(yaw)
    cp, sp = torch.cos(pitch), torch.sin(pitch)
    cr, sr = torch.cos(roll), torch.sin(roll)
    return _rows([
        [cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr],
        [sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr],
        [-sp, cp * sr, cp * cr],
    ])


def euler_zyx_rate_matrix(euler: Tensor) -> Tensor:
    """Body angular velocity -> ZYX euler rates, [..., 3, 3]."""
    pitch, roll = euler[..., 1:2], euler[..., 2:3]
    cp = torch.clamp(torch.cos(pitch), min=EULER_RATE_COS_FLOOR)
    sp = torch.sin(pitch)
    cr, sr = torch.cos(roll), torch.sin(roll)
    zero, one = torch.zeros_like(cp), torch.ones_like(cp)
    return _rows([
        [zero, sr / cp, cr / cp],
        [zero, cr, -sr],
        [one, sr * sp / cp, cr * sp / cp],
    ])


# -- state accessors (CentroidalModelInfo layout) ---------------------------
def com_velocity(x):
    return x[..., 0:3]


def normalized_ang_momentum(x):
    return x[..., 3:6]


def base_position(x):
    return x[..., 6:9]


def base_euler(x):
    return x[..., 9:12]


def joint_angles(x):
    return x[..., 12:24]


def _per_leg(v: Tensor) -> Tensor:
    return v.reshape(v.shape[:-1] + (NUM_LEGS, 3))


def contact_forces(u):
    """[..., 4, 3] world-frame contact forces."""
    return _per_leg(u[..., 0:12])


def joint_velocities(u):
    return u[..., 12:24]


def _cross(a: Tensor, b: Tensor) -> Tensor:
    return torch.linalg.cross(*torch.broadcast_tensors(a, b), dim=-1)


def _rotate(r_wb: Tensor, v: Tensor) -> Tensor:
    """R v for every leg: r_wb [..., 3, 3], v [..., 4, 3]."""
    return v @ r_wb.transpose(-1, -2)


def _feet_relative_world(x) -> Tensor:
    """[..., 4, 3] foot positions relative to the base origin, world frame."""
    k = _constants(x.device, x.dtype)
    feet_b = _feet_base(_per_leg(joint_angles(x)), k.lateral, k.hip_offsets)
    return _rotate(euler_zyx_rotation(base_euler(x)), feet_b)


def foot_positions_world(x) -> Tensor:
    """[..., 4, 3] foot positions in world frame."""
    return base_position(x).unsqueeze(-2) + _feet_relative_world(x)


def _body_angular_velocity(x) -> Tensor:
    k = _constants(x.device, x.dtype)
    return MASS * normalized_ang_momentum(x) / k.inertia  # I w = m * h_ang_n


def foot_velocities_world(x, u) -> Tensor:
    """[..., 4, 3] world-frame foot velocities.

    v_foot = v_base + omega x (R p_rel) + R J_leg dq_leg; base velocity is
    taken from the centroidal states (SRBD: v_base ~= v_com), angular
    velocity from the normalized angular momentum.
    """
    k = _constants(x.device, x.dtype)
    r_wb = euler_zyx_rotation(base_euler(x))
    q = _per_leg(joint_angles(x))
    dq = _per_leg(joint_velocities(u))
    p_rel = _rotate(r_wb, _feet_base(q, k.lateral, k.hip_offsets))
    omega = _body_angular_velocity(x).unsqueeze(-2)
    return (
        com_velocity(x).unsqueeze(-2)
        + _cross(omega, p_rel)
        + _rotate(r_wb, _feet_velocity_base(q, dq, k.lateral))
    )


def dynamics(t, x, u, p):
    """SRBD centroidal dynamics: x [..., 24], u [..., 24] -> dx/dt."""
    del t, p
    k = _constants(x.device, x.dtype)
    forces = contact_forces(u)  # [..., 4, 3] world frame
    # CoM assumed at the base origin (SRBD).
    lever = _feet_relative_world(x)
    total_force = torch.sum(forces, dim=-2)
    torque = torch.sum(_cross(lever, forces), dim=-2)

    dv_com = total_force / MASS - k.gravity
    dh_ang = torque / MASS  # normalized angular momentum rate

    omega = _body_angular_velocity(x)
    deuler = (euler_zyx_rate_matrix(base_euler(x)) @ omega.unsqueeze(-1)).squeeze(-1)
    return torch.cat(
        [dv_com, dh_ang, com_velocity(x), deuler, joint_velocities(u)], dim=-1
    )


def default_state(device="cuda") -> Tensor:
    x = np.zeros(NX, np.float32)
    x[8] = STAND_HEIGHT
    x[12:24] = DEFAULT_JOINTS
    return torch.as_tensor(x, device=device)


def weight_compensating_input(contact_flags, device="cuda") -> Tensor:
    """Gravity-compensating contact forces split over stance legs;
    contact_flags [4] (array-like or tensor) -> u [24]."""
    flags = torch.as_tensor(contact_flags, dtype=torch.float32, device=device)
    n_stance = torch.clamp(torch.sum(flags), min=1.0)
    zeros = torch.zeros_like(flags)
    forces = torch.stack([zeros, zeros, MASS * GRAVITY / n_stance * flags], dim=-1)
    return torch.cat(
        [forces.reshape(-1), torch.zeros(NUM_JOINTS, dtype=torch.float32, device=device)]
    )
