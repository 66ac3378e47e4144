"""Quadrotor — 12-state nonlinear attitude dynamics.

Counterpart of ``ocs2_tpu/models/quadrotor.py`` (STATE_DIM 12, INPUT_DIM 4;
Newton-Euler with ZYX Euler angles).

State x = [p (3), eulerZYX (3), v_world (3), omega_body (3)];
input u = [total thrust Fz (body), torques Mx My Mz].

Batch-polymorphic (``x [..., 12]``, ``u [..., 4]``) and built from width-1
slices: under ``torch.func.jacfwd`` a 0-dim select times a Python float would
compute in float64.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..core.reference import TargetTrajectories
from ..oc.problem import OptimalControlProblem, quadratic_cost, quadratic_final_cost

Tensor = torch.Tensor

NX = 12
NU = 4

MASS = 1.0
GRAVITY = 9.81
INERTIA = np.array([0.005, 0.005, 0.009], np.float32)  # Ixx Iyy Izz


@functools.lru_cache(maxsize=None)
def _constants(device: torch.device, dtype: torch.dtype):
    """(inertia [3], gravity vector [3]) on one device, made once."""
    new = lambda v: torch.tensor(np.asarray(v), dtype=dtype, device=device)  # noqa: E731
    return new(INERTIA), new([0.0, 0.0, GRAVITY])


def _matrix(rows) -> Tensor:
    """[..., 3, 3] from three rows of three width-1 entries [..., 1]."""
    return torch.stack([torch.cat(r, dim=-1) for r in rows], dim=-2)


def euler_zyx_to_rotation(euler: Tensor) -> Tensor:
    """R_world_body = Rz(yaw) Ry(pitch) Rx(roll) for euler [..., 3]."""
    yaw, pitch, roll = euler[..., 0:1], euler[..., 1:2], euler[..., 2:3]
    cy, sy = torch.cos(yaw), torch.sin(yaw)
    cp, sp = torch.cos(pitch), torch.sin(pitch)
    cr, sr = torch.cos(roll), torch.sin(roll)
    zero, one = torch.zeros_like(cy), torch.ones_like(cy)
    rz = _matrix([[cy, -sy, zero], [sy, cy, zero], [zero, zero, one]])
    ry = _matrix([[cp, zero, sp], [zero, one, zero], [-sp, zero, cp]])
    rx = _matrix([[one, zero, zero], [zero, cr, -sr], [zero, sr, cr]])
    return rz @ ry @ rx


def euler_zyx_rate_matrix(euler: Tensor) -> Tensor:
    """Maps body angular velocity to ZYX Euler-angle rates, [..., 3, 3]."""
    pitch, roll = euler[..., 1:2], euler[..., 2:3]
    cp = torch.cos(pitch)
    sp = torch.sin(pitch)
    cr = torch.cos(roll)
    sr = torch.sin(roll)
    # Guard the pitch singularity for robustness far from hover.
    sec = 1.0 / torch.clamp(torch.abs(cp), min=1e-3) * torch.sign(cp + 1e-9)
    zero, one = torch.zeros_like(cp), torch.ones_like(cp)
    return _matrix([
        [zero, sr * sec, cr * sec],
        [zero, cr, -sr],
        [one, sr * sp * sec, cr * sp * sec],
    ])


def dynamics(t, x, u, p):
    del t, p
    inertia, gravity = _constants(x.device, x.dtype)
    euler = x[..., 3:6]
    v = x[..., 6:9]
    omega = x[..., 9:12]
    r_wb = euler_zyx_to_rotation(euler)
    # R [0, 0, Fz]: the third column scaled by the thrust.
    thrust_world = r_wb[..., :, 2] * u[..., 0:1]
    dv = thrust_world / MASS - gravity
    deuler = (euler_zyx_rate_matrix(euler) @ omega.unsqueeze(-1)).squeeze(-1)
    torque = u[..., 1:4]
    gyro = torch.linalg.cross(*torch.broadcast_tensors(omega, inertia * omega), dim=-1)
    domega = (torque - gyro) / inertia
    return torch.cat([v, deuler, dv, domega], dim=-1)


def hover_input(device="cuda") -> Tensor:
    return torch.tensor([MASS * GRAVITY, 0.0, 0.0, 0.0], dtype=torch.float32, device=device)


Q = np.diag(
    np.array([10.0, 10.0, 10.0, 5.0, 5.0, 5.0, 1.0, 1.0, 1.0, 0.1, 0.1, 0.1], np.float32)
)
R = np.diag(np.array([0.1, 1.0, 1.0, 1.0], np.float32))
QF = 2.0 * Q


def make_problem(device="cuda") -> OptimalControlProblem:
    return OptimalControlProblem(
        dynamics=dynamics,
        cost_terms=(quadratic_cost(Q, R, device=device),),
        final_cost_terms=(quadratic_final_cost(QF, device=device),),
        nx=NX,
        nu=NU,
    )


def make_params(target_position=(0.0, 0.0, 1.0), device="cuda"):
    target_state = np.zeros(NX, np.float32)
    target_state[0:3] = np.asarray(target_position, np.float32)
    return {
        "target": TargetTrajectories.constant(target_state, hover_input(device), device=device)
    }
