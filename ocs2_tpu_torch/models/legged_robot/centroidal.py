"""Full centroidal dynamics and the RBD conversions for the quadruped.

Counterpart of ``ocs2_tpu/models/legged_robot/centroidal.py``: a mass model
with point masses at the leg links' CoMs (the base keeps its rotational
inertia), the configuration-dependent CoM offset, the centroidal momentum
matrix A(q) with h = A(q) [v_base, omega, dq], FullCentroidalDynamics
(base velocities recovered from the momentum through A) and the
conversions between the full-order (q, v) and the centroidal state.

The reference takes A by ``jacfwd`` of the momentum, and the links'
velocities by ``jacfwd`` of their positions.  Both maps are linear, so here
the link velocities are written in closed form (``_leg_link_coms``) and A
is the momentum evaluated on the 18 unit velocities at once, one batched
evaluation and no transform.  Every function is batch-polymorphic
(``x [..., 24]``); state and input layout are those of ``model.py``.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from . import model
from .model import (
    MASS,
    NUM_LEGS,
    SHANK_LENGTH,
    THIGH_LENGTH,
    _cross,
    _per_leg,
    _rotate,
    base_euler,
    base_position,
    contact_forces,
    euler_zyx_rate_matrix,
    euler_zyx_rotation,
    joint_angles,
    joint_velocities,
)
from ...ops.smallmat import solve_psd_small

Tensor = torch.Tensor

# -- mass model ----------------------------------------------------------------
# Point masses at the leg links' CoMs; the base carries the rest of model.MASS,
# so the SRBD and the full variants describe the same robot.
HIP_MASS = 1.5
THIGH_MASS = 1.2
SHANK_MASS = 0.3
LEG_MASS = HIP_MASS + THIGH_MASS + SHANK_MASS
BASE_MASS = MASS - NUM_LEGS * LEG_MASS
BASE_INERTIA = model.INERTIA  # rotational inertia of the base body


class MassModel(NamedTuple):
    hip: float
    thigh: float
    shank: float

    @property
    def leg(self):
        return self.hip + self.thigh + self.shank

    @property
    def base(self):
        return MASS - NUM_LEGS * self.leg


DEFAULT_MASSES = MassModel(HIP_MASS, THIGH_MASS, SHANK_MASS)
SRBD_MASSES = MassModel(0.0, 0.0, 0.0)  # all mass in the base -> SRBD limit

# (along the thigh, along the shank) to the CoM of the thigh and of the shank.
_LINK_ARMS = ((0.5 * THIGH_LENGTH, 0.0), (THIGH_LENGTH, 0.5 * SHANK_LENGTH))


def _link_masses(masses: MassModel, like: Tensor) -> Tensor:
    """[3, 1]: hip, thigh, shank, to weigh [..., 4, 3, 3] link tensors."""
    return _masses_on(masses, like.device, like.dtype)


@functools.lru_cache(maxsize=None)
def _masses_on(masses: MassModel, device: torch.device, dtype: torch.dtype) -> Tensor:
    """The link masses made once per device (no host copy inside a solve)."""
    return torch.tensor([[masses.hip], [masses.thigh], [masses.shank]], dtype=dtype,
                        device=device)


def _leg_link_coms(q: Tensor, dq: Tensor = None):
    """Base-frame CoMs of each leg's hip, thigh and shank for legs q [..., 4, 3]:
    c [..., 4, 3, 3] (leg, link, xyz), the chain of ``model.foot_position_base``.
    With dq [..., 4, 3] also their velocity along dq and their acceleration
    with zero joint acceleration: (c, c', c'')."""
    k = model._constants(q.device, q.dtype)
    haa, hfe, kfe = q[..., 0:1], q[..., 1:2], q[..., 2:3]
    ca, sa = torch.cos(haa), torch.sin(haa)
    s1, c1 = torch.sin(hfe), torch.cos(hfe)
    s12, c12 = torch.sin(hfe + kfe), torch.cos(hfe + kfe)

    def rx(v0, v1, v2):  # HAA roll about x
        return torch.cat([v0, ca * v1 - sa * v2, sa * v1 + ca * v2], dim=-1)

    def ex_cross(v):  # e_x x v
        return torch.cat([torch.zeros_like(v[..., 0:1]), -v[..., 2:3], v[..., 1:2]], dim=-1)

    hip = k.hip_offsets
    rs = [rx(-a * s1 - b * s12, k.lateral, -a * c1 - b * c12) for a, b in _LINK_ARMS]
    c = torch.stack([hip.expand_as(rs[0])] + [hip + r for r in rs], dim=-2)
    if dq is None:
        return c
    dhaa, dhfe, dkfe = dq[..., 0:1], dq[..., 1:2], dq[..., 2:3]
    d12 = dhfe + dkfe
    zero = torch.zeros_like(s1 * dhfe)
    cds, cdds = [], []
    for (a, b), r in zip(_LINK_ARMS, rs):
        r_d = rx(-a * c1 * dhfe - b * c12 * d12, zero, a * s1 * dhfe + b * s12 * d12)
        r_dd = rx(a * s1 * dhfe * dhfe + b * s12 * d12 * d12, zero,
                  a * c1 * dhfe * dhfe + b * c12 * d12 * d12)
        cds.append(dhaa * ex_cross(r) + r_d)
        cdds.append(dhaa * dhaa * ex_cross(ex_cross(r)) + 2.0 * dhaa * ex_cross(r_d) + r_dd)
    still = torch.zeros_like(cds[0])  # the hip link sits at its mount
    return c, torch.stack([still] + cds, dim=-2), torch.stack([still] + cdds, dim=-2)


def com_offset_base(q_joints: Tensor, masses: MassModel = DEFAULT_MASSES) -> Tensor:
    """CoM offset from the base origin in the base frame, [..., 3]."""
    c = _leg_link_coms(_per_leg(q_joints))
    return torch.sum(_link_masses(masses, c) * c, dim=(-3, -2)) / MASS


def _momentum_world(q_joints, euler, v_base, omega, dq, masses: MassModel):
    """Centroidal momentum [..., 6] (h_lin, h_ang about the CoM), world frame,
    from the world base velocity, the world angular velocity and the joint
    velocities; linear in (v_base, omega, dq)."""
    r_wb = euler_zyx_rotation(euler)
    c, cd, _ = _leg_link_coms(_per_leg(q_joints), _per_leg(dq))
    m = _link_masses(masses, c)
    p = _rotate(r_wb, c.flatten(-3, -2)).unflatten(-2, (NUM_LEGS, 3))  # [..., 4, 3, 3]
    v = (v_base[..., None, None, :] + _cross(omega[..., None, None, :], p)
         + _rotate(r_wb, cd.flatten(-3, -2)).unflatten(-2, (NUM_LEGS, 3)))
    r_com = torch.sum(m * p, dim=(-3, -2)) / MASS
    h_lin = masses.base * v_base + torch.sum(m * v, dim=(-3, -2))
    ib = model._constants(c.device, c.dtype).inertia
    w_body = (r_wb.transpose(-1, -2) @ omega[..., None])[..., 0]
    h_ang = (r_wb @ (ib * w_body)[..., None])[..., 0]  # the base's rotation
    h_ang = h_ang + masses.base * _cross(-r_com, v_base) + torch.sum(
        m * _cross(p - r_com[..., None, None, :], v), dim=(-3, -2))
    return torch.cat([h_lin, h_ang], dim=-1)


def centroidal_momentum_matrix(
    q_joints: Tensor, euler: Tensor, masses: MassModel = DEFAULT_MASSES
) -> Tensor:
    """A(q) [..., 6, 18] with h = A(q) [v_base, omega, dq]: the momentum of the
    18 unit velocities, one batched evaluation of the linear map."""
    eye = torch.eye(18, dtype=q_joints.dtype, device=q_joints.device)
    h = _momentum_world(q_joints[..., None, :], euler[..., None, :], eye[:, 0:3],
                        eye[:, 3:6], eye[:, 6:18], masses)
    return h.transpose(-1, -2)


def _matvec(a: Tensor, v: Tensor) -> Tensor:
    return (a @ v[..., None])[..., 0]


def base_velocity_from_momentum(x: Tensor, dq: Tensor, masses: MassModel = DEFAULT_MASSES):
    """(v_base, omega) from the normalized momentum states: A_b is block upper
    triangular (sum m_i (p_i - r_com) = 0), so omega = I_tot^{-1} rhs_ang by
    the unrolled 3x3 Cholesky and v_base = (rhs_lin - A_b[0:3, 3:6] omega) / m."""
    a = centroidal_momentum_matrix(joint_angles(x), base_euler(x), masses)
    rhs = MASS * x[..., 0:6] - _matvec(a[..., 6:18], dq)
    omega = solve_psd_small(a[..., 3:6, 3:6], rhs[..., 3:6])
    v_base = (rhs[..., 0:3] - _matvec(a[..., 0:3, 3:6], omega)) / MASS
    return v_base, omega


def make_dynamics(masses: MassModel = DEFAULT_MASSES):
    """FullCentroidalDynamics flow map, the signature and 24/24 layout of
    ``model.dynamics``."""

    def dynamics(t, x, u, p):
        del t, p
        k = model._constants(x.device, x.dtype)
        forces = contact_forces(u)
        r_wb = euler_zyx_rotation(base_euler(x))
        dq = joint_velocities(u)
        r_com = _matvec(r_wb, com_offset_base(joint_angles(x), masses))
        lever = model._feet_relative_world(x) - r_com[..., None, :]
        dv_com = torch.sum(forces, dim=-2) / MASS - k.gravity
        dh_ang = torch.sum(_cross(lever, forces), dim=-2) / MASS
        v_base, omega = base_velocity_from_momentum(x, dq, masses)
        deuler = _matvec(euler_zyx_rate_matrix(base_euler(x)), omega)
        return torch.cat([dv_com, dh_ang, v_base, deuler, dq], dim=-1)

    return dynamics


dynamics_full = make_dynamics()


# -- RBD conversions -----------------------------------------------------------


def centroidal_state_from_rbd(q_rbd: Tensor, v_rbd: Tensor,
                              masses: MassModel = DEFAULT_MASSES) -> Tensor:
    """q_rbd [..., 18] = [base position, euler zyx, joints], v_rbd [..., 18] =
    [world linear, world angular base velocity, joint velocities] -> x [..., 24]."""
    euler, q_j = q_rbd[..., 3:6], q_rbd[..., 6:18]
    h = _momentum_world(q_j, euler, v_rbd[..., 0:3], v_rbd[..., 3:6], v_rbd[..., 6:18], masses)
    return torch.cat([h / MASS, q_rbd[..., 0:3], euler, q_j], dim=-1)


def rbd_state_from_centroidal(x: Tensor, u: Tensor, masses: MassModel = DEFAULT_MASSES):
    """Centroidal state and input -> full-order (q_rbd [..., 18], v_rbd [..., 18])."""
    v_base, omega = base_velocity_from_momentum(x, joint_velocities(u), masses)
    q_rbd = torch.cat([base_position(x), base_euler(x), joint_angles(x)], dim=-1)
    v_rbd = torch.cat([v_base, omega, joint_velocities(u)], dim=-1)
    return q_rbd, v_rbd

