"""ComKino full kinodynamic quadruped model.

Counterpart of ``ocs2_tpu/models/legged_robot/comkino.py`` (the reference's
ComKinoSystemDynamicsAd: base dynamics from the top 6 rows of the full
rigid-body dynamics with zero joint acceleration, joints integrated from the
commanded joint velocities, the contact wrench J^T lambda on the base).

The JAX package derives the equations from the Lagrangian by AD nested three
deep (a ``grad`` of a ``jvp`` inside ``jacfwd``, a ``jvp`` of that gradient),
and the LQ approximation adds a ``jacfwd`` on top.  Here the same equations
are written in closed form.  With generalized coordinates
z = [p_base, euler zyx, q] (18), the base's body angular velocity
w = W(euler) euler', W the inverse of ``model.euler_zyx_rate_matrix``
(``_rate_inverse``), point masses m_i at the base origin and at the leg
links' CoMs c_i(q) (base frame, ``centroidal._leg_link_coms``), world
positions P_i = p + R c_i, and s = sum m_i c_i:

    M[0:3, 0:3] = m I,   M[0:3, 3:6] = -R [s]x W,
    M[3:6, 3:6] = W' (I_b + sum m_i [c_i]x' [c_i]x) W,
    bias[0:3]   = R sum m_i a_i + m g e_z,
    bias[3:6]   = W' (sum m_i c_i x a_i + I_b w' + w x I_b w + g s x R'e_z),
    Q[0:3]      = sum_f f,   Q[3:6] = W' sum_f c_f x R'f,

where a_i = w x (w x c_i) + w' x c_i + 2 w x c_i' + c_i'' is the body-frame
acceleration of link i at zero generalized acceleration and w' = W' euler'
(``_rate_inverse_dot``).  With ddq = 0 the top 6 rows close the system:
(M[:6, :6] + 1e-9 I) zdd_base = Q[:6] - bias[:6], solved by the unrolled
6x6 Cholesky of ``ops/smallmat``.  W is the closed-form inverse of the rate
matrix, the rate matrix's clamp of cos(pitch) at 1e-3 included; where the
JAX package differentiates R itself it uses the unclamped cosine, which
differs only past 89.9 degrees of pitch.

State/input layout is model.py's 24/24 (x[0:3] the base's linear velocity,
x[3:6] INERTIA * w_body / MASS), every function batch-polymorphic
(``x [..., 24]``).
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from . import model
from .centroidal import (
    DEFAULT_MASSES,
    MassModel,
    _leg_link_coms,
    _link_masses,
    _matvec,
)
from .model import (
    GRAVITY,
    INERTIA,
    MASS,
    NUM_LEGS,
    _cross,
    _per_leg,
    _rotate,
    _rows,
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

NZ = 18  # generalized coordinates: base position (3) + euler zyx (3) + q (12)


# Base rotational inertia consistent with the SRBD model: model.INERTIA is the
# whole robot's in the nominal configuration; the base body carries what the
# leg links (point masses at their CoMs) do not.  Host numpy, as in the JAX
# package.
def _leg_link_coms_np(leg: int, q_leg: np.ndarray):
    haa, hfe, kfe = q_leg
    side = model.leg_side_sign(leg)
    c, s = np.cos(haa), np.sin(haa)
    rx = np.array([[1.0, 0, 0], [0, c, -s], [0, s, c]])
    hip_mount = np.asarray(model.HIP_OFFSETS[leg], np.float64)

    def sagittal(r_thigh, r_shank):
        x_p = -r_thigh * np.sin(hfe) - r_shank * np.sin(hfe + kfe)
        z_p = -r_thigh * np.cos(hfe) - r_shank * np.cos(hfe + kfe)
        return np.array([x_p, side * model.HIP_LATERAL, z_p])

    p_hip = hip_mount
    p_thigh = hip_mount + rx @ sagittal(0.5 * model.THIGH_LENGTH, 0.0)
    p_shank = hip_mount + rx @ sagittal(model.THIGH_LENGTH, 0.5 * model.SHANK_LENGTH)
    return p_hip, p_thigh, p_shank


def _base_inertia(masses: MassModel) -> np.ndarray:
    q_nom = np.asarray(model.DEFAULT_JOINTS, np.float64).reshape(NUM_LEGS, 3)
    leg_inertia = np.zeros(3)
    for leg in range(NUM_LEGS):
        coms = _leg_link_coms_np(leg, q_nom[leg])
        for m_i, c in zip((masses.hip, masses.thigh, masses.shank), coms):
            # Point-mass inertia about the base origin (diagonal part).
            leg_inertia += m_i * (np.sum(c * c) - c * c)
    return np.maximum(np.asarray(INERTIA, np.float64) - leg_inertia, 1e-3).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _mass_constants(masses: MassModel, device: torch.device, dtype: torch.dtype):
    """(base inertia [3], the 13 point masses [13]: base, then each leg's hip,
    thigh, shank), made once per device."""
    ib = torch.as_tensor(_base_inertia(masses), dtype=dtype, device=device)
    ms = [masses.base] + [masses.hip, masses.thigh, masses.shank] * NUM_LEGS
    return ib, torch.tensor(ms, dtype=dtype, device=device)


def _rate_inverse(euler: Tensor) -> Tensor:
    """W [..., 3, 3]: ZYX euler rates -> body angular velocity, the inverse of
    ``model.euler_zyx_rate_matrix`` (with its clamp of cos(pitch))."""
    pitch, roll = euler[..., 1:2], euler[..., 2:3]
    cp = torch.clamp(torch.cos(pitch), min=1e-3)
    sp = torch.sin(pitch)
    cr, sr = torch.cos(roll), torch.sin(roll)
    zero, one = torch.zeros_like(cp), torch.ones_like(cp)
    return _rows([[-sp, zero, one], [cp * sr, cr, zero], [cp * cr, -sr, zero]])


def _rate_inverse_dot(euler: Tensor, deuler: Tensor) -> Tensor:
    """(d/dt W(euler)) deuler [..., 3] along euler' = deuler."""
    pitch, roll = euler[..., 1:2], euler[..., 2:3]
    cos_p = torch.cos(pitch)
    cp = torch.clamp(cos_p, min=1e-3)
    sp = torch.sin(pitch)
    cr, sr = torch.cos(roll), torch.sin(roll)
    dyaw, dpitch, droll = deuler[..., 0:1], deuler[..., 1:2], deuler[..., 2:3]
    dcp = torch.where(cos_p > 1e-3, -sp * dpitch, torch.zeros_like(cp))
    return torch.cat([
        -cos_p * dpitch * dyaw,
        (dcp * sr + cp * cr * droll) * dyaw - sr * droll * dpitch,
        (dcp * cr - cp * sr * droll) * dyaw - cr * droll * dpitch,
    ], dim=-1)


def _omega_body(euler: Tensor, deuler: Tensor) -> Tensor:
    """ZYX euler rates -> body angular velocity, [..., 3]."""
    return _matvec(_rate_inverse(euler), deuler)


def _link_points(z: Tensor, masses: MassModel):
    """World positions [..., 13, 3] and masses [13] of the point-mass links
    (the base at its origin, then each leg's hip, thigh and shank CoM)."""
    p_base = z[..., 0:3]
    r_wb = euler_zyx_rotation(z[..., 3:6])
    c = _leg_link_coms(_per_leg(z[..., 6:18])).flatten(-3, -2)
    ps = torch.cat([p_base[..., None, :], p_base[..., None, :] + _rotate(r_wb, c)], dim=-2)
    return ps, _mass_constants(masses, z.device, z.dtype)[1]


def _link_velocities(z: Tensor, zdot: Tensor) -> Tensor:
    """World velocities [..., 13, 3] of the point-mass links: v + R (w x c_i + c_i')."""
    r_wb = euler_zyx_rotation(z[..., 3:6])
    w = _omega_body(z[..., 3:6], zdot[..., 3:6])
    c, cd, _ = _leg_link_coms(_per_leg(z[..., 6:18]), _per_leg(zdot[..., 6:18]))
    rel = _cross(w[..., None, None, :], c) + cd
    v = zdot[..., None, 0:3]
    links = v + _rotate(r_wb, rel.flatten(-3, -2))
    return torch.cat([v.expand_as(links[..., :1, :]), links], dim=-2)


def _kinetic_energy(z: Tensor, zdot: Tensor, masses: MassModel, ib) -> Tensor:
    """Translational KE of the point-mass links plus the base body's rotation."""
    m = _mass_constants(masses, z.device, z.dtype)[1]
    v = _link_velocities(z, zdot)
    w = _omega_body(z[..., 3:6], zdot[..., 3:6])
    ib = torch.as_tensor(ib, dtype=z.dtype, device=z.device)
    return 0.5 * torch.sum(m * torch.sum(v * v, dim=-1), dim=-1) + 0.5 * torch.sum(
        w * ib * w, dim=-1)


def _potential_energy(z: Tensor, masses: MassModel) -> Tensor:
    ps, m = _link_points(z, masses)
    return GRAVITY * torch.sum(m * ps[..., 2], dim=-1)


def _skew(v: Tensor) -> Tensor:
    """[v]x [..., 3, 3]."""
    x, y, z = v[..., 0:1], v[..., 1:2], v[..., 2:3]
    zero = torch.zeros_like(x)
    return _rows([[zero, -z, y], [z, zero, -x], [-y, x, zero]])


def _contact_generalized_force(z: Tensor, forces: Tensor) -> Tensor:
    """Q [..., 18] = sum_f J_foot(z)' f_f for world-frame forces [..., 4, 3]:
    the total force, W' sum c_f x R'f, and each leg's J_leg' R'f."""
    k = model._constants(z.device, z.dtype)
    q = _per_leg(z[..., 6:18])
    r_wb = euler_zyx_rotation(z[..., 3:6])
    f_body = forces @ r_wb  # R' f per leg
    feet = model._feet_base(q, k.lateral, k.hip_offsets)
    q_e = _matvec(_rate_inverse(z[..., 3:6]).transpose(-1, -2),
                  torch.sum(_cross(feet, f_body), dim=-2))
    # Columns of each leg's Jacobian: its foot velocity for the 3 unit joint rates.
    eye = torch.eye(3, dtype=z.dtype, device=z.device)
    cols = model._feet_velocity_base(q[..., None, :], eye, k.lateral[:, None, :])
    q_q = torch.sum(cols * f_body[..., None, :], dim=-1)
    return torch.cat([torch.sum(forces, dim=-2), q_e, q_q.flatten(-2, -1)], dim=-1)


def _base_dynamics(z, zdot, forces, masses, external_force_world, external_torque_base):
    """(zdd_base [..., 6], W, W' euler') of the top 6 rows with ddq = 0."""
    k = model._constants(z.device, z.dtype)
    ib = _mass_constants(masses, z.device, z.dtype)[0]
    euler, deuler = z[..., 3:6], zdot[..., 3:6]
    q, dq = _per_leg(z[..., 6:18]), _per_leg(zdot[..., 6:18])
    r_wb = euler_zyx_rotation(euler)
    w_mat = _rate_inverse(euler)
    w = _matvec(w_mat, deuler)
    w_dot = _rate_inverse_dot(euler, deuler)

    c, cd, cdd = _leg_link_coms(q, dq)
    m = _link_masses(masses, c)
    wb, wdb = w[..., None, None, :], w_dot[..., None, None, :]
    acc = _cross(wb, _cross(wb, c)) + _cross(wdb, c) + 2.0 * _cross(wb, cd) + cdd
    s = torch.sum(m * c, dim=(-3, -2))
    mc = (m * c).flatten(-3, -2)
    cc = mc.transpose(-1, -2) @ c.flatten(-3, -2)  # sum m_i c_i c_i'
    eye3 = torch.eye(3, dtype=z.dtype, device=z.device)
    i_rot = torch.diagonal(cc, dim1=-2, dim2=-1).sum(-1)[..., None, None] * eye3 - cc
    i_rot = i_rot + torch.diag_embed(ib)

    m_pe = -(r_wb @ _skew(s) @ w_mat)
    m_ee = w_mat.transpose(-1, -2) @ i_rot @ w_mat
    m66 = torch.cat([
        torch.cat([(MASS * eye3).expand_as(m_pe), m_pe], dim=-1),
        torch.cat([m_pe.transpose(-1, -2), m_ee], dim=-1),
    ], dim=-2)

    f_body = forces @ r_wb
    feet = model._feet_base(q, k.lateral, k.hip_offsets)
    g_body = GRAVITY * r_wb[..., 2, :]  # R' e_z g
    rhs_p = (torch.sum(forces, dim=-2) - _matvec(r_wb, torch.sum(m * acc, dim=(-3, -2)))
             - MASS * k.gravity)
    tau = (torch.sum(_cross(feet, f_body), dim=-2) - torch.sum(m * _cross(c, acc), dim=(-3, -2))
           - ib * w_dot - _cross(w, ib * w) - _cross(s, g_body))
    if external_force_world is not None:
        # A world force at the base origin: the position rows take it directly.
        rhs_p = rhs_p + torch.as_tensor(external_force_world, dtype=z.dtype, device=z.device)
    if external_torque_base is not None:
        # A base-frame torque enters the euler rows as W' tau.
        tau = tau + torch.as_tensor(external_torque_base, dtype=z.dtype, device=z.device)
    rhs = torch.cat([rhs_p, _matvec(w_mat.transpose(-1, -2), tau)], dim=-1)
    eye6 = torch.eye(6, dtype=z.dtype, device=z.device)
    return solve_psd_small(m66 + 1e-9 * eye6, rhs), w_mat, w_dot


def base_acceleration(
    z: Tensor,
    zdot: Tensor,
    forces: Tensor,
    masses: MassModel = DEFAULT_MASSES,
    external_force_world=None,
    external_torque_base=None,
) -> Tensor:
    """zdd_base [..., 6]: [p_base'' (world), euler''] from the top 6 rows of the
    rigid-body dynamics with ddq = 0."""
    return _base_dynamics(z, zdot, forces, masses, external_force_world,
                          external_torque_base)[0]


def _state_to_z(x: Tensor):
    """State -> (z, w_body, euler rates); x[3:6] stores INERTIA * w_body / MASS."""
    k = model._constants(x.device, x.dtype)
    euler = base_euler(x)
    w_body = MASS * x[..., 3:6] / k.inertia
    deuler = _matvec(euler_zyx_rate_matrix(euler), w_body)
    z = torch.cat([base_position(x), euler, joint_angles(x)], dim=-1)
    return z, w_body, deuler


def dynamics(t, x, u, p, masses: MassModel = DEFAULT_MASSES):
    """ComKino flow map on the 24/24 centroidal layout.

    Optional disturbance parameters (the reference's ComKinoDynamicsParameters):
      p["external_force_world"]  [3] N   applied at the base origin,
      p["external_torque_base"]  [3] Nm  in the base frame.
    """
    del t
    k = model._constants(x.device, x.dtype)
    z, _, deuler = _state_to_z(x)
    dq = joint_velocities(u)
    zdot = torch.cat([x[..., 0:3], deuler, dq], dim=-1)
    ext = p if isinstance(p, dict) else {}
    zdd, w_mat, w_dot = _base_dynamics(
        z, zdot, contact_forces(u), masses, ext.get("external_force_world"),
        ext.get("external_torque_base"))
    # d/dt (I w_body / m) with w_body = W(euler) euler'.
    dw_body = w_dot + _matvec(w_mat, zdd[..., 3:6])
    return torch.cat([zdd[..., 0:3], k.inertia * dw_body / MASS, x[..., 0:3], deuler, dq],
                     dim=-1)


def mass_matrix(x: Tensor, masses: MassModel = DEFAULT_MASSES) -> Tensor:
    """The full generalized mass matrix M(z) [..., 18, 18]: sum m_i J_i' J_i
    plus W' I_b W, with the link Jacobians J_i the link velocities of the 18
    unit generalized velocities."""
    z, _, _ = _state_to_z(x)
    ib, m = _mass_constants(masses, x.device, x.dtype)
    eye = torch.eye(NZ, dtype=x.dtype, device=x.device)
    jac = _link_velocities(z[..., None, :], eye)  # [..., 18, 13, 3]
    w = _omega_body(z[..., None, 3:6], eye[:, 3:6])  # [..., 18, 3]
    return (torch.einsum("...bia,...cia,i->...bc", jac, jac, m)
            + torch.einsum("...ba,...ca,a->...bc", w, w, ib))
