"""Soft-contact quadruped plant: spring-damper ground, Coulomb friction and
joint-servo force transmission, as a rollout backend of the MRT.

Counterpart of ``ocs2_tpu/models/legged_robot/contact_plant.py`` (the
reference's RaiSim rollout backend): a plant whose ground reactions come
from foot penetration and slip, not from the MPC's commanded input.

Model: the SRBD base and velocity-controlled legs of ``model.dynamics``,
with two plant-side effects the MPC model does not have:

1. Ground: per-foot Kelvin-Voigt normal contact and viscous tangential
   friction inside a Coulomb cone, f_n = kp d - kd v_z (d the penetration),
   f_t = -kt v_t, |f_t| <= mu f_n.
2. Joint-servo admittance: the leg drive realizes the commanded force
   u[:12] by pressing the foot against the ground with finite admittance,
   v_extra = -M (f_cmd - f_plant), M = R J J' R' / b_servo.

The force and the servo velocity are coupled; the force is solved
implicitly per foot, f = (I + K M)^{-1} (f_raw(v_cmd) + K M f_cmd) with
K = diag(kt, kt, kd) (the closed-form 3x3 inverse, all four feet at once),
then the gate, f_z >= 0 and the Coulomb cap are applied.  The reference
maps its per-leg function over the legs; here the legs are the [..., 4]
axis of one batched evaluation.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from . import model

Tensor = torch.Tensor


class ContactParams(NamedTuple):
    """Ground and servo constants (RaiSim-like for a 30 kg quadruped)."""

    kp: float = 4.0e4  # normal stiffness [N/m] -> ~2 mm static penetration
    kd: float = 2.0e3  # normal damping [N s/m]
    kt: float = 2.0e3  # tangential viscous friction [N s/m]
    mu: float = 0.7  # Coulomb friction coefficient
    b_servo: float = 25.0  # joint-servo viscous coefficient [N m s / rad]


def _leg_jacobians(x: Tensor) -> Tensor:
    """[..., 4, 3, 3] world-frame foot Jacobians d p_foot_world / d q_leg: the
    closed-form leg Jacobian of ``model`` applied to the unit joint rates."""
    k = model._constants(x.device, x.dtype)
    r_wb = model.euler_zyx_rotation(model.base_euler(x))
    q = model._per_leg(model.joint_angles(x))
    eye = torch.eye(3, dtype=x.dtype, device=x.device)
    cols = model._feet_velocity_base(q[..., None, :], eye, k.lateral[:, None, :])  # [.., 4, j, a]
    return r_wb[..., None, :, :] @ cols.transpose(-1, -2)


def _solve3(a: Tensor, b: Tensor) -> Tensor:
    """a^{-1} b for a [..., 3, 3] and b [..., 3] by the adjugate."""
    c0 = torch.linalg.cross(a[..., 1, :], a[..., 2, :], dim=-1)
    c1 = torch.linalg.cross(a[..., 2, :], a[..., 0, :], dim=-1)
    c2 = torch.linalg.cross(a[..., 0, :], a[..., 1, :], dim=-1)
    det = torch.sum(a[..., 0, :] * c0, dim=-1, keepdim=True)
    adj_t = torch.stack([c0, c1, c2], dim=-1)  # adj(a) = [c0 c1 c2] as columns
    return (adj_t @ b[..., None])[..., 0] / det


def plant_forces(x: Tensor, u: Tensor, height_at: Callable[[Tensor], Tensor],
                 cp: ContactParams = ContactParams()):
    """Implicit ground-reaction solve for x [..., 24], u [..., 24];
    ``height_at(xy [..., 2]) -> [...]`` is the ground.

    Returns (forces [..., 4, 3] world, dq_extra [..., 12] servo joint velocities)."""
    feet = model.foot_positions_world(x)
    v_cmd = model.foot_velocities_world(x, u)
    jacs = _leg_jacobians(x)
    f_cmd = model.contact_forces(u)
    pen = height_at(feet[..., :2]) - feet[..., 2]
    in_contact = (pen > 0.0)[..., None]

    k_diag = torch.tensor([cp.kt, cp.kt, cp.kd], dtype=x.dtype, device=x.device)
    m = jacs @ jacs.transpose(-1, -2) / cp.b_servo  # PSD servo admittance (world)
    km = k_diag[:, None] * m
    f_raw = torch.cat([-cp.kt * v_cmd[..., 0:2], cp.kp * pen[..., None] - cp.kd * v_cmd[..., 2:3]],
                      dim=-1)
    a = torch.eye(3, dtype=x.dtype, device=x.device) + km
    f = _solve3(a, f_raw + (km @ f_cmd[..., None])[..., 0])
    # Clamps: normal force nonnegative, Coulomb cone.
    f_n = torch.clamp(f[..., 2:3], min=0.0)
    f_t = f[..., 0:2]
    f_t_norm = torch.linalg.vector_norm(f_t, dim=-1, keepdim=True)
    f_t = f_t * torch.clamp(cp.mu * f_n / torch.clamp(f_t_norm, min=1e-9), max=1.0)
    forces = torch.where(in_contact, torch.cat([f_t, f_n], dim=-1), torch.zeros_like(f))
    # Servo joint motion realizing the force error: -J' (f_cmd - f) / b.
    df = f_cmd - forces
    dq_extra = -(jacs.transpose(-1, -2) @ df[..., None])[..., 0] / cp.b_servo
    return forces, dq_extra.flatten(-2, -1)


def contact_forces_from_state(x: Tensor, u: Tensor, height_at: Callable[[Tensor], Tensor],
                              cp: ContactParams = ContactParams()) -> Tensor:
    """[..., 4, 3] world-frame ground-reaction forces."""
    return plant_forces(x, u, height_at, cp)[0]


def _flat_ground(xy: Tensor) -> Tensor:
    return torch.zeros_like(xy[..., 0])


def make_soft_contact_dynamics(height_at: Optional[Callable[[Tensor], Tensor]] = None,
                               cp: ContactParams = ContactParams()) -> Callable:
    """Plant flow map ``(t, x, u, params) -> dx`` for ``ExternalSimRollout``.
    ``height_at(xy [..., 2]) -> z [...]`` is the ground (default flat z = 0;
    ``ElevationMap.height_at`` for terrain)."""
    h_fn = height_at or _flat_ground

    def dynamics(t, x, u, p):
        del p
        forces, dq_extra = plant_forces(x, u, h_fn, cp)
        dq = model.joint_velocities(u) + dq_extra
        # The SRBD bookkeeping of model.dynamics with the plant's forces.
        return model.dynamics(t, x, torch.cat([forces.flatten(-2, -1), dq], dim=-1), None)

    return dynamics


def make_contact_rollout(height_at: Optional[Callable[[Tensor], Tensor]] = None,
                         cp: ContactParams = ContactParams(), substeps: int = 8):
    """``ExternalSimRollout`` over the soft-contact plant.  The stiff ground
    needs small RK4 steps: 8 substeps at a 100 Hz control period are 1.25 ms,
    inside the RK4 stability region of the tangential damping 4 kt / m."""
    from ...mpc.mrt import ExternalSimRollout

    return ExternalSimRollout(make_soft_contact_dynamics(height_at, cp), method="rk4",
                              substeps=substeps)
