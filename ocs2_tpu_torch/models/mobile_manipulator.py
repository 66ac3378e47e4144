"""Mobile manipulator: kinematic MPC with end-effector pose tracking, joint
and velocity limits, sphere self-collision and an optional workspace-SDF
clearance.

Counterpart of ``ocs2_tpu/models/mobile_manipulator.py`` (the reference's
ocs2_mobile_manipulator: a velocity-controlled wheeled base and arm, the
EndEffectorCost of position and orientation error, joint limits, the sphere
self-collision of ocs2_self_collision, and the perceptive
EndEffectorDistanceConstraint), plus the URDF arms on the reference's four
base types.

Built-in arm: x = [base_x, base_y, base_yaw, q_arm (6)] (nx = 9),
u = [v_forward, omega_yaw, dq_arm (6)] (nu = 8).

Every term is batch-polymorphic (``x [..., nx]``, width-1 slices) and reads
its constant tensors from a per-device cache, so one problem runs wherever
its inputs live.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..core import penalties as pen
from ..oc.problem import OptimalControlProblem, soft_constraint
from .collision import SphereModel, self_collision_constraint
from .kinematics import Chain, Joint, rot_axis, rotation_error

Tensor = torch.Tensor

NX = 9
NU = 8

ARM = Chain(
    joints=(
        Joint(offset=(0.2, 0.0, 0.6), axis="z"),  # shoulder pan (on base)
        Joint(offset=(0.0, 0.0, 0.1), axis="y"),  # shoulder lift
        Joint(offset=(0.0, 0.0, 0.35), axis="y"),  # elbow
        Joint(offset=(0.0, 0.0, 0.30), axis="z"),  # wrist roll
        Joint(offset=(0.0, 0.0, 0.08), axis="y"),  # wrist pitch
        Joint(offset=(0.0, 0.0, 0.06), axis="z"),  # wrist yaw
    ),
    ee_offset=(0.0, 0.0, 0.10),
)

JOINT_LOWER = np.array([-2.9, -1.8, -2.9, -2.9, -1.8, -2.9], np.float32)
JOINT_UPPER = -JOINT_LOWER
VEL_LIMIT = np.array([0.5, 0.8, 1.5, 1.5, 1.5, 2.0, 2.0, 2.0], np.float32)  # [v, w, dq..]

# Sphere decomposition for self-collision: base body against forearm, wrist
# and EE (the reference decomposes link geometry into spheres; the monitored
# pairs mirror its collision-pair list).  Frames of ARM.frame_poses: 0 = the
# base footprint (identity rotation at the arm mount), 1..6 after each arm
# joint, 7 = EE.
SPHERE_SPECS = (
    (0, (0.0, 0.0, 0.25), 0.28),   # base body
    (0, (0.25, 0.0, 0.45), 0.12),  # base top front
    (3, (0.0, 0.0, 0.15), 0.07),   # forearm (after elbow)
    (5, (0.0, 0.0, 0.05), 0.06),   # wrist
    (7, (0.0, 0.0, 0.02), 0.05),   # end effector
)
SPHERE_PAIR_FRAMES = ((0, 3), (0, 5), (0, 7))
SELF_COLLISION_MIN_DISTANCE = 0.02


@functools.lru_cache(maxsize=None)
def _tensor(values: tuple, device: torch.device, dtype: torch.dtype) -> Tensor:
    return torch.tensor(values, dtype=dtype, device=device)


def _const(values: np.ndarray, like: Tensor) -> Tensor:
    return _tensor(tuple(float(v) for v in values), like.device, like.dtype)


@functools.lru_cache(maxsize=None)
def _spheres(device: torch.device) -> SphereModel:
    return SphereModel.create(SPHERE_SPECS, SPHERE_PAIR_FRAMES, device=device)


def spheres(device="cuda") -> SphereModel:
    """The built-in arm's sphere model on ``device``."""
    return _spheres(torch.device(device))


def _planar_base(x: Tensor):
    """(base_rot, base_pos) of a wheeled base [x, y, yaw, ...]."""
    base_pos = torch.cat([x[..., 0:2], torch.zeros_like(x[..., 0:1])], dim=-1)
    return rot_axis(2, x[..., 2:3]), base_pos


def ee_pose(x: Tensor):
    """End-effector position [..., 3] and rotation [..., 3, 3] in the world
    frame."""
    base_rot, base_pos = _planar_base(x)
    return ARM.forward(x[..., 3:9], base_rot=base_rot, base_pos=base_pos)


def _wheeled_flow(x: Tensor, u: Tensor) -> Tensor:
    yaw, v = x[..., 2:3], u[..., 0:1]
    return torch.cat([v * torch.cos(yaw), v * torch.sin(yaw), u[..., 1:]], dim=-1)


def dynamics(t, x, u, p):
    del t, p
    return _wheeled_flow(x, u)


def _has_param(p, key: str) -> bool:
    return isinstance(p, dict) and (key in p or key in p.get("scenario", {}))


def scenario_param(p, key: str, like: Tensor) -> Tensor:
    """params[key], shared by the scenarios, or params["scenario"][key], one
    row per scenario (``oc/approx.PER_SCENARIO_KEYS``): [B, ...] in a batched
    evaluation, reshaped to broadcast against ``like`` [B, ..., d]; one row
    under the LQ approximation's map."""
    if key in p:
        return p[key]
    v = p["scenario"][key]
    extra = like.ndim - v.ndim
    return v if extra <= 0 else v.reshape(v.shape[:1] + (1,) * extra + v.shape[1:])


def _pose_cost(pos: Tensor, rot: Tensor, p) -> Tensor:
    """50 |pos - target|^2, plus 30 |orientation error|^2 when params hold
    'ee_target_rot' (the reference's EndEffectorCost)."""
    err = pos - scenario_param(p, "ee_target", pos)
    c = 50.0 * torch.sum(err * err, dim=-1)
    if _has_param(p, "ee_target_rot"):
        rot_err = rotation_error(rot, scenario_param(p, "ee_target_rot", rot))
        c = c + 30.0 * torch.sum(rot_err * rot_err, dim=-1)
    return c


def ee_tracking_cost(t, x, u, p):
    """End-effector pose tracking to params['ee_target'] (and
    'ee_target_rot' when present)."""
    del t, u
    return _pose_cost(*ee_pose(x), p)


def ee_final_cost(t, x, p):
    """Terminal EE pose cost (the reference's `finalEndEffector`): anchors the
    end of the horizon on the target."""
    del t
    return _pose_cost(*ee_pose(x), p)


def input_cost(t, x, u, p):
    del t, x, p
    scaled = u / _const(VEL_LIMIT, u)
    return 0.5 * torch.sum(scaled * scaled, dim=-1)


def joint_limits(t, x, p):
    """h >= 0 joint position box (the reference's JointLimits)."""
    del t, p
    q = x[..., 3:9]
    return torch.cat([q - _const(JOINT_LOWER, q), _const(JOINT_UPPER, q) - q], dim=-1)


def velocity_limits(t, x, u, p):
    del t, x, p
    vmax = _const(VEL_LIMIT, u)
    return torch.cat([u + vmax, vmax - u], dim=-1)


def arm_frame_poses(x: Tensor):
    base_rot, base_pos = _planar_base(x)
    return ARM.frame_poses(x[..., 3:9], base_rot=base_rot, base_pos=base_pos)


def self_collision(t, x, p):
    """Sphere-pair distances minus SELF_COLLISION_MIN_DISTANCE, [..., P]
    (>= 0 when separated); the sphere model of ``x``'s device."""
    return self_collision_constraint(
        _spheres(x.device), arm_frame_poses, min_distance=SELF_COLLISION_MIN_DISTANCE
    )(t, x, p)


def _relaxed_barrier():
    return pen.relaxed_barrier(mu=1e-2, delta=1e-3)


def make_problem(
    constraint_mode: str = "soft",
    self_collision_avoidance: bool = True,
    workspace_sdf=None,
    sdf_clearance: float = 0.0,
) -> OptimalControlProblem:
    """The manipulator OCP (the reference's MobileManipulatorInterface): EE
    pose tracking and an input cost, joint and velocity limits, sphere
    self-collision, and optionally an EE workspace-clearance constraint
    against a ``perceptive.SignedDistanceField`` on the solver's device.
    Its terms take their constants from the device of their inputs."""
    base = OptimalControlProblem(
        dynamics=dynamics,
        cost_terms=(ee_tracking_cost, input_cost),
        final_cost_terms=(ee_final_cost,),
        nx=NX,
        nu=NU,
    )
    state_ineq = []
    if self_collision_avoidance:
        state_ineq.append(self_collision)
    if workspace_sdf is not None:
        from .perceptive import ee_distance_constraint

        state_ineq.append(
            ee_distance_constraint(
                workspace_sdf,
                lambda x: ee_pose(x)[0].unsqueeze(-2),
                clearance=sdf_clearance,
            )
        )
    if constraint_mode == "soft":
        barrier = _relaxed_barrier()
        state_soft = tuple(
            soft_constraint(g, barrier, with_input=False)
            for g in [joint_limits] + state_ineq
        )
        return base.add(
            cost_terms=(soft_constraint(velocity_limits, barrier),),
            state_cost_terms=state_soft,
            # Running soft constraints carry only ~dt/2 weight at the last
            # node; applying them again in the final cost keeps the terminal
            # EE from trading clearance against the final pose cost.
            final_cost_terms=state_soft,
        )
    if constraint_mode == "hard":
        return base.add(
            inequality_terms=(velocity_limits,),
            state_inequality_terms=tuple([joint_limits] + state_ineq),
        )
    return base


def _arm_terms(chain: Chain, ee, lower, upper, vmax, velocity_weight, arm_q):
    """Cost and constraint terms of a URDF arm; ``ee(x)`` gives (pos, rot)."""

    def ee_cost(t, x, u, p):
        del t, u
        return _pose_cost(*ee(x), p)

    def ee_final(t, x, p):
        del t
        return _pose_cost(*ee(x), p)

    def in_cost(t, x, u, p):
        del t, x, p
        scaled = u / _const(vmax, u)
        return velocity_weight * torch.sum(scaled * scaled, dim=-1)

    def q_limits(t, x, p):
        del t, p
        q = arm_q(x)
        return torch.cat([q - _const(lower, q), _const(upper, q) - q], dim=-1)

    def dq_limits(t, x, u, p):
        del t, x, p
        v = _const(vmax, u)
        return torch.cat([u + v, v - u], dim=-1)

    barrier = _relaxed_barrier()
    finite_q = np.all(np.isfinite(lower)) and np.all(np.isfinite(upper))
    state_soft = (
        (soft_constraint(q_limits, barrier, with_input=False),) if finite_q else ()
    )
    return dict(
        cost_terms=(ee_cost, in_cost, soft_constraint(dq_limits, barrier)),
        state_cost_terms=state_soft,
        final_cost_terms=(ee_final,) + state_soft,
    )


def _arm_limits(loaded):
    lower = np.asarray(loaded.lower, np.float32)
    upper = np.asarray(loaded.upper, np.float32)
    vmax = np.asarray(np.minimum(loaded.velocity, 1e3), np.float32)  # cap inf limits
    return lower, upper, vmax


def make_urdf_arm_problem(loaded, velocity_weight: float = 0.5) -> OptimalControlProblem:
    """Kinematic MPC of a fixed-base URDF arm (the reference's default
    manipulator model): x = q [dof], u = dq [dof], the EE pose tracked to
    params['ee_target'] (and 'ee_target_rot') through the chain's forward
    kinematics.  ``loaded`` is a ``models.urdf.LoadedChain``."""
    chain = loaded.chain
    dof = chain.num_dof
    lower, upper, vmax = _arm_limits(loaded)

    def dyn(t, x, u, p):
        del t, x, p
        return u

    return OptimalControlProblem(
        dynamics=dyn,
        nx=dof,
        nu=dof,
        **_arm_terms(chain, chain.forward, lower, upper, vmax, velocity_weight,
                     lambda x: x),
    )


# ---------------------------------------------------------------------------
# Base-type variants over URDF arms (the reference's ManipulatorModelType:
# Default, WheelBased, FloatingArm, FullyActuatedFloatingArm dynamics).
# ---------------------------------------------------------------------------

BASE_TYPES = (
    "default",
    "wheel_based",
    "floating_arm",
    "fully_actuated_floating_arm",
)


def _base_dims(base_type: str, dof: int):
    """(num base states, num base inputs, nx, nu) per variant."""
    if base_type == "default":
        return 0, 0, dof, dof
    if base_type == "wheel_based":
        return 3, 2, 3 + dof, 2 + dof
    if base_type == "floating_arm":
        # A 6-DOF base pose in the state, unactuated (a static platform whose
        # pose is part of the optimization state but has zero flow).
        return 6, 0, 6 + dof, dof
    if base_type == "fully_actuated_floating_arm":
        # A 6-DOF base pose, velocity-actuated (dxdt = input).
        return 6, 6, 6 + dof, 6 + dof
    raise ValueError(f"unknown base_type {base_type!r}; one of {BASE_TYPES}")


def floating_base_rotation(x: Tensor) -> Tensor:
    """Rz(yaw) Ry(pitch) Rx(roll) of a floating base x[..., 3:6] = euler zyx."""
    return (rot_axis(2, x[..., 3:4]) @ rot_axis(1, x[..., 4:5])) @ rot_axis(0, x[..., 5:6])


def variant_ee_pose(chain: Chain, base_type: str, x: Tensor):
    """World EE position [..., 3] and rotation [..., 3, 3] of an arm on a base
    variant, from its state x [..., nx] (the layouts of
    ``make_urdf_manipulator_problem``)."""
    if base_type == "default":
        return chain.forward(x)
    nb = _base_dims(base_type, chain.num_dof)[0]
    if base_type == "wheel_based":
        rot, pos = _planar_base(x)
    else:
        rot, pos = floating_base_rotation(x), x[..., 0:3]
    return chain.forward(x[..., nb:], base_rot=rot, base_pos=pos)


def make_urdf_manipulator_problem(
    loaded,
    base_type: str = "default",
    velocity_weight: float = 0.5,
    base_velocity_limit: float = 0.5,
) -> OptimalControlProblem:
    """Kinematic EE-tracking MPC of a URDF arm on any of the reference's four
    base types.

    State / input layouts (arm dof = d):
      default:                     x = q[d],                       u = dq[d]
      wheel_based:                 x = [xy, yaw, q],               u = [v, w, dq]
      floating_arm:                x = [pos(3), euler_zyx(3), q],  u = dq
      fully_actuated_floating_arm: x = [pos(3), euler_zyx(3), q],
                                   u = [v_base(3), w_euler_rates(3), dq]
    """
    chain = loaded.chain
    dof = chain.num_dof
    nb, _, nx, nu = _base_dims(base_type, dof)
    lower, upper, vmax_arm = _arm_limits(loaded)
    if base_type == "wheel_based":
        vmax = np.concatenate([np.array([base_velocity_limit, 1.0], np.float32), vmax_arm])
    elif base_type == "fully_actuated_floating_arm":
        vmax = np.concatenate([np.full(6, base_velocity_limit, np.float32), vmax_arm])
    else:
        vmax = vmax_arm

    def arm_q(x):
        return x[..., nb:]

    def ee(x):
        return variant_ee_pose(chain, base_type, x)

    def dyn(t, x, u, p):
        del t, p
        if base_type == "wheel_based":
            return _wheeled_flow(x, u)
        if base_type == "floating_arm":
            return torch.cat([torch.zeros_like(x[..., :6]), u], dim=-1)
        return u  # default and fully actuated: dxdt = input

    return OptimalControlProblem(
        dynamics=dyn,
        nx=nx,
        nu=nu,
        **_arm_terms(chain, ee, lower, upper, vmax, velocity_weight, arm_q),
    )


def variant_home_state(loaded, base_type: str, base_pose=None, q_home=None, device="cuda"):
    """Home state of a base variant; base_pose = [pos(3), euler_zyx(3)] for
    the floating variants.  ``q_home`` overrides the default joint home (the
    limits' midpoints): pass a non-singular configuration for arms whose
    midpoint is a kinematic singularity (e.g. a fully stretched UR5)."""
    dof = loaded.chain.num_dof
    nb, _, _, _ = _base_dims(base_type, dof)
    if q_home is None:
        q_home = np.where(
            np.isfinite(loaded.lower) & np.isfinite(loaded.upper),
            0.5 * (np.asarray(loaded.lower) + np.asarray(loaded.upper)),
            0.0,
        )
    base = np.zeros(nb, np.float32)
    if base_pose is not None and nb == 6:
        base = np.asarray(base_pose, np.float32)
    x = np.concatenate([base, np.asarray(q_home, np.float32)])
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def make_params(ee_target=(1.0, 0.5, 0.8), ee_target_rot=None, device="cuda"):
    """Params of one EE target (and rotation) for every scenario; an
    ``ee_target`` of shape [B, 3] (``ee_target_rot`` [B, 3, 3]) gives each
    scenario of a batched solve its own, under params["scenario"]."""
    target = torch.as_tensor(np.asarray(ee_target, np.float32), device=device)
    p = {"ee_target": target}
    if ee_target_rot is not None:
        p["ee_target_rot"] = torch.as_tensor(np.asarray(ee_target_rot, np.float32), device=device)
    return p if target.ndim == 1 else {"scenario": p}


def home_state(device="cuda"):
    return torch.tensor([0.0, 0.0, 0.0, 0.0, -0.5, 1.0, 0.0, 0.5, 0.0],
                        dtype=torch.float32, device=device)
