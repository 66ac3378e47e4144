"""Legged-robot problem assembly: base-tracking cost, friction cone,
zero-force and zero/normal-velocity constraints, swing references, and the
gait-synchronized reference manager of the MPC runtime.

Counterpart of ``ocs2_tpu/models/legged_robot/interface.py``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ...core import penalties as pen
from ...core.reference import TargetTrajectories
from ...mpc.mpc import ReferenceManager
from ...oc.problem import (
    OptimalControlProblem,
    quadratic_cost,
    quadratic_final_cost,
    soft_constraint,
)
from ...oc.time_discretization import TimeGrid
from . import constraints as con
from . import model
from .gait import GAIT_MAP, GaitSchedule
from .lq_kernel import SrbdLqKernel
from .swing import plan_swing_references

# Base-tracking weights.
Q_DIAG = np.concatenate(
    [
        np.array([15.0, 15.0, 30.0]),  # com velocity
        np.array([5.0, 10.0, 10.0]),  # normalized angular momentum
        np.array([500.0, 500.0, 500.0]),  # base position
        np.array([100.0, 200.0, 200.0]),  # base orientation (z, y, x)
        np.full((12,), 20.0),  # joint angles
    ]
).astype(np.float32)


# R(12:24) = 5000*1e-3 weights FOOT velocity relative to the base, mapped to
# joint velocities through the base-to-feet Jacobian at the nominal
# configuration: R_qdot = J^T R_task J.  A direct 5.0 on joint velocities
# over-penalizes leg swing ~25x and freezes the gait.
def _foot_jacobian_np(leg: int, q_leg: np.ndarray) -> np.ndarray:
    """d foot_position_base / d (haa, hfe, kfe) in numpy (host-side weight
    construction); mirrors model.foot_position_base analytically."""
    haa, hfe, kfe = float(q_leg[0]), float(q_leg[1]), float(q_leg[2])
    lt, ls = model.THIGH_LENGTH, model.SHANK_LENGTH
    side = model.leg_side_sign(leg)
    # Sagittal-plane position and its derivatives wrt hfe/kfe.
    x_p = -lt * np.sin(hfe) - ls * np.sin(hfe + kfe)
    z_p = -lt * np.cos(hfe) - ls * np.cos(hfe + kfe)
    dx_dhfe = -lt * np.cos(hfe) - ls * np.cos(hfe + kfe)
    dx_dkfe = -ls * np.cos(hfe + kfe)
    dz_dhfe = lt * np.sin(hfe) + ls * np.sin(hfe + kfe)
    dz_dkfe = ls * np.sin(hfe + kfe)
    p = np.array([x_p, side * model.HIP_LATERAL, z_p])
    dp_dhfe = np.array([dx_dhfe, 0.0, dz_dhfe])
    dp_dkfe = np.array([dx_dkfe, 0.0, dz_dkfe])
    c, s = np.cos(haa), np.sin(haa)
    rx = np.array([[1.0, 0, 0], [0, c, -s], [0, s, c]])
    drx = np.array([[0.0, 0, 0], [0, -s, -c], [0, c, -s]])
    jac = np.stack([drx @ p, rx @ dp_dhfe, rx @ dp_dkfe], axis=1)
    return jac.astype(np.float32)


def _input_cost_weight() -> np.ndarray:
    q_nom = model.DEFAULT_JOINTS.reshape(model.NUM_LEGS, 3)
    r = np.zeros((model.NU, model.NU), np.float32)
    r[:12, :12] = np.diag(np.full((12,), 1e-3, np.float32))  # contact forces
    r_task = 5000.0 * 1e-3  # foot-velocity weight
    for leg in range(model.NUM_LEGS):
        jac = _foot_jacobian_np(leg, q_nom[leg])
        block = r_task * (jac.T @ jac)
        s = slice(12 + 3 * leg, 12 + 3 * (leg + 1))
        r[s, s] = block
    return r


R_MAT = _input_cost_weight()

# 50*sum(g^2) as a structured Gauss-Newton quadratic-penalty term.
_swing_velocity_soft = soft_constraint(con.swing_normal_velocity, pen.quadratic(100.0))


def select_dynamics(model_type: str):
    """The flow map of ``model_type``: "srbd" (``model.dynamics``), "full"
    (``centroidal.dynamics_full``) or "comkino" (``comkino.dynamics``, the
    full kinodynamic model)."""
    if model_type == "full":
        from .centroidal import dynamics_full

        return dynamics_full
    if model_type == "comkino":
        from .comkino import dynamics

        return dynamics
    if model_type != "srbd":
        raise ValueError(f"model_type={model_type!r}: 'srbd', 'full' or 'comkino'")
    return model.dynamics


def make_problem(
    # "soft" (relaxed barrier cost) | "hard" (an inequality: augmented
    # Lagrangian under SQP, the native barrier under IPM)
    friction_cone: str = "soft",
    project_foot_constraint: bool = True,
    model_type: str = "srbd",  # "srbd" | "full" | "comkino"
    device="cuda",
) -> OptimalControlProblem:
    problem = OptimalControlProblem(
        dynamics=select_dynamics(model_type),
        cost_terms=(quadratic_cost(np.diag(Q_DIAG), R_MAT, device=device),),
        final_cost_terms=(
            quadratic_final_cost(10.0 * np.diag(Q_DIAG[:24]), device=device),
        ),
        equality_terms=(con.foot_constraint, con.swing_normal_velocity)
        if not project_foot_constraint
        else (con.foot_constraint,),
        state_cost_terms=(con.swing_height_tracking,),
        nx=model.NX,
        nu=model.NU,
    )
    if project_foot_constraint:
        # Swing vertical-velocity tracking via AL would put a rank-deficient
        # row into the projection; keep it as a soft cost companion to the
        # height tracking.
        problem = problem.add(cost_terms=(_swing_velocity_soft,))
    if friction_cone == "soft":
        problem = problem.add(cost_terms=(con.make_friction_cone_soft(),))
    else:
        problem = problem.add(inequality_terms=(con.friction_cone,))
    if model_type == "srbd" and project_foot_constraint:
        # K10 computes this problem's whole LQ approximation on the card, in
        # the variant of its friction cone.
        problem = dataclasses.replace(problem, lq_kernel=SrbdLqKernel(problem))
    return problem


def default_target(x0=None, device="cuda") -> TargetTrajectories:
    x_target = model.default_state(device) if x0 is None else x0
    u_target = model.weight_compensating_input(np.ones(4, np.float32), device)
    return TargetTrajectories.constant(x_target, u_target, device=device)


def make_params(
    grid: TimeGrid,
    target: Optional[TargetTrajectories] = None,
    swing_height: float = 0.08,
    device="cuda",
) -> dict:
    """Build the params dict for a given discretization (swing references
    are per-node arrays aligned with the grid), every leaf on ``device``."""
    swing = plan_swing_references(
        np.asarray(grid.times), np.asarray(grid.modes), swing_height
    )
    return {
        "target": target or default_target(device=device),
        "swing_vz": torch.as_tensor(swing.vz, device=device),
        "swing_z": torch.as_tensor(swing.z, device=device),
        "fz_max": torch.tensor(500.0, dtype=torch.float32, device=device),
    }


class SwitchedModelReferenceManager(ReferenceManager):
    """Injects the gait's ModeSchedule and the swing references before every
    solve: ``pre_solver_run`` takes the schedule of [t0, tf] from the gait,
    ``augment_params`` plans the swing references on the tick's concrete
    grid (numpy on the host) and puts them on the device of the params'
    target, which is the Mpc's."""

    def __init__(
        self,
        gait_schedule: GaitSchedule,
        target: Optional[TargetTrajectories] = None,
        swing_height: float = 0.08,
        device="cuda",
    ):
        super().__init__(target or default_target(device=device))
        self.gait_schedule = gait_schedule
        self.swing_height = swing_height

    def set_gait(self, name_or_template) -> None:
        tpl = (
            GAIT_MAP[name_or_template]()
            if isinstance(name_or_template, str)
            else name_or_template
        )
        self.gait_schedule.set_template(tpl)

    def pre_solver_run(self, t0: float, tf: float, x0) -> None:
        super().pre_solver_run(t0, tf, x0)
        self._mode_schedule = self.gait_schedule.mode_schedule(t0, tf)

    def augment_params(self, grid: TimeGrid, params: dict) -> dict:
        swing = plan_swing_references(
            np.asarray(grid.times), np.asarray(grid.modes), self.swing_height
        )
        dev = params["target"].times.device
        return dict(
            params,
            swing_vz=torch.as_tensor(swing.vz, device=dev),
            swing_z=torch.as_tensor(swing.z, device=dev),
        )
