"""Frequency-shaped (loopshaping) legged MPC.

Counterpart of ``ocs2_tpu/models/legged_robot/loopshaping_mpc.py`` (the
reference's loopshaped quadruped, ocs2_anymal_loopshaping_mpc +
ocs2_quadruped_loopshaping_interface): the switched legged problem is
augmented with one input filter per channel, so that high-frequency content
in the contact forces and joint velocities is penalized.

Shaping transfer, as the shipped loopshaping.info
(ocs2_anymal_loopshaping_mpc/config/c_series/loopshaping.info):
* force channels (12):          s_inv(s) = 4 * s / (s + 100)
* joint-velocity channels (12): s_inv(s) = 3 * s / (s + 50)

Composition route: the reference's outputpattern (r_filter,
``oc/loopshaping.wrap_problem_r_filter``).  The plant input u stays the
decision variable, filter states low-pass it (xi' = p (u - xi)) and the
shaping cost lands on the filtered output

    y = g (u - xi)  =  [g s / (s + p)] u  =  s_inv(s) u.

Because u is untouched, the 12-row foot constraint keeps its full-rank
u-Jacobian and is projected as in the unshaped problem: the augmented state
is nx = 24 + 24 = 48 and the projected input nu = 12, the backward sweep's
(48, 12).

The filter pole (p = 100) makes the augmented dynamics stiff: |lambda| dt
must stay inside the integrator's stability region, hence RK2 with 2
substeps at dt = 0.025 (``make_solver_settings``).
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ...oc.loopshaping import LoopshapingDefinition, wrap_problem_r_filter
from ...oc.problem import OptimalControlProblem
from ...solvers import sqp
from . import model
from .gait import contact_flags_static
from .interface import make_problem

Tensor = torch.Tensor


def anymal_loopshaping_definition(
    force_pole: float = 100.0,
    force_gain: float = 4.0,
    velocity_pole: float = 50.0,
    velocity_gain: float = 3.0,
    shaping_weight: float = 1e-2,
    dtype=torch.float32,
    device="cuda",
) -> LoopshapingDefinition:
    """r_filter realization of y = s_inv(s) u per channel:
    xi' = -p xi + p u (low-pass state), y = g (u - xi).

    ``shaping_weight`` balances the filtered-output penalty against the task
    weights (the JAX package's measurement on the trot task: w = 1e-2 cuts
    the shaping functional |y|^2 by about 18 % against the unshaped solve
    while the base height stays within 5 cm)."""
    poles = np.concatenate([np.full(12, force_pole), np.full(12, velocity_pole)])
    gains = np.concatenate([np.full(12, force_gain), np.full(12, velocity_gain)])

    def t(m):
        return torch.as_tensor(m, dtype=dtype, device=device)

    return LoopshapingDefinition(
        A=t(np.diag(-poles)),
        B=t(np.diag(poles)),
        C=t(np.diag(-gains)),
        D=t(np.diag(gains)),
        R_v=shaping_weight * torch.eye(24, dtype=dtype, device=device),
    )


def make_loopshaping_problem(
    defn: Optional[LoopshapingDefinition] = None,
    device="cuda",
    **problem_kwargs,
) -> Tuple[OptimalControlProblem, LoopshapingDefinition]:
    """The loopshaped legged problem (AnymalLoopshapingInterface analogue):
    (augmented problem, definition); augmented state [x (24), xi (24)], input
    the plant input u (24) (outputpattern).  ``problem_kwargs`` go to
    ``interface.make_problem``."""
    defn = defn if defn is not None else anymal_loopshaping_definition(device=device)
    problem = make_problem(device=device, **problem_kwargs)
    return wrap_problem_r_filter(problem, defn), defn


def make_solver_settings(**overrides) -> sqp.SqpSettings:
    """SQP settings stable for the stiff filter pole: RK2 with 2 substeps
    keeps |lambda_max| h = p dt / substeps inside the stability region at
    the reference dt = 0.025."""
    kw = dict(max_iterations=12, integrator="rk2", substeps=2)
    kw.update(overrides)
    return sqp.SqpSettings(**kw)


def _equilibrium(defn: LoopshapingDefinition, u: Tensor) -> Tensor:
    """xi = (-A)^{-1} B u for u [..., nu]."""
    return torch.linalg.solve(-defn.A, (u @ defn.B.T)[..., None])[..., 0]


def augment_state(defn: LoopshapingDefinition, x: Tensor, u: Tensor) -> Tensor:
    """(plant state, steady input) -> augmented initial state (reference
    LoopshapingSystemObservation.augmentedSystemState): the filter state at
    equilibrium, xi = (-A)^{-1} B u (unit-DC low-pass: xi = u)."""
    return torch.cat([x, _equilibrium(defn, u)], dim=-1)


def loopshaped_warm_start(defn: LoopshapingDefinition, grid, x0: Tensor):
    """Warm start consistent with the gait's contact structure: per-node
    weight-compensating plant inputs and equilibrium filter states (the
    LoopshapingInitializer analogue).  Returns (xs [N+1, 48], us [N, 24]) on
    x0's device."""
    modes = grid.modes.cpu().numpy() if isinstance(grid.modes, Tensor) else np.asarray(grid.modes)
    u_des = torch.stack([
        model.weight_compensating_input(contact_flags_static(int(m)), x0.device) for m in modes])
    xi = _equilibrium(defn, u_des)
    xs_init = torch.cat([x0[None].expand(len(modes), -1), xi.to(x0.dtype)], dim=-1)
    return xs_init.to(x0.dtype), u_des[:-1].to(x0.dtype)


def plant_trajectory(defn: LoopshapingDefinition, xs: Tensor, us: Tensor):
    """Augmented solution -> plant (x, u) trajectories.  In the outputpattern
    the input is the plant input (getSystemInput: systemInput = input); the
    state drops the filter block."""
    nx = xs.shape[-1] - defn.num_filter_states
    return xs[..., :nx], us


def filtered_output(defn: LoopshapingDefinition, xs: Tensor, us: Tensor) -> Tensor:
    """y_k = C xi_k + D u_k, the shaped quantity (getFilteredInput), for xs
    [..., N+1, nx_aug] and us [..., N, nu]."""
    nx = xs.shape[-1] - defn.num_filter_states
    xi = xs[..., :-1, nx:]
    return xi @ defn.C.T + us @ defn.D.T
