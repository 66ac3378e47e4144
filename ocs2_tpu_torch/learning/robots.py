"""Per-robot MPC-Net definitions: ballbot and legged robot.

Counterpart of ``ocs2_tpu/learning/robots.py`` (the reference's
ocs2_ballbot_mpcnet and ocs2_legged_robot_mpcnet: the legged observation
generalizes the state with the gait phase, and the action transform biases
the network output with the weight-compensating input, so that the policy
learns deviations from gravity compensation).  The samplers draw from a
``torch.Generator`` on the generator's device.
"""
from __future__ import annotations

import functools
import math
from typing import Optional

import numpy as np
import torch

from ..models import ballbot
from ..models.legged_robot import interface, model
from ..models.legged_robot.gait import GaitSchedule, contact_flags, trot_gait
from ..oc.time_discretization import TimeGrid, make_time_grid
from ..solvers import sqp
from .mpcnet import Mpcnet, MpcnetSettings
from .policy import (
    LinearPolicy,
    MixtureOfLinearExpertsPolicy,
    MixtureOfNonlinearExpertsPolicy,
    NonlinearPolicy,
)

Tensor = torch.Tensor

POLICY_ZOO = {
    "linear": LinearPolicy,
    "nonlinear": NonlinearPolicy,
    "mixture_of_linear_experts": MixtureOfLinearExpertsPolicy,
    "mixture_of_nonlinear_experts": MixtureOfNonlinearExpertsPolicy,
}


def _policy_factory(policy: str, action_dim: int, policy_kwargs: dict):
    if "mixture" in policy and "num_experts" not in policy_kwargs:
        policy_kwargs = dict(policy_kwargs, num_experts=3)
    return functools.partial(POLICY_ZOO[policy], action_dim=action_dim, **policy_kwargs)


def _randn(generator: Optional[torch.Generator], shape) -> Tensor:
    device = generator.device if generator is not None else "cpu"
    return torch.randn(shape, generator=generator, device=device)


def make_ballbot_mpcnet(
    policy: str = "nonlinear",
    settings: Optional[MpcnetSettings] = None,
    device="cuda",
    **policy_kwargs,
) -> Mpcnet:
    """Ballbot MPC-Net: the 10-state ballbot, state observation, identity
    action transform."""
    problem = ballbot.make_problem(device=device)
    settings = settings or MpcnetSettings(
        rollout_steps=6,
        control_dt=0.1,
        batch_size=32,
        learning_rate=1e-2,
        learning_iterations=200,
        memory_capacity=1024,
        data_scenarios=8,
        rounds=3,
        mpc_horizon=1.0,
        mpc_intervals=16,
        solver_settings=sqp.SqpSettings(max_iterations=6, integrator="rk4"),
    )
    return Mpcnet(problem, ballbot.make_params(device=device),
                  _policy_factory(policy, problem.nu, policy_kwargs), settings=settings,
                  device=device)


def ballbot_x0_sampler(generator: Optional[torch.Generator], n: int) -> Tensor:
    """Random leans and offsets, 0.15 N(0, 1) on every state."""
    return 0.15 * _randn(generator, (n, ballbot.NX))


# ---------------------------------------------------------------------------
# Legged robot.
# ---------------------------------------------------------------------------


def _phase(t: Tensor, gait_cycle: float) -> Tensor:
    """The gait phase in [0, 1), in float32 as the JAX package rounds it."""
    return torch.remainder(torch.as_tensor(t, dtype=torch.float32) / gait_cycle, 1.0)


def legged_observation(t: Tensor, x: Tensor, gait_cycle: float = 0.7) -> Tensor:
    """The state generalized with the gait phase as (sin, cos): t [] or
    [...], x [..., 24] -> [..., 26]."""
    phase = 2.0 * math.pi * _phase(t, gait_cycle).to(x.device)
    sc = torch.stack([torch.sin(phase), torch.cos(phase)], dim=-1)
    return torch.cat([sc.expand(x.shape[:-1] + (2,)), x], dim=-1)


def legged_action_transform(t: Tensor, x: Tensor, a: Tensor, gait_cycle: float = 0.7):
    """u = u_weight_compensating(trot contact flags at t) + a: LF+RH in the
    first half of the cycle (mode 9), RF+LH in the second (mode 6)."""
    del x
    phase = _phase(t, gait_cycle).to(a.device)
    mode = torch.where(phase < 0.5, 9, 6)
    flags = contact_flags(mode)  # [..., 4]
    n_stance = torch.clamp(torch.sum(flags, dim=-1, keepdim=True), min=1.0)
    fz = model.MASS * model.GRAVITY / n_stance
    zeros = torch.zeros_like(flags)
    forces = torch.stack([zeros, zeros, fz * flags], dim=-1).flatten(-2)  # [..., 12]
    u_wc = torch.cat([forces, torch.zeros_like(forces)], dim=-1)
    return u_wc + a


def make_legged_mpcnet(
    policy: str = "mixture_of_linear_experts",
    settings: Optional[MpcnetSettings] = None,
    gait_cycle: float = 0.7,
    device="cuda",
    **policy_kwargs,
) -> Mpcnet:
    """Legged-robot MPC-Net: trot grid, gait-phase observation,
    weight-compensating action transform.  The grid at t0 is the phase-0
    trot grid shifted by t0, with the swing references (``params``) of the
    phase-0 grid, as in the JAX package."""
    problem = interface.make_problem(device=device)
    gs = GaitSchedule(trot_gait(gait_cycle))
    horizon, n_int = 0.7, 14
    ms = gs.mode_schedule(0.0, horizon)
    grid0 = make_time_grid(0.0, horizon, n_int, event_times=np.asarray(ms.event_times),
                           mode_sequence=np.asarray(ms.mode_sequence))

    def grid_fn(t0) -> TimeGrid:
        return TimeGrid(times=(grid0.times + np.float32(t0)).astype(np.float32),
                        modes=grid0.modes, is_jump=grid0.is_jump)

    settings = settings or MpcnetSettings(
        rollout_steps=4,
        control_dt=0.05,
        batch_size=32,
        learning_rate=5e-3,
        learning_iterations=150,
        memory_capacity=512,
        data_scenarios=4,
        rounds=2,
        mpc_horizon=horizon,
        mpc_intervals=n_int,
        solver_settings=sqp.SqpSettings(max_iterations=5, integrator="rk2"),
    )
    return Mpcnet(
        problem,
        interface.make_params(grid0, device=device),
        _policy_factory(policy, problem.nu, policy_kwargs),
        observation_fn=lambda t, x: legged_observation(t, x, gait_cycle),
        action_transform=lambda t, x, a: legged_action_transform(t, x, a, gait_cycle),
        settings=settings,
        grid_fn=grid_fn,
        device=device,
    )


LEGGED_X0_SCALE = np.concatenate([
    0.05 * np.ones(6),  # momenta
    0.02 * np.ones(3),  # base position
    0.03 * np.ones(3),  # orientation
    0.05 * np.ones(12),  # joints
]).astype(np.float32)


def legged_x0_sampler(generator: Optional[torch.Generator], n: int) -> Tensor:
    """Perturbed stands: the default state plus scaled N(0, 1) noise."""
    noise = _randn(generator, (n, model.NX))
    base = model.default_state(noise.device)
    return base[None] + torch.as_tensor(LEGGED_X0_SCALE, device=noise.device)[None] * noise
