"""MRT — model reference tracking (the consumer side of the MPC split).

Counterpart of ``ocs2_tpu/mpc/mrt.py``: the double-buffered policy manager
(``Mrt``: move_to_buffer / update_policy / evaluate_policy /
rollout_policy), the in-process MPC+MRT pairing (``MpcMrtInterface``) and the
closed-loop simulator at synthetic rates (``dummy_loop``).  Policies are
records of device tensors swapped by reference on the host; a control step
evaluates the controller and integrates the plant with a few small launches
and no host read.
"""
from __future__ import annotations

from typing import Callable, List, Optional

import torch

from ..core.integrate import discretize
from ..core.interpolation import interpolate
from ..oc.problem import OptimalControlProblem
from .mpc import Mpc, MpcPolicy

Tensor = torch.Tensor


def _f32(v: float, device) -> Tensor:
    """A 0-dim float32 tensor of a host float, filled on the device (no copy
    from the host, so no synchronisation)."""
    return torch.full((), float(v), dtype=torch.float32, device=device)


class SystemObservation:
    """(mode, time, state, input) plant sample."""

    def __init__(self, time: float, state: Tensor, input: Optional[Tensor] = None,
                 mode: int = 0):
        self.time = time
        self.state = state
        self.input = input
        self.mode = mode


class RolloutBackend:
    """Pluggable plant simulator for the MRT side: a different flow map gives
    the closed loop model mismatch.

    Implement ``step(t, x, u, dt, params) -> x_next`` on tensors."""

    def step(self, t, x, u, dt, params):
        raise NotImplementedError


class FlowMapRollout(RolloutBackend):
    """Default backend: integrate the problem's own flow map."""

    def __init__(self, problem: OptimalControlProblem, method="rk4", substeps=2):
        self.problem = problem
        self.method = method
        self.substeps = substeps

    def step(self, t, x, u, dt, params):
        flow = discretize(
            lambda tt, xx, uu: self.problem.dynamics(tt, xx, uu, params),
            self.method, self.substeps,
        )
        return flow(t, x, u, dt)


class ExternalSimRollout(RolloutBackend):
    """Backend wrapping any external simulator dynamics (a different flow
    map, a contact model, a learned simulator) with optional state
    conversions in and out of the MPC state space."""

    def __init__(
        self,
        sim_dynamics: Callable,  # (t, x_sim, u, params) -> dx_sim
        method: str = "rk4",
        substeps: int = 2,
        state_to_sim: Optional[Callable] = None,
        sim_to_state: Optional[Callable] = None,
    ):
        self.sim_dynamics = sim_dynamics
        self.method = method
        self.substeps = substeps
        self.to_sim = state_to_sim or (lambda x: x)
        self.to_state = sim_to_state or (lambda x: x)

    def step(self, t, x, u, dt, params):
        flow = discretize(
            lambda tt, xx, uu: self.sim_dynamics(tt, xx, uu, params),
            self.method, self.substeps,
        )
        return self.to_state(flow(t, self.to_sim(x), u, dt))


class Mrt:
    """Policy consumer with buffer-swap semantics."""

    def __init__(
        self,
        problem: OptimalControlProblem,
        rollout_backend: Optional[RolloutBackend] = None,
    ):
        self.problem = problem
        self.rollout_backend = rollout_backend or FlowMapRollout(problem)
        self._active: Optional[MpcPolicy] = None
        self._buffer: Optional[MpcPolicy] = None

    # -- policy transport ---------------------------------------------------
    def move_to_buffer(self, policy: MpcPolicy) -> None:
        """Receive a new policy."""
        self._buffer = policy

    def update_policy(self) -> bool:
        """Swap in the newest buffered policy."""
        if self._buffer is None:
            return False
        self._active = self._buffer
        self._buffer = None
        return True

    @property
    def initialized(self) -> bool:
        return self._active is not None

    @property
    def policy(self) -> MpcPolicy:
        assert self._active is not None, "no policy received yet (MRT gating)"
        return self._active

    # -- policy queries -----------------------------------------------------
    def evaluate_policy(self, t: float, x: Tensor) -> Tensor:
        """u = uff + K (x - x_nom) interpolated at t (a float32 query)."""
        controller = self.policy.controller
        return controller(_f32(t, controller.times.device), x)

    def rollout_policy(self, t: float, x: Tensor, dt: float, params: dict,
                       substeps: int = 1) -> Tensor:
        """Integrate the plant under the policy for one control period."""
        dev = self.policy.controller.times.device
        x = torch.as_tensor(x, dtype=torch.float32, device=dev)
        h = dt / substeps
        for i in range(substeps):
            ti = t + i * h
            u = self.evaluate_policy(ti, x)
            x = self.rollout_backend.step(_f32(ti, dev), x, u, _f32(h, dev), params)
        return x


class MpcMrtInterface:
    """In-process MPC+MRT pairing for tests, Python users and MPC-Net."""

    def __init__(self, mpc: Mpc, mrt: Optional[Mrt] = None):
        self.mpc = mpc
        self.mrt = mrt or Mrt(mpc.problem)
        self._observation: Optional[SystemObservation] = None

    def set_current_observation(self, obs: SystemObservation) -> None:
        self._observation = obs

    def advance_mpc(self) -> MpcPolicy:
        assert self._observation is not None, "no observation set"
        policy = self.mpc.run(self._observation.time, self._observation.state)
        self.mrt.move_to_buffer(policy)
        return policy

    def evaluate_policy(self, t: float, x: Tensor) -> Tensor:
        return self.mrt.evaluate_policy(t, x)


def dummy_loop(
    interface: MpcMrtInterface,
    x0,
    duration: float,
    mrt_frequency: float = 400.0,
    mpc_frequency: float = 50.0,
    params: Optional[dict] = None,
    observers: Optional[List[Callable]] = None,
    use_rollout: bool = True,
):
    """Closed-loop simulation at synthetic rates (synchronized mode: the MPC
    runs every mrt/mpc-ratio control steps, before that step).  Each observer
    is called as ``obs(t, x, u)`` after every control step.

    Returns (times [M], states [M, nx], inputs [M-1, nu]) on the Mpc's
    device.
    """
    params = params or interface.mpc.base_params
    dt = 1.0 / mrt_frequency
    ratio = max(1, int(round(mrt_frequency / mpc_frequency)))
    steps = int(round(duration * mrt_frequency))
    dev = interface.mpc.device

    t, x = 0.0, torch.as_tensor(x0, dtype=torch.float32, device=dev)
    times, states, inputs = [t], [x], []
    for k in range(steps):
        if k % ratio == 0:
            interface.set_current_observation(SystemObservation(t, x))
            interface.advance_mpc()
            interface.mrt.update_policy()
        u = interface.mrt.evaluate_policy(t, x)
        if use_rollout:
            x = interface.mrt.rollout_policy(t, x, dt, params)
        else:
            # Pure tracking debug: teleport to the planner's nominal state at
            # the next step (interpolated; x_nom is a [N, nx] trajectory).
            ctrl = interface.mrt.policy.controller
            x = interpolate(ctrl.times, ctrl.x_nom, _f32(t + dt, dev))
        t += dt
        times.append(t)
        states.append(x)
        inputs.append(u)
        for obs in observers or ():
            obs(t, x, u)
    return (
        torch.tensor(times, dtype=torch.float32, device=dev),
        torch.stack(states),
        torch.stack(inputs),
    )
