"""MPC-Net: policy learning by imitating the MPC through its Hamiltonian.

Counterpart of ``ocs2_tpu/learning/mpcnet.py`` (the reference's ocs2_mpcnet
pipeline).  The JAX package maps one scenario's closed-loop ``scan`` over
the scenarios with ``jax.vmap``; here the scenarios are an explicit batch:
each control step is ONE batched SQP solve of every scenario (``sqp.solve``
with a leading [B]: on the card its Riccati sweep is the CUDA kernel with
clamped pivots), on the grid at the step's time, which every scenario shares
(the rounds start all scenarios at t = 0).  As in the JAX package:

* every solve is cold-started (no warm start between control steps);
* the sample's Hamiltonian is the Q-function expansion at node 0 assembled
  from the solution's LQ data and value function (``loss.py``);
* the behavioural controller blends alpha u* + (1 - alpha) u_policy, and
  the plant steps by rk4 with 2 substeps;
* samples flatten scenario-major to [B * steps, ...];
* training draws batches from a ``CircularMemory`` and takes Adam steps
  (``torch.optim.Adam``, whose update lr m_hat / (sqrt(v_hat) + eps) with
  eps 1e-8 is ``optax.adam``'s), with alpha annealed 1 -> 0 over the rounds;
* evaluation reports survival time and the incurred Hamiltonian.

Time is carried as float32, as the JAX scan carries it, so that a gait's
phase at t = k * control_dt rounds as it does there.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, NamedTuple, Optional, Sequence

import numpy as np
import torch
from torch import nn

from ..core.integrate import discretize
from ..oc.approx import approximate_lq
from ..oc.problem import OptimalControlProblem
from ..oc.time_discretization import TimeGrid
from ..solvers import sqp as sqp_mod
from .loss import HamiltonianApprox, hamiltonian_from_lq, hamiltonian_loss
from .memory import CircularMemory

Tensor = torch.Tensor


class MpcnetSample(NamedTuple):
    """Harvested data points, with any leading dims."""

    t: Tensor  # []
    x: Tensor  # [nx]
    u_star: Tensor  # [nu]  MPC-optimal input
    h0: Tensor  # []
    hu: Tensor  # [nu]
    Huu: Tensor  # [nu, nu]


@dataclasses.dataclass(frozen=True)
class MpcnetSettings:
    rollout_steps: int = 10  # control steps per scenario rollout
    control_dt: float = 0.1
    batch_size: int = 32
    learning_rate: float = 1e-3
    learning_iterations: int = 100
    memory_capacity: int = 4096
    data_scenarios: int = 8  # closed-loop scenarios per round
    rounds: int = 10  # alpha anneals 1 -> 0 over the rounds
    mpc_horizon: float = 1.0
    mpc_intervals: int = 20
    solver_settings: sqp_mod.SqpSettings = sqp_mod.SqpSettings(max_iterations=5)
    # Divergence threshold on |x| for the survival-time metric.
    x_max: float = 1e3


def _linspace32(stop: float, num: int) -> np.ndarray:
    """A uniform float32 grid of [0, stop], as ``jnp.linspace`` computes it
    under XLA (stop * (i * (1 / (num - 1))), the last node exactly stop):
    within one ulp of the JAX package's nodes."""
    div = num - 1
    step = np.arange(div, dtype=np.float32) * (np.float32(1.0) / np.float32(div))
    return np.concatenate([np.float32(stop) * step, [np.float32(stop)]]).astype(np.float32)


def uniform_grid_fn(horizon: float, num_intervals: int) -> Callable[[Any], TimeGrid]:
    """Moving-horizon grid for event-free problems: t0 + the offsets of a
    uniform grid over [0, horizon], in float32."""
    offsets = _linspace32(horizon, num_intervals + 1)

    def fn(t0) -> TimeGrid:
        return TimeGrid(
            times=(np.float32(t0) + offsets).astype(np.float32),
            is_jump=np.zeros((num_intervals,), np.float32),
            modes=np.zeros((num_intervals + 1,), np.int32),
        )

    return fn


def _f32(t) -> np.float32:
    return np.float32(t.item() if isinstance(t, torch.Tensor) else t)


class Mpcnet:
    """The MPC-Net trainer (the reference's Mpcnet, mpcnet.py:177).

    ``make_policy(obs_dim, generator=..., device=...)`` builds a policy
    module (a class of ``learning/policy.py`` with its other arguments
    bound); ``observation_fn(t, x)`` and ``action_transform(t, x, a)`` take
    a time (a float32 tensor, [] or [B]) and states [B, nx]."""

    def __init__(
        self,
        problem: OptimalControlProblem,
        params: dict,
        make_policy: Callable[..., nn.Module],
        observation_fn: Callable[[Tensor, Tensor], Tensor] = lambda t, x: x,
        action_transform: Optional[Callable[[Tensor, Tensor, Tensor], Tensor]] = None,
        settings: MpcnetSettings = MpcnetSettings(),
        grid_fn: Optional[Callable[[Any], TimeGrid]] = None,
        device="cuda",
    ):
        self.problem = problem
        self.params = dict(params)
        self.make_policy = make_policy
        self.observation_fn = observation_fn
        self.action_transform = action_transform
        self.s = settings
        self.grid_fn = grid_fn or uniform_grid_fn(settings.mpc_horizon, settings.mpc_intervals)
        self.device = torch.device(device)
        self.flow = discretize(
            lambda tt, xx, uu: self.problem.dynamics(tt, xx, uu, self.params), "rk4", 2)

    # -- policy ------------------------------------------------------------
    def _time(self, t) -> Tensor:
        return torch.as_tensor(t, dtype=torch.float32, device=self.device)

    def policy_u(self, policy: nn.Module, t, x: Tensor) -> Tensor:
        t = self._time(t)
        a = policy(self.observation_fn(t, x))
        if self.action_transform is not None:
            return self.action_transform(t, x, a)
        return a

    def init_policy(self, generator: Optional[torch.Generator], example_x) -> nn.Module:
        """A fresh policy sized by the observation of ``example_x``."""
        x = torch.as_tensor(example_x, dtype=torch.float32, device=self.device)
        obs = self.observation_fn(self._time(0.0), x)
        return self.make_policy(obs.shape[-1], generator=generator, device=self.device)

    # -- data generation ----------------------------------------------------
    def _mpc_step(self, t, x: Tensor):
        """One batched MPC solve of the scenarios x [B, nx] at time t; returns
        (u* [B, nu], the Hamiltonian expansion at node 0, the solution)."""
        st = self.s.solver_settings
        grid = self.grid_fn(_f32(t))
        sol = sqp_mod.solve(self.problem, grid, x, self.params, settings=st, device=self.device)
        lq = approximate_lq(self.problem, grid, sol.xs, sol.us, self.params,
                            method=st.integrator, substeps=st.substeps)
        hammy = hamiltonian_from_lq(lq, sol.value_S, sol.value_s, sol.xs)
        return sol.us[:, 0], HamiltonianApprox(
            h0=hammy.h0[:, 0], hu=hammy.hu[:, 0], Huu=hammy.Huu[:, 0]), sol

    def generate_data(self, policy: nn.Module, alpha: float, t0s, x0s,
                      on_solve: Optional[Callable] = None) -> MpcnetSample:
        """Closed-loop behavioural rollouts of the scenarios x0s [B, nx] from
        the common start time t0s (one value, or [B] equal values), one
        sample a control step, flattened scenario-major to [B * steps, ...].
        ``on_solve(sol)`` sees each step's solution."""
        x = torch.as_tensor(x0s, dtype=torch.float32, device=self.device)
        t0s = np.atleast_1d(np.asarray(t0s, np.float32))
        if not np.all(t0s == t0s[0]):
            raise ValueError("the scenarios share one grid: every t0 must be equal")
        t, batch = np.float32(t0s[0]), x.shape[0]
        steps = []
        with torch.no_grad():
            for _ in range(self.s.rollout_steps):
                u_star, hammy, sol = self._mpc_step(t, x)
                if on_solve is not None:
                    on_solve(sol)
                u = alpha * u_star + (1.0 - alpha) * self.policy_u(policy, t, x)
                steps.append(MpcnetSample(
                    t=self._time(t).expand(batch), x=x, u_star=u_star,
                    h0=hammy.h0, hu=hammy.hu, Huu=hammy.Huu))
                x = self.flow(self._time(t), x, u, self.s.control_dt)
                t = np.float32(t + np.float32(self.s.control_dt))
        return MpcnetSample(*(
            torch.stack(leaves, dim=1).reshape((-1,) + tuple(leaves[0].shape[1:]))
            for leaves in zip(*steps)))

    # -- training -----------------------------------------------------------
    def loss_fn(self, policy: nn.Module, batch: MpcnetSample) -> Tensor:
        u_pred = self.policy_u(policy, batch.t, batch.x)
        hammy = HamiltonianApprox(h0=batch.h0, hu=batch.hu, Huu=batch.Huu)
        return hamiltonian_loss(hammy, u_pred, batch.u_star)

    def make_optimizer(self, policy: nn.Module) -> torch.optim.Optimizer:
        return torch.optim.Adam(policy.parameters(), lr=self.s.learning_rate,
                                betas=(0.9, 0.999), eps=1e-8)

    def train_step(self, policy: nn.Module, optimizer: torch.optim.Optimizer,
                   memory: CircularMemory, generator: Optional[torch.Generator],
                   indices: Optional[Tensor] = None) -> Tensor:
        """One Adam step on a batch drawn from ``memory`` (``indices``
        replays given draws); updates ``policy`` in place and returns the
        batch's loss before the step."""
        batch = memory.sample(generator, self.s.batch_size, indices=indices)
        optimizer.zero_grad(set_to_none=True)
        loss = self.loss_fn(policy, batch)
        loss.backward()
        optimizer.step()
        return loss.detach()

    def example_sample(self, nx: int) -> MpcnetSample:
        nu = self.problem.nu
        zeros = lambda *s: torch.zeros(s, dtype=torch.float32)  # noqa: E731
        return MpcnetSample(t=zeros(), x=zeros(nx), u_star=zeros(nu), h0=zeros(),
                            hu=zeros(nu), Huu=zeros(nu, nu))

    def train(self, generator: Optional[torch.Generator],
              x0_sampler: Callable[[Optional[torch.Generator], int], Tensor],
              verbose: bool = False, policy: Optional[nn.Module] = None,
              indices: Optional[Sequence[Optional[Tensor]]] = None,
              on_round: Optional[Callable[[dict], None]] = None,
              on_solve: Optional[Callable] = None):
        """The training loop (the reference's Mpcnet.train): per round, a
        data round at alpha = 1 - round / max(rounds - 1, 1) from
        ``x0_sampler(generator, data_scenarios)``, pushed into the replay
        memory, then ``learning_iterations`` Adam steps.  ``policy`` starts
        from given weights instead of a fresh policy (it is trained in
        place); ``indices[round]`` ([learning_iterations, batch_size])
        replays given draws in that round.  ``on_round(info)`` sees each
        round's samples, step losses, policy and timings, ``on_solve(sol)``
        each control step's solution.  Returns (policy, last loss of each
        round)."""
        example_x = torch.as_tensor(x0_sampler(generator, 1)[0], device=self.device)
        if policy is None:
            policy = self.init_policy(generator, example_x)
        optimizer = self.make_optimizer(policy)
        memory = CircularMemory.create(self.example_sample(example_x.shape[-1]),
                                       self.s.memory_capacity, device=self.device)
        losses = []
        for rnd in range(self.s.rounds):
            alpha = 1.0 - rnd / max(self.s.rounds - 1, 1)
            start = time.perf_counter()
            x0s = torch.as_tensor(x0_sampler(generator, self.s.data_scenarios),
                                  dtype=torch.float32, device=self.device)
            samples = self.generate_data(policy, alpha, np.zeros(1, np.float32), x0s,
                                         on_solve=on_solve)
            memory.push_batch(samples)
            _sync(self.device)
            data_s = time.perf_counter() - start
            rows = None if indices is None else indices[rnd]
            step_losses = [
                self.train_step(policy, optimizer, memory, generator,
                                None if rows is None else rows[it])
                for it in range(self.s.learning_iterations)]
            step_losses = torch.stack(step_losses).cpu()
            train_s = time.perf_counter() - start - data_s
            losses.append(float(step_losses[-1]))
            if verbose:
                print(f"round {rnd}: alpha={alpha:.2f} loss={losses[-1]:.4f}")
            if on_round is not None:
                on_round(dict(round=rnd, alpha=alpha, x0s=x0s, samples=samples,
                              step_losses=step_losses, policy=policy, data_s=data_s,
                              train_s=train_s))
        return policy, losses

    # -- evaluation -----------------------------------------------------------
    def evaluate(self, policy: nn.Module, t0, x0, steps: Optional[int] = None):
        """Pure-policy rollouts of x0 ([nx], or [B, nx] scenarios): survival
        time and incurred Hamiltonian (a scenario that diverges is frozen
        where it was and stops counting)."""
        steps = steps or self.s.rollout_steps
        x = torch.as_tensor(x0, dtype=torch.float32, device=self.device)
        single = x.ndim == 1
        x = x.reshape(-1, x.shape[-1])
        t = _f32(t0)
        alive = torch.ones(x.shape[0], dtype=torch.float32, device=self.device)
        incurred = torch.zeros_like(alive)
        survived = torch.zeros_like(alive)
        with torch.no_grad():
            for _ in range(steps):
                u_star, hammy, _ = self._mpc_step(t, x)
                u = self.policy_u(policy, t, x)
                incurred = incurred + alive * hammy.value(u - u_star)
                x_next = self.flow(self._time(t), x, u, self.s.control_dt)
                ok = torch.isfinite(x_next).all(dim=-1) & (
                    x_next.abs().amax(dim=-1) < self.s.x_max)
                survived = survived + alive
                alive = alive * ok.to(x.dtype)
                x = torch.where(ok[:, None], x_next, x)
                t = np.float32(t + np.float32(self.s.control_dt))
        out = {"survival_time": survived * self.s.control_dt, "incurred_hamiltonian": incurred}
        return {k: v[0] for k, v in out.items()} if single else out


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
