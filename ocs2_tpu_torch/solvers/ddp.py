"""Gauss-Newton DDP (iLQR) — single-shooting trajectory optimization of a
batch of scenarios.

Counterpart of ``ocs2_tpu/solvers/ddp.py``.  The JAX solve is written for one
scenario and batched with ``jax.vmap``; here every array carries an explicit
leading scenario dim ``B``.  Under ``vmap`` the JAX ``while_loop`` runs its
body while ANY scenario is active and freezes the carry of finished ones; the
port does the same: a Python loop over iterations, a mask
``active = (it < max_iterations) & ~done`` of shape [B], every carry leaf
updated with ``torch.where(active, new, old)``, and one host read of
``active.any()`` per iteration to stop early.  ``it`` stops counting for a
finished scenario.

Per iteration: one mapped LQ approximation of all nodes of all scenarios
(``oc/approx.py``), the backward sweep, a line search that rolls out the whole
step-size grid of every scenario at once, Levenberg-Marquardt regularization
in the carry, and the augmented-Lagrangian outer loop of ``solvers/al.py``.
The sweep is, with ``algorithm="ilqr"``, the discrete Riccati recursion
(``ops/riccati.lqr_backward``: the CUDA kernel of ``riccati_backward.cu`` on
the card) on the discretized transitions and, with ``algorithm="slq"``, the
continuous-time Riccati ODE (``ops/riccati_ct.slq_backward``: the CUDA kernel
of ``riccati_ct_backward.cu`` on the card) on the continuous-time LQ data of
``approx.approximate_lq_ct``.  ``parallel_riccati=True`` takes the
associative-scan Riccati (``ops/riccati.lqr_backward_parallel``, torch ops)
for iLQR's sweep; SLQ ignores it, as the JAX package's SLQ does.
"""
from __future__ import annotations

import dataclasses
from functools import partial
from typing import Any, NamedTuple, Optional

import torch

from ..core.types import PerformanceIndex
from ..oc.approx import approximate_lq, approximate_lq_ct, example_params
from ..oc.metrics import TrajectoryMetrics, al_dual_ascent, al_merit, evaluate_trajectory
from ..oc.problem import OptimalControlProblem
from ..oc.rollout import ddp_search_policy, open_loop_policy, rollout
from ..oc.time_discretization import TimeGrid
from ..ops.riccati import (
    LqrCoeffs,
    LqrSolution,
    convexify,
    convexify_stage_hessians,
    lqr_backward,
    lqr_backward_parallel,
)
from ..ops.riccati_ct import slq_backward
from .al import AlState, augment_problem

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class DdpSettings:
    algorithm: str = "ilqr"  # "ilqr" (discrete Riccati) | "slq" (Riccati ODE)
    max_iterations: int = 15
    min_rel_cost: float = 1e-3  # relative merit decrease convergence
    constraint_tolerance: float = 1e-3
    num_alphas: int = 8
    alpha_decay: float = 0.5
    armijo_coefficient: float = 1e-4
    integrator: str = "rk4"
    substeps: int = 1
    reg_init: float = 1e-6
    reg_increase: float = 10.0
    reg_decrease: float = 0.5
    reg_max: float = 1e8
    reg_min: float = 1e-9
    al_rho_init: float = 10.0
    al_rho_growth: float = 10.0
    al_rho_max: float = 1e6
    # AL outer-loop schedule: dual ascent / penalty growth fires when the
    # inner merit descent slows below inner_tol (a LOOSER threshold than the
    # min_rel_cost convergence test), and is forced every outer_update_every
    # inner iterations so a slowly-descending inner problem cannot starve the
    # multiplier updates.
    inner_tol: float = 1e-3
    outer_update_every: int = 10
    parallel_riccati: bool = False
    use_feedback_policy: bool = True
    # PSD-project stage Hessians.  "auto": skip when every cost term is
    # PSD-by-construction (problem.cost_structure_psd), else correct.
    convexify: Any = "auto"
    hessian_correction: str = "eigh"
    riccati_substeps: int = 4

    @property
    def _substeps(self) -> int:
        return max(self.substeps, 2) if self.algorithm == "slq" else self.substeps


class DdpIterationLog(NamedTuple):
    """Per-iteration record, [B, max_iterations] arrays NaN-padded beyond the
    executed iterations of each scenario."""

    merit: Tensor
    cost: Tensor
    constraint_viol: Tensor
    step_accepted: Tensor  # 1.0 when the line search accepted a candidate
    reg: Tensor


class DdpSolution(NamedTuple):
    """Primal solution + value function, every field with a leading [B]."""

    xs: Tensor  # [B, N+1, nx]
    us: Tensor  # [B, N, nu]
    gains: Tensor  # [B, N, nu, nx]
    value_S: Tensor  # [B, N+1, nx, nx]
    value_s: Tensor  # [B, N+1, nx]
    performance: PerformanceIndex
    iterations: Tensor  # [B] int32
    converged: Tensor  # [B] bool
    al: AlState
    history: DdpIterationLog


class _Carry(NamedTuple):
    xs: Tensor
    us: Tensor
    al: AlState
    reg: Tensor
    merit: Tensor
    viol: Tensor
    best_viol: Tensor
    rel_decrease: Tensor
    since_outer: Tensor
    it: Tensor
    done: Tensor
    gains: Tensor
    value_S: Tensor
    value_s: Tensor


def _lq_to_coeffs(lq) -> LqrCoeffs:
    c = lq.cost
    return LqrCoeffs(
        A=lq.dynamics.dfdx.contiguous(),
        B=lq.dynamics.dfdu.contiguous(),
        b=torch.zeros_like(lq.dynamics.f),  # single shooting: zero defects
        Qxx=c.dfdxx[:, :-1].contiguous(),
        qx=c.dfdx[:, :-1].contiguous(),
        Quu=c.dfduu[:, :-1].contiguous(),
        qu=c.dfdu[:, :-1].contiguous(),
        Qux=c.dfdux[:, :-1].contiguous(),
        Qf=c.dfdxx[:, -1].contiguous(),
        qf=c.dfdx[:, -1].contiguous(),
    )


def _where(mask: Tensor, new: Tensor, old: Tensor) -> Tensor:
    """Per-scenario select: mask [B] against leaves [B, ...]."""
    return torch.where(mask.reshape(mask.shape + (1,) * (new.ndim - 1)), new, old)


def _where_tree(mask: Tensor, new, old):
    return type(new)(*(_where(mask, a, b) for a, b in zip(new, old)))


def solve(
    problem: OptimalControlProblem,
    grid: TimeGrid,
    x0,
    params: Any,
    us_init: Optional[Tensor] = None,
    al_init: Optional[AlState] = None,
    settings: DdpSettings = DdpSettings(),
    device="cuda",
    force_plain_riccati: bool = False,
) -> DdpSolution:
    """Run DDP on a batch of scenarios to convergence.

    x0 [B, nx]; us_init [B, N, nu] or [N, nu] (shared); al_init with a
    leading [B] on every leaf; ``params`` (a dict) is shared by all
    scenarios.  Everything runs on ``device``; the problem, the params and
    the inputs must live there.  ``force_plain_riccati`` is a test hook that
    routes the backward sweep (either algorithm's) through its kernel's plain
    PyTorch version."""
    if settings.algorithm not in ("ilqr", "slq"):
        raise ValueError(f"unknown algorithm {settings.algorithm!r}; 'ilqr' or 'slq'")
    if not isinstance(params, dict):
        raise TypeError(f"params must be a dict, got {type(params).__name__}")
    f32 = torch.float32
    x0 = torch.as_tensor(x0, dtype=f32, device=device)
    if x0.ndim != 2:
        raise ValueError(f"x0 must be [B, nx], got {tuple(x0.shape)}")
    dev = x0.device
    batch = x0.shape[0]
    n = grid.num_intervals
    nx, nu = problem.nx, problem.nu
    grid = grid.device(dev)
    aug = augment_problem(problem)
    do_convexify = (
        not aug.cost_structure_psd
        if settings.convexify == "auto"
        else bool(settings.convexify)
    )
    dims = problem.constraint_dims(example_params(params, dev), device=dev)
    if al_init is None:
        al_init = AlState.init(
            dims, n, settings.al_rho_init, batch=(batch,), dtype=f32, device=dev
        )
    if us_init is None:
        us_init = torch.zeros((n, nu), dtype=f32, device=dev)
    us_init = torch.as_tensor(us_init, dtype=f32, device=dev).expand(batch, n, nu)

    ro = partial(rollout, method=settings.integrator, substeps=settings._substeps)

    def eval_traj(xs, us) -> TrajectoryMetrics:
        return evaluate_trajectory(problem, grid, xs, us, params)

    def viol_of(m: TrajectoryMetrics) -> Tensor:
        return torch.sqrt(m.eq_sse + m.ineq_sse)

    # Initial rollout.
    xs0, us0 = ro(problem, grid, x0, open_loop_policy(us_init), params)
    metrics0 = eval_traj(xs0, us0)
    merit0 = al_merit(metrics0, al_init)
    viol0 = viol_of(metrics0)

    alphas = settings.alpha_decay ** torch.arange(
        settings.num_alphas, dtype=f32, device=dev
    )
    rows = torch.arange(batch, device=dev)

    def backward_pass(xs, us, p_al, reg) -> LqrSolution:
        if settings.algorithm == "slq":
            ct = approximate_lq_ct(aug, grid, xs, us, p_al)
            if do_convexify:
                q_m, p_m, r_m, qf = convexify_stage_hessians(
                    ct.Q, ct.P, ct.R, ct.Qf, method=settings.hessian_correction)
                ct = ct._replace(Q=q_m.contiguous(), P=p_m.contiguous(),
                                 R=r_m.contiguous(), Qf=qf.contiguous())
            return slq_backward(ct, reg, substeps=settings.riccati_substeps,
                                force_plain=force_plain_riccati)
        lq = approximate_lq(
            aug, grid, xs, us, p_al,
            method=settings.integrator, substeps=settings._substeps,
        )
        coeffs = _lq_to_coeffs(lq)
        if do_convexify:
            coeffs = convexify(coeffs, method=settings.hessian_correction)
        if settings.parallel_riccati:
            return lqr_backward_parallel(coeffs, reg)
        return lqr_backward(coeffs, reg, force_plain=force_plain_riccati)

    def iteration(c: _Carry):
        p_al = dict(params, al=c.al)
        sol = backward_pass(c.xs, c.us, p_al, c.reg)

        # Line search over the whole step-size grid in one rollout:
        # candidates [B, A, ...].  Each candidate also records its raw
        # constraint values so merit under any multipliers is an elementwise
        # reduction afterwards.
        policy = ddp_search_policy(c.us, sol.kff, sol.gains, c.xs, alphas)
        x0_cand = x0[:, None, :].expand(batch, settings.num_alphas, nx)
        xs_cand, us_cand = ro(problem, grid, x0_cand, policy, params)
        metrics_cand = eval_traj(xs_cand, us_cand)
        al_cand = AlState(*(a.unsqueeze(1) for a in c.al))
        merits = al_merit(metrics_cand, al_cand)  # [B, A]
        # Armijo on the Riccati expected decrease.
        expected = alphas * sol.dv1[:, None] + alphas**2 * sol.dv2[:, None]
        accept = merits <= c.merit[:, None] + settings.armijo_coefficient * expected
        merits_ok = torch.where(accept, merits, torch.full_like(merits, float("inf")))
        best = torch.argmin(merits_ok, dim=1)
        any_ok = torch.any(accept, dim=1)

        pick = lambda a: None if a is None else a[rows, best]  # noqa: E731
        xs_n = _where(any_ok, pick(xs_cand), c.xs)
        us_n = _where(any_ok, pick(us_cand), c.us)
        metrics_n = TrajectoryMetrics(*(pick(a) for a in metrics_cand))
        merit_n = torch.where(any_ok, pick(merits), c.merit)
        reg_n = torch.where(
            any_ok,
            torch.clamp(c.reg * settings.reg_decrease, min=settings.reg_min),
            torch.clamp(c.reg * settings.reg_increase, max=settings.reg_max),
        )

        # LANCELOT-style AL outer loop: dual ascent / penalty growth when the
        # inner problem (AL merit at fixed multipliers) is near-stationary;
        # also forced every outer_update_every iterations.
        rel = torch.abs(c.merit - merit_n) / torch.clamp(torch.abs(c.merit), min=1e-12)
        inner_stat = (any_ok & (rel < settings.inner_tol)) | ~any_ok
        outer_due = inner_stat | (c.since_outer >= settings.outer_update_every)
        viol = viol_of(metrics_n)
        feasible = viol < settings.constraint_tolerance
        improved = (viol <= 0.5 * c.best_viol) | feasible
        take_dual = outer_due & improved
        take_rho = outer_due & ~improved
        dual = al_dual_ascent(metrics_n, c.al)
        al_n = _where_tree(take_dual, dual, c.al)
        al_n = al_n._replace(
            rho=torch.where(
                take_rho,
                torch.clamp(c.al.rho * settings.al_rho_growth, max=settings.al_rho_max),
                al_n.rho,
            )
        )
        best_viol = torch.where(outer_due, torch.minimum(c.best_viol, viol), c.best_viol)
        # Merit must be measured under the multipliers the next iteration
        # will use, else the line search chases a stale objective.
        merit_carry = torch.where(any_ok, al_merit(metrics_n, al_n), c.merit)

        stalled = ~any_ok & (c.reg >= settings.reg_max * 0.99)
        # Converged = an ACCEPTED inner-stationary step AND constraints
        # satisfied.  A failed line search alone is NOT convergence — the
        # Levenberg regularization just grew; keep iterating with the damped
        # direction until it is saturated (`stalled`).
        inner_conv = any_ok & (rel < settings.min_rel_cost)
        done = (inner_conv & feasible) | stalled
        log = DdpIterationLog(
            merit=merit_n,
            cost=metrics_n.cost,
            constraint_viol=viol,
            step_accepted=any_ok.to(f32),
            reg=c.reg,
        )
        new = _Carry(
            xs=xs_n, us=us_n, al=al_n, reg=reg_n, merit=merit_carry,
            viol=torch.where(any_ok, viol, c.viol), best_viol=best_viol,
            rel_decrease=rel,
            since_outer=torch.where(
                outer_due, torch.zeros_like(c.since_outer), c.since_outer + 1
            ),
            it=c.it + 1, done=done,
            gains=sol.gains, value_S=sol.value_S, value_s=sol.value_s,
        )
        return new, log

    zeros = lambda *s: torch.zeros((batch,) + s, dtype=f32, device=dev)  # noqa: E731
    carry = _Carry(
        xs=xs0, us=us0, al=al_init,
        reg=torch.full((batch,), settings.reg_init, dtype=f32, device=dev),
        merit=merit0,
        viol=viol0,
        best_viol=viol0,
        rel_decrease=torch.full((batch,), float("inf"), dtype=f32, device=dev),
        since_outer=torch.zeros((batch,), dtype=torch.int32, device=dev),
        it=torch.zeros((batch,), dtype=torch.int32, device=dev),
        done=torch.zeros((batch,), dtype=torch.bool, device=dev),
        gains=zeros(n, nu, nx),
        value_S=zeros(n + 1, nx, nx),
        value_s=zeros(n + 1, nx),
    )
    history = DdpIterationLog(
        *(
            torch.full((batch, settings.max_iterations), float("nan"), dtype=f32, device=dev)
            for _ in DdpIterationLog._fields
        )
    )

    # An active scenario has run exactly `i` iterations when the loop is at
    # index i (a finished one never becomes active again), so column i of the
    # history is the slot the JAX solve writes at its own `it`.
    for i in range(settings.max_iterations):
        active = (carry.it < settings.max_iterations) & ~carry.done
        if not bool(active.any()):  # the one host read of the iteration
            break
        new, log = iteration(carry)
        carry = _Carry(*(
            _where_tree(active, a, b) if isinstance(a, AlState) else _where(active, a, b)
            for a, b in zip(new, carry)
        ))
        for col, val in zip(history, log):
            col[:, i] = torch.where(active, val, col[:, i])

    metrics_f = eval_traj(carry.xs, carry.us)
    merit_f = al_merit(metrics_f, carry.al)
    zero = torch.zeros((batch,), dtype=f32, device=dev)
    performance = PerformanceIndex(
        merit=merit_f,
        cost=metrics_f.cost,
        dynamics_violation_sse=zero,
        equality_constraints_sse=metrics_f.eq_sse,
        inequality_constraints_sse=metrics_f.ineq_sse,
        equality_lagrangian=merit_f - metrics_f.cost,
        inequality_lagrangian=zero,
    )
    return DdpSolution(
        xs=carry.xs,
        us=carry.us,
        gains=carry.gains if settings.use_feedback_policy else torch.zeros_like(carry.gains),
        value_S=carry.value_S,
        value_s=carry.value_s,
        performance=performance,
        iterations=carry.it,
        converged=carry.done,
        al=carry.al,
        history=history,
    )

