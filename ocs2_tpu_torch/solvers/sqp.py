"""Multiple-shooting SQP solver for a batch of scenarios.

Counterpart of ``ocs2_tpu/solvers/sqp.py``.  The JAX solve is written for one
scenario and batched with ``jax.vmap``; here every array carries an explicit
leading scenario dim ``B`` (a single problem is ``B = 1``), and the loop is
the one of ``solvers/ddp.py``: a Python loop over iterations, a per-scenario
mask ``active = (it < max_iterations) & ~done`` that freezes the carry, the
iteration count and the history rows of finished scenarios, and one host
read of ``active.any()`` per iteration.

Per iteration, with no sequential rollout anywhere:

* transcription: one mapped LQ approximation of all nodes of all scenarios
  with the multiple-shooting defects (``oc/approx.py``);
* QR projection of the state-input equalities onto their null space
  (``ops/projection.py``);
* the equality-constrained QP by the Riccati recursion
  (``ops/riccati.lqr_backward``: the CUDA kernel on the card, with strict
  pivots at B = 1 and clamped ones for a batch) and the forward pass
  ``lqr_forward``;
* a filter line search that evaluates the whole step-size grid of every
  scenario at once, ``[B, num_alphas]`` candidates;
* inequality constraints as augmented-Lagrangian terms in the cost
  (``solvers/al.py``) with a LANCELOT outer schedule.

``qp_solver="pipg"`` swaps the Riccati recursion for Ruiz equilibration and
the first-order PIPG iteration (``ops/pipg.py``; the SLP configuration,
``solvers/slp.py``).  PIPG gives no value function and no feedback: the
gains are zero (remapped through the projection, where there is one) and
``value_S`` / ``value_s`` are NaN, so that a consumer of the value function
fails visibly.  ``qp_solver="pipg_sharded"`` runs the same PIPG with the
stage axis split over the shards of ``time_mesh``
(``parallel/horizon.py``), and ``parallel_riccati=True`` replaces the
sequential sweep by the associative-scan Riccati
(``ops/riccati.lqr_backward_parallel``, torch ops; the CUDA kernel is then
not launched).

While recording is on (``utils/timers``: under ``torch.profiler`` or inside
``timers.recording()``), the loop marks its phases as spans, one of each an
iteration, on the host's clock, the stream's and the profiler's timeline.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Optional

import torch

from ..core.integrate import discretize
from ..core.types import PerformanceIndex
from ..oc.approx import approximate_lq, example_params, node_params
from ..oc.metrics import TrajectoryMetrics, al_dual_ascent, al_merit, evaluate_trajectory
from ..oc.problem import OptimalControlProblem
from ..oc.time_discretization import TimeGrid
from ..ops.pipg import PipgSettings, pipg_solve, ruiz_equilibrate
from ..ops.projection import project_lqr_coeffs, remap_projected_gain, remap_projected_input
from ..ops.riccati import (
    LqrCoeffs,
    convexify,
    lqr_backward,
    lqr_backward_parallel,
    lqr_forward,
)
from ..parallel.horizon import pipg_solve_horizon_sharded
from ..utils.timers import SPANS
from .al import AlState, augment_problem
from .ddp import _where, _where_tree

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class SqpSettings:
    max_iterations: int = 10
    integrator: str = "rk2"
    substeps: int = 1
    num_alphas: int = 8
    alpha_decay: float = 0.5
    armijo_factor: float = 1e-4
    # Filter line-search thresholds on the total violation.
    g_max: float = 1e6
    g_min: float = 1e-6
    cost_tol: float = 1e-4
    dynamics_tol: float = 1e-6  # convergence on step + defect size
    # Primal termination: RMS of the accepted (dx, du) step both below this.
    delta_tol: float = 1e-6
    # Total-violation feasibility threshold for convergence.
    constraint_tol: float = 1e-4
    project_equalities: bool = True
    hessian_reg: float = 1e-6
    # Adaptive Riccati input regularization (Levenberg-Marquardt effect):
    # grown on line-search failure, shrunk on success.
    reg_init: float = 1e-6
    reg_increase: float = 10.0
    reg_decrease: float = 0.5
    reg_max: float = 1e8
    reg_min: float = 0.0
    # PSD-project stage Hessians; required whenever exact Hessians of
    # nonconvex terms can go indefinite.  "auto": skip when every cost term
    # is PSD-by-construction (problem.cost_structure_psd), else correct.
    convexify: Any = "auto"
    # "eigh" (exact eigenvalue clamping) or "gershgorin" (cheap scalar
    # diagonal shift; its loose bound over-damps coupled Hessians — use only
    # for diagonally dominant problems).
    hessian_correction: str = "eigh"
    al_rho_init: float = 10.0
    al_rho_growth: float = 10.0
    al_rho_max: float = 1e6
    # Force an AL outer update every K inner iterations so a slowly
    # descending inner problem cannot starve multiplier updates.
    outer_update_every: int = 10
    parallel_riccati: bool = False
    use_feedback_policy: bool = True
    # Inner QP backend: "riccati" (exact), "pipg" (first-order, the SLP
    # configuration) or "pipg_sharded" (PIPG with the horizon split over
    # `time_mesh`, parallel/horizon.py).
    qp_solver: str = "riccati"
    pipg_iterations: int = 2000
    ruiz_iterations: int = 5
    # Mesh (parallel/mesh.Mesh) with a "time" axis for
    # qp_solver="pipg_sharded"; the horizon must divide by the axis size.
    time_mesh: Any = None
    time_mesh_axis: str = "time"


class IterationLog(NamedTuple):
    """Per-iteration solver record, [B, max_iterations] arrays padded with
    NaN beyond the executed iterations of each scenario."""

    merit: Tensor
    cost: Tensor
    constraint_viol: Tensor  # sqrt(eq_sse + ineq_sse)
    total_viol: Tensor  # incl. dynamics defects
    step_size: Tensor  # accepted alpha (0 when rejected)
    reg: Tensor


class SqpSolution(NamedTuple):
    """Every field with a leading [B]."""

    xs: Tensor  # [B, N+1, nx]
    us: Tensor  # [B, N, nu]
    gains: Tensor  # [B, N, nu, nx]
    value_S: Tensor  # [B, N+1, nx, nx]
    value_s: Tensor  # [B, N+1, nx]
    performance: PerformanceIndex
    iterations: Tensor  # [B] int32
    converged: Tensor  # [B] bool
    al: AlState
    history: IterationLog


class _Carry(NamedTuple):
    xs: Tensor
    us: Tensor
    al: AlState
    merit: Tensor
    viol: Tensor
    best_cviol: Tensor  # best constraint-only violation at last outer update
    since_outer: Tensor
    reg: Tensor
    it: Tensor
    done: Tensor
    gains: Tensor
    value_S: Tensor
    value_s: Tensor


def _defects(problem, grid, xs, us, params, method, substeps):
    """Multiple-shooting gaps b_k = F(t_k, x_k, u_k) - x_{k+1} of all nodes
    at once; xs [..., N+1, nx], us [..., N, nu] -> [..., N, nx]."""
    grid = grid.device(xs.device)
    nodes = torch.arange(grid.num_intervals, device=xs.device)
    p = node_params(params, grid, nodes)
    p_next = node_params(params, grid, nodes + 1)
    x_k = xs[..., :-1, :]
    # Times as columns [N, 1], so that the stepper's t + c*dt and x + dt*k
    # both broadcast; the dynamics get them back as [N].
    flow = discretize(
        lambda tt, xx, uu: problem.dynamics(tt[..., 0], xx, uu, p), method, substeps
    )
    t = grid.times[:-1, None]
    x_int = flow(t, x_k, us, grid.times[1:, None] - t)
    x_jmp = problem.apply_jump(grid.times[:-1], x_k, p_next)
    m = grid.is_jump[:, None]
    return (1.0 - m) * x_int + m * x_jmp - xs[..., 1:, :]


def solve(
    problem: OptimalControlProblem,
    grid: TimeGrid,
    x0,
    params: Any,
    xs_init: Optional[Tensor] = None,
    us_init: Optional[Tensor] = None,
    al_init: Optional[AlState] = None,
    settings: SqpSettings = SqpSettings(),
    device="cuda",
    force_plain_riccati: bool = False,
    force_single_riccati: bool = False,
) -> SqpSolution:
    """Run SQP on a batch of scenarios to convergence.

    x0 [B, nx] (a [nx] input is a batch of one); xs_init [B, N+1, nx] or
    [N+1, nx], us_init [B, N, nu] or [N, nu] (shared); al_init with a leading
    [B] on every leaf; ``params`` (a dict) is shared by all scenarios.
    Everything runs on ``device``; the problem, the params and the inputs
    must live there.  Two test hooks route the backward sweep away from the
    CUDA kernel: ``force_plain_riccati`` through its plain PyTorch version,
    ``force_single_riccati`` (B = 1) through the single-scenario sweep."""
    if settings.qp_solver not in ("riccati", "pipg", "pipg_sharded"):
        raise ValueError(f"unknown qp_solver {settings.qp_solver!r}")
    if settings.qp_solver == "pipg_sharded" and settings.time_mesh is None:
        raise ValueError("qp_solver='pipg_sharded' needs SqpSettings.time_mesh")
    if not isinstance(params, dict):
        raise TypeError(f"params must be a dict, got {type(params).__name__}")
    f32 = torch.float32
    x0 = torch.as_tensor(x0, dtype=f32, device=device)
    if x0.ndim == 1:
        x0 = x0[None]
    if x0.ndim != 2:
        raise ValueError(f"x0 must be [B, nx] or [nx], got {tuple(x0.shape)}")
    dev = x0.device
    batch = x0.shape[0]
    n = grid.num_intervals
    nx, nu = problem.nx, problem.nu
    grid = grid.device(dev)
    project = settings.project_equalities and bool(problem.equality_terms)
    aug = augment_problem(problem, project_equalities=project)
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
    if xs_init is None:
        # Constant-state initialization.
        xs_init = x0[:, None, :].expand(batch, n + 1, nx)
    xs_init = torch.as_tensor(xs_init, dtype=f32, device=dev).expand(batch, n + 1, nx)
    xs_init = torch.cat([x0[:, None, :], xs_init[:, 1:]], dim=1)

    # The problem used for merit evaluation keeps projected equalities as
    # *metrics* (they enter the filter violation, not the AL merit).
    def eval_traj(xs, us) -> TrajectoryMetrics:
        return evaluate_trajectory(problem, grid, xs, us, params)

    def total_viol(metrics: TrajectoryMetrics, d_sse) -> Tensor:
        return torch.sqrt(metrics.eq_sse + metrics.ineq_sse + d_sse)

    def defect_sse(xs, us) -> Tensor:
        d = _defects(
            problem, grid, xs, us, params, settings.integrator, settings.substeps
        )
        return torch.sum(torch.square(d), dim=(-2, -1))

    metrics0 = eval_traj(xs_init, us_init)
    merit0 = al_merit(metrics0, al_init)
    # Filter baseline = the initial trajectory's actual violation (seeding
    # with inf would let the first accepted step trade any merit explosion
    # for a trivial violation decrease).
    viol0 = total_viol(metrics0, defect_sse(xs_init, us_init))
    cviol0 = torch.sqrt(metrics0.eq_sse + metrics0.ineq_sse)
    num_alphas = settings.num_alphas
    alphas = settings.alpha_decay ** torch.arange(num_alphas, dtype=f32, device=dev)
    rows = torch.arange(batch, device=dev)
    reg_eye = settings.hessian_reg * torch.eye(nu, dtype=f32, device=dev)
    dx0 = torch.zeros((batch, nx), dtype=f32, device=dev)

    spans = SPANS.solve("sqp.solve", dev)

    def iteration(c: _Carry):
        spans.mark("sqp.approx", synced=True)
        p_al = dict(params, al=c.al)
        # Transcription: mapped LQ approximation with defects.
        lq = approximate_lq(
            aug, grid, c.xs, c.us, p_al,
            method=settings.integrator, substeps=settings.substeps,
        )
        coeffs = LqrCoeffs(
            A=lq.dynamics.dfdx,
            B=lq.dynamics.dfdu,
            b=lq.dynamics.f - c.xs[:, 1:],
            Qxx=lq.cost.dfdxx[:, :-1],
            qx=lq.cost.dfdx[:, :-1],
            Quu=lq.cost.dfduu[:, :-1] + reg_eye,
            qu=lq.cost.dfdu[:, :-1],
            Qux=lq.cost.dfdux[:, :-1],
            Qf=lq.cost.dfdxx[:, -1],
            qf=lq.cost.dfdx[:, -1],
        )
        if do_convexify:
            coeffs = convexify(
                coeffs, settings.hessian_reg, method=settings.hessian_correction
            )

        def solve_qp(qp: LqrCoeffs):
            """(dxs, dus, gains, value_S, value_s) of the inner QP."""
            spans.mark("sqp.riccati")
            if settings.qp_solver in ("pipg", "pipg_sharded"):
                scaled, scal = ruiz_equilibrate(qp, settings.ruiz_iterations)
                pipg_settings = PipgSettings(num_iterations=settings.pipg_iterations)
                if settings.qp_solver == "pipg_sharded":
                    psol = pipg_solve_horizon_sharded(
                        scaled, settings.time_mesh, pipg_settings, axis=settings.time_mesh_axis)
                else:
                    psol = pipg_solve(scaled, pipg_settings)
                spans.mark("sqp.forward")
                nv = qp.B.shape[-1]
                nan = float("nan")
                return (
                    scal.d_x * psol.dxs, scal.d_u * psol.dus,
                    torch.zeros((batch, n, nv, nx), dtype=f32, device=dev),
                    torch.full((batch, n + 1, nx, nx), nan, dtype=f32, device=dev),
                    torch.full((batch, n + 1, nx), nan, dtype=f32, device=dev),
                )
            qp = LqrCoeffs(*(leaf.contiguous() for leaf in qp))
            if settings.parallel_riccati:
                sol = lqr_backward_parallel(qp, c.reg)
            else:
                sol = lqr_backward(
                    qp, c.reg, force_plain=force_plain_riccati,
                    force_single=force_single_riccati,
                )
            spans.mark("sqp.forward")
            dxs, dus_r = lqr_forward(qp, sol, dx0)
            return dxs, dus_r, sol.gains, sol.value_S, sol.value_s

        if project:
            spans.mark("sqp.projection")
            reduced, proj = project_lqr_coeffs(
                coeffs, lq.eq.f, lq.eq.dfdx, lq.eq.dfdu
            )
            dxs, dvs, gains_r, value_S, value_s = solve_qp(reduced)
            dus = remap_projected_input(proj, dxs[:, :-1], dvs)
            gains = remap_projected_gain(proj, gains_r)
        else:
            dxs, dus, gains, value_S, value_s = solve_qp(coeffs)

        # Non-finite directions (ill-posed QP at wildly infeasible iterates)
        # must not poison the carry: zero the step so every candidate equals
        # the baseline, the line search rejects, and the Levenberg-style
        # regularization below grows until the QP is well-posed again.
        step_finite = torch.isfinite(dxs).all(dim=(1, 2)) & torch.isfinite(dus).all(
            dim=(1, 2)
        )
        dxs = _where(step_finite, dxs, torch.zeros_like(dxs))
        dus = _where(step_finite, dus, torch.zeros_like(dus))

        # Filter line search: all candidates [B, A, ...] in one evaluation.
        spans.mark("sqp.line_search")
        a4 = alphas[None, :, None, None]
        xs_cand = c.xs[:, None] + a4 * dxs[:, None]
        us_cand = c.us[:, None] + a4 * dus[:, None]
        metrics_cand = eval_traj(xs_cand, us_cand)
        merits = al_merit(metrics_cand, AlState(*(a.unsqueeze(1) for a in c.al)))
        viols = total_viol(metrics_cand, defect_sse(xs_cand, us_cand))  # [B, A]

        # Armijo slope from the QP gradient: g'd = sum qx.dx + qu.du.
        slope = (
            torch.sum(coeffs.qx * dxs[:, :-1], dim=(1, 2))
            + torch.sum(coeffs.qu * dus, dim=(1, 2))
            + torch.sum(coeffs.qf * dxs[:, -1], dim=1)
        )
        merit_c, viol_c = c.merit[:, None], c.viol[:, None]
        armijo = merits <= merit_c + settings.armijo_factor * alphas * slope[:, None]
        # The three acceptStep cases of a filter line search.
        hi = viol_c > settings.g_max
        lo = (viol_c < settings.g_min) & (viols < settings.g_min)
        less_viol = viols < (1.0 - 1e-3) * viol_c
        accept = torch.where(
            hi, less_viol, torch.where(lo, armijo, (merits < merit_c) | less_viol)
        )
        accept = accept & step_finite[:, None]
        # Largest accepted step (alphas descend; argmax gives the first).
        first_ok = torch.argmax(accept.to(torch.int8), dim=1)
        any_ok = torch.any(accept, dim=1)
        # Levenberg-style trust-region effect: shrink the Riccati input
        # regularization on success, grow it when the line search rejects
        # everything (adaptive reg keeps making progress where terminating
        # on a small step would strand an infeasible iterate).
        reg_n = torch.where(
            any_ok,
            torch.clamp(c.reg * settings.reg_decrease, min=settings.reg_min),
            torch.clamp(
                torch.clamp(c.reg, min=settings.reg_init) * settings.reg_increase,
                max=settings.reg_max,
            ),
        )

        pick = lambda a: None if a is None else a[rows, first_ok]  # noqa: E731
        xs_n = _where(any_ok, pick(xs_cand), c.xs)
        us_n = _where(any_ok, pick(us_cand), c.us)
        metrics_n = TrajectoryMetrics(*(pick(a) for a in metrics_cand))
        viol_n = torch.where(any_ok, pick(viols), c.viol)
        merit_n = torch.where(any_ok, pick(merits), c.merit)

        # -- AL outer loop (LANCELOT schedule) --------------------------------
        spans.mark("sqp.update")
        # Inner problem = minimize the AL merit at FIXED (lambda, rho); outer
        # updates fire only when the inner iteration is stationary (tiny
        # relative merit decrease, or a failed line search).  Growing rho per
        # SQP step — before the inner problem converges — explodes the merit
        # and stalls the line search.
        rel_cost = torch.abs(c.merit - merit_n) / torch.clamp(
            torch.abs(c.merit), min=1e-12
        )
        inner_conv = (any_ok & (rel_cost < settings.cost_tol)) | ~any_ok
        outer_due = inner_conv | (c.since_outer >= settings.outer_update_every)
        # Constraint-only violation drives dual-vs-penalty choice (defects are
        # the QP's job, not the AL's).
        cviol_n = torch.sqrt(metrics_n.eq_sse + metrics_n.ineq_sse)
        c_feasible = cviol_n < settings.constraint_tol
        improved = (cviol_n <= 0.5 * c.best_cviol) | c_feasible
        take_dual = outer_due & improved
        take_rho = outer_due & ~improved
        al_n = _where_tree(take_dual, al_dual_ascent(metrics_n, c.al), c.al)
        al_n = al_n._replace(
            rho=torch.where(
                take_rho,
                torch.clamp(c.al.rho * settings.al_rho_growth, max=settings.al_rho_max),
                al_n.rho,
            )
        )
        best_cviol = torch.where(
            outer_due, torch.minimum(c.best_cviol, cviol_n), c.best_cviol
        )
        merit_carry = torch.where(any_ok, al_merit(metrics_n, al_n), c.merit)

        # Converged = inner stationary AND total violation (defects +
        # constraints) within tolerance, OR the accepted primal step is
        # negligible while feasible (gated on feasibility so a
        # stalled-but-infeasible AL outer loop keeps growing rho).
        alpha_acc = alphas[first_ok]
        dx_rms = alpha_acc * torch.sqrt(torch.mean(torch.square(dxs), dim=(1, 2)))
        du_rms = alpha_acc * torch.sqrt(torch.mean(torch.square(dus), dim=(1, 2)))
        primal_conv = (
            any_ok & (dx_rms < settings.delta_tol) & (du_rms < settings.delta_tol)
        )
        # A FAILED line search alone is not convergence: the regularization
        # above just grew — keep iterating with the damped direction, and
        # only give up once the damping is saturated (reg at reg_max).
        ls_exhausted = ~any_ok & (c.reg >= settings.reg_max)
        accepted_conv = inner_conv & any_ok & (viol_n < settings.constraint_tol)
        done = (primal_conv & c_feasible) | accepted_conv | ls_exhausted
        log = IterationLog(
            merit=merit_n,
            cost=metrics_n.cost,
            constraint_viol=cviol_n,
            total_viol=viol_n,
            step_size=torch.where(any_ok, alpha_acc, torch.zeros_like(alpha_acc)),
            reg=c.reg,
        )
        new = _Carry(
            xs=xs_n, us=us_n, al=al_n, merit=merit_carry, viol=viol_n,
            best_cviol=best_cviol,
            since_outer=torch.where(
                outer_due, torch.zeros_like(c.since_outer), c.since_outer + 1
            ),
            reg=reg_n,
            it=c.it + 1, done=done,
            gains=gains, value_S=value_S, value_s=value_s,
        )
        return new, log

    zeros = lambda *s: torch.zeros((batch,) + s, dtype=f32, device=dev)  # noqa: E731
    carry = _Carry(
        xs=xs_init, us=us_init, al=al_init, merit=merit0, viol=viol0,
        best_cviol=cviol0,
        since_outer=torch.zeros((batch,), dtype=torch.int32, device=dev),
        reg=torch.full((batch,), settings.reg_init, dtype=f32, device=dev),
        it=torch.zeros((batch,), dtype=torch.int32, device=dev),
        done=torch.zeros((batch,), dtype=torch.bool, device=dev),
        gains=zeros(n, nu, nx),
        value_S=zeros(n + 1, nx, nx),
        value_s=zeros(n + 1, nx),
    )
    history = IterationLog(
        *(
            torch.full((batch, settings.max_iterations), float("nan"), dtype=f32, device=dev)
            for _ in IterationLog._fields
        )
    )

    # An active scenario has run exactly `i` iterations when the loop is at
    # index i (a finished one never becomes active again), so column i of the
    # history is the slot the reference writes at its own `it`.
    # The phases of an iteration, marked in this order: sqp.host_read,
    # sqp.approx, sqp.projection (when projecting), sqp.riccati, sqp.forward,
    # sqp.line_search and sqp.update, which ends after the carry merge.
    for i in range(settings.max_iterations):
        spans.mark("sqp.host_read", iteration=i)
        active = (carry.it < settings.max_iterations) & ~carry.done
        if not bool(active.any()):  # the one host read of the iteration
            spans.drop()
            break
        new, log = iteration(carry)
        carry = _Carry(*(
            _where_tree(active, a, b) if isinstance(a, AlState) else _where(active, a, b)
            for a, b in zip(new, carry)
        ))
        for col, val in zip(history, log):
            col[:, i] = torch.where(active, val, col[:, i])
    spans.end()

    metrics_f = eval_traj(carry.xs, carry.us)
    merit_f = al_merit(metrics_f, carry.al)
    performance = PerformanceIndex(
        merit=merit_f,
        cost=metrics_f.cost,
        dynamics_violation_sse=defect_sse(carry.xs, carry.us),
        equality_constraints_sse=metrics_f.eq_sse,
        inequality_constraints_sse=metrics_f.ineq_sse,
        equality_lagrangian=merit_f - metrics_f.cost,
        inequality_lagrangian=torch.zeros((batch,), dtype=f32, device=dev),
    )
    return SqpSolution(
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
