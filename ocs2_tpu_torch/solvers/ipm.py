"""Multiple-shooting nonlinear interior-point solver for a batch of scenarios.

Counterpart of ``ocs2_tpu/solvers/ipm.py``.  The JAX solve is written for one
scenario and batched with ``jax.vmap``; here every array carries an explicit
leading scenario dim ``B`` and the loop is the one of ``solvers/sqp.py``: a
Python loop over iterations, a per-scenario mask ``active = (it <
max_iterations) & ~done`` that freezes the carry, and one host read of
``active.any()`` per iteration.  Every reduction of the JAX function (the
fraction-to-boundary ``min``, the barrier sum, the Armijo slope) is a
reduction over one scenario's nodes and rows, never over the batch, and the
barrier parameter ``mu`` is a ``[B]`` tensor.

Inequality constraints h(t, x, u) >= 0 get slack s > 0 and dual v > 0
variables with a log-barrier -mu*sum(log s).  Each Newton step condenses the
slack/dual blocks into the per-node LQ stage data,

    Sigma = v / s                               (elementwise)
    Q    += H' diag(Sigma) H
    q    -= H' (mu / s - Sigma * (h - s))

after which the equality-constrained QP is solved by the Riccati recursion
(``ops/riccati.lqr_backward``: the CUDA kernel on the card, with strict pivots
at B = 1 and clamped ones for a batch), with the state-input equalities
removed by null-space projection as in the SQP solver (with
``parallel_riccati=True``, by the associative-scan ``lqr_backward_parallel``
instead).  The slack and dual Newton directions are recovered per node,

    ds = H dz + (h - s),      dv = mu/s - v - Sigma * ds,

and steps are clipped by the fraction-to-boundary rule with separate primal
and dual step sizes.  The primal step also passes the SQP solver's filter
line search, on the barrier merit.

State-only equality / final equality constraints are handled by augmented
Lagrangian (as in solvers/sqp.py); state-only inequalities get their own
slack/dual pairs over the N+1 state nodes (the terminal node condenses into
the terminal cost).  A family that is absent has zero-width slacks and duals
and takes no part in any reduction.

While recording is on (``utils/timers``: under ``torch.profiler`` or inside
``timers.recording()``), the loop marks its phases as spans, one of each an
iteration, on the host's clock, the stream's and the profiler's timeline, as
``solvers/sqp.solve`` does.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Optional

import torch

from ..core.types import PerformanceIndex
from ..oc.approx import approximate_lq, example_params
from ..oc.metrics import TrajectoryMetrics, al_dual_ascent, al_merit, evaluate_trajectory
from ..oc.metrics import _rho_like as _bcast
from ..oc.problem import OptimalControlProblem
from ..oc.time_discretization import TimeGrid
from ..ops.projection import project_lqr_coeffs, remap_projected_gain, remap_projected_input
from ..ops.riccati import (
    LqrCoeffs,
    convexify,
    lqr_backward,
    lqr_backward_parallel,
    lqr_forward,
)
from ..utils.timers import SPANS
from .al import AlState, augment_problem
from .ddp import _where, _where_tree
from .sqp import _defects

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class IpmSettings:
    max_iterations: int = 15
    integrator: str = "rk2"
    substeps: int = 1
    num_alphas: int = 8
    alpha_decay: float = 0.5
    armijo_factor: float = 1e-4
    g_max: float = 1e6
    g_min: float = 1e-6
    cost_tol: float = 1e-4
    dynamics_tol: float = 1e-6
    constraint_tol: float = 1e-4
    project_equalities: bool = True
    hessian_reg: float = 1e-6
    # "auto": skip when every cost term is PSD-by-construction
    # (problem.cost_structure_psd), else correct.  The barrier condensation
    # adds its own PSD contribution, so "auto" stays valid.
    convexify: Any = "auto"
    # "eigh" (exact eigenvalue clamping) or "gershgorin" (cheap scalar
    # diagonal shift).
    hessian_correction: str = "eigh"
    # Barrier schedule: initial and target mu, linear decrease factor and
    # superlinear decrease power.
    mu_init: float = 1e-2
    mu_target: float = 1e-4
    mu_linear_decrease: float = 0.5
    mu_superlinear_power: float = 1.2
    # Fraction-to-boundary margin tau.
    ftb_margin: float = 0.995
    slack_init_min: float = 1e-2
    al_rho_init: float = 10.0
    al_rho_growth: float = 10.0
    al_rho_max: float = 1e6
    parallel_riccati: bool = False
    use_feedback_policy: bool = True


class IpmVars(NamedTuple):
    """Slack/dual interior-point variables of a batch (zero-width when the
    family is absent)."""

    slack_ineq: Tensor  # [B, N, ni]
    dual_ineq: Tensor  # [B, N, ni]
    slack_state_ineq: Tensor  # [B, N+1, nsi]
    dual_state_ineq: Tensor  # [B, N+1, nsi]
    mu: Tensor  # [B] barrier parameter


class IterationLog(NamedTuple):
    """Per-iteration solver record, [B, max_iterations] arrays padded with
    NaN beyond the executed iterations of each scenario."""

    merit: Tensor  # barrier merit carried after the iteration
    total_viol: Tensor  # sqrt(eq_sse + slack gap + defects)
    step_size: Tensor  # accepted primal step alpha * a_primal (0 when rejected)
    mu: Tensor  # barrier parameter after the iteration
    rho: Tensor  # AL penalty after the iteration


class IpmSolution(NamedTuple):
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
    ipm: IpmVars
    history: IterationLog


class _Carry(NamedTuple):
    xs: Tensor
    us: Tensor
    al: AlState
    ipm: IpmVars
    merit: Tensor
    viol: Tensor
    best_cviol: Tensor
    it: Tensor
    done: Tensor
    gains: Tensor
    value_S: Tensor
    value_s: Tensor


def _init_slack_dual(h: Optional[Tensor], mu: Tensor, s_min: float, shape):
    """s = max(h, s_min), v = mu / s; zero-width [B, K, 0] when absent."""
    if h is None:
        s = torch.zeros(shape, dtype=mu.dtype, device=mu.device)
        return s, s
    s = torch.clamp(h, min=s_min)
    return s, _bcast(mu, s) / s


def augment(problem: OptimalControlProblem, project: bool) -> OptimalControlProblem:
    """The problem whose LQ approximation ``solve`` takes each iteration: AL
    takes only the equality families; the inequality terms are put back so
    that approximate_lq linearizes them for the condensation.  Built with
    ``dataclasses.replace``, it keeps the problem's ``lq_kernel``, which
    takes it where no AL term was added (``oc/approx.kernel_takes``)."""
    eq_only = dataclasses.replace(problem, inequality_terms=(), state_inequality_terms=())
    return dataclasses.replace(
        augment_problem(eq_only, project_equalities=project),
        inequality_terms=problem.inequality_terms,
        state_inequality_terms=problem.state_inequality_terms,
    )


def _condense(lq, ipm: IpmVars):
    """Condense the slack/dual blocks into the stage LQ data.

    Returns additive updates (dQxx, dqx, dQuu, dqu, dQux) for the
    intermediate nodes [B, N, ...] and (dQf, dqf) for the terminal node."""
    cost = lq.cost
    batch, n = lq.dynamics.f.shape[:2]
    nx, nu = cost.dfdx.shape[-1], cost.dfdu.shape[-1]
    like = dict(dtype=cost.dfdx.dtype, device=cost.dfdx.device)
    z = lambda *s: torch.zeros((batch,) + s, **like)  # noqa: E731
    dQxx, dqx, dQuu, dqu, dQux = z(n, nx, nx), z(n, nx), z(n, nu, nu), z(n, nu), z(n, nu, nx)
    dQf, dqf = z(nx, nx), z(nx)

    if lq.ineq is not None:
        h, hx, hu = lq.ineq.f, lq.ineq.dfdx, lq.ineq.dfdu
        s, v = ipm.slack_ineq, ipm.dual_ineq
        sig = v / s  # [B, N, ni]
        grad = _bcast(ipm.mu, s) / s - sig * (h - s)
        dQxx = dQxx + torch.einsum("bkix,bki,bkiy->bkxy", hx, sig, hx)
        dQuu = dQuu + torch.einsum("bkiu,bki,bkiw->bkuw", hu, sig, hu)
        dQux = dQux + torch.einsum("bkiu,bki,bkix->bkux", hu, sig, hx)
        dqx = dqx - torch.einsum("bkix,bki->bkx", hx, grad)
        dqu = dqu - torch.einsum("bkiu,bki->bku", hu, grad)

    if lq.state_ineq is not None:
        h, hx = lq.state_ineq.f, lq.state_ineq.dfdx
        s, v = ipm.slack_state_ineq, ipm.dual_state_ineq
        sig = v / s
        grad = _bcast(ipm.mu, s) / s - sig * (h - s)
        dxx = torch.einsum("bkix,bki,bkiy->bkxy", hx, sig, hx)
        dx = -torch.einsum("bkix,bki->bkx", hx, grad)
        dQxx = dQxx + dxx[:, :-1]
        dqx = dqx + dx[:, :-1]
        dQf = dQf + dxx[:, -1]
        dqf = dqf + dx[:, -1]

    return dQxx, dqx, dQuu, dqu, dQux, dQf, dqf


def _slack_dual_steps(lq, ipm: IpmVars, dxs: Tensor, dus: Tensor):
    """Newton directions ds, dv of each inequality family (None if absent)."""
    ds_i = dv_i = ds_s = dv_s = None
    if lq.ineq is not None:
        h, hx, hu = lq.ineq.f, lq.ineq.dfdx, lq.ineq.dfdu
        s, v = ipm.slack_ineq, ipm.dual_ineq
        hdz = torch.einsum("bkix,bkx->bki", hx, dxs[:, :-1]) + torch.einsum(
            "bkiu,bku->bki", hu, dus)
        ds_i = hdz + (h - s)
        dv_i = _bcast(ipm.mu, s) / s - v - (v / s) * ds_i
    if lq.state_ineq is not None:
        h, hx = lq.state_ineq.f, lq.state_ineq.dfdx
        s, v = ipm.slack_state_ineq, ipm.dual_state_ineq
        ds_s = torch.einsum("bkix,bkx->bki", hx, dxs) + (h - s)
        dv_s = _bcast(ipm.mu, s) / s - v - (v / s) * ds_s
    return ds_i, dv_i, ds_s, dv_s


def _ftb_alpha(s: Tensor, ds: Optional[Tensor], tau: float) -> Tensor:
    """Fraction-to-boundary, per scenario: the largest alpha <= 1 with
    s + alpha*ds >= (1 - tau) s over all of one scenario's nodes and rows.
    An absent or zero-width family gives 1."""
    if ds is None or s.shape[-1] == 0:
        return torch.ones(s.shape[:-2], dtype=s.dtype, device=s.device)
    neg = ds < 0.0
    ratio = torch.where(neg, -tau * s / torch.where(neg, ds, torch.full_like(ds, -1.0)),
                        torch.ones_like(ds))
    return torch.clamp(torch.amin(ratio, dim=(-2, -1)), max=1.0)


def _barrier_term(ipm: IpmVars) -> Tensor:
    """-mu * sum(log s) over both families; any leading dims of mu."""
    t = torch.zeros_like(ipm.mu)
    for s in (ipm.slack_ineq, ipm.slack_state_ineq):
        if s.shape[-1]:
            t = t - ipm.mu * torch.sum(torch.log(s), dim=(-2, -1))
    return t


def _slack_gap_sse(metrics: TrajectoryMetrics, ipm: IpmVars) -> Tensor:
    """|| h - s ||^2 over both families (the IPM primal residual)."""
    sse = torch.zeros_like(metrics.cost)
    if metrics.h_ineq is not None:
        sse = sse + torch.sum(torch.square(metrics.h_ineq - ipm.slack_ineq), dim=(-2, -1))
    if metrics.h_state_ineq is not None:
        sse = sse + torch.sum(
            torch.square(metrics.h_state_ineq - ipm.slack_state_ineq), dim=(-2, -1))
    return sse


def _equalities_only(metrics: TrajectoryMetrics) -> TrajectoryMetrics:
    """The AL handles only the equality families in IPM; inequalities enter
    through the barrier and the slack condensation."""
    return metrics._replace(h_ineq=None, h_state_ineq=None)


def solve(
    problem: OptimalControlProblem,
    grid: TimeGrid,
    x0,
    params: Any,
    xs_init: Optional[Tensor] = None,
    us_init: Optional[Tensor] = None,
    al_init: Optional[AlState] = None,
    settings: IpmSettings = IpmSettings(),
    device="cuda",
    force_plain_riccati: bool = False,
    force_single_riccati: bool = False,
) -> IpmSolution:
    """Run the interior-point method on a batch of scenarios.

    x0 [B, nx] (a [nx] input is a batch of one); xs_init [B, N+1, nx] or
    [N+1, nx], us_init [B, N, nu] or [N, nu] (shared); al_init with a leading
    [B] on every leaf; ``params`` (a dict) is shared by all scenarios.
    Slacks start at max(h, slack_init_min) of the initial guess and duals at
    mu_init / s; neither is carried in from outside.  The two test hooks are
    those of ``sqp.solve``: ``force_plain_riccati`` routes the backward sweep
    through the kernel's plain PyTorch version, ``force_single_riccati``
    (B = 1) through the single-scenario sweep."""
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
    aug = augment(problem, project)
    do_convexify = (
        not aug.cost_structure_psd if settings.convexify == "auto" else bool(settings.convexify)
    )
    dims = problem.constraint_dims(example_params(params, dev), device=dev)
    if al_init is None:
        al_init = AlState.init(
            dims, n, settings.al_rho_init, batch=(batch,), dtype=f32, device=dev)
    if us_init is None:
        us_init = torch.zeros((n, nu), dtype=f32, device=dev)
    us_init = torch.as_tensor(us_init, dtype=f32, device=dev).expand(batch, n, nu)
    if xs_init is None:
        xs_init = x0[:, None, :].expand(batch, n + 1, nx)
    xs_init = torch.as_tensor(xs_init, dtype=f32, device=dev).expand(batch, n + 1, nx)
    xs_init = torch.cat([x0[:, None, :], xs_init[:, 1:]], dim=1)

    def eval_traj(xs, us) -> TrajectoryMetrics:
        return evaluate_trajectory(problem, grid, xs, us, params)

    def defect_sse(xs, us) -> Tensor:
        d = _defects(problem, grid, xs, us, params, settings.integrator, settings.substeps)
        return torch.sum(torch.square(d), dim=(-2, -1))

    def merit_fn(metrics, al, ipm):
        # Hiding h_ineq from al_merit keeps the line-search merit consistent
        # with the Newton direction's model (no double penalty).
        return al_merit(_equalities_only(metrics), al) + _barrier_term(ipm)

    def total_viol(metrics, ipm, d_sse):
        return torch.sqrt(metrics.eq_sse + _slack_gap_sse(metrics, ipm) + d_sse)

    metrics0 = eval_traj(xs_init, us_init)
    mu0 = torch.full((batch,), settings.mu_init, dtype=f32, device=dev)
    s_i, v_i = _init_slack_dual(
        metrics0.h_ineq, mu0, settings.slack_init_min, (batch, n, dims["ni"]))
    s_s, v_s = _init_slack_dual(
        metrics0.h_state_ineq, mu0, settings.slack_init_min, (batch, n + 1, dims["nsi"]))
    ipm0 = IpmVars(slack_ineq=s_i, dual_ineq=v_i, slack_state_ineq=s_s, dual_state_ineq=v_s,
                   mu=mu0)
    merit0 = merit_fn(metrics0, al_init, ipm0)
    # Filter baseline from the initial trajectory's actual violation.
    viol0 = total_viol(metrics0, ipm0, defect_sse(xs_init, us_init))
    alphas = settings.alpha_decay ** torch.arange(settings.num_alphas, dtype=f32, device=dev)
    tau = settings.ftb_margin
    rows = torch.arange(batch, device=dev)
    reg_eye = settings.hessian_reg * torch.eye(nu, dtype=f32, device=dev)
    dx0 = torch.zeros((batch, nx), dtype=f32, device=dev)
    # The sweep runs unregularized: hessian_reg * I went into Quu above.
    reg0 = torch.zeros((batch,), dtype=f32, device=dev)
    spans = SPANS.solve("ipm.solve", dev)

    def iteration(c: _Carry):
        spans.mark("ipm.approx", synced=True)
        p_al = dict(params, al=c.al)
        lq = approximate_lq(
            aug, grid, c.xs, c.us, p_al, method=settings.integrator, substeps=settings.substeps)
        spans.mark("ipm.condense")
        dQxx, dqx, dQuu, dqu, dQux, dQf, dqf = _condense(lq, c.ipm)
        coeffs = LqrCoeffs(
            A=lq.dynamics.dfdx,
            B=lq.dynamics.dfdu,
            b=lq.dynamics.f - c.xs[:, 1:],
            Qxx=lq.cost.dfdxx[:, :-1] + dQxx,
            qx=lq.cost.dfdx[:, :-1] + dqx,
            Quu=lq.cost.dfduu[:, :-1] + dQuu + reg_eye,
            qu=lq.cost.dfdu[:, :-1] + dqu,
            Qux=lq.cost.dfdux[:, :-1] + dQux,
            Qf=lq.cost.dfdxx[:, -1] + dQf,
            qf=lq.cost.dfdx[:, -1] + dqf,
        )
        if do_convexify:
            coeffs = convexify(coeffs, settings.hessian_reg, method=settings.hessian_correction)

        def solve_qp(qp: LqrCoeffs):
            spans.mark("ipm.riccati")
            qp = LqrCoeffs(*(leaf.contiguous() for leaf in qp))
            if settings.parallel_riccati:
                # The JAX package's IPM passes no regularization to either sweep.
                sol = lqr_backward_parallel(qp)
            else:
                sol = lqr_backward(
                    qp, reg0, force_plain=force_plain_riccati, force_single=force_single_riccati)
            spans.mark("ipm.forward")
            dxs, dus_r = lqr_forward(qp, sol, dx0)
            return dxs, dus_r, sol

        if project:
            spans.mark("ipm.projection")
            reduced, proj = project_lqr_coeffs(coeffs, lq.eq.f, lq.eq.dfdx, lq.eq.dfdu)
            dxs, dvs, sol = solve_qp(reduced)
            dus = remap_projected_input(proj, dxs[:, :-1], dvs)
            gains = remap_projected_gain(proj, sol.gains)
        else:
            dxs, dus, sol = solve_qp(coeffs)
            gains = sol.gains

        ds_i, dv_i, ds_s, dv_s = _slack_dual_steps(lq, c.ipm, dxs, dus)
        # Fraction-to-boundary step-size limits [B]: primal on the slacks,
        # dual on the duals.
        a_primal = torch.minimum(_ftb_alpha(c.ipm.slack_ineq, ds_i, tau),
                                 _ftb_alpha(c.ipm.slack_state_ineq, ds_s, tau))
        a_dual = torch.minimum(_ftb_alpha(c.ipm.dual_ineq, dv_i, tau),
                               _ftb_alpha(c.ipm.dual_state_ineq, dv_s, tau))

        def step_slacks(ipm: IpmVars, alpha: Tensor) -> IpmVars:
            """Slacks moved by alpha [B] or [B, A] along ds."""
            out = {}
            for name, ds in (("slack_ineq", ds_i), ("slack_state_ineq", ds_s)):
                s = getattr(ipm, name)
                if ds is not None:
                    if alpha.ndim == 2:
                        s, ds = s[:, None], ds[:, None]
                    out[name] = s + _bcast(alpha, s) * ds
            return ipm._replace(**out)

        # Filter line search on the barrier merit over the FTB-scaled grid:
        # all candidates [B, A, ...] in one evaluation.
        spans.mark("ipm.line_search")
        a_eff = alphas[None, :] * a_primal[:, None]  # [B, A]
        a4 = a_eff[:, :, None, None]
        xs_cand = c.xs[:, None] + a4 * dxs[:, None]
        us_cand = c.us[:, None] + a4 * dus[:, None]
        ipm_cand = step_slacks(c.ipm._replace(mu=c.ipm.mu[:, None]), a_eff)
        metrics_cand = eval_traj(xs_cand, us_cand)
        al_cand = AlState(*(a.unsqueeze(1) for a in c.al))
        merits = merit_fn(metrics_cand, al_cand, ipm_cand)  # [B, A]
        viols = total_viol(metrics_cand, ipm_cand, defect_sse(xs_cand, us_cand))

        # Armijo slope from the (condensed, unprojected) QP gradient.
        slope = (
            torch.sum(coeffs.qx * dxs[:, :-1], dim=(1, 2))
            + torch.sum(coeffs.qu * dus, dim=(1, 2))
            + torch.sum(coeffs.qf * dxs[:, -1], dim=1)
        )
        merit_c, viol_c = c.merit[:, None], c.viol[:, None]
        armijo = merits <= merit_c + settings.armijo_factor * a_eff * slope[:, None]
        hi = viol_c > settings.g_max
        lo = (viol_c < settings.g_min) & (viols < settings.g_min)
        less_viol = viols < (1.0 - 1e-3) * viol_c
        accept = torch.where(
            hi, less_viol, torch.where(lo, armijo, (merits < merit_c) | less_viol))
        # First accepted step (alphas descend); argmax takes no bool.
        first_ok = torch.argmax(accept.to(torch.int8), dim=1)
        any_ok = torch.any(accept, dim=1)
        a_star = torch.where(any_ok, a_eff[rows, first_ok], torch.zeros_like(a_primal))

        pick = lambda a: None if a is None else a[rows, first_ok]  # noqa: E731
        xs_n = _where(any_ok, pick(xs_cand), c.xs)
        us_n = _where(any_ok, pick(us_cand), c.us)
        metrics_n = TrajectoryMetrics(*(pick(a) for a in metrics_cand))
        viol_n = torch.where(any_ok, pick(viols), c.viol)

        spans.mark("ipm.update")
        # Accepted slack step + full FTB dual step (separate primal and dual
        # step sizes).  The slacks are NOT guarded by any_ok, as in the
        # reference: a rejected non-finite step (the B = 1 sweep's NaN on a
        # Quu_hat that is not positive definite) writes 0 * NaN into them.
        # ROADMAP.md §3 records this as a matched quirk (the IPM zero-input
        # fault).
        ipm_n = step_slacks(c.ipm, a_star)
        if dv_i is not None:
            ipm_n = ipm_n._replace(dual_ineq=_where(
                any_ok, c.ipm.dual_ineq + _bcast(a_dual, dv_i) * dv_i, c.ipm.dual_ineq))
        if dv_s is not None:
            ipm_n = ipm_n._replace(dual_state_ineq=_where(
                any_ok, c.ipm.dual_state_ineq + _bcast(a_dual, dv_s) * dv_s,
                c.ipm.dual_state_ineq))
        # Barrier decrease: linear factor and superlinear power, clipped at
        # the target.
        mu = c.ipm.mu
        mu_n = torch.where(
            any_ok,
            torch.clamp(torch.minimum(settings.mu_linear_decrease * mu,
                                      mu ** settings.mu_superlinear_power),
                        min=settings.mu_target),
            mu,
        )
        ipm_n = ipm_n._replace(mu=mu_n)

        # AL outer loop on the equality families (LANCELOT schedule: dual or
        # penalty updates only when the inner iteration is stationary).
        merit_same_al = torch.where(any_ok, merit_fn(metrics_n, c.al, ipm_n), c.merit)
        rel_cost = torch.abs(c.merit - merit_same_al) / torch.clamp(
            torch.abs(c.merit), min=1e-12)
        inner_conv = (any_ok & (rel_cost < settings.cost_tol)) | ~any_ok
        cviol_n = torch.sqrt(metrics_n.eq_sse)
        c_feasible = cviol_n < settings.constraint_tol
        improved = (cviol_n <= 0.5 * c.best_cviol) | c_feasible
        take_dual = inner_conv & improved
        take_rho = inner_conv & ~improved
        # Equality families only: inequality multipliers stay at zero.
        al_n = _where_tree(take_dual, al_dual_ascent(_equalities_only(metrics_n), c.al), c.al)
        al_n = al_n._replace(rho=torch.where(
            take_rho,
            torch.clamp(c.al.rho * settings.al_rho_growth, max=settings.al_rho_max),
            al_n.rho,
        ))
        best_cviol = torch.where(
            inner_conv, torch.minimum(c.best_cviol, cviol_n), c.best_cviol)
        merit_n = torch.where(any_ok, merit_fn(metrics_n, al_n, ipm_n), c.merit)

        at_target_mu = mu <= settings.mu_target * (1.0 + 1e-9)
        done = inner_conv & (viol_n < settings.constraint_tol) & at_target_mu
        log = IterationLog(merit=merit_n, total_viol=viol_n, step_size=a_star, mu=mu_n,
                           rho=al_n.rho)
        new = _Carry(
            xs=xs_n, us=us_n, al=al_n, ipm=ipm_n, merit=merit_n, viol=viol_n,
            best_cviol=best_cviol, it=c.it + 1, done=done,
            gains=gains, value_S=sol.value_S, value_s=sol.value_s,
        )
        return new, log

    zeros = lambda *s: torch.zeros((batch,) + s, dtype=f32, device=dev)  # noqa: E731
    carry = _Carry(
        xs=xs_init, us=us_init, al=al_init, ipm=ipm0, merit=merit0, viol=viol0,
        best_cviol=torch.sqrt(metrics0.eq_sse),
        it=torch.zeros((batch,), dtype=torch.int32, device=dev),
        done=torch.zeros((batch,), dtype=torch.bool, device=dev),
        gains=zeros(n, nu, nx), value_S=zeros(n + 1, nx, nx), value_s=zeros(n + 1, nx),
    )
    history = IterationLog(*(
        torch.full((batch, settings.max_iterations), float("nan"), dtype=f32, device=dev)
        for _ in IterationLog._fields
    ))

    # The phases of an iteration, marked in this order: ipm.host_read,
    # ipm.approx, ipm.condense, ipm.projection (when projecting), ipm.riccati,
    # ipm.forward, ipm.line_search and ipm.update, which ends after the carry
    # merge and the history write.
    for i in range(settings.max_iterations):
        spans.mark("ipm.host_read", iteration=i)
        active = (carry.it < settings.max_iterations) & ~carry.done
        if not bool(active.any()):  # the one host read of the iteration
            spans.drop()
            break
        new, log = iteration(carry)
        carry = _Carry(*(
            _where_tree(active, a, b) if isinstance(a, tuple) else _where(active, a, b)
            for a, b in zip(new, carry)
        ))
        for col, val in zip(history, log):
            col[:, i] = torch.where(active, val, col[:, i])
    spans.end()

    metrics_f = eval_traj(carry.xs, carry.us)
    performance = PerformanceIndex(
        merit=merit_fn(metrics_f, carry.al, carry.ipm),
        cost=metrics_f.cost,
        dynamics_violation_sse=defect_sse(carry.xs, carry.us),
        equality_constraints_sse=metrics_f.eq_sse,
        inequality_constraints_sse=metrics_f.ineq_sse,
        equality_lagrangian=al_merit(_equalities_only(metrics_f), carry.al) - metrics_f.cost,
        inequality_lagrangian=_barrier_term(carry.ipm),
    )
    return IpmSolution(
        xs=carry.xs,
        us=carry.us,
        gains=carry.gains if settings.use_feedback_policy else torch.zeros_like(carry.gains),
        value_S=carry.value_S,
        value_s=carry.value_s,
        performance=performance,
        iterations=carry.it,
        converged=carry.done,
        al=carry.al,
        ipm=carry.ipm,
        history=history,
    )
