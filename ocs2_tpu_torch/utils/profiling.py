"""Solver phase profiling: the per-phase breakdown of one SQP iteration.

Counterpart of ``ocs2_tpu/utils/profiling.py``.  There each phase is jitted
and timed in isolation, because a compiled solve cannot be timed inside; here
the phases are eager calls, timed one by one on the same representative data
(the initial guess), each call ending in a synchronise where there is a
card.  The report keeps the JAX package's keys so that the two compare.
It replays each phase alone on one scenario; the phases inside a batched
solve are the spans that ``utils/timers`` records in ``sqp.solve``.

Usage:
    from ocs2_tpu_torch.utils.profiling import profile_sqp_phases, format_report
    report = profile_sqp_phases(problem, grid, x0, params, settings, device="cuda")
    print(format_report(report))
"""
from __future__ import annotations

import time
from typing import Dict

import torch


def time_call(fn, *args, warmup: int = 2, reps: int = 10) -> float:
    """Median wall-clock seconds of ``fn(*args)`` over ``reps`` calls after
    ``warmup`` calls; each call ends in ``torch.cuda.synchronize()`` where
    there is a card, so that work queued on it is counted."""

    def call():
        fn(*args)
        if torch.cuda.is_available():
            torch.cuda.synchronize()

    for _ in range(warmup):
        call()
    times = []
    for _ in range(reps):
        tic = time.perf_counter()
        call()
        times.append(time.perf_counter() - tic)
    times.sort()
    return times[len(times) // 2]


def profile_sqp_phases(
    problem, grid, x0, params, settings=None, us_init=None, device="cuda",
    warmup: int = 2, reps: int = 10,
) -> Dict[str, float]:
    """Median seconds of each phase of one SQP iteration's work on one
    scenario (x0 [nx]) at its initial guess, and of the whole solve.

    Phases: lq_approx (transcription), convexify_eigh, projection (where the
    problem has equalities to project), riccati_seq (``lqr_backward``: the
    CUDA kernel on the card), riccati_parallel (``lqr_backward_parallel``),
    qp_forward, linesearch (all step-size candidates at once) and full_solve
    (``sqp.solve``, every iteration)."""
    from ..oc.approx import approximate_lq, example_params
    from ..oc.metrics import evaluate_trajectory
    from ..ops.projection import project_lqr_coeffs
    from ..ops.riccati import (
        LqrCoeffs,
        convexify,
        lqr_backward,
        lqr_backward_parallel,
        lqr_forward,
    )
    from ..solvers import sqp as sqp_mod
    from ..solvers.al import AlState, augment_problem

    settings = settings or sqp_mod.SqpSettings()
    f32 = torch.float32
    x0 = torch.as_tensor(x0, dtype=f32, device=device).reshape(1, -1)
    dev = x0.device
    n = grid.num_intervals
    nu = problem.nu
    grid = grid.device(dev)
    if us_init is None:
        us_init = torch.zeros((n, nu), dtype=f32, device=dev)
    us = torch.as_tensor(us_init, dtype=f32, device=dev).expand(1, n, nu)
    xs = x0[:, None, :].expand(1, n + 1, x0.shape[-1])
    project = settings.project_equalities and bool(problem.equality_terms)
    aug = augment_problem(problem, project_equalities=project)
    dims = problem.constraint_dims(example_params(params, dev), device=dev)
    al = AlState.init(dims, n, settings.al_rho_init, batch=(1,), dtype=f32, device=dev)
    p_al = dict(params, al=al)
    timed = lambda fn, *args: time_call(fn, *args, warmup=warmup, reps=reps)  # noqa: E731

    report: Dict[str, float] = {}

    def lq_fn(xs, us):
        return approximate_lq(
            aug, grid, xs, us, p_al, method=settings.integrator, substeps=settings.substeps)

    report["lq_approx"] = timed(lq_fn, xs, us)
    lq = lq_fn(xs, us)

    coeffs = LqrCoeffs(
        A=lq.dynamics.dfdx, B=lq.dynamics.dfdu, b=lq.dynamics.f - xs[:, 1:],
        Qxx=lq.cost.dfdxx[:, :-1], qx=lq.cost.dfdx[:, :-1],
        Quu=lq.cost.dfduu[:, :-1] + settings.hessian_reg * torch.eye(nu, dtype=f32, device=dev),
        qu=lq.cost.dfdu[:, :-1], Qux=lq.cost.dfdux[:, :-1],
        Qf=lq.cost.dfdxx[:, -1], qf=lq.cost.dfdx[:, -1],
    )
    report["convexify_eigh"] = timed(
        lambda c: convexify(c, settings.hessian_reg, method="eigh"), coeffs)

    if project:
        proj_fn = lambda c: project_lqr_coeffs(c, lq.eq.f, lq.eq.dfdx, lq.eq.dfdu)  # noqa: E731
        report["projection"] = timed(proj_fn, coeffs)
        reduced, _ = proj_fn(coeffs)
    else:
        reduced = coeffs
    reduced = LqrCoeffs(*(leaf.contiguous() for leaf in reduced))

    report["riccati_seq"] = timed(lambda c: lqr_backward(c, 0.0), reduced)
    report["riccati_parallel"] = timed(lqr_backward_parallel, reduced)
    sol = lqr_backward(reduced, 0.0)
    dx0 = torch.zeros((1, reduced.A.shape[-1]), dtype=f32, device=dev)
    report["qp_forward"] = timed(lambda c, s: lqr_forward(c, s, dx0), reduced, sol)

    alphas = settings.alpha_decay ** torch.arange(settings.num_alphas, dtype=f32, device=dev)
    dxs, dus = torch.zeros_like(xs), torch.zeros_like(us)

    def linesearch_fn(xs, us):
        a4 = alphas[None, :, None, None]
        m = evaluate_trajectory(problem, grid, xs[:, None] + a4 * dxs[:, None],
                                us[:, None] + a4 * dus[:, None], params)
        return m.cost, m.eq_sse, m.ineq_sse

    report["linesearch"] = timed(linesearch_fn, xs, us)

    report["full_solve"] = timed(
        lambda x: sqp_mod.solve(problem, grid, x, params, us_init=us_init, settings=settings,
                                device=dev).xs,
        x0,
    )
    return report


def format_report(report: Dict[str, float]) -> str:
    """Percentage breakdown of the phases.  Percentages are of one estimated
    iteration (the isolated phases overlap the full solve, so they are
    indicative, not additive to 100 %)."""
    full = report.get("full_solve", None)
    lines = ["SQP phase breakdown (isolated-phase medians):"]
    iter_est = sum(
        v for k, v in report.items()
        if k in ("lq_approx", "riccati_seq", "qp_forward", "linesearch", "projection")
    )
    for key, val in sorted(report.items(), key=lambda kv: -kv[1]):
        pct = 100.0 * val / iter_est if iter_est else 0.0
        lines.append(f"  {key:>18}: {1e3 * val:8.3f} ms  ({pct:5.1f}% of iter est)")
    if full is not None and iter_est > 0:
        lines.append(
            f"  est. iterations amortized in full solve: {full / iter_est:.1f}"
        )
    return "\n".join(lines)
