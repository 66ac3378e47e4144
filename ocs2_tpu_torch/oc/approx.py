"""Linear-quadratic approximation of the optimal-control problem.

Counterpart of ``ocs2_tpu/oc/approx.py``.  One fused node evaluation is
written for a single node of a single scenario and mapped with
``torch.func.vmap`` over the nodes of the horizon and over the scenarios of
the batch; the Jacobians of the discretized flow are ``torch.func.jacfwd``
inside that map, the generic cost/constraint fallbacks are
``torch.func.hessian`` / ``jacrev``.  A problem may carry a hand-written
kernel of the whole approximation (``OptimalControlProblem.lq_kernel``, K10
for the legged SRBD problem); ``approximate_lq`` hands it the calls it
computes exactly (``kernel_takes``) and counts each path in
``path_counts``, the kernel's calls by variant in ``variant_counts``.
``approximate_lq_ct`` gives the continuous-time LQ data of the SLQ backward
pass (``ops/riccati_ct.py``) the generic way.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch

from ..core.integrate import DiscreteTransition, discretize
from ..core.types import ScalarQuadraticApproximation, VectorLinearApproximation
from .problem import OptimalControlProblem
from .time_discretization import TimeGrid

Tensor = torch.Tensor

# Entries of the parameter dict whose leaves carry a leading scenario dim [B]:
# the solver's augmented-Lagrangian state, and "scenario", a dict of the
# caller's per-scenario parameters (e.g. one end-effector target per
# scenario of a batch, where the JAX package maps a whole solve over its
# params).  The LQ approximation maps them with the scenarios; a batched
# evaluation hands terms the [B, ...] leaves, to broadcast against their
# inputs' leading dim.  Every other entry is shared.
PER_SCENARIO_KEYS = ("al", "scenario")


class LQData(NamedTuple):
    """Per-node LQ approximation over the horizon, with a leading scenario
    dim [B] on every leaf.

    cost:      quadratic approx, [B, N+1, ...]; at the terminal node the
               input-derivative entries are zero.
    dynamics:  discrete transitions x_{k+1} ~ f + A dx + B du, [B, N, ...]
               (jump transitions hold the jump-map linearization, B = 0).
    eq:        state-input equality g(t,x,u) = 0, [B, N, ne] (projectable).
    state_eq:  state-only equality, [B, N+1, nse].
    ineq:      state-input inequality h >= 0, [B, N, ni].
    state_ineq: state-only inequality, [B, N+1, nsi].
    final_eq:  terminal equality at node N, [B, nfe].
    """

    cost: ScalarQuadraticApproximation
    dynamics: DiscreteTransition
    eq: Optional[VectorLinearApproximation]
    state_eq: Optional[VectorLinearApproximation]
    ineq: Optional[VectorLinearApproximation]
    state_ineq: Optional[VectorLinearApproximation]
    final_eq: Optional[VectorLinearApproximation]


def quadratize_scalar(fn, x: Tensor, u: Tensor) -> ScalarQuadraticApproximation:
    """Exact second-order expansion of fn(x, u) in (x, u) jointly (one
    sample: x [nx], u [nu])."""
    nx = x.shape[0]
    z = torch.cat([x, u])

    def fz(zz):
        return fn(zz[:nx], zz[nx:])

    # Casts: see the note on Python scalars in oc/problem.py.
    f = fz(z).to(x.dtype)
    g = torch.func.grad(fz)(z).to(x.dtype)
    h = torch.func.hessian(fz)(z).to(x.dtype)
    return ScalarQuadraticApproximation(
        f=f,
        dfdx=g[:nx],
        dfdu=g[nx:],
        dfdxx=h[:nx, :nx],
        dfdux=h[nx:, :nx],
        dfduu=h[nx:, nx:],
    )


def quadratize_state_scalar(fn, x: Tensor, nu: int) -> ScalarQuadraticApproximation:
    f = fn(x).to(x.dtype)
    g = torch.func.grad(fn)(x).to(x.dtype)
    h = torch.func.hessian(fn)(x).to(x.dtype)
    nx = x.shape[0]
    z = lambda *s: torch.zeros(s, dtype=x.dtype, device=x.device)  # noqa: E731
    return ScalarQuadraticApproximation(
        f=f, dfdx=g, dfdu=z(nu), dfdxx=h, dfdux=z(nu, nx), dfduu=z(nu, nu)
    )


def linearize_vector(fn, x: Tensor, u: Optional[Tensor]) -> VectorLinearApproximation:
    """Constraint linearization via one joint jacrev — one reverse pass per
    constraint row (constraints have few rows, states+inputs have many)."""
    if u is None:
        return VectorLinearApproximation(
            f=fn(x).to(x.dtype), dfdx=torch.func.jacrev(fn)(x).to(x.dtype), dfdu=None
        )
    nx = x.shape[0]
    z = torch.cat([x, u])
    fz = lambda zz: fn(zz[:nx], zz[nx:])  # noqa: E731
    jac = torch.func.jacrev(fz)(z).to(x.dtype)
    return VectorLinearApproximation(
        f=fz(z).to(x.dtype), dfdx=jac[:, :nx], dfdu=jac[:, nx:]
    )


def _split_terms(terms):
    structured = tuple(t for t in terms if hasattr(t, "quad_approx"))
    plain = tuple(t for t in terms if not hasattr(t, "quad_approx"))
    return structured, plain


def _scale_quad(q: ScalarQuadraticApproximation, s):
    return ScalarQuadraticApproximation(
        *(None if a is None else s * a for a in q)
    )


def _pad_state_quad(q: ScalarQuadraticApproximation, nu: int):
    """Extend a state-only approximation with zero input blocks."""
    nx = q.dfdx.shape[-1]
    z = lambda *s: torch.zeros(  # noqa: E731
        s, dtype=q.dfdx.dtype, device=q.dfdx.device
    )
    return ScalarQuadraticApproximation(
        f=q.f, dfdx=q.dfdx, dfdu=z(nu), dfdxx=q.dfdxx, dfdux=z(nu, nx),
        dfduu=z(nu, nu),
    )


def _sum_quads(parts, nx, nu, like: Tensor):
    if not parts:
        return ScalarQuadraticApproximation.zeros(
            nx, nu, dtype=like.dtype, device=like.device
        )
    total = parts[0]
    for q in parts[1:]:
        total = total + q
    return total


def quadratize_running_cost(problem, t, dt, x, u, p, jump_mask):
    """Term-structured quadratization of one node's running cost.

    Structured terms (quad_approx — closed-form quadratics, Gauss-Newton
    penalty terms) are summed analytically; only the remaining plain
    callables go through generic forward-over-reverse AD.
    """
    nu = u.shape[0]
    s_xu, p_xu = _split_terms(problem.cost_terms)
    s_x, p_x = _split_terms(problem.state_cost_terms)

    parts = [_scale_quad(term.quad_approx(t, x, u, p), dt) for term in s_xu]
    parts += [
        _scale_quad(_pad_state_quad(term.quad_approx(t, x, p), nu), dt)
        for term in s_x
    ]

    if p_xu or p_x or problem.pre_jump_cost_terms:

        def plain_cost(xx, uu):
            run = torch.zeros((), dtype=x.dtype, device=x.device)
            for term in p_xu:
                run = run + term(t, xx, uu, p)
            for term in p_x:
                run = run + term(t, xx, p)
            run = dt * run
            if problem.pre_jump_cost_terms:
                run = run + jump_mask * problem.pre_jump_cost(t, xx, p)
            return run

        parts.append(quadratize_scalar(plain_cost, x, u))

    return _sum_quads(parts, x.shape[0], nu, x)


def quadratize_final_cost(problem, t, x, p, nu: int):
    """Term-structured quadratization of the terminal cost (zero u blocks)."""
    s_f, p_f = _split_terms(problem.final_cost_terms)
    parts = [_pad_state_quad(term.quad_approx(t, x, p), nu) for term in s_f]
    if p_f:

        def plain_cost(xx):
            run = torch.zeros((), dtype=x.dtype, device=x.device)
            for term in p_f:
                run = run + term(t, xx, p)
            return run

        parts.append(quadratize_state_scalar(plain_cost, x, nu))
    return _sum_quads(parts, x.shape[0], nu, x)


def node_params(params: Any, grid: TimeGrid, k):
    """Inject the per-node mode and node index into the (dict) parameter
    pytree — consumed by mode-switched dynamics and by augmented-Lagrangian
    terms gathering their multiplier row.  ``k`` is an int, an index tensor
    of one node, or an index tensor of many nodes (then ``mode`` and ``node``
    are tensors over those nodes).  ``grid`` holds tensors (TimeGrid.device)."""
    if isinstance(params, dict):
        p = dict(params)
        p["mode"] = grid.modes[k]
        p["node"] = k
        return p
    return params


def example_params(params: Any, device="cuda"):
    """Params with a mode and a node index of node 0 injected, for probing
    constraint dimensions (shapes only)."""
    if isinstance(params, dict):
        p = dict(params)
        p["mode"] = torch.zeros((), dtype=torch.int64, device=device)
        p["node"] = torch.zeros((), dtype=torch.int64, device=device)
        return p
    return params


def _vector_fields(prefix, v: VectorLinearApproximation, out: dict):
    out[prefix + "_f"] = v.f
    out[prefix + "_dfdx"] = v.dfdx
    if v.dfdu is not None:
        out[prefix + "_dfdu"] = v.dfdu


def _vector_from(prefix, out: dict) -> Optional[VectorLinearApproximation]:
    if prefix + "_f" not in out:
        return None
    return VectorLinearApproximation(
        f=out[prefix + "_f"], dfdx=out[prefix + "_dfdx"],
        dfdu=out.get(prefix + "_dfdu"),
    )


# Calls of approximate_lq by the path they took: "kernel", the problem's
# hand-written kernel (K10, models/legged_robot/lq_kernel), or "generic".
path_counts = {"kernel": 0, "generic": 0}
# The kernel's calls by the variant that computed them (``lq_kernel.variant``):
# K10's "soft" (the friction cone a relaxed barrier in the cost) or "hard"
# (the cone an inequality, its rows written as ``ineq``).
variant_counts = {"soft": 0, "hard": 0}


def kernel_takes(problem: OptimalControlProblem, params: Any, method: str, substeps: int,
                 device, dtype) -> bool:
    """Whether ``problem.lq_kernel`` computes exactly this call: the problem
    still has the terms the kernel was made for, no per-scenario parameters
    (an "al" entry is read by no term of such a problem), tensors in float32
    on a CUDA device, and the integrator the kernel implements, in one
    step."""
    kernel = problem.lq_kernel
    return (
        kernel is not None
        and kernel.computes(problem)
        and not (isinstance(params, dict) and "scenario" in params)
        and torch.device(device).type == "cuda"
        and dtype == torch.float32
        and method.lower() == kernel.method
        and substeps == 1
    )


def approximate_lq(
    problem: OptimalControlProblem,
    grid: TimeGrid,
    xs: Tensor,  # [B, N+1, nx]
    us: Tensor,  # [B, N, nu]
    params: Any,
    method: str = "rk4",
    substeps: int = 1,
) -> LQData:
    """Full-horizon LQ approximation of a batch of trajectories.  ``params``
    is shared by the scenarios except the entries named in
    PER_SCENARIO_KEYS, whose leaves carry a leading [B].  Computed by the
    problem's kernel where ``kernel_takes`` holds, else by the generic
    mapped evaluation; both give the same LQData."""
    same = xs.device == us.device and xs.dtype == us.dtype
    if same and kernel_takes(problem, params, method, substeps, xs.device, xs.dtype):
        path_counts["kernel"] += 1
        variant_counts[problem.lq_kernel.variant] += 1
        return problem.lq_kernel.approximate(grid, xs, us, params)
    path_counts["generic"] += 1
    return _approximate_lq_generic(problem, grid, xs, us, params, method, substeps)


def _approximate_lq_generic(
    problem: OptimalControlProblem,
    grid: TimeGrid,
    xs: Tensor,
    us: Tensor,
    params: Any,
    method: str = "rk4",
    substeps: int = 1,
) -> LQData:
    """``approximate_lq`` of any problem in one mapped evaluation: ``vmap``
    over scenarios and nodes of ``jacfwd`` of the discrete step, the terms'
    closed-form or Gauss-Newton quadratizations and ``jacrev`` of the
    constraints."""
    grid = grid.device(xs.device)
    n = grid.num_intervals
    nx, nu = problem.nx, problem.nu
    eye_x = torch.eye(nx, dtype=xs.dtype, device=xs.device)

    if isinstance(params, dict):
        shared = {k: v for k, v in params.items() if k not in PER_SCENARIO_KEYS}
        per_scenario = {k: v for k, v in params.items() if k in PER_SCENARIO_KEYS}
    else:
        shared, per_scenario = params, {}

    def scenario(xs_b, us_b, p_b):
        p_all = dict(shared, **p_b) if isinstance(shared, dict) else shared

        def intermediate(k, t, t1, x, u, m):
            dt = t1 - t
            p = node_params(p_all, grid, k)
            p_next = node_params(p_all, grid, k + 1)

            # Discrete transition: integration step or jump map, selected by
            # mask.  Both branches are evaluated; no divergent control flow.
            flow = discretize(
                lambda tt, xx, uu: problem.dynamics(tt, xx, uu, p), method, substeps
            )
            x_int = flow(t, x, u, dt)
            a_int = torch.func.jacfwd(lambda xx: flow(t, xx, u, dt))(x).to(x.dtype)
            b_int = torch.func.jacfwd(lambda uu: flow(t, x, uu, dt))(u).to(x.dtype)
            if problem.jump_map is None:
                x_jmp, a_jmp = x, eye_x
            else:
                x_jmp = problem.apply_jump(t, x, p_next)
                a_jmp = torch.func.jacfwd(
                    lambda xx: problem.apply_jump(t, xx, p_next)
                )(x).to(x.dtype)
            out = {
                "dyn_f": (1.0 - m) * x_int + m * x_jmp,
                "dyn_dfdx": (1.0 - m) * a_int + m * a_jmp,
                "dyn_dfdu": (1.0 - m) * b_int,
            }

            # Running cost, dt-weighted; pre-jump cost on jump transitions.
            cost = quadratize_running_cost(problem, t, dt, x, u, p, m)
            out.update({"cost_" + k_: v for k_, v in cost._asdict().items()})

            if problem.equality_terms:
                _vector_fields("eq", linearize_vector(
                    lambda xx, uu: problem.equality(t, xx, uu, p), x, u), out)
            if problem.inequality_terms:
                _vector_fields("ineq", linearize_vector(
                    lambda xx, uu: problem.inequality(t, xx, uu, p), x, u), out)
            if problem.state_equality_terms:
                _vector_fields("seq", linearize_vector(
                    lambda xx: problem.state_equality(t, xx, p), x, None), out)
            if problem.state_inequality_terms:
                _vector_fields("sineq", linearize_vector(
                    lambda xx: problem.state_inequality(t, xx, p), x, None), out)
            return out

        out = torch.func.vmap(intermediate)(
            torch.arange(n, device=xs.device), grid.times[:-1], grid.times[1:],
            xs_b[:-1], us_b, grid.is_jump,
        )

        # Terminal node.
        tN = grid.times[n]
        xN = xs_b[n]
        pN = node_params(p_all, grid, n)
        cost_f = quadratize_final_cost(problem, tN, xN, pN, nu)
        for k_, v in cost_f._asdict().items():
            out["cost_" + k_] = torch.cat([out["cost_" + k_], v[None]], dim=0)
        if problem.state_equality_terms:
            last = linearize_vector(
                lambda xx: problem.state_equality(tN, xx, pN), xN, None)
            for k_ in ("f", "dfdx"):
                out["seq_" + k_] = torch.cat(
                    [out["seq_" + k_], getattr(last, k_)[None]], dim=0)
        if problem.state_inequality_terms:
            last = linearize_vector(
                lambda xx: problem.state_inequality(tN, xx, pN), xN, None)
            for k_ in ("f", "dfdx"):
                out["sineq_" + k_] = torch.cat(
                    [out["sineq_" + k_], getattr(last, k_)[None]], dim=0)
        if problem.final_equality_terms:
            _vector_fields("feq", linearize_vector(
                lambda xx: problem.final_equality(tN, xx, pN), xN, None), out)
        return out

    if per_scenario:
        out = torch.func.vmap(scenario)(xs, us, per_scenario)
    else:
        out = torch.func.vmap(lambda a, b: scenario(a, b, {}))(xs, us)

    return LQData(
        cost=ScalarQuadraticApproximation(
            **{k_: out["cost_" + k_] for k_ in ScalarQuadraticApproximation._fields}
        ),
        dynamics=DiscreteTransition(
            f=out["dyn_f"], dfdx=out["dyn_dfdx"], dfdu=out["dyn_dfdu"]
        ),
        eq=_vector_from("eq", out),
        state_eq=_vector_from("seq", out),
        ineq=_vector_from("ineq", out),
        state_ineq=_vector_from("sineq", out),
        final_eq=_vector_from("feq", out),
    )


def approximate_lq_ct(
    problem: OptimalControlProblem,
    grid: TimeGrid,
    xs: Tensor,  # [B, N+1, nx]
    us: Tensor,  # [B, N, nu]
    params: Any,
):
    """Continuous-time LQ data of a batch for the SLQ backward pass: per node
    the linearization A = df/dx, B = df/du of the flow (not of its
    discretization) and the running-cost RATE quadratization (dt = 1, no jump
    term), the input at node N repeating the last one; per interval the
    jump-map linearization (post-jump params) and the pre-jump cost quadratic
    (dt = 0, jump mask 1); the terminal quadratic.  Returns
    ``ops.riccati_ct.CtLqCoeffs`` with leaves [B, ...] and the grid's shared
    ``times`` / ``is_jump``, WITHOUT the Hessian correction (callers
    convexify).  ``params`` as in ``approximate_lq``."""
    from ..ops.riccati_ct import CtLqCoeffs

    grid = grid.device(xs.device)
    n = grid.num_intervals
    nu = problem.nu

    if isinstance(params, dict):
        shared = {k: v for k, v in params.items() if k not in PER_SCENARIO_KEYS}
        per_scenario = {k: v for k, v in params.items() if k in PER_SCENARIO_KEYS}
    else:
        shared, per_scenario = params, {}

    def scenario(xs_b, us_b, p_b):
        p_all = dict(shared, **p_b) if isinstance(shared, dict) else shared
        us_ext = torch.cat([us_b, us_b[-1:]], dim=0)  # value at node N

        def node(k, t, x, u):
            p = node_params(p_all, grid, k)
            a = torch.func.jacfwd(lambda xx: problem.dynamics(t, xx, u, p))(x).to(x.dtype)
            b = torch.func.jacfwd(lambda uu: problem.dynamics(t, x, uu, p))(u).to(x.dtype)
            rate = quadratize_running_cost(problem, t, 1.0, x, u, p, 0.0)
            return a, b, rate.dfdxx, rate.dfdx, rate.dfduu, rate.dfdu, rate.dfdux

        def jump(k, t, x, u):
            p_next = node_params(p_all, grid, k + 1)
            aj = torch.func.jacfwd(lambda xx: problem.apply_jump(t, xx, p_next))(x).to(x.dtype)
            pj = quadratize_running_cost(
                problem, t, 0.0, x, u, node_params(p_all, grid, k), 1.0)
            return aj, pj.dfdxx, pj.dfdx

        nodes = torch.arange(n + 1, device=xs.device)
        a_n, b_n, qm, qv, rm, rv, pm = torch.func.vmap(node)(nodes, grid.times, xs_b, us_ext)
        a_j, q_j, qv_j = torch.func.vmap(jump)(
            nodes[:-1], grid.times[:-1], xs_b[:-1], us_b)
        cost_f = quadratize_final_cost(
            problem, grid.times[n], xs_b[n], node_params(p_all, grid, n), nu)
        return a_n, b_n, qm, qv, rm, rv, pm, a_j, q_j, qv_j, cost_f.dfdxx, cost_f.dfdx

    if per_scenario:
        out = torch.func.vmap(scenario)(xs, us, per_scenario)
    else:
        out = torch.func.vmap(lambda a, b: scenario(a, b, {}))(xs, us)
    out = [leaf.contiguous() for leaf in out]
    return CtLqCoeffs(*out, times=grid.times.contiguous(), is_jump=grid.is_jump.contiguous())
