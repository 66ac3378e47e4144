"""Loopshaping: frequency-domain cost shaping via input-filter augmentation.

Counterpart of ``ocs2_tpu/oc/loopshaping.py`` (the reference's
ocs2_core/loopshaping/: LoopshapingDefinition.h with its two patterns, the
dynamics, cost and constraint wrappers, and the property-tree loader
LoopshapingPropertyTree.h).

Loopshaping is one function from problem to problem: the augmented state is
x_aug = (x, xi) with xi the input filter's state,

    xi' = A xi + B v,   u = C xi + D v,

and every original term is evaluated at (x, u(xi, v)).  No wrapper objects
exist at run time: the wrapped terms are plain closures, so the LQ
approximation takes them through exact AD and ``cost_structure_psd`` of a
wrapped problem is False, as in the JAX package (SQP then runs its Hessian
correction).

Every closure is batch-polymorphic like the problem's own callables
(``x [..., nx]``): the state splits along the last axis and the filter's
matrices act from the right (``xi @ A.T``).  The definition's matrices live
on the device of the problem they wrap.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from .problem import OptimalControlProblem

Tensor = torch.Tensor


class LoopshapingDefinition(NamedTuple):
    """Input-filter state space (reference LoopshapingDefinition.h).

    A [nf, nf], B [nf, nv], C [nu, nf], D [nu, nv].  R_v is an optional
    quadratic penalty on the filtered input v (the shaping weight).
    """

    A: Tensor
    B: Tensor
    C: Tensor
    D: Tensor
    R_v: Optional[Tensor] = None

    @property
    def num_filter_states(self) -> int:
        return self.A.shape[0]

    @property
    def num_filtered_inputs(self) -> int:
        return self.B.shape[1]

    def filter_input(self, xi: Tensor, v: Tensor) -> Tensor:
        """Plant input u = C xi + D v (LoopshapingDefinition::getSystemInput)."""
        return xi @ self.C.T + v @ self.D.T

    def equilibrium_filter_state(self, u: Tensor) -> Tensor:
        """xi with C xi = u for the steady plant input u [..., nu]: the
        least-squares solution when C is not square.  By ``lstsq``'s QR
        driver ``gels`` on either device (on the card it takes C with at
        least as many rows as columns, at full rank)."""
        c = self.C.expand(*u.shape[:-1], *self.C.shape)
        return torch.linalg.lstsq(c, u[..., None], driver="gels").solution[..., 0]


def first_order_filter(
    nu: int, pole: float, zero: float, gain: float = 1.0, dtype=torch.float32,
    device="cuda",
) -> LoopshapingDefinition:
    """Diagonal first-order shaping filter s -> gain*(s+zero)/(s+pole) per
    input channel (the common configuration in the reference's loopshaping
    .info files)."""
    eye = torch.eye(nu, dtype=dtype, device=device)
    return LoopshapingDefinition(
        A=-pole * eye,
        B=eye,
        C=gain * (zero - pole) * eye,
        D=gain * eye,
    )


def augment_observation(defn: LoopshapingDefinition, x: Tensor, u: Tensor) -> Tensor:
    """(x, u) -> x_aug for warm starts / initial conditions."""
    return torch.cat([x, defn.equilibrium_filter_state(u)], dim=-1)


def split_state(defn: LoopshapingDefinition, x_aug: Tensor):
    nf = defn.num_filter_states
    return x_aug[..., :-nf], x_aug[..., -nf:]


def _half_quad(m: Tensor, y: Tensor) -> Tensor:
    """1/2 y' m y over the last axis of y [..., n]."""
    return 0.5 * torch.sum(y * (y @ m.T), dim=-1)


def _wrap_x(nx: int, term):
    def fn(t, xa, p):
        return term(t, xa[..., :nx], p)

    return fn


def _jump_map(problem: OptimalControlProblem, nx: int):
    """The plant's jump; the filter state passes a jump unchanged."""
    if problem.jump_map is None:
        return None

    def jump_map(t, xa, p):
        return torch.cat([problem.apply_jump(t, xa[..., :nx], p), xa[..., nx:]], dim=-1)

    return jump_map


def wrap_problem_r_filter(
    problem: OptimalControlProblem,
    defn: LoopshapingDefinition,
) -> OptimalControlProblem:
    """The reference's outputpattern (r_filter route,
    LoopshapingPropertyTree.cpp:154: the system inputs remain the inputs of
    the augmented system):

        x_aug = [x, xi],  xi' = A xi + B u,   input stays u,
        extra cost  1/2 y' R_v y  with  y = C xi + D u  (getFilteredInput).

    Every original cost and constraint term sees (x, u) as before (same
    classification, same u-Jacobians: the projection and AL machinery are
    those of the unshaped problem); only the dynamics gain the filter block
    and the cost gains the filtered-output penalty."""
    nx, nf = problem.nx, defn.num_filter_states
    assert defn.R_v is not None, "r_filter pattern needs the shaping weight R_v"

    def dynamics(t, xa, u, p):
        x, xi = xa[..., :nx], xa[..., nx:]
        dx = problem.dynamics(t, x, u, p)
        dxi = xi @ defn.A.T + u @ defn.B.T
        return torch.cat([dx, dxi], dim=-1)

    def wrap_xu(term):
        def fn(t, xa, u, p):
            return term(t, xa[..., :nx], u, p)

        return fn

    def shaping_cost(t, xa, u, p):
        return _half_quad(defn.R_v, xa[..., nx:] @ defn.C.T + u @ defn.D.T)

    wrap_x = lambda term: _wrap_x(nx, term)  # noqa: E731
    return dataclasses.replace(
        problem,
        dynamics=dynamics,
        nx=nx + nf,
        cost_terms=tuple(wrap_xu(c) for c in problem.cost_terms) + (shaping_cost,),
        state_cost_terms=tuple(wrap_x(c) for c in problem.state_cost_terms),
        pre_jump_cost_terms=tuple(wrap_x(c) for c in problem.pre_jump_cost_terms),
        final_cost_terms=tuple(wrap_x(c) for c in problem.final_cost_terms),
        equality_terms=tuple(wrap_xu(g) for g in problem.equality_terms),
        inequality_terms=tuple(wrap_xu(g) for g in problem.inequality_terms),
        state_equality_terms=tuple(wrap_x(g) for g in problem.state_equality_terms),
        state_inequality_terms=tuple(wrap_x(g) for g in problem.state_inequality_terms),
        final_equality_terms=tuple(wrap_x(g) for g in problem.final_equality_terms),
        jump_map=_jump_map(problem, nx),
    )


def wrap_problem(
    problem: OptimalControlProblem,
    defn: LoopshapingDefinition,
    pattern: str = "output",  # "output" | "eliminate"
) -> OptimalControlProblem:
    """Loopshaping augmentation as a problem-to-problem transform.

    Returns a problem with nx + nf states and nv inputs whose solutions,
    restricted to the plant block, solve the shaped control problem.

    pattern="output": u = C xi + D v (reference outputPattern); original
    terms keep their state-input classification.
    pattern="eliminate" (reference eliminatePattern, requires D = 0): the
    plant input is a function of the filter state alone, u = C xi, so every
    original state-input cost or constraint becomes a state-only term of the
    augmented problem, which keeps the projection and AL machinery
    rank-correct (a state-input constraint with an all-zero v-Jacobian would
    break the QR null-space projection)."""
    nx, nf = problem.nx, defn.num_filter_states
    nv = defn.num_filtered_inputs
    if pattern not in ("output", "eliminate"):
        raise ValueError(f"unknown loopshaping pattern {pattern!r}")
    eliminate = pattern == "eliminate"
    if eliminate:
        if not np.allclose(defn.D.detach().cpu().numpy(), 0.0):
            raise AssertionError("eliminate pattern requires a strictly proper filter (D = 0)")
        if defn.R_v is None:
            raise AssertionError(
                "eliminate pattern needs R_v: with every original cost now state-only, "
                "the shaping penalty is the ONLY input cost (otherwise Quu is singular)"
            )

    def split(xa, v):
        x, xi = xa[..., :nx], xa[..., nx:]
        return x, xi, defn.filter_input(xi, v)

    def dynamics(t, xa, v, p):
        x, xi, u = split(xa, v)
        dx = problem.dynamics(t, x, u, p)
        dxi = xi @ defn.A.T + v @ defn.B.T
        return torch.cat([dx, dxi], dim=-1)

    def wrap_xu(term):
        def fn(t, xa, v, p):
            x, _, u = split(xa, v)
            return term(t, x, u, p)

        return fn

    extra_cost = ()
    if defn.R_v is not None:

        def shaping_cost(t, xa, v, p):
            return _half_quad(defn.R_v, v)

        extra_cost = (shaping_cost,)

    def as_state_term(term):
        """Eliminate pattern: a state-input term of the original problem is
        a state term of the augmented one, u = C xi."""

        def fn(t, xa, p):
            return term(t, xa[..., :nx], xa[..., nx:] @ defn.C.T, p)

        return fn

    wrap_x = lambda term: _wrap_x(nx, term)  # noqa: E731
    common = dict(
        dynamics=dynamics,
        nx=nx + nf,
        nu=nv,
        pre_jump_cost_terms=tuple(wrap_x(c) for c in problem.pre_jump_cost_terms),
        final_cost_terms=tuple(wrap_x(c) for c in problem.final_cost_terms),
        final_equality_terms=tuple(wrap_x(g) for g in problem.final_equality_terms),
        jump_map=_jump_map(problem, nx),
    )
    if eliminate:
        return dataclasses.replace(
            problem,
            cost_terms=extra_cost,
            state_cost_terms=tuple(as_state_term(c) for c in problem.cost_terms)
            + tuple(wrap_x(c) for c in problem.state_cost_terms),
            equality_terms=(),
            inequality_terms=(),
            state_equality_terms=tuple(as_state_term(g) for g in problem.equality_terms)
            + tuple(wrap_x(g) for g in problem.state_equality_terms),
            state_inequality_terms=tuple(as_state_term(g) for g in problem.inequality_terms)
            + tuple(wrap_x(g) for g in problem.state_inequality_terms),
            **common,
        )
    return dataclasses.replace(
        problem,
        cost_terms=tuple(wrap_xu(c) for c in problem.cost_terms) + extra_cost,
        state_cost_terms=tuple(wrap_x(c) for c in problem.state_cost_terms),
        equality_terms=tuple(wrap_xu(g) for g in problem.equality_terms),
        inequality_terms=tuple(wrap_xu(g) for g in problem.inequality_terms),
        state_equality_terms=tuple(wrap_x(g) for g in problem.state_equality_terms),
        state_inequality_terms=tuple(wrap_x(g) for g in problem.state_inequality_terms),
        **common,
    )


def load_loopshaping_info(source: str, device="cuda") -> tuple:
    """Load a reference loopshaping ``.info`` file into a
    (LoopshapingDefinition, pattern) pair, the analogue of
    LoopshapingPropertyTree.cpp:143-160:

    * an ``r_filter`` section -> the outputpattern (use with
      wrap_problem_r_filter: filter driven by u, shaping cost on y),
    * an ``s_inv_filter`` section -> the eliminatepattern with the INVERTED
      filter (use with wrap_problem: u = C xi + D v).

    Each filter is a concatenation of SISO first-order sections
    (numFilters / FilterK { numRepeats, scaling, zeros { (0) z }, poles
    { (0) p } }); only the 1-pole/1-zero sections the shipped configs use
    are supported.  ``source`` is the .info text or a path; the matrices are
    float32 tensors on ``device``.
    """
    from ..utils.config import load_info, parse_info

    tree = parse_info(source) if "\n" in source or "{" in source else load_info(source)

    def read_mimo(section: str, invert: bool):
        sec = tree.get(section)
        if not sec:
            return None
        k = int(float(sec.get("numFilters", 0)))
        gains, poles, zeros = [], [], []
        for i in range(k):
            f = sec[f"Filter{i}"]
            reps = int(float(f.get("numRepeats", 1)))
            g = float(f.get("scaling", 1.0))
            z = float(f["zeros"]["(0)"]) if "zeros" in f else 0.0
            p_ = float(f["poles"]["(0)"]) if "poles" in f else 0.0
            gains += [g] * reps
            poles += [p_] * reps
            zeros += [z] * reps
        g = np.asarray(gains)
        p_ = -np.asarray(poles)  # the .info stores the pole location (negative)
        z = -np.asarray(zeros)
        if invert:
            # invert H = g (s+z)/(s+p)  ->  (1/g)(s+p)/(s+z).
            g, p_, z = 1.0 / g, z, p_
        n = len(g)

        def f32(m):
            return torch.as_tensor(np.asarray(m, np.float32), device=device)

        # Realization of H(s) = g (s+z)/(s+p): A=-p, B=1, C=g(z-p), D=g.
        return LoopshapingDefinition(
            A=f32(np.diag(-p_)),
            B=f32(np.eye(n)),
            C=f32(np.diag(g * (z - p_))),
            D=f32(np.diag(g)),
            R_v=f32(np.eye(n)),  # default costMatrix identity
        )

    r = read_mimo("r_filter", invert=False)
    s = read_mimo("s_inv_filter", invert=True)
    if r is not None and s is not None:
        raise ValueError("using both r and s filter not implemented")
    if r is not None:
        return r, "output"
    if s is not None:
        return s, "eliminate"
    raise ValueError("no valid loopshaping filter found")
