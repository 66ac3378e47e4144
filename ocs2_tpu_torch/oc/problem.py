"""Optimal-control problem definition as a frozen dataclass of pure functions.

Counterpart of ``ocs2_tpu/oc/problem.py``.

Signatures (p is the user parameter dict — targets, gait, model constants):
    dynamics(t, x, u, p)            -> dx/dt               (continuous flow map)
    cost(t, x, u, p)                -> scalar cost *rate*  (integrated over dt)
    state_cost(t, x, p)             -> scalar cost rate
    final_cost(t, x, p)             -> scalar
    pre_jump_cost(t, x, p)          -> scalar              (at event nodes)
    jump_map(t, x, p)               -> x_post              (state at mode switch)
    equality(t, x, u, p)            -> [ne]   g(t,x,u) = 0 (projectable)
    state_equality(t, x, p)         -> [nse]  g(t,x)   = 0
    inequality(t, x, u, p)          -> [ni]   h(t,x,u) >= 0
    state_inequality(t, x, p)       -> [nsi]  h(t,x)   >= 0
    final_equality(t, x, p)         -> [nfe]

Every callable is batch-polymorphic: ``x`` is ``[..., nx]``, ``u`` is
``[..., nu]``, ``t`` broadcasts against the leading dims; a scalar result is
``[...]`` and a vector result ``[..., m]``.  The LQ approximator calls them on
one sample under ``torch.func`` transforms, the rollout and the trajectory
evaluation on whole batches.  So: index along the last axis, build outputs
with ``torch.cat`` / ``torch.stack(..., dim=-1)``, do not branch on values and
do not write in place.  Prefer width-1 slices ``x[..., i:i+1]`` to selects
``x[..., i]``: on one sample a select is a 0-dim tensor, and under
``torch.func.jacfwd`` arithmetic between a 0-dim tensor and a Python float is
promoted to float64 (the LQ approximator casts its Jacobians back, but the
node then computes in double).  ``quad_approx`` methods are per-sample only.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Tuple

import numpy as np
import torch

from ..core.types import ScalarQuadraticApproximation

Tensor = torch.Tensor
CostFn = Callable[..., Tensor]
ConstraintFn = Callable[..., Tensor]


def _sum_terms(terms: Tuple[CostFn, ...], *args):
    if not terms:
        return 0.0
    total = terms[0](*args)
    for t in terms[1:]:
        total = total + t(*args)
    return total


def _as_rows(out: Tensor, x: Tensor) -> Tensor:
    """A term that yields one scalar per sample ([...]) becomes [..., 1]."""
    return out.unsqueeze(-1) if out.ndim == x.ndim - 1 else out


def _cat_terms(terms: Tuple[ConstraintFn, ...], *args) -> Optional[Tensor]:
    if not terms:
        return None
    x = args[1]
    return torch.cat([_as_rows(t(*args), x) for t in terms], dim=-1)


def _quad_form(m: Tensor, d: Tensor) -> Tensor:
    """d' m d over the last axis of d [..., n]."""
    return torch.sum(d * (d @ m.T), dim=-1)


@dataclasses.dataclass(frozen=True)
class OptimalControlProblem:
    """Problem ingredients (term tuples sum / concatenate on evaluation)."""

    dynamics: Callable
    cost_terms: Tuple[CostFn, ...] = ()
    state_cost_terms: Tuple[CostFn, ...] = ()
    final_cost_terms: Tuple[CostFn, ...] = ()
    pre_jump_cost_terms: Tuple[CostFn, ...] = ()
    equality_terms: Tuple[ConstraintFn, ...] = ()
    state_equality_terms: Tuple[ConstraintFn, ...] = ()
    inequality_terms: Tuple[ConstraintFn, ...] = ()
    state_inequality_terms: Tuple[ConstraintFn, ...] = ()
    final_equality_terms: Tuple[ConstraintFn, ...] = ()
    jump_map: Optional[Callable] = None
    # Static model dimensions.
    nx: int = 0
    nu: int = 0
    # A hand-written kernel of the whole LQ approximation, set by a model's
    # constructor for exactly the terms above (``oc/approx.kernel_takes``:
    # it serves a problem only while its terms are those it was made for,
    # so ``add`` and ``solvers/al.augment_problem`` leave it unused once
    # they add a term).
    lq_kernel: Any = None

    # -- fused evaluators ---------------------------------------------------
    def cost(self, t, x, u, p):
        return _sum_terms(self.cost_terms, t, x, u, p) + _sum_terms(
            self.state_cost_terms, t, x, p
        )

    def final_cost(self, t, x, p):
        return _sum_terms(self.final_cost_terms, t, x, p)

    def pre_jump_cost(self, t, x, p):
        return _sum_terms(self.pre_jump_cost_terms, t, x, p)

    def equality(self, t, x, u, p) -> Optional[Tensor]:
        return _cat_terms(self.equality_terms, t, x, u, p)

    def state_equality(self, t, x, p) -> Optional[Tensor]:
        return _cat_terms(self.state_equality_terms, t, x, p)

    def inequality(self, t, x, u, p) -> Optional[Tensor]:
        return _cat_terms(self.inequality_terms, t, x, u, p)

    def state_inequality(self, t, x, p) -> Optional[Tensor]:
        return _cat_terms(self.state_inequality_terms, t, x, p)

    def final_equality(self, t, x, p) -> Optional[Tensor]:
        return _cat_terms(self.final_equality_terms, t, x, p)

    def apply_jump(self, t, x, p) -> Tensor:
        if self.jump_map is None:
            return x
        return self.jump_map(t, x, p)

    # -- constraint dimensions (static, from one evaluation on zeros) -------
    def constraint_dims(self, p_example: Any, device="cuda") -> dict:
        t = torch.zeros((), device=device)
        x = torch.zeros((self.nx,), device=device)
        u = torch.zeros((self.nu,), device=device)

        def dim(fn, with_u):
            args = (t, x, u, p_example) if with_u else (t, x, p_example)
            out = fn(*args)
            return 0 if out is None else out.shape[0]

        return {
            "ne": dim(self.equality, True),
            "nse": dim(self.state_equality, False),
            "ni": dim(self.inequality, True),
            "nsi": dim(self.state_inequality, False),
            "nfe": dim(self.final_equality, False),
        }

    # -- structure queries ----------------------------------------------------
    @property
    def cost_structure_psd(self) -> bool:
        """True when every cost term carries a PSD quadratization by
        construction (quadratic tracking terms, Gauss-Newton penalty terms
        with convex penalties) — then the LQ subproblem is convex without any
        Hessian correction.  Plain callables go through exact AD and may
        produce indefinite Hessians, as may pre-jump cost terms."""
        if self.pre_jump_cost_terms:
            return False
        terms = self.cost_terms + self.state_cost_terms + self.final_cost_terms
        return all(getattr(t, "psd_quadratization", False) for t in terms)

    # -- extension ----------------------------------------------------------
    def add(self, **kwargs) -> "OptimalControlProblem":
        """Return a copy with term tuples extended, e.g.
        problem.add(cost_terms=(my_cost,), inequality_terms=(cone,))."""
        updates = {}
        for key, val in kwargs.items():
            cur = getattr(self, key)
            if isinstance(cur, tuple):
                updates[key] = cur + tuple(val)
            else:
                updates[key] = val
        return dataclasses.replace(self, **updates)


# --------------------------------------------------------------------------
# Structured cost terms (term-wise quadratization).
#
# A cost term may expose ``quad_approx(t, x, u, p)`` (or ``(t, x, p)`` for
# state-only terms) returning a ScalarQuadraticApproximation.  The LQ
# approximator (oc/approx.py) sums structured approximations in closed form
# and only runs generic AD on the remaining plain callables.
# --------------------------------------------------------------------------


def _weights(m, device) -> Tensor:
    return torch.as_tensor(np.asarray(m, np.float32), device=device)


class QuadraticTrackingCost:
    """Tracking cost 0.5 (x-x*)'Q(x-x*) + 0.5 (u-u*)'R(u-u*).

    The target is read from params[target_key] (a TargetTrajectories).
    Closed-form quadratization."""

    psd_quadratization = True  # Q, R assumed PSD

    def __init__(self, Q, R, target_key: str = "target", device="cuda"):
        self.Q = _weights(Q, device)
        self.R = _weights(R, device)
        self.target_key = target_key

    def _deltas(self, t, x, u, p):
        tt = p[self.target_key]
        return x - tt.state_at(t), u - tt.input_at(t)

    def __call__(self, t, x, u, p):
        dx, du = self._deltas(t, x, u, p)
        return 0.5 * _quad_form(self.Q, dx) + 0.5 * _quad_form(self.R, du)

    def quad_approx(self, t, x, u, p):
        dx, du = self._deltas(t, x, u, p)
        qx = dx @ self.Q.T
        ru = du @ self.R.T
        return ScalarQuadraticApproximation(
            f=0.5 * torch.sum(dx * qx, -1) + 0.5 * torch.sum(du * ru, -1),
            dfdx=qx,
            dfdu=ru,
            dfdxx=self.Q,
            dfdux=torch.zeros(
                (u.shape[-1], x.shape[-1]), dtype=x.dtype, device=x.device
            ),
            dfduu=self.R,
        )


def quadratic_cost(Q, R, target_key: str = "target", device="cuda"):
    return QuadraticTrackingCost(Q, R, target_key, device=device)


class QuadraticStateCost:
    """0.5 (x-x*)'Qf(x-x*) — state-only / final tracking, closed form."""

    psd_quadratization = True  # Qf assumed PSD

    def __init__(self, Qf, target_key: str = "target", device="cuda"):
        self.Qf = _weights(Qf, device)
        self.target_key = target_key

    def __call__(self, t, x, p):
        dx = x - p[self.target_key].state_at(t)
        return 0.5 * _quad_form(self.Qf, dx)

    def quad_approx(self, t, x, p):
        dx = x - p[self.target_key].state_at(t)
        qx = dx @ self.Qf.T
        return ScalarQuadraticApproximation(
            f=0.5 * torch.sum(dx * qx, -1), dfdx=qx, dfdu=None,
            dfdxx=self.Qf, dfdux=None, dfduu=None,
        )


def quadratic_final_cost(Qf, target_key: str = "target", device="cuda"):
    return QuadraticStateCost(Qf, target_key, device=device)


class GaussNewtonCost:
    """Penalty-of-constraint cost  sum_i phi_i(g_i(t,x,u,p))  with
    Gauss-Newton quadratization:  grad = J'phi',  Hess = J' diag(phi'') J
    (constraint curvature dropped).

    ``penalty_fn(h, p) -> PenaltyValue`` may read parameters (e.g. AL
    multipliers) from p.  The constraint Jacobian is computed with jacrev —
    one reverse pass per constraint row.
    """

    # J' diag(phi'') J with phi'' >= 0 (all shipped penalties are convex).
    psd_quadratization = True

    def __init__(self, g_fn, penalty_fn, with_input: bool = True):
        self.g_fn = g_fn
        self.penalty_fn = penalty_fn
        self.with_input = with_input

    def __call__(self, *args):
        p = args[-1]
        h = _as_rows(self.g_fn(*args), args[1])
        return torch.sum(self.penalty_fn(h, p).value, dim=-1)

    def quad_approx(self, *args):
        p = args[-1]
        if self.with_input:
            t, x, u, _ = args
            nx = x.shape[0]
            z = torch.cat([x, u])
            gz = lambda zz: torch.atleast_1d(  # noqa: E731
                self.g_fn(t, zz[:nx], zz[nx:], p)
            )
        else:
            t, x, _ = args
            z = x
            gz = lambda zz: torch.atleast_1d(self.g_fn(t, zz, p))  # noqa: E731
        g = gz(z)
        jac = torch.func.jacrev(gz)(z)  # [ng, nz]
        pv = self.penalty_fn(g, p)
        grad = jac.T @ pv.first
        hess = (jac * pv.second[:, None]).T @ jac
        f = torch.sum(pv.value)
        if not self.with_input:
            return ScalarQuadraticApproximation(
                f=f, dfdx=grad, dfdu=None, dfdxx=hess, dfdux=None, dfduu=None
            )
        nx = args[1].shape[0]
        return ScalarQuadraticApproximation(
            f=f,
            dfdx=grad[:nx],
            dfdu=grad[nx:],
            dfdxx=hess[:nx, :nx],
            dfdux=hess[nx:, :nx],
            dfduu=hess[nx:, nx:],
        )


class ResidualGaussNewtonCost:
    """Weighted-residual cost  0.5 ||sqrt(w) * r(t,x,u,p)||^2  with the
    Gauss-Newton quadratization  grad = J'(w*r),  Hess = J' diag(w) J
    (residual curvature dropped)."""

    psd_quadratization = True  # J' diag(w) J with w >= 0

    def __init__(self, residual_fn, weights, with_input: bool = True, device="cuda"):
        self.residual_fn = residual_fn
        self.weights = _weights(weights, device)
        self.with_input = with_input

    def __call__(self, *args):
        r = _as_rows(self.residual_fn(*args), args[1])
        return 0.5 * torch.sum(self.weights * r * r, dim=-1)

    def quad_approx(self, *args):
        p = args[-1]
        if self.with_input:
            t, x, u, _ = args
            nx = x.shape[0]
            z = torch.cat([x, u])
            rz = lambda zz: torch.atleast_1d(  # noqa: E731
                self.residual_fn(t, zz[:nx], zz[nx:], p)
            )
        else:
            t, x, _ = args
            z = x
            rz = lambda zz: torch.atleast_1d(self.residual_fn(t, zz, p))  # noqa: E731
        r = rz(z)
        jac = torch.func.jacrev(rz)(z)  # [nr, nz]
        grad = jac.T @ (self.weights * r)
        hess = (jac * self.weights[:, None]).T @ jac
        f = 0.5 * torch.sum(self.weights * r * r)
        if not self.with_input:
            return ScalarQuadraticApproximation(
                f=f, dfdx=grad, dfdu=None, dfdxx=hess, dfdux=None, dfduu=None
            )
        nx = args[1].shape[0]
        return ScalarQuadraticApproximation(
            f=f,
            dfdx=grad[:nx],
            dfdu=grad[nx:],
            dfdxx=hess[:nx, :nx],
            dfdux=hess[nx:, :nx],
            dfduu=hess[nx:, nx:],
        )


# --------------------------------------------------------------------------
# Common term constructors.
# --------------------------------------------------------------------------


def soft_constraint(constraint_fn: ConstraintFn, penalty, with_input: bool = True):
    """Fold an inequality constraint h >= 0 into a cost term via a penalty
    (``core/penalties``).  Returns a structured Gauss-Newton term, which
    keeps ``penalty`` as ``term.penalty``."""
    term = GaussNewtonCost(
        constraint_fn, lambda h, p: penalty(h), with_input=with_input
    )
    term.penalty = penalty
    return term


def soft_box_input_constraint(lower, upper, penalty, device="cuda"):
    """Soft input box bounds lower <= u <= upper."""
    lower = _weights(lower, device)
    upper = _weights(upper, device)

    def cost(t, x, u, p):
        del t, x, p
        return torch.sum(penalty(u - lower).value, dim=-1) + torch.sum(
            penalty(upper - u).value, dim=-1
        )

    return cost
