"""Scalar penalty functions for soft constraints and augmented Lagrangians.

Counterpart of ``ocs2_tpu/core/penalties.py``.  Each penalty is a pure
function h -> (value, dh, ddh) evaluated elementwise on constraint values;
the solver folds them into the cost quadratic via the chain rule.

Sign convention: inequality constraints are written ``g(x, u) >= 0`` and the
penalty pushes g up.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, NamedTuple

import torch

Tensor = torch.Tensor


class PenaltyValue(NamedTuple):
    value: Tensor  # penalty value, same shape as h
    first: Tensor  # d penalty / dh
    second: Tensor  # d^2 penalty / dh^2


Penalty = Callable[[Tensor], PenaltyValue]


def _with_derivatives(fn: Callable[[Tensor], Tensor], form: tuple) -> Penalty:
    """Lift a scalar penalty fn to (value, first, second) elementwise.

    ``fn`` is differentiated twice per element with ``torch.func.grad`` under
    ``torch.func.vmap``, so it must stay branch-free (``torch.where``).  The
    penalty keeps ``form``, its name and parameters, as ``penalty.form``: a
    kernel that evaluates the penalty in closed form reads them there."""

    d1 = torch.func.grad(fn)
    d2 = torch.func.grad(d1)

    def penalty(h: Tensor) -> PenaltyValue:
        flat = h.reshape(-1)
        v = torch.func.vmap(fn)(flat).reshape(h.shape)
        g = torch.func.vmap(d1)(flat).reshape(h.shape)
        gg = torch.func.vmap(d2)(flat).reshape(h.shape)
        return PenaltyValue(v, g, gg)

    penalty.form = form
    return penalty


def relaxed_barrier(mu: float = 1.0, delta: float = 1e-3) -> Penalty:
    """Relaxed log barrier: -mu ln(h) for h > delta, quadratic extension
    below delta (C2 continuous)."""

    def fn(h):
        log_branch = -mu * torch.log(torch.clamp(h, min=delta))
        quad_branch = mu * (
            0.5 * torch.square((h - 2.0 * delta) / delta) - 0.5 - math.log(delta)
        )
        return torch.where(h > delta, log_branch, quad_branch)

    return _with_derivatives(fn, ("relaxed_barrier", mu, delta))


def squared_hinge(mu: float = 1.0, delta: float = 0.0) -> Penalty:
    """0.5*mu*max(0, delta - h)^2."""

    def fn(h):
        return 0.5 * mu * torch.square(torch.clamp(delta - h, min=0.0))

    return _with_derivatives(fn, ("squared_hinge", mu, delta))


def quadratic(scale: float = 1.0) -> Penalty:
    """0.5*scale*h^2 — for equality-style soft constraints."""

    def fn(h):
        return 0.5 * scale * torch.square(h)

    return _with_derivatives(fn, ("quadratic", scale))


def smooth_absolute(scale: float = 1.0, relaxation: float = 1e-2) -> Penalty:
    """scale*(sqrt(h^2 + rel^2) - rel)."""

    def fn(h):
        return scale * (torch.sqrt(torch.square(h) + relaxation**2) - relaxation)

    return _with_derivatives(fn, ("smooth_absolute", scale, relaxation))


def double_sided(lower, upper, inner: Penalty) -> Penalty:
    """Apply ``inner`` to both h-lower >= 0 and upper-h >= 0."""

    def penalty(h: Tensor) -> PenaltyValue:
        lo = inner(h - lower)
        hi = inner(upper - h)
        return PenaltyValue(
            lo.value + hi.value, lo.first - hi.first, lo.second + hi.second
        )

    return penalty


# --------------------------------------------------------------------------
# Augmented-Lagrangian penalties.  These take (multiplier lambda, penalty
# scale rho, constraint value h) and produce the AL term; solvers also use
# them to update multipliers.
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class AugmentedPenalty:
    """Equality/inequality augmented-Lagrangian term.

    value(lmbd, rho, h): AL contribution added to the merit.
    derivatives(lmbd, rho, h): PenaltyValue (value, d/dh, d2/dh2) — consumed
      by the Gauss-Newton term quadratization (oc/problem.GaussNewtonCost).
    multiplier_update(lmbd, rho, h): next multiplier (dual ascent step).
    """

    value: Callable[[Tensor, Tensor, Tensor], Tensor]
    derivatives: Callable[[Tensor, Tensor, Tensor], PenaltyValue]
    multiplier_update: Callable[[Tensor, Tensor, Tensor], Tensor]


def al_quadratic_equality() -> AugmentedPenalty:
    """Standard AL for g(x,u)=0: -lmbd*h + 0.5*rho*h^2; lmbd <- lmbd - rho*h."""

    def value(lmbd, rho, h):
        return -lmbd * h + 0.5 * rho * torch.square(h)

    def derivatives(lmbd, rho, h):
        return PenaltyValue(
            value(lmbd, rho, h), rho * h - lmbd, rho * torch.ones_like(h)
        )

    return AugmentedPenalty(
        value=value,
        derivatives=derivatives,
        multiplier_update=lambda lmbd, rho, h: lmbd - rho * h,
    )


def al_hinge_inequality() -> AugmentedPenalty:
    """AL for g(x,u)>=0 via squared hinge on the shifted constraint.

    value = rho/2 * max(0, lmbd/rho - h)^2 - lmbd^2/(2 rho);
    lmbd <- max(0, lmbd - rho*h).
    """

    def value(lmbd, rho, h):
        return 0.5 * rho * torch.square(
            torch.clamp(lmbd / rho - h, min=0.0)
        ) - torch.square(lmbd) / (2.0 * rho)

    def derivatives(lmbd, rho, h):
        slack = torch.clamp(lmbd / rho - h, min=0.0)
        active = (slack > 0.0).to(h.dtype)
        return PenaltyValue(
            0.5 * rho * torch.square(slack) - torch.square(lmbd) / (2.0 * rho),
            -rho * slack,
            rho * active,
        )

    def update(lmbd, rho, h):
        return torch.clamp(lmbd - rho * h, min=0.0)

    return AugmentedPenalty(value=value, derivatives=derivatives, multiplier_update=update)


def modified_relaxed_barrier(mu: float = 1.0, delta: float = 1e-3) -> AugmentedPenalty:
    """Relaxed-barrier AL variant: barrier on h shifted by the multiplier
    estimate; multiplier follows the barrier gradient."""

    barrier = relaxed_barrier(mu, delta)

    def value(lmbd, rho, h):
        del rho
        return barrier(h).value - lmbd * h

    def derivatives(lmbd, rho, h):
        del rho
        b = barrier(h)
        return PenaltyValue(b.value - lmbd * h, b.first - lmbd, b.second)

    def update(lmbd, rho, h):
        del rho
        return torch.clamp(lmbd - barrier(h).first, min=0.0)

    return AugmentedPenalty(value=value, derivatives=derivatives, multiplier_update=update)
