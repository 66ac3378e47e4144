"""Solver-solution query API: value function and Hamiltonian at arbitrary
(t, x[, u]).

Counterpart of ``ocs2_tpu/oc/queries.py``.  Every solver solution carries the
Riccati value function (value_S [N+1, nx, nx], value_s [N+1, nx]) in DELTA
coordinates around the solution trajectory; these helpers interpolate it onto
arbitrary query times and assemble the quadratic expansions.  They take one
scenario's arrays (a solver's result indexed at its scenario).  Derivatives
are ``torch.func.grad`` / ``jacfwd``.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from ..core.interpolation import interpolate
from ..core.types import ScalarQuadraticApproximation
from .approx import node_params
from .problem import OptimalControlProblem
from .time_discretization import TimeGrid

Tensor = torch.Tensor


class ValueFunctionQuery(NamedTuple):
    """V(t, x) ~ f + dfdx'(x - x_nom) + 1/2 (x - x_nom)' dfdxx (x - x_nom),
    reported at the queried x (f evaluated, gradient at x)."""

    f: Tensor  # V(t, x)
    dfdx: Tensor  # dV/dx at (t, x)
    dfdxx: Tensor  # d2V/dx2 (constant in the quadratic model)


def _times(grid: TimeGrid, like: Tensor) -> Tensor:
    return torch.as_tensor(grid.times, dtype=torch.float32, device=like.device)


def value_function(
    grid: TimeGrid, xs: Tensor, value_S: Tensor, value_s: Tensor, t, x: Tensor
) -> ValueFunctionQuery:
    """Quadratic cost-to-go at an arbitrary (t, x): (S, s, x_nom)
    interpolated onto t and expanded around the nominal trajectory,
    V = s'dx + 1/2 dx'S dx with dx = x - x_nom(t) (the absolute constant is
    dropped: values compare within one solve)."""
    times = _times(grid, xs)
    s_mat = interpolate(times, value_S, t)
    s_vec = interpolate(times, value_s, t)
    x_nom = interpolate(times, xs, t)
    dx = x - x_nom
    sdx = s_mat @ dx
    return ValueFunctionQuery(
        f=torch.dot(s_vec, dx) + 0.5 * torch.dot(dx, sdx),
        dfdx=s_vec + sdx,
        dfdxx=s_mat,
    )


def hamiltonian(
    problem: OptimalControlProblem,
    grid: TimeGrid,
    xs: Tensor,
    value_S: Tensor,
    value_s: Tensor,
    t,
    x: Tensor,
    u: Tensor,
    params: Any,
) -> Tensor:
    """Control Hamiltonian H(t, x, u) = L(t, x, u) + dV/dx(t, x)' f(t, x, u).

    L is the problem's running cost (with the node's mode injected from the
    grid) and dV/dx comes from the interpolated quadratic value model."""
    times = _times(grid, xs)
    t = torch.as_tensor(t, dtype=torch.float32, device=xs.device)
    k = torch.clamp(
        torch.searchsorted(times, t, right=True) - 1, 0, grid.num_intervals - 1
    )
    p = node_params(params, grid.device(xs.device), k)
    lagrangian = problem.cost(t, x, u, p)
    vx = value_function(grid, xs, value_S, value_s, t, x).dfdx
    xdot = problem.dynamics(t, x, u, p)
    return lagrangian + torch.dot(vx, xdot)


def hamiltonian_approx(
    problem: OptimalControlProblem,
    grid: TimeGrid,
    xs: Tensor,
    value_S: Tensor,
    value_s: Tensor,
    t,
    x: Tensor,
    u: Tensor,
    params: Any,
) -> ScalarQuadraticApproximation:
    """Quadratic expansion of H in (x, u) at the query point, from the
    gradient and the jacfwd-of-grad Hessian of the exact H above."""
    nx = x.shape[0]
    z = torch.cat([x, u])

    def hz(zz):
        return hamiltonian(
            problem, grid, xs, value_S, value_s, t, zz[:nx], zz[nx:], params
        )

    g = torch.func.grad(hz)(z)
    h_mat = torch.func.jacfwd(torch.func.grad(hz))(z)
    return ScalarQuadraticApproximation(
        f=hz(z),
        dfdx=g[:nx],
        dfdu=g[nx:],
        dfdxx=h_mat[:nx, :nx],
        dfdux=h_mat[nx:, :nx],
        dfduu=h_mat[nx:, nx:],
    )
