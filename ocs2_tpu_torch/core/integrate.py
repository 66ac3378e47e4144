"""Fixed-step ODE integration and discretization.

Counterpart of ``ocs2_tpu/core/integrate.py`` (euler / rk2 / rk4 steps,
``discretize``, ``DiscreteTransition``, ``trapezoidal``).  The discrete
sensitivities A = dx_{k+1}/dx_k, B = dx_{k+1}/du_k are ``torch.func.jacfwd``
of the discrete step (see ``oc/approx.py``).  The steps are plain tensor
arithmetic, so they work on one sample and on ``[..., nx]`` batches alike.
The adaptive ODE45 stepper is not ported yet.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

Tensor = torch.Tensor
# Continuous dynamics signature: f(t, x, u) -> dx/dt.
ContinuousDynamics = Callable[[Tensor, Tensor, Tensor], Tensor]
# Discrete step signature: step(t, x, u, dt) -> x_next.
DiscreteStep = Callable[[Tensor, Tensor, Tensor, Tensor], Tensor]


def euler_step(f: ContinuousDynamics, t, x, u, dt):
    return x + dt * f(t, x, u)


def rk2_step(f: ContinuousDynamics, t, x, u, dt):
    """Explicit midpoint rule."""
    k1 = f(t, x, u)
    k2 = f(t + 0.5 * dt, x + 0.5 * dt * k1, u)
    return x + dt * k2


def rk4_step(f: ContinuousDynamics, t, x, u, dt):
    k1 = f(t, x, u)
    k2 = f(t + 0.5 * dt, x + 0.5 * dt * k1, u)
    k3 = f(t + 0.5 * dt, x + 0.5 * dt * k2, u)
    k4 = f(t + dt, x + dt * k3, u)
    return x + (dt / 6.0) * (k1 + 2.0 * k2 + 2.0 * k3 + k4)


_STEPPERS = {"euler": euler_step, "rk2": rk2_step, "rk4": rk4_step}


def discretize(
    f: ContinuousDynamics, method: str = "rk4", substeps: int = 1
) -> DiscreteStep:
    """Build a discrete step x_{k+1} = F(t_k, x_k, u_k, dt) from continuous f.
    ``substeps`` subdivides dt (zero-order-hold input)."""
    if method.lower() == "ode45":
        raise NotImplementedError(
            "the adaptive ode45 stepper is not ported yet; use euler/rk2/rk4"
        )
    stepper = _STEPPERS[method.lower()]

    def step(t, x, u, dt):
        h = dt / substeps
        for i in range(substeps):
            x = stepper(f, t + i * h, x, u, h)
        return x

    return step


class DiscreteTransition(NamedTuple):
    """One discretized transition with sensitivities:
    x_next ~= f + dfdx @ dx + dfdu @ du."""

    f: Tensor  # x_{k+1}            [nx]
    dfdx: Tensor  # d x_{k+1} / d x_k  [nx, nx]
    dfdu: Tensor  # d x_{k+1} / d u_k  [nx, nu]


def trapezoidal(values: Tensor, ts: Tensor) -> Tensor:
    """Trapezoidal quadrature of samples values [M, ...] over grid ts [M]."""
    dts = ts[1:] - ts[:-1]
    dts = dts.reshape(dts.shape + (1,) * (values.ndim - 1))
    return torch.sum(0.5 * dts * (values[1:] + values[:-1]), dim=0)
