"""ODE integration (fixed-step and adaptive) and discretization.

Counterpart of ``ocs2_tpu/core/integrate.py``: the euler / rk2 / rk4 steps,
the adaptive Dormand-Prince 5(4) stepper (``integrate_adaptive``,
``ode45_step``, ``discretize("ode45")``), ``sensitivity_step``,
``integrate_trajectory`` and ``trapezoidal``.  The discrete sensitivities
A = dx_{k+1}/dx_k, B = dx_{k+1}/du_k are ``torch.func.jacfwd`` of the discrete
step.  The fixed steps are plain tensor arithmetic, so they work on one sample
and on ``[..., nx]`` batches alike.

The reference's adaptive stepper is a ``lax.while_loop``; ``torch.func``
cannot trace a loop whose length depends on the data, so the port runs all
``max_steps`` attempts and masks the finished ones with ``torch.where`` (a
finished attempt is a no-op, so the numbers are the reference's), which keeps
it differentiable by ``jacfwd`` and mappable by ``vmap``.
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


# Dormand-Prince 5(4) tableau (the reference's ODE45).
_DP_C = (0.0, 1 / 5, 3 / 10, 4 / 5, 8 / 9, 1.0, 1.0)
_DP_A = (
    (),
    (1 / 5,),
    (3 / 40, 9 / 40),
    (44 / 45, -56 / 15, 32 / 9),
    (19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729),
    (9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176, -5103 / 18656),
    (35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84),
)
_DP_B5 = (35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84, 0.0)
_DP_B4 = (
    5179 / 57600, 0.0, 7571 / 16695, 393 / 640, -92097 / 339200, 187 / 2100,
    1 / 40,
)


def _dp_stages(f, t, x, u, h):
    """One Dormand-Prince step: (5th-order solution, embedded error)."""
    ks = []
    for i in range(7):
        xi = x
        for j, a in enumerate(_DP_A[i]):
            xi = xi + h * a * ks[j]
        ks.append(f(t + _DP_C[i] * h, xi, u))
    x5 = x
    x4 = x
    for i in range(7):
        x5 = x5 + h * _DP_B5[i] * ks[i]
        x4 = x4 + h * _DP_B4[i] * ks[i]
    return x5, x5 - x4


def integrate_adaptive(
    f: ContinuousDynamics,
    t0,
    x0: Tensor,
    u: Tensor,
    dt,
    rtol: float = 1e-6,
    atol: float = 1e-8,
    max_steps: int = 64,
):
    """Adaptive Dormand-Prince 5(4) over one interval [t0, t0 + dt] with
    zero-order-hold input (one sample: x0 [nx]).  The step controller is
    h <- h * clip(0.9 e^(-1/5), 0.2, 5); a rejected step shrinks h and
    retries.  All ``max_steps`` attempts run, an attempt after the interval
    is covered changing nothing; if the attempts run out first, the tail is
    finished with one step (conservative).  Returns x(t0 + dt)."""
    as_t = lambda v: (v.to(x0.dtype) if isinstance(v, torch.Tensor)  # noqa: E731
                      else torch.tensor(v, dtype=x0.dtype, device=x0.device))
    dt, t0 = as_t(dt), as_t(t0)
    t_end = t0 + dt
    t, x, h = t0, x0, dt
    for _ in range(max_steps):
        running = t < t_end - 1e-12
        h_try = torch.minimum(h, t_end - t)
        x_new, err = _dp_stages(f, t, x, u, h_try)
        tol = atol + rtol * torch.maximum(torch.amax(torch.abs(x)), torch.amax(torch.abs(x_new)))
        e = torch.amax(torch.abs(err)) / tol
        accept = e <= 1.0
        factor = torch.clamp(0.9 * (torch.clamp(e, min=1e-10) ** -0.2), 0.2, 5.0)
        h_next = torch.minimum(torch.maximum(h_try * factor, dt / (8.0 * max_steps)), dt)
        take = running & accept
        t = torch.where(take, t + h_try, t)
        x = torch.where(take, x_new, x)
        h = torch.where(running, h_next, h)
    x_tail, _ = _dp_stages(f, t, x, u, torch.clamp(t_end - t, min=0.0))
    return torch.where(t < t_end - 1e-12, x_tail, x)


def ode45_step(f: ContinuousDynamics, rtol=1e-6, atol=1e-8, max_steps=64):
    """DiscreteStep adapter: step(t, x, u, dt) via adaptive DP5(4)."""

    def step(t, x, u, dt):
        return integrate_adaptive(f, t, x, u, dt, rtol, atol, max_steps)

    return step


def discretize(
    f: ContinuousDynamics, method: str = "rk4", substeps: int = 1
) -> DiscreteStep:
    """Build a discrete step x_{k+1} = F(t_k, x_k, u_k, dt) from continuous f.
    ``substeps`` subdivides dt (zero-order-hold input); method="ode45"
    selects the adaptive Dormand-Prince 5(4) stepper (one sample, no
    substeps)."""
    if method.lower() == "ode45":
        return ode45_step(f)
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


def sensitivity_step(step: DiscreteStep) -> Callable[..., DiscreteTransition]:
    """Discrete dynamics + exact Jacobians (``jacfwd``) of one sample."""

    def run(t, x, u, dt):
        f = step(t, x, u, dt)
        dfdx = torch.func.jacfwd(lambda xx: step(t, xx, u, dt))(x)
        dfdu = torch.func.jacfwd(lambda uu: step(t, x, uu, dt))(u)
        return DiscreteTransition(f=f, dfdx=dfdx, dfdu=dfdu)

    return run


def integrate_trajectory(
    f: ContinuousDynamics,
    x0: Tensor,
    ts: Tensor,
    us: Tensor,
    method: str = "rk4",
    substeps: int = 1,
) -> Tensor:
    """Integrate x' = f(t,x,u) over grid ts [N+1] with ZOH inputs us [N, nu];
    returns states [N+1, nx]."""
    step = discretize(f, method, substeps)
    xs = [x0]
    for k in range(ts.shape[0] - 1):
        xs.append(step(ts[k], xs[-1], us[k], ts[k + 1] - ts[k]))
    return torch.stack(xs, dim=0)


def trapezoidal(values: Tensor, ts: Tensor) -> Tensor:
    """Trapezoidal quadrature of samples values [M, ...] over grid ts [M]."""
    dts = ts[1:] - ts[:-1]
    dts = dts.reshape(dts.shape + (1,) * (values.ndim - 1))
    return torch.sum(0.5 * dts * (values[1:] + values[:-1]), dim=0)
