"""State-triggered rollout: guard-surface event detection during simulation.

Counterpart of ``ocs2_tpu/oc/hybrid_rollout.py``.  A loop over fixed control
steps where each step

  1. integrates dt with RK4 (4 substeps),
  2. detects a guard sign change (guard > 0 inside a mode, crossing at 0),
  3. refines the crossing time with a fixed number of bisection iterations,
  4. applies the jump map at the refined state and integrates the remainder
     of the step in the new mode.

At most one event per step is resolved; choose dt below the minimum
inter-event spacing.  The state may carry leading scenario dims
(x0 [..., nx], modes [...]).  Where the reference selects the event branch
with ``lax.cond`` (both branches evaluated under ``vmap``), the port reads
once per step whether any scenario crossed and computes the event branch
only then; the branch's results are taken per scenario by ``torch.where``,
so a batch gets what each scenario gets alone.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from ..core.integrate import discretize

Tensor = torch.Tensor


class HybridSystem(NamedTuple):
    """Mode-indexed hybrid system.

    dynamics(t, x, u, p, mode) -> dx/dt
    guard(t, x, p, mode) -> [...], positive inside the mode, crossing at 0
    jump(t, x, p, mode) -> (x_post, next_mode)
    """

    dynamics: Callable
    guard: Callable
    jump: Callable


class HybridTrajectory(NamedTuple):
    times: Tensor  # [N+1]
    xs: Tensor  # [..., N+1, nx]
    modes: Tensor  # [..., N+1] int64
    event_mask: Tensor  # [..., N] 1.0 where an event fired inside the step
    event_times: Tensor  # [..., N] refined crossing times (t+dt where no event)


def rollout_state_triggered(
    system: HybridSystem,
    t0,
    x0: Tensor,
    policy: Callable[[Tensor, Tensor, int], Tensor],  # (t, x, k) -> u
    dt: float,
    num_steps: int,
    params,
    mode0=0,
    substeps: int = 4,
    bisection_iters: int = 24,
) -> HybridTrajectory:
    """Roll ``policy`` through the guarded system from x0 [..., nx] at time
    t0 (shared) in ``num_steps`` steps of ``dt``; one host read per step."""
    dtype, dev = x0.dtype, x0.device
    batch_shape = x0.shape[:-1]
    mode = torch.as_tensor(mode0, device=dev).to(torch.int64).expand(batch_shape)

    def flow(t, x, u, md, h):
        f = discretize(lambda tt, xx, uu: system.dynamics(tt, xx, uu, params, md), "rk4", substeps)
        return f(t, x, u, h)

    def col(mask):
        return mask.unsqueeze(-1)

    t = torch.as_tensor(t0, dtype=dtype, device=dev)
    x = x0
    times, xs, modes, masks, etimes = [t], [x0], [mode], [], []
    for k in range(num_steps):
        u = policy(t, x, k)
        x_end = flow(t, x, u, mode, dt)
        g0 = system.guard(t, x, params, mode)
        g1 = system.guard(t + dt, x_end, params, mode)
        crossed = (g0 > 0.0) & (g1 <= 0.0)
        x_next, mode_next, t_event = x_end, mode, (t + dt).expand(batch_shape)
        if bool(crossed.any()):  # the step's one host read
            # Bisection on tau in [0, dt] for guard(flow(tau)) = 0.
            lo = torch.zeros(batch_shape, dtype=dtype, device=dev)
            hi = torch.full(batch_shape, dt, dtype=dtype, device=dev)
            for _ in range(bisection_iters):
                mid = 0.5 * (lo + hi)
                xm = flow(t, x, u, mode, col(mid))
                gm = system.guard(t + mid, xm, params, mode)
                lo, hi = torch.where(gm > 0.0, mid, lo), torch.where(gm > 0.0, hi, mid)
            tau = 0.5 * (lo + hi)
            x_event = flow(t, x, u, mode, col(tau))
            x_post, mode_jump = system.jump(t + tau, x_event, params, mode)
            mode_jump = torch.as_tensor(mode_jump, device=dev).to(torch.int64)
            x_rest = flow(t + tau, x_post, u, mode_jump, col(dt - tau))
            x_next = torch.where(col(crossed), x_rest, x_end)
            mode_next = torch.where(crossed, mode_jump, mode)
            t_event = torch.where(crossed, t + tau, t_event)
        t = t + dt
        x, mode = x_next, mode_next
        times.append(t)
        xs.append(x)
        modes.append(mode)
        masks.append(crossed.to(dtype))
        etimes.append(t_event)
    return HybridTrajectory(
        times=torch.stack(times),
        xs=torch.stack(xs, dim=-2),
        modes=torch.stack(modes, dim=-1),
        event_mask=torch.stack(masks, dim=-1),
        event_times=torch.stack(etimes, dim=-1),
    )
