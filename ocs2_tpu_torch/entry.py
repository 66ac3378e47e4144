"""Entry points of the flagship step and of the multi-device dry run.

Counterpart of the repository's ``__graft_entry__.py``:

* ``entry(device)`` -> ``(step, (x0,))``: one legged-robot trot SQP solve at
  N = 32 (``step(x0)`` returns ``(xs, us, cost)``);
* ``dryrun_multichip(n_devices, devices)``: a scenario batch split over an
  n-device mesh, the horizon-sharded PIPG QP on a time mesh, and an SQP solve
  that selects that QP through ``SqpSettings(qp_solver="pipg_sharded")``.
"""
from __future__ import annotations

import numpy as np
import torch


def _flagship(num_intervals: int, horizon: float = 1.0, device="cuda"):
    """The flagship problem (SRBD legged robot, trot, rk2, 10 SQP iterations
    at most) and its step; returns ``(step, x0)``."""
    from .models.legged_robot import interface, model
    from .models.legged_robot.gait import GaitSchedule, trot_gait
    from .oc.time_discretization import make_time_grid
    from .solvers import sqp

    problem = interface.make_problem(device=device)
    ms = GaitSchedule(trot_gait(0.7)).mode_schedule(0.0, horizon)
    grid = make_time_grid(
        0.0, horizon, num_intervals,
        event_times=np.asarray(ms.event_times), mode_sequence=np.asarray(ms.mode_sequence))
    params = interface.make_params(grid, device=device)
    u0 = model.weight_compensating_input(np.ones(4), device)
    us_init = u0[None].expand(num_intervals, u0.shape[0])
    settings = sqp.SqpSettings(max_iterations=10, integrator="rk2")

    def step(x0, params=params, us_init=us_init):
        """One SQP solve from x0 [nx] (results without a batch dim, as the JAX
        step's) or from a batch x0 [B, nx]."""
        x0 = torch.as_tensor(x0, dtype=torch.float32, device=device)
        sol = sqp.solve(problem, grid, x0, params, us_init=us_init, settings=settings,
                        device=device)
        out = (sol.xs, sol.us, sol.performance.cost)
        return tuple(o[0] for o in out) if x0.ndim == 1 else out

    return step, model.default_state(device)


def entry(device="cuda"):
    """The flagship step at N = 32 and its example arguments."""
    step, x0 = _flagship(num_intervals=32, device=device)
    return step, (x0,)


def dryrun_qp_coeffs(n_devices: int, device="cuda"):
    """The dry run's QP: 4 n_devices random stages (nx = 6, nu = 3, A = 0.95 I,
    positive-definite costs) from a seeded ``torch.Generator``, a batch of
    one."""
    from .ops.riccati import LqrCoeffs

    n, nx, nu = 4 * n_devices, 6, 3
    gen = torch.Generator().manual_seed(0)
    normal = lambda *shape: torch.randn(shape, generator=gen)  # noqa: E731
    eye = torch.eye(nx)

    def psd(d, cnt):
        m = normal(cnt, d, d) * 0.1
        return m @ m.transpose(1, 2) + torch.eye(d)[None]

    coeffs = LqrCoeffs(
        A=eye[None].repeat(n, 1, 1) * 0.95, B=normal(n, nx, nu) * 0.3, b=normal(n, nx) * 0.05,
        Qxx=psd(nx, n), qx=torch.zeros((n, nx)), Quu=psd(nu, n), qu=torch.zeros((n, nu)),
        Qux=torch.zeros((n, nu, nx)), Qf=eye, qf=torch.ones((nx,)),
    )
    return LqrCoeffs(*(leaf[None].to(device) for leaf in coeffs))


def dryrun_sqp(n_devices: int, device="cuda", **settings):
    """The dry run's SQP solve: the ballbot leaning 0.05 rad over 0.5 s at
    N = 2 n_devices, 2 iterations, PIPG of 100 iterations (``settings`` pick
    the QP back end)."""
    from .models import ballbot
    from .oc.time_discretization import uniform_grid
    from .solvers import sqp

    st = sqp.SqpSettings(max_iterations=2, pipg_iterations=100, use_feedback_policy=False,
                         **settings)
    x0 = torch.zeros(ballbot.NX)
    x0[3] = 0.05
    return sqp.solve(ballbot.make_problem(device=device), uniform_grid(0.0, 0.5, 2 * n_devices),
                     x0, ballbot.make_params(device=device), settings=st, device=device)


def dryrun_multichip(n_devices: int, devices=None) -> dict:
    """The multi-device path end to end on small shapes: ``devices`` (by
    default the first ``n_devices`` CUDA devices; a device may repeat) hold
    one shard each.  Raises if a result is not finite; returns the three
    results (the scenario batch's costs, the sharded QP's states and
    residual, the SQP solve)."""
    from .models.legged_robot import model
    from .ops.pipg import PipgSettings, ruiz_equilibrate
    from .parallel.horizon import pipg_solve_horizon_sharded
    from .parallel.mesh import Mesh, make_mesh, sharded

    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(min(n_devices, torch.cuda.device_count()))]
    devices = [torch.device(d) for d in devices]
    assert len(devices) == n_devices, f"need {n_devices} devices, have {len(devices)}"
    mesh = make_mesh(devices)

    # The scenario axis: a batch of flagship solves split over the mesh, each
    # chunk solved by the step built on its own device.
    # (Keyed by the device a tensor sent there reports: "cpu:0" holds "cpu".)
    steps = {}
    for dev in devices:
        home = torch.empty(0, device=dev).device
        if home not in steps:
            steps[home] = _flagship(num_intervals=8, horizon=0.5, device=dev)[0]
    x0 = model.default_state(devices[0])
    run = sharded(lambda x: steps[x.device](x), mesh)
    batch = 2 * n_devices
    x0s = x0[None].repeat(batch, 1) + 0.01 * torch.arange(
        batch, dtype=torch.float32, device=devices[0])[:, None]
    xs, us, cost = run(x0s)
    assert xs.shape[0] == batch
    assert bool(torch.isfinite(cost).all()), "non-finite cost in dryrun"

    # The time axis: the horizon-sharded PIPG QP on random stages.
    tmesh = Mesh(tuple(devices), ("time",))
    scaled, scal = ruiz_equilibrate(dryrun_qp_coeffs(n_devices, devices[0]), 3)
    sol = pipg_solve_horizon_sharded(scaled, tmesh, PipgSettings(num_iterations=200))
    dxs = scal.d_x * sol.dxs
    assert bool(torch.isfinite(dxs).all()), "non-finite horizon-sharded QP"

    # The same time mesh through a user-facing solver setting.
    bsol = dryrun_sqp(n_devices, devices[0], qp_solver="pipg_sharded", time_mesh=tmesh)
    assert bool(torch.isfinite(bsol.xs).all()), "non-finite sharded-QP SQP"
    return {"scenario_cost": cost, "qp_dxs": dxs, "qp_residual": sol.primal_residual,
            "sqp": bsol}
