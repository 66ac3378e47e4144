#!/usr/bin/env python3
"""The JAX package's DDP on the flagship legged problem, on the CPU: why the
port's SLQ lane on the card is the ballbot batch and not a legged DDP node.

    JAX_PLATFORMS=cpu python3 tools/legged_ddp_reference.py

Runs ``ocs2_tpu.solvers.ddp.solve`` (jitted) with ``algorithm="ilqr"`` and
with ``algorithm="slq"`` on ``chip_smoke.py``'s legged problem (SRBD, trot
0.7 s, N = 100 over 1 s, rk2, 15 iterations at most) from the default state
and the weight-compensating inputs, and prints one JSON line per algorithm:
iterations, convergence, and per iteration the merit, the constraint
violation (the foot constraint, which single shooting puts into the
augmented Lagrangian where SQP projects it) and whether the line search
accepted a step.  A few minutes, most of it compiling; imports only the JAX
package (and ``chip_smoke``'s constants).
"""
from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    import jax

    import chip_smoke
    from ocs2_tpu.models.legged_robot import gait, interface, model
    from ocs2_tpu.oc.time_discretization import make_time_grid
    from ocs2_tpu.solvers import ddp

    n, horizon = chip_smoke.LEGGED_N, chip_smoke.LEGGED_HORIZON
    ms = gait.GaitSchedule(gait.trot_gait(0.7)).mode_schedule(0.0, horizon)
    grid = make_time_grid(0.0, horizon, n, event_times=np.asarray(ms.event_times),
                          mode_sequence=np.asarray(ms.mode_sequence))
    params = interface.make_params(grid)
    problem = interface.make_problem()
    x0 = np.array(model.default_state(), np.float32)
    u0 = np.tile(np.asarray(model.weight_compensating_input(np.ones(4))), (n, 1))
    for algorithm in ("ilqr", "slq"):
        settings = ddp.DdpSettings(algorithm=algorithm, max_iterations=15, integrator="rk2")
        t0 = time.perf_counter()
        sol = jax.jit(lambda x, u: ddp.solve(problem, grid, x, params, us_init=u,
                                             settings=settings))(x0, u0)
        h = sol.history
        its = int(sol.iterations)
        print(json.dumps({
            "algorithm": algorithm, "iterations": its, "converged": bool(sol.converged),
            "merit": [float(v) for v in np.asarray(h.merit)[:its]],
            "constraint_violation": [float(v) for v in np.asarray(h.constraint_viol)[:its]],
            "step_accepted": [float(v) for v in np.asarray(h.step_accepted)[:its]],
            "final_merit": float(sol.performance.merit),
            "final_equality_sse": float(sol.performance.equality_constraints_sse),
            "seconds": time.perf_counter() - t0,
        }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
