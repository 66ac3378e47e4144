#!/usr/bin/env python3
"""The legged MPC closed loop of ``chip_smoke.py`` (phase
``legged_mpc_closed_loop``) in the JAX package, on the CPU.

    JAX_PLATFORMS=cpu python3 tools/legged_closed_loop_reference.py \\
        [--compare closed_loop.json]

``ocs2_tpu.mpc`` runs ``dummy_loop`` over the same MPC as the chip phase:
SRBD legged robot, trot 0.7 s, N = 100 over 1 s,
``SqpSettings(max_iterations=10, integrator="rk2")``, 400 Hz control, 50 Hz
MPC, from the default state, for ``chip_smoke.MPC_DURATION`` (0.2 s).  Prints one JSON line: the SQP
iterations of every tick and the largest deviation of the base height from
``STAND_HEIGHT``.  With ``--compare`` (the file ``chip_smoke.py
--closed-loop-out`` writes on the card) it also gives the ticks whose
iterations agree and the largest state difference over the loop.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--compare", metavar="JSON", help="the port's closed-loop record")
    args = ap.parse_args()

    import jax

    jax.config.update("jax_platforms", "cpu")
    import chip_smoke
    from ocs2_tpu.models.legged_robot import gait, interface, model
    from ocs2_tpu.mpc import mpc, mrt
    from ocs2_tpu.oc.time_discretization import make_time_grid
    from ocs2_tpu.solvers import sqp

    n, horizon = chip_smoke.LEGGED_N, chip_smoke.LEGGED_HORIZON
    ms = gait.GaitSchedule(gait.trot_gait(0.7)).mode_schedule(0.0, horizon)
    grid = make_time_grid(0.0, horizon, n, event_times=np.asarray(ms.event_times),
                          mode_sequence=np.asarray(ms.mode_sequence))
    ref_mpc = mpc.Mpc(
        interface.make_problem(), interface.make_params(grid),
        mpc.MpcSettings(time_horizon=horizon, num_intervals=n, solver="sqp"),
        solver_settings=sqp.SqpSettings(max_iterations=10, integrator="rk2"),
        reference_manager=interface.SwitchedModelReferenceManager(
            gait.GaitSchedule(gait.trot_gait(0.7))))
    its = []
    solve = ref_mpc._jitted

    def counted(*a):
        sol, ctrl = solve(*a)
        its.append(int(sol.iterations))
        return sol, ctrl

    ref_mpc._jitted = counted
    t0 = time.perf_counter()
    _, xs, _ = mrt.dummy_loop(
        mrt.MpcMrtInterface(ref_mpc), model.default_state(), duration=chip_smoke.MPC_DURATION,
        mrt_frequency=chip_smoke.MRT_HZ, mpc_frequency=chip_smoke.MPC_HZ)
    xs = np.asarray(xs)
    rec = {
        "reference": "ocs2_tpu (JAX, CPU)", "ticks": len(its), "iterations_per_tick": its,
        "base_height_max_abs_dev": float(np.abs(xs[:, 8] - model.STAND_HEIGHT).max()),
        "base_height_final": float(xs[-1, 8]), "stand_height": model.STAND_HEIGHT,
        "seconds_cpu": time.perf_counter() - t0,
    }
    if args.compare:
        with open(args.compare) as f:
            port = json.load(f)
        p_xs = np.asarray(port["states"], np.float32)
        assert p_xs.shape == xs.shape, (p_xs.shape, xs.shape)
        p_its = port["iterations_per_tick"]
        rec["port"] = {
            "iterations_per_tick": p_its,
            "ticks_with_equal_iterations": int(sum(a == b for a, b in zip(its, p_its))),
            "max_abs_state_difference": float(np.abs(p_xs - xs).max()),
            "base_height_max_abs_dev": float(np.abs(p_xs[:, 8] - model.STAND_HEIGHT).max()),
        }
    print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
