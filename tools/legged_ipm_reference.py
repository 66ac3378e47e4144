#!/usr/bin/env python3
"""The interior-point lane of ``chip_smoke.py`` (phase ``legged_ipm_tick_b1``)
in the JAX package, on the CPU, and the witnesses of its zero-input fault.

    JAX_PLATFORMS=cpu python3 tools/legged_ipm_reference.py [--compare ipm.json]
    JAX_PLATFORMS=cpu python3 tools/legged_ipm_reference.py --zero-start

Default: ``ocs2_tpu.solvers.ipm.solve`` on the chip phase's problem (SRBD,
trot 0.7 s, N = 100 over 1 s, rk2, the hard friction cone as the barrier's
inequality, the foot constraint projected, ``IpmSettings(max_iterations=15)``):
the cold solve from the default state and the weight-compensating inputs,
then ``chip_smoke.IPM_CHAINS`` chains of ``IPM_TICKS_PER_CHAIN`` receding-horizon ticks, each starting at the solved
xs[1] and warm-started with the solved inputs.  Prints one JSON line: the
iterations, convergence, final mu and smallest stance slack of every solve.
With ``--compare`` (the file ``chip_smoke.py --ipm-out`` writes on the card)
it also gives the ticks whose iterations agree, the largest difference of the
ticks' states and of the cold solve's xs / us, and the merits.

``--zero-start``: the JAX package's IPM fails from zero inputs (zero contact
forces put every stance slack at its floor; ROADMAP.md §3).  Runs
(1) ``ipm.solve`` at N = 100 for 2 iterations from the default state and zero
inputs in the JAX package and in the port (``ocs2_tpu_torch``, CPU) and
compares where their slacks, gains and merits are NaN, element for element;
(2) the JAX package's ``Mpc(solver="ipm")`` in ``dummy_loop`` (N = 100,
0.3 s at 400 Hz control and 50 Hz MPC; its first tick cold-starts from zero
inputs) and prints every tick's iterations and the first tick after which
the state is NaN.  About four minutes, most of it compiling.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

ZERO_START_ITERATIONS = 2
LOOP_DURATION = 0.3


def _grid(make_time_grid, gait, n, horizon):
    ms = gait.GaitSchedule(gait.trot_gait(0.7)).mode_schedule(0.0, horizon)
    return make_time_grid(0.0, horizon, n, event_times=np.asarray(ms.event_times),
                          mode_sequence=np.asarray(ms.mode_sequence))


def _stance_slack_min(sol, grid, gait):
    stance = np.asarray(gait.contact_flags(np.asarray(grid.modes)[:-1, None])) > 0.5
    return float(np.asarray(sol.ipm.slack_ineq)[stance].min())


def chains(chip_smoke, compare):
    import jax

    from ocs2_tpu.models.legged_robot import gait, interface, model
    from ocs2_tpu.oc.time_discretization import make_time_grid
    from ocs2_tpu.solvers import ipm

    n, horizon = chip_smoke.LEGGED_N, chip_smoke.LEGGED_HORIZON
    grid = _grid(make_time_grid, gait, n, horizon)
    params = interface.make_params(grid)
    problem = interface.make_problem(friction_cone="hard")
    settings = ipm.IpmSettings(max_iterations=chip_smoke.IPM_MAX_ITERATIONS, integrator="rk2")
    solve = jax.jit(lambda x, u: ipm.solve(problem, grid, x, params, us_init=u,
                                           settings=settings))
    x0 = np.array(model.default_state(), np.float32)
    u0 = np.tile(np.asarray(model.weight_compensating_input(np.ones(4))), (n, 1))
    t0 = time.perf_counter()
    cold = solve(x0, u0)

    def summary(sol):
        return {"iterations": int(sol.iterations), "converged": bool(sol.converged),
                "mu": float(sol.ipm.mu), "merit": float(sol.performance.merit),
                "min_stance_slack": _stance_slack_min(sol, grid, gait)}

    x, us, starts, ticks = x0, u0, [], []
    for _ in range(chip_smoke.IPM_CHAINS):
        for _ in range(chip_smoke.IPM_TICKS_PER_CHAIN):
            starts.append(np.asarray(x))
            sol = solve(x, us)
            x, us = sol.xs[1], sol.us
            ticks.append(summary(sol))
    rec = {"reference": "ocs2_tpu (JAX, CPU)", "cold": summary(cold), "ticks": ticks,
           "iterations_per_tick": [t["iterations"] for t in ticks],
           "seconds_cpu": time.perf_counter() - t0}
    if compare:
        with open(compare) as f:
            port = json.load(f)
        p_starts = np.asarray(port["tick_states"], np.float32)
        p_its = port["iterations_per_tick"]
        its = rec["iterations_per_tick"]
        rec["port"] = {
            "cold_iterations": port["cold"]["iterations"],
            "cold_xs_max_abs_difference": float(np.abs(
                np.asarray(port["cold"]["xs"]) - np.asarray(cold.xs)).max()),
            "cold_us_max_abs_difference": float(np.abs(
                np.asarray(port["cold"]["us"]) - np.asarray(cold.us)).max()),
            "cold_merit": port["cold"]["merit"],
            "iterations_per_tick": p_its,
            "ticks_with_equal_iterations": int(sum(a == b for a, b in zip(its, p_its))),
            "max_abs_tick_state_difference": float(np.abs(p_starts - np.stack(starts)).max()),
            "final_state_max_abs_difference": float(np.abs(
                np.asarray(port["final_state"]) - np.asarray(x)).max()),
            "merit_max_rel_difference": float(max(
                abs(a - b["merit"]) / abs(b["merit"]) for a, b in zip(port["merit_per_tick"],
                                                                      ticks))),
        }
    return rec


def zero_start(chip_smoke):
    import jax
    import torch

    from ocs2_tpu.models.legged_robot import gait, interface, model
    from ocs2_tpu.mpc import mpc, mrt
    from ocs2_tpu.oc.time_discretization import make_time_grid
    from ocs2_tpu.solvers import ipm
    from ocs2_tpu_torch.models.legged_robot import interface as tinterface
    from ocs2_tpu_torch.oc.time_discretization import make_time_grid as tmake_time_grid
    from ocs2_tpu_torch.solvers import ipm as tipm

    n, horizon = chip_smoke.LEGGED_N, chip_smoke.LEGGED_HORIZON
    grid = _grid(make_time_grid, gait, n, horizon)
    tgrid = _grid(tmake_time_grid, gait, n, horizon)
    x0 = np.array(model.default_state(), np.float32)
    zeros = np.zeros((n, 24), np.float32)
    settings = ipm.IpmSettings(max_iterations=ZERO_START_ITERATIONS, integrator="rk2")
    t0 = time.perf_counter()
    ref = jax.jit(lambda x, u: ipm.solve(
        interface.make_problem(friction_cone="hard"), grid, x, interface.make_params(grid),
        us_init=u, settings=settings))(x0, zeros)
    port = tipm.solve(
        tinterface.make_problem(friction_cone="hard", device="cpu"), tgrid, x0,
        tinterface.make_params(tgrid, device="cpu"), us_init=torch.as_tensor(zeros),
        settings=tipm.IpmSettings(max_iterations=ZERO_START_ITERATIONS, integrator="rk2"),
        device="cpu")

    def nan_where(name, a, b):
        a, b = np.isnan(np.asarray(a)), np.isnan(np.asarray(b))
        return {f"{name}_nan_jax": int(b.sum()), f"{name}_nan_port": int(a.sum()),
                f"{name}_nan_placement_equal": bool(np.array_equal(a, b))}

    single = {"N": n, "iterations": ZERO_START_ITERATIONS,
              "jax_iterations": int(ref.iterations), "port_iterations": int(port.iterations[0]),
              "jax_mu": float(ref.ipm.mu), "port_mu": float(port.ipm.mu[0]),
              "jax_rho": float(ref.al.rho), "port_rho": float(port.al.rho[0]),
              "port_step_sizes": port.history.step_size[0].tolist(),
              "jax_merit": float(ref.performance.merit),
              "port_merit": float(port.performance.merit[0])}
    for name, a, b in (("slack_ineq", port.ipm.slack_ineq[0], ref.ipm.slack_ineq),
                       ("dual_ineq", port.ipm.dual_ineq[0], ref.ipm.dual_ineq),
                       ("gains", port.gains[0], ref.gains), ("us", port.us[0], ref.us)):
        single.update(nan_where(name, a, b))
    fin = ~np.isnan(np.asarray(ref.ipm.slack_ineq)) & ~np.isnan(port.ipm.slack_ineq[0].numpy())
    single["slack_ineq_max_abs_difference_where_finite"] = float(np.abs(
        port.ipm.slack_ineq[0].numpy()[fin] - np.asarray(ref.ipm.slack_ineq)[fin]).max()) \
        if fin.any() else None

    ref_mpc = mpc.Mpc(
        interface.make_problem(friction_cone="hard"), interface.make_params(grid),
        mpc.MpcSettings(time_horizon=horizon, num_intervals=n, solver="ipm"),
        solver_settings=ipm.IpmSettings(max_iterations=chip_smoke.IPM_MAX_ITERATIONS,
                                        integrator="rk2"),
        reference_manager=interface.SwitchedModelReferenceManager(
            gait.GaitSchedule(gait.trot_gait(0.7))))
    its, nan_slacks = [], []
    solve = ref_mpc._jitted

    def counted(*a):
        sol, ctrl = solve(*a)
        its.append(int(sol.iterations))
        nan_slacks.append(int(np.isnan(np.asarray(sol.ipm.slack_ineq)).sum()))
        return sol, ctrl

    ref_mpc._jitted = counted
    _, xs, _ = mrt.dummy_loop(mrt.MpcMrtInterface(ref_mpc), model.default_state(),
                              duration=LOOP_DURATION, mrt_frequency=chip_smoke.MRT_HZ,
                              mpc_frequency=chip_smoke.MPC_HZ)
    xs = np.asarray(xs)
    nan_rows = np.nonzero(np.isnan(xs).any(axis=1))[0]
    loop = {"duration_s": LOOP_DURATION, "ticks": len(its), "iterations_per_tick": its,
            "nan_slacks_per_tick": nan_slacks, "states": int(xs.shape[0]),
            "first_nan_state": int(nan_rows[0]) if nan_rows.size else None,
            "nan_states": int(nan_rows.size)}
    return {"reference": "ocs2_tpu (JAX, CPU) and ocs2_tpu_torch (CPU)",
            "single_solve": single, "jax_mpc_loop": loop,
            "seconds_cpu": time.perf_counter() - t0}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--compare", metavar="JSON", help="the card's --ipm-out record")
    ap.add_argument("--zero-start", action="store_true",
                    help="the zero-input fault in both packages, and the JAX Mpc loop")
    args = ap.parse_args()

    import jax

    jax.config.update("jax_platforms", "cpu")
    import chip_smoke

    rec = zero_start(chip_smoke) if args.zero_start else chains(chip_smoke, args.compare)
    print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
