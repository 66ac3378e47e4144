#!/usr/bin/env python3
"""The two perceptive loops of ``chip_smoke.py`` (phases ``perceptive_mpc``
and ``perceptive_closed_loop``) in the JAX package, on the CPU.

    JAX_PLATFORMS=cpu python3 tools/perceptive_reference.py \\
        [--compare perceptive.json] [--witness]

* ``perceptive_mpc``: ``bench.py:287``'s lane: the decomposed stepped map
  (0.12 m at x = 0.45), N = 46 over 1.4 s, ``trot_gait(0.7)``, the segmented
  perceptive problem, ``SqpSettings(max_iterations=8, integrator="rk2")``; a
  warm-up tick, then 20 ticks, each a host re-plan on the current state and a
  solve warm in ``us``, x <- xs[1].
* ``perceptive_closed_loop``: ``tests/test_segmented_planes.py``'s
  ``TestClosedLoopPerceptive``: the 0.08 m step, ``Mpc`` with the
  ``PerceptiveReferenceManager``, N = 32 over 1 s, 6 iterations, ``dummy_loop``
  for 2 s at 60 Hz control and 15 Hz MPC.

Prints one JSON line: the SQP iterations and merits of every tick and the
final state of each loop.  With ``--compare`` (the file ``chip_smoke.py
--perceptive-out`` writes on the card) it also gives, per loop, the ticks
whose iterations agree, the ticks that differ at an equal merit (within
1e-6 relative: a tie decided by float32 rounding), and the largest state
difference.  With ``--witness`` it solves the segmented problem at N = 14
over 0.7 s from the default state toward the lane's walking target with a
budget of 3 iterations twice in the JAX package, as one solve and inside
``jax.vmap``, and prints how far the two routes' ``xs`` / ``us`` lie apart
(float32 conditioning of that fixture).  Imports only the JAX package (and
``chip_smoke``'s constants).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _setup():
    import jax.numpy as jnp

    import chip_smoke as cs
    from ocs2_tpu.core.reference import TargetTrajectories
    from ocs2_tpu.models.legged_robot import model
    from ocs2_tpu.models.legged_robot.gait import GaitSchedule, trot_gait
    from ocs2_tpu.models.legged_robot.segmented_planes import decompose_planes
    from ocs2_tpu.models.legged_robot.terrain import ElevationMap
    from ocs2_tpu.oc.time_discretization import make_time_grid

    def stepped(high, extent=4.0, res=0.05):
        m = int(extent / res)
        h = np.zeros((m, m), np.float32)
        h[-extent / 2 + (np.arange(m) + 0.5) * res > cs.PERC_STEP_X, :] = high
        return ElevationMap.create(h, origin_xy=(-extent / 2, -extent / 2), resolution=res)

    def grid(horizon, n):
        ms = GaitSchedule(trot_gait(0.7)).mode_schedule(0.0, horizon)
        return make_time_grid(0.0, horizon, n, event_times=np.asarray(ms.event_times),
                              mode_sequence=np.asarray(ms.mode_sequence))

    def target(times, first, last):
        x = model.default_state()
        u0 = model.weight_compensating_input(jnp.ones(4))
        a, b = x, x
        for i, v in first.items():
            a = a.at[i].set(v)
        for i, v in last.items():
            b = b.at[i].set(v)
        return TargetTrajectories.create(times=times, states=jnp.stack([a, b]),
                                         inputs=jnp.stack([u0, u0]))

    return cs, model, stepped, grid, target, decompose_planes


def perceptive_mpc():
    import jax
    import jax.numpy as jnp

    from ocs2_tpu.models.legged_robot.foothold_planner import (
        make_perceptive_params,
        make_segmented_perceptive_problem,
        plan_footholds,
        plan_to_params,
    )
    from ocs2_tpu.solvers import sqp

    cs, model, stepped, make_grid, target_of, decompose_planes = _setup()
    em = stepped(cs.PERC_STEP_H)
    terr = decompose_planes(em)
    grid = make_grid(cs.PERC_HORIZON, cs.PERC_N)
    x0 = model.default_state()
    target = target_of([0.0, cs.PERC_HORIZON], {0: 0.6},
                       {0: 0.6, 6: 0.85, 8: model.STAND_HEIGHT + cs.PERC_STEP_H})
    problem = make_segmented_perceptive_problem()
    params = make_perceptive_params(grid, terr, em, x0, target)
    st = sqp.SqpSettings(max_iterations=8, integrator="rk2")

    @jax.jit
    def solve(x, us, p):
        sol = sqp.solve(problem, grid, x, p, us_init=us, settings=st)
        return sol.xs[1], sol.us, sol.iterations, sol.performance.merit

    us = jnp.tile(model.weight_compensating_input(jnp.ones(4))[None], (cs.PERC_N, 1))
    _, _, warm_its, _ = solve(x0, us, params)
    x, states, its, merits = x0, [np.asarray(x0)], [], []
    for _ in range(cs.PERC_TICKS):
        plan = plan_footholds(terr, em, np.asarray(grid.times), np.asarray(grid.modes),
                              np.asarray(x), target)
        x, us, it, merit = solve(x, us, plan_to_params(plan, params))
        its.append(int(it))
        merits.append(float(merit))
        states.append(np.asarray(x))
    return {"warm_up_iterations": int(warm_its), "iterations_per_tick": its,
            "merit_per_tick": merits, "states": np.stack(states)}


def perceptive_closed_loop():
    import jax.numpy as jnp

    from ocs2_tpu.models.legged_robot.foothold_planner import (
        PerceptiveReferenceManager,
        make_perceptive_params,
        make_segmented_perceptive_problem,
    )
    from ocs2_tpu.models.legged_robot.gait import GaitSchedule, trot_gait
    from ocs2_tpu.mpc import mpc, mrt
    from ocs2_tpu.solvers import sqp

    cs, model, stepped, make_grid, target_of, decompose_planes = _setup()
    em = stepped(cs.LOOP_STEP_H)
    terr = decompose_planes(em)
    x0 = model.default_state()
    tgt = target_of([0.0, 4.0], {0: 0.4}, {0: 0.4, 6: 1.6, 8: model.STAND_HEIGHT + cs.LOOP_STEP_H})
    ref_mpc = mpc.Mpc(
        make_segmented_perceptive_problem(),
        make_perceptive_params(make_grid(cs.LOOP_HORIZON, cs.LOOP_N), terr, em, x0, tgt),
        settings=mpc.MpcSettings(time_horizon=cs.LOOP_HORIZON, num_intervals=cs.LOOP_N,
                                 solver="sqp"),
        solver_settings=sqp.SqpSettings(max_iterations=6, integrator="rk2"),
        reference_manager=PerceptiveReferenceManager(terr, em, GaitSchedule(trot_gait(0.7)),
                                                     target=tgt))
    its, merits, solve = [], [], ref_mpc._jitted

    def counted(*a):
        sol, ctrl = solve(*a)
        its.append(int(sol.iterations))
        merits.append(float(sol.performance.merit))
        return sol, ctrl

    ref_mpc._jitted = counted
    _, xs, _ = mrt.dummy_loop(mrt.MpcMrtInterface(ref_mpc), jnp.asarray(x0),
                              duration=cs.LOOP_DURATION, mrt_frequency=cs.LOOP_MRT_HZ,
                              mpc_frequency=cs.LOOP_MPC_HZ)
    return {"iterations_per_tick": its, "merit_per_tick": merits, "states": np.asarray(xs)}


def witness():
    """The segmented problem at N = 14 from the default state toward the
    lane's walking target, 3 iterations: one solve against the same solve
    inside jax.vmap (a batch of two equal scenarios)."""
    import jax
    import jax.numpy as jnp

    from ocs2_tpu.models.legged_robot.foothold_planner import (
        make_perceptive_params,
        make_segmented_perceptive_problem,
    )
    from ocs2_tpu.solvers import sqp

    cs, model, stepped, make_grid, target_of, decompose_planes = _setup()
    em = stepped(cs.PERC_STEP_H)
    terr = decompose_planes(em)
    n, horizon = 14, 0.7
    grid = make_grid(horizon, n)
    x0 = model.default_state()
    target = target_of([0.0, horizon], {0: 0.6},
                       {0: 0.6, 6: 0.85, 8: model.STAND_HEIGHT + cs.PERC_STEP_H})
    problem = make_segmented_perceptive_problem()
    params = make_perceptive_params(grid, terr, em, x0, target)
    us = jnp.tile(model.weight_compensating_input(jnp.ones(4))[None], (n, 1))
    st = sqp.SqpSettings(max_iterations=3, integrator="rk2")
    one = lambda x: sqp.solve(problem, grid, x, params, us_init=us, settings=st)  # noqa: E731
    a = jax.jit(one)(x0)
    b = jax.jit(jax.vmap(one))(jnp.stack([x0, x0]))
    return {"fixture": "segmented problem, N = 14 over 0.7 s, walking target, 3 iterations",
            "iterations": [int(a.iterations), int(b.iterations[0])],
            "single_vs_vmapped_max_abs_xs": float(jnp.abs(a.xs - b.xs[0]).max()),
            "single_vs_vmapped_max_abs_us": float(jnp.abs(a.us - b.us[0]).max()),
            "us_max_abs": float(jnp.abs(a.us).max())}


def compare(ref, port):
    p_its, r_its = port["iterations_per_tick"], ref["iterations_per_tick"]
    p_m, r_m = port["merit_per_tick"], ref["merit_per_tick"]
    equal = sum(a == b for a, b in zip(p_its, r_its))
    ties = [i for i, (a, b, ma, mb) in enumerate(zip(p_its, r_its, p_m, r_m))
            if a != b and abs(ma - mb) <= 1e-6 * max(abs(mb), 1e-30)]
    p_xs = np.asarray(port["states"], np.float32)
    assert p_xs.shape == ref["states"].shape, (p_xs.shape, ref["states"].shape)
    diff = np.abs(p_xs - ref["states"])
    first_diff = next((i for i, (a, b) in enumerate(zip(p_its, r_its)) if a != b), None)
    return {
        "iterations_per_tick": p_its, "ticks": len(p_its), "ticks_with_equal_iterations": equal,
        "ticks_differing_at_equal_merit": ties,
        "share_equal_or_tied": (equal + len(ties)) / len(p_its),
        "first_tick_with_other_iterations": first_diff,
        "merit_max_rel_diff": max(abs(a - b) / max(abs(b), 1e-30) for a, b in zip(p_m, r_m)),
        "max_abs_state_difference": float(diff.max()),
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--compare", metavar="JSON", help="the port's perceptive record")
    ap.add_argument("--witness", action="store_true",
                    help="also solve the walking fixture as one solve and inside vmap")
    args = ap.parse_args()

    import jax

    jax.config.update("jax_platforms", "cpu")
    t0 = time.perf_counter()
    runs = {"perceptive_mpc": perceptive_mpc(), "perceptive_closed_loop": perceptive_closed_loop()}
    rec = {"reference": "ocs2_tpu (JAX, CPU)"}
    for name, run in runs.items():
        rec[name] = {k: v for k, v in run.items() if k != "states"}
        rec[name]["final_state_base_xyz"] = run["states"][-1, 6:9].tolist()
    if args.compare:
        with open(args.compare) as f:
            port = json.load(f)
        for name, run in runs.items():
            rec[name]["port"] = compare(run, port[name])
    if args.witness:
        rec["witness"] = witness()
    rec["seconds_cpu"] = time.perf_counter() - t0
    print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
