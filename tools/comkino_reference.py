#!/usr/bin/env python3
"""The ComKino solves and loops of ``chip_smoke.py`` in the JAX package, on the CPU.

    JAX_PLATFORMS=cpu python3 tools/comkino_reference.py --record [PATH]
    JAX_PLATFORMS=cpu python3 tools/comkino_reference.py --compare comkino.json

``--record`` writes the record that ``tests/test_torch_comkino.py`` holds the
port against (``tests/torch_data/comkino_reference.npz`` by default, numpy
``savez_compressed``; a live JAX ComKino solve compiles for minutes, too long
for the test suite).  Every input is stored beside the result, so the test
solves exactly what the JAX package solved:

* ``lq/``: ``approximate_lq`` of ``interface.make_problem(model_type="comkino")``
  (rk2) on a trot grid of 8 nodes over 0.4 s at numpy-seeded states and inputs
  around the stance (seed 3): the discrete dynamics and their Jacobians;
* ``trot/``: the trot solve of ``tests/test_comkino.py:85`` cut to N = 12 over
  0.3 s and 3 iterations, from the default state and the weight-compensating
  input;
* ``loop/tick{i}/``: the first 3 ticks of ``tests/test_comkino.py:333`` (the
  stepped map of 0.08 m, the segmented problem on ComKino, N = 32 over 1 s,
  5 iterations, ``dummy_loop`` at 50 Hz control and 12.5 Hz MPC): each tick's
  grid, state, warm start, multipliers and params, and its solution;
  ``loop/tick{i}/vmapped/``: the same tick solved inside ``jax.vmap`` (the
  batched sweep), the JAX package's own float32 spread on those inputs;
  ``loop/states``: the loop's 13 states;
* ``stand/``: the full centroidal model's standing solve of
  ``tests/test_centroidal.py:136`` (stance, N = 20 over 1 s, 12 iterations).

The JAX package compiles each of these for one to five minutes on the CPU;
the whole record takes about 15 minutes.  ``--compare`` runs the closed loop
of ``chip_smoke.py``'s phase ``comkino_perceptive_closed_loop`` (1 s, 13
ticks) and holds the file ``chip_smoke.py --comkino-out`` writes on the card
against it: ticks with equal iterations, ties at equal merit, the largest
state difference over the loop and per tick; and, where the record has the
card's re-solved ticks, the third one solved by the JAX package alone and
inside ``jax.vmap`` (the reference's own spread on the card's inputs).
Imports only the JAX package (and ``chip_smoke``'s constants, and
``tools/perceptive_reference.py``'s conversion of a card record).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
DEFAULT_RECORD = os.path.join(ROOT, "tests", "torch_data", "comkino_reference.npz")
LQ_N, LQ_HORIZON, LQ_SEED = 8, 0.4, 3
TROT_N, TROT_HORIZON, TROT_ITERATIONS = 12, 0.3, 3
RECORDED_TICKS = 3
STAND_N, STAND_ITERATIONS = 20, 12


def _flat(prefix, tree, out):
    """Flatten dicts and named tuples of arrays into ``prefix/key`` entries."""
    items = tree.items() if isinstance(tree, dict) else (
        tree._asdict().items() if hasattr(tree, "_asdict") else None)
    if items is None:
        out[prefix] = np.asarray(tree)
        return
    for k, v in items:
        _flat(f"{prefix}/{k}", v, out)


def _trot_grid(horizon, n):
    from ocs2_tpu.models.legged_robot.gait import GaitSchedule, trot_gait
    from ocs2_tpu.oc.time_discretization import make_time_grid

    ms = GaitSchedule(trot_gait(0.7)).mode_schedule(0.0, horizon)
    return make_time_grid(0.0, horizon, n, event_times=np.asarray(ms.event_times),
                          mode_sequence=np.asarray(ms.mode_sequence))


def lq_fixture():
    """States and inputs of the LQ fixture: numpy-seeded around the stance."""
    from ocs2_tpu.models.legged_robot import model

    rng = np.random.default_rng(LQ_SEED)
    x = np.asarray(model.default_state())
    u = np.asarray(model.weight_compensating_input(np.ones(4, np.float32)))
    xs = x[None] + 0.05 * rng.standard_normal((LQ_N + 1, 24))
    us = u[None] + np.concatenate([5.0 * rng.standard_normal((LQ_N, 12)),
                                   0.5 * rng.standard_normal((LQ_N, 12))], axis=1)
    return xs.astype(np.float32), us.astype(np.float32)


def record_lq(out):
    import jax

    from ocs2_tpu.models.legged_robot import interface
    from ocs2_tpu.oc.approx import approximate_lq

    grid = _trot_grid(LQ_HORIZON, LQ_N)
    problem = interface.make_problem(model_type="comkino")
    xs, us = lq_fixture()
    lq = jax.jit(lambda a, b, p: approximate_lq(problem, grid, a, b, p, method="rk2"))(
        xs, us, interface.make_params(grid))
    _flat("lq/grid", grid, out)
    out["lq/xs"], out["lq/us"] = xs, us
    _flat("lq/dynamics", lq.dynamics, out)


def _solve_record(prefix, sol, out):
    out[f"{prefix}/iterations"] = np.asarray(sol.iterations)
    out[f"{prefix}/xs"] = np.asarray(sol.xs)
    out[f"{prefix}/us"] = np.asarray(sol.us)
    out[f"{prefix}/merit"] = np.asarray(sol.performance.merit)
    out[f"{prefix}/dynamics_violation_sse"] = np.asarray(sol.performance.dynamics_violation_sse)


def record_trot(out):
    import jax
    import jax.numpy as jnp

    from ocs2_tpu.models.legged_robot import interface, model
    from ocs2_tpu.solvers import sqp

    grid = _trot_grid(TROT_HORIZON, TROT_N)
    problem = interface.make_problem(model_type="comkino")
    params = interface.make_params(grid)
    x0 = model.default_state()
    us = jnp.tile(model.weight_compensating_input(jnp.ones(4))[None], (TROT_N, 1))
    st = sqp.SqpSettings(max_iterations=TROT_ITERATIONS)
    sol = jax.jit(lambda x: sqp.solve(problem, grid, x, params, us_init=us, settings=st))(x0)
    _flat("trot/grid", grid, out)
    out["trot/x0"], out["trot/us_init"] = np.asarray(x0), np.asarray(us)
    _solve_record("trot", sol, out)


def record_stand(out):
    import jax
    import jax.numpy as jnp

    from ocs2_tpu.models.legged_robot import interface, model
    from ocs2_tpu.models.legged_robot.gait import GaitSchedule, stance_gait
    from ocs2_tpu.oc.time_discretization import make_time_grid
    from ocs2_tpu.solvers import sqp

    ms = GaitSchedule(stance_gait()).mode_schedule(0.0, 1.0)
    grid = make_time_grid(0.0, 1.0, STAND_N, event_times=np.asarray(ms.event_times),
                          mode_sequence=np.asarray(ms.mode_sequence))
    problem = interface.make_problem(model_type="full")
    params = interface.make_params(grid)
    x0 = model.default_state()
    us = jnp.tile(model.weight_compensating_input(jnp.ones(4))[None], (STAND_N, 1))
    st = sqp.SqpSettings(max_iterations=STAND_ITERATIONS, integrator="rk2")
    sol = jax.jit(lambda x: sqp.solve(problem, grid, x, params, us_init=us, settings=st))(x0)
    _flat("stand/grid", grid, out)
    out["stand/x0"], out["stand/us_init"] = np.asarray(x0), np.asarray(us)
    _solve_record("stand", sol, out)


def closed_loop(duration, capture=0):
    """tests/test_comkino.py:333's loop in the JAX package for ``duration``
    seconds: (iterations, merits, states [M, 24], the first ``capture`` ticks'
    solver arguments and solutions)."""
    import jax.numpy as jnp

    import chip_smoke as cs
    from ocs2_tpu.core.reference import TargetTrajectories
    from ocs2_tpu.models.legged_robot import model
    from ocs2_tpu.models.legged_robot.foothold_planner import (
        PerceptiveReferenceManager,
        make_perceptive_params,
        make_segmented_perceptive_problem,
    )
    from ocs2_tpu.models.legged_robot.gait import GaitSchedule, trot_gait
    from ocs2_tpu.models.legged_robot.segmented_planes import decompose_planes
    from ocs2_tpu.models.legged_robot.terrain import ElevationMap
    from ocs2_tpu.mpc import mpc, mrt
    from ocs2_tpu.solvers import sqp

    extent, res = 4.0, 0.05
    m = int(extent / res)
    heights = np.zeros((m, m), np.float32)
    heights[-extent / 2 + (np.arange(m) + 0.5) * res > cs.PERC_STEP_X, :] = cs.LOOP_STEP_H
    em = ElevationMap.create(heights, origin_xy=(-extent / 2, -extent / 2), resolution=res)
    terr = decompose_planes(em)
    x0 = model.default_state()
    x_t = x0.at[0].set(0.4)
    u0 = model.weight_compensating_input(jnp.ones(4))
    tgt = TargetTrajectories.create(
        times=[0.0, 4.0],
        states=jnp.stack([x_t, x_t.at[6].set(1.6).at[8].set(model.STAND_HEIGHT + cs.LOOP_STEP_H)]),
        inputs=jnp.stack([u0, u0]))
    ref_mpc = mpc.Mpc(
        make_segmented_perceptive_problem(model_type="comkino"),
        make_perceptive_params(_trot_grid(cs.CK_HORIZON, cs.CK_N), terr, em, x0, tgt),
        settings=mpc.MpcSettings(time_horizon=cs.CK_HORIZON, num_intervals=cs.CK_N,
                                 solver="sqp"),
        solver_settings=sqp.SqpSettings(max_iterations=cs.CK_MAX_ITERATIONS, integrator="rk2"),
        reference_manager=PerceptiveReferenceManager(terr, em, GaitSchedule(trot_gait(0.7)),
                                                     target=tgt))
    its, merits, ticks, solve = [], [], [], ref_mpc._jitted

    def counted(*args):
        sol, ctrl = solve(*args)
        its.append(int(sol.iterations))
        merits.append(float(sol.performance.merit))
        if len(ticks) < capture:
            ticks.append((args, sol))
        return sol, ctrl

    ref_mpc._jitted = counted
    _, xs, _ = mrt.dummy_loop(mrt.MpcMrtInterface(ref_mpc), x0, duration=duration,
                              mrt_frequency=cs.CK_MRT_HZ, mpc_frequency=cs.CK_MPC_HZ)
    return its, merits, np.asarray(xs), ticks


def record_loop(out):
    import jax

    import chip_smoke as cs
    from ocs2_tpu.models.legged_robot.foothold_planner import make_segmented_perceptive_problem
    from ocs2_tpu.solvers import sqp

    its, merits, xs, ticks = closed_loop(RECORDED_TICKS / cs.CK_MPC_HZ, capture=RECORDED_TICKS)
    assert len(its) == RECORDED_TICKS, its
    out["loop/states"] = xs
    # Each tick once more inside jax.vmap (the batched sweep, clamped pivots):
    # the JAX package's own float32 spread on these inputs.
    problem = make_segmented_perceptive_problem(model_type="comkino")
    st = sqp.SqpSettings(max_iterations=cs.CK_MAX_ITERATIONS, integrator="rk2")
    vmapped = jax.jit(jax.vmap(
        lambda g, x, xs0, us0, al, p: sqp.solve(problem, g, x, p, xs_init=xs0, us_init=us0,
                                                al_init=al, settings=st),
        in_axes=(None, 0, 0, 0, 0, None)))
    for i, ((grid, x0, warm_xs, warm_us, al, params), sol) in enumerate(ticks):
        p = f"loop/tick{i}"
        _flat(f"{p}/grid", grid, out)
        _flat(f"{p}/al", al, out)
        _flat(f"{p}/params", params, out)
        out[f"{p}/x0"], out[f"{p}/xs_init"] = np.asarray(x0), np.asarray(warm_xs)
        out[f"{p}/us_init"] = np.asarray(warm_us)
        _solve_record(p, sol, out)
        batch = lambda v: v[None]  # noqa: E731
        wide = vmapped(grid, batch(x0), batch(warm_xs), batch(warm_us), jax.tree.map(batch, al),
                       params)
        _solve_record(f"{p}/vmapped", jax.tree.map(lambda v: v[0], wide), out)


def resolved_spread(port, tick=2):
    """The card's re-solved tick (``resolved_ticks`` of its record) through the
    JAX package as one solve and inside jax.vmap: the reference's own spread on
    the card's inputs, beside the card's kernel and single-sweep results."""
    import jax

    import chip_smoke as cs
    from ocs2_tpu.models.legged_robot.foothold_planner import make_segmented_perceptive_problem
    from ocs2_tpu.solvers import sqp
    from tools.perceptive_reference import _jax_tree

    rec = port["resolved_ticks"][tick]
    grid, x0, xs0, us0, al, params = _jax_tree(rec["inputs"], drop_batch=True)
    problem = make_segmented_perceptive_problem(model_type="comkino")
    st = sqp.SqpSettings(max_iterations=cs.CK_MAX_ITERATIONS, integrator="rk2")

    def one(x, xs, us, a):
        return sqp.solve(problem, grid, x, params, xs_init=xs, us_init=us, al_init=a, settings=st)

    single = jax.jit(one)(x0, xs0, us0, al)
    batched = jax.jit(jax.vmap(one))(x0[None], xs0[None], us0[None],
                                     jax.tree.map(lambda v: v[None], al))
    us = {"jax_single": np.asarray(single.us), "jax_batched": np.asarray(batched.us[0]),
          "card_kernel": np.asarray(rec["kernel"]["us"], np.float32),
          "card_single_sweep": np.asarray(rec["single_sweep"]["us"], np.float32)}
    names = sorted(us)
    pairs = [(a, b) for i, a in enumerate(names) for b in names[i + 1:]]
    return {"tick": tick,
            "iterations": {"jax_single": int(single.iterations),
                           "jax_batched": int(batched.iterations[0]),
                           "card_kernel": rec["kernel"]["iterations"],
                           "card_single_sweep": rec["single_sweep"]["iterations"]},
            "contact_force_max_abs_diff": {
                f"{a} vs {b}": float(np.abs(us[a] - us[b])[:, :12].max()) for a, b in pairs},
            "joint_velocity_max_abs_diff": {
                f"{a} vs {b}": float(np.abs(us[a] - us[b])[:, 12:].max()) for a, b in pairs}}


def compare(port):
    """The card's loop (``chip_smoke.py --comkino-out``) against the JAX loop."""
    import chip_smoke as cs

    r_its, r_m, r_xs, _ = closed_loop(cs.CK_DURATION)
    p_its, p_m = port["iterations_per_tick"], port["merit_per_tick"]
    p_xs = np.asarray(port["states"], np.float32)
    assert p_xs.shape == r_xs.shape, (p_xs.shape, r_xs.shape)
    diff = np.abs(p_xs - r_xs).max(axis=1)
    ratio = int(round(cs.CK_MRT_HZ / cs.CK_MPC_HZ))
    per_tick = [float(diff[1 + ratio * i: 1 + ratio * (i + 1)].max()) for i in range(len(p_its))]
    ties = [i for i, (a, b, ma, mb) in enumerate(zip(p_its, r_its, p_m, r_m))
            if a != b and abs(ma - mb) <= 1e-6 * max(abs(mb), 1e-30)]
    return {
        "reference_iterations_per_tick": r_its, "iterations_per_tick": p_its,
        "ticks": len(p_its),
        "ticks_with_equal_iterations": sum(a == b for a, b in zip(p_its, r_its)),
        "ticks_differing_at_equal_merit": ties,
        "first_tick_with_other_iterations": next(
            (i for i, (a, b) in enumerate(zip(p_its, r_its)) if a != b), None),
        "merit_max_rel_diff": max(abs(a - b) / max(abs(b), 1e-30) for a, b in zip(p_m, r_m)),
        "max_abs_state_difference": float(diff.max()),
        "max_abs_state_difference_per_tick": per_tick,
        "reference_final_base_x": float(r_xs[-1, 6]),
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--record", nargs="?", const=DEFAULT_RECORD, metavar="PATH",
                    help="write the record of the port's CPU parity tests")
    ap.add_argument("--compare", metavar="JSON", help="the card's ComKino loop record")
    args = ap.parse_args()
    if not (args.record or args.compare):
        ap.error("give --record and/or --compare")

    import jax

    jax.config.update("jax_platforms", "cpu")
    t0 = time.perf_counter()
    rec = {"reference": "ocs2_tpu (JAX, CPU)"}
    if args.record:
        out = {}
        for part in (record_lq, record_trot, record_loop, record_stand):
            t = time.perf_counter()
            part(out)
            rec[f"{part.__name__}_seconds"] = time.perf_counter() - t
        np.savez_compressed(args.record, **out)
        rec["record"] = {"path": args.record, "bytes": os.path.getsize(args.record),
                         "trot_iterations": int(out["trot/iterations"]),
                         "loop_iterations": [int(out[f"loop/tick{i}/iterations"])
                                             for i in range(RECORDED_TICKS)],
                         "stand_iterations": int(out["stand/iterations"])}
    if args.compare:
        with open(args.compare) as f:
            port = json.load(f)
        rec["comkino_perceptive_closed_loop"] = compare(port)
        if "resolved_ticks" in port:
            rec["resolved_tick_spread"] = resolved_spread(port)
    rec["seconds_cpu"] = time.perf_counter() - t0
    print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
