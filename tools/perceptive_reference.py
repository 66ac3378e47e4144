#!/usr/bin/env python3
"""The two perceptive loops of ``chip_smoke.py`` (phases ``perceptive_mpc``
and ``perceptive_closed_loop``) in the JAX package, on the CPU.

    JAX_PLATFORMS=cpu python3 tools/perceptive_reference.py \\
        [--compare perceptive.json] [--witness] [--resolve K] [--force-spread]

* ``perceptive_mpc``: ``bench.py:287``'s lane: the decomposed stepped map
  (0.12 m at x = 0.45), N = 46 over 1.4 s, ``trot_gait(0.7)``, the segmented
  perceptive problem, ``SqpSettings(max_iterations=8, integrator="rk2")``; a
  warm-up tick, then 12 ticks, each a host re-plan on the current state and a
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
(float32 conditioning of that fixture).  With ``--compare`` the largest
state difference is also given per tick, and the first state past the parity
bound 1e-3 + 1e-4 |value|.  ``--resolve K`` (with ``--compare``) solves tick K
of the card's ``perceptive_mpc`` from its exact inputs (the recorded state and
warm start; the plan is the host planner's on that state) in the JAX package
as one solve and inside ``jax.vmap``, and gives how far each lies from the
card's result and from the other.  ``--force-spread`` (with ``--compare``)
solves the third re-solved tick of the card's ``perceptive_closed_loop`` from
its recorded solver arguments through the JAX package's single-scenario sweep
(one solve), its batched sweep (``jax.vmap``, clamped pivots) and, in float64,
its single sweep, and gives the contact forces' spread between them beside the
card's kernel and single-sweep results.  Imports only the JAX package (and
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


def _per_tick_difference(ref_states, port_states):
    """Largest state difference of each state after the first, and the first
    state (index) past the parity bound 1e-3 + 1e-4 |value|."""
    p_xs = np.asarray(port_states, np.float32)
    diff = np.abs(p_xs - ref_states)
    past = np.nonzero((diff > 1e-3 + 1e-4 * np.abs(ref_states)).any(axis=1))[0]
    return diff.max(axis=1)[1:].tolist(), (int(past[0]) if past.size else None)


def _jax_tree(rec, drop_batch=False):
    """A port record (nested lists) as the JAX package's solver arguments."""
    import jax.numpy as jnp

    from ocs2_tpu.core.reference import TargetTrajectories
    from ocs2_tpu.oc.time_discretization import TimeGrid
    from ocs2_tpu.solvers.al import AlState

    f32 = lambda v: jnp.asarray(np.asarray(v, np.float32))  # noqa: E731
    grid = TimeGrid(times=np.asarray(rec["grid"]["times"], np.float32),
                    is_jump=np.asarray(rec["grid"]["is_jump"], np.float32),
                    modes=np.asarray(rec["grid"]["modes"], np.int32))
    al = AlState(**{k: f32(v)[0] if drop_batch else f32(v) for k, v in rec["al_init"].items()})
    params = {k: (TargetTrajectories(**{f: f32(x) for f, x in v.items()})
                  if isinstance(v, dict) else f32(v)) for k, v in rec["params"].items()}
    return grid, f32(rec["x0"]), f32(rec["xs_init"]), f32(rec["us_init"]), al, params


def resolve_tick(port, k):
    """Tick k of the card's perceptive MPC in the JAX package: one solve and the
    same solve inside jax.vmap (a batch of two equal scenarios)."""
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
    target = target_of([0.0, cs.PERC_HORIZON], {0: 0.6},
                       {0: 0.6, 6: 0.85, 8: model.STAND_HEIGHT + cs.PERC_STEP_H})
    problem = make_segmented_perceptive_problem()
    x = jnp.asarray(np.asarray(port["states"][k], np.float32))
    us = jnp.asarray(np.asarray(port["us_init_per_tick"][k], np.float32))
    params = plan_to_params(plan_footholds(terr, em, np.asarray(grid.times),
                                           np.asarray(grid.modes), np.asarray(x), target),
                            make_perceptive_params(grid, terr, em, x, target))
    st = sqp.SqpSettings(max_iterations=8, integrator="rk2")
    one = lambda xx: sqp.solve(problem, grid, xx, params, us_init=us, settings=st)  # noqa: E731
    a = jax.jit(one)(x)
    b = jax.jit(jax.vmap(one))(jnp.stack([x, x]))
    card_next = np.asarray(port["states"][k + 1], np.float32)
    out = {
        "tick": k, "card_iterations": port["iterations_per_tick"][k],
        "jax_iterations": [int(a.iterations), int(b.iterations[0])],
        "card_merit": port["merit_per_tick"][k],
        "jax_merit": [float(a.performance.merit), float(b.performance.merit[0])],
        "card_vs_jax_single_next_state": float(np.abs(card_next - np.asarray(a.xs[1])).max()),
        "card_vs_jax_vmapped_next_state": float(np.abs(card_next - np.asarray(b.xs[0, 1])).max()),
        "jax_single_vs_vmapped_xs": float(jnp.abs(a.xs - b.xs[0]).max()),
        "jax_single_vs_vmapped_us": float(jnp.abs(a.us - b.us[0]).max()),
    }
    wide = _float64_solve(lambda xx, p, u: sqp.solve(problem, grid, xx, p, us_init=u,
                                                      settings=st), (x, params, us))
    if isinstance(wide, str):
        out["float64_error"] = wide
    else:
        next64 = np.asarray(wide.xs[1])
        out.update({"jax_float64_merit": float(wide.performance.merit),
                    "card_vs_jax_float64_next_state": float(np.abs(card_next - next64).max()),
                    "jax_single_vs_float64_next_state": float(
                        np.abs(np.asarray(a.xs[1]) - next64).max())})
    return out


def _float64_solve(fn, args):
    """fn(*args) with every floating leaf in float64 (x64 on for the call), or
    the error's text if the JAX package cannot take float64 there."""
    import jax
    import jax.numpy as jnp

    try:
        jax.config.update("jax_enable_x64", True)
        wide = jax.tree.map(lambda v: jnp.asarray(v, jnp.float64) if jnp.issubdtype(
            jnp.asarray(v).dtype, jnp.floating) else v, args)
        return jax.block_until_ready(jax.jit(fn)(*wide))
    except Exception as e:  # noqa: BLE001 - the float64 solve is optional evidence
        return f"{type(e).__name__}: {e}"[:300]
    finally:
        jax.config.update("jax_enable_x64", False)


def force_spread(port, tick=2):
    """The card's re-solved closed-loop tick through the JAX package's single
    sweep, its batched sweep and its single sweep in float64."""
    import jax
    import jax.numpy as jnp

    from ocs2_tpu.models.legged_robot.foothold_planner import make_segmented_perceptive_problem
    from ocs2_tpu.solvers import sqp

    rec = port["resolved_ticks"][tick]
    grid, x0, xs0, us0, al, params = _jax_tree(rec["inputs"], drop_batch=True)
    problem = make_segmented_perceptive_problem()
    st = sqp.SqpSettings(max_iterations=6, integrator="rk2")

    def one(g, x, xs, us, a, p):
        return sqp.solve(problem, g, x, p, xs_init=xs, us_init=us, al_init=a, settings=st)

    single = jax.jit(one)(grid, x0, xs0, us0, al, params)
    batched = jax.jit(jax.vmap(one, in_axes=(None, 0, 0, 0, 0, None)))(
        grid, x0[None], xs0[None], us0[None], jax.tree.map(lambda v: v[None], al), params)
    out = {"tick": tick, "iterations": {"jax_single": int(single.iterations),
                                        "jax_batched": int(batched.iterations[0]),
                                        "card_kernel": rec["kernel"]["iterations"],
                                        "card_single_sweep": rec["single_sweep"]["iterations"]}}
    forces = {"jax_single": np.asarray(single.us)[:, :12],
              "jax_batched": np.asarray(batched.us[0])[:, :12],
              "card_kernel": np.asarray(rec["kernel"]["us"], np.float32)[:, :12],
              "card_single_sweep": np.asarray(rec["single_sweep"]["us"], np.float32)[:, :12]}
    wide = _float64_solve(one, (grid, x0, xs0, us0, al, params))
    if isinstance(wide, str):
        out["float64_error"] = wide
    else:
        forces["jax_single_float64"] = np.asarray(wide.us)[:, :12]
        out["iterations"]["jax_single_float64"] = int(wide.iterations)
    names = sorted(forces)
    out["contact_force_max_abs_diff"] = {
        f"{a} vs {b}": float(np.abs(forces[a] - forces[b]).max())
        for i, a in enumerate(names) for b in names[i + 1:]}
    worst = np.unravel_index(np.argmax(np.abs(forces["card_kernel"]
                                              - forces["card_single_sweep"])),
                             forces["card_kernel"].shape)
    out["card_worst_entry"] = {"node": int(worst[0]), "force_index": int(worst[1]),
                               **{k: float(v[worst]) for k, v in forces.items()}}
    return out


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
    per_tick, first_past = _per_tick_difference(ref["states"], port["states"])
    return {
        "max_abs_state_difference_per_tick": per_tick,
        "first_state_past_parity_bound": first_past,
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
    ap.add_argument("--resolve", type=int, metavar="K",
                    help="re-solve the card's perceptive MPC tick K (needs --compare)")
    ap.add_argument("--force-spread", action="store_true",
                    help="re-solve the card's third closed-loop tick by three routes "
                         "(needs --compare)")
    args = ap.parse_args()
    if (args.resolve is not None or args.force_spread) and not args.compare:
        ap.error("--resolve and --force-spread read the card's record: give --compare")

    import jax

    jax.config.update("jax_platforms", "cpu")
    t0 = time.perf_counter()
    rec = {"reference": "ocs2_tpu (JAX, CPU)"}
    port = None
    if args.compare:
        with open(args.compare) as f:
            port = json.load(f)
    if args.resolve is not None:
        rec["resolve"] = resolve_tick(port["perceptive_mpc"], args.resolve)
    if args.force_spread:
        rec["force_spread"] = force_spread(port["perceptive_closed_loop"])
    runs = {}
    if args.resolve is None and not args.force_spread:
        runs = {"perceptive_mpc": perceptive_mpc(),
                "perceptive_closed_loop": perceptive_closed_loop()}
    for name, run in runs.items():
        rec[name] = {k: v for k, v in run.items() if k != "states"}
        rec[name]["final_state_base_xyz"] = run["states"][-1, 6:9].tolist()
        if port is not None:
            rec[name]["port"] = compare(run, port[name])
    if args.witness:
        rec["witness"] = witness()
    rec["seconds_cpu"] = time.perf_counter() - t0
    print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
