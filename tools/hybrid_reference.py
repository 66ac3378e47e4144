#!/usr/bin/env python3
"""The state-triggered hybrid DDP of ``chip_smoke.py``'s phase
``hybrid_bouncing_mass``, and the switch-time optimization of its phase
``switch_time_exp0``, in the JAX package, on the CPU.

    JAX_PLATFORMS=cpu python3 tools/hybrid_reference.py --record [PATH]
    JAX_PLATFORMS=cpu python3 tools/hybrid_reference.py --compare CARD.json

``--record`` runs ``solve_state_triggered`` (jitted) on the bouncing mass of
``tests/test_hybrid_ddp.py`` (t in [0, 1.2], 40 base intervals, 3 event
slots, 3 outer rounds, ``DdpSettings(max_iterations=25, min_rel_cost=1e-4)``,
the constants from ``chip_smoke.py``) and writes
``tests/torch_data/hybrid_bouncing_mass_reference.npz``: the detected event
times, the mode sequence, the final solve's cost, states and inputs, its
iterations, the grid's times and the outer loop's drift.  ``chip_smoke.py``
holds the card's solve against it.  ``--compare`` reads the JSON that
``chip_smoke.py --hybrid-out`` wrote on the card and prints the largest
differences from the record.

``--record`` also writes ``tests/torch_data/switch_time_exp0_reference.npz``
(``--switch-record PATH`` elsewhere): on ``tests/test_hybrid.py``'s switched
linear system (N = 40 over [0, 2], SQP with 15 iterations), the switch-time
gradient at theta0 = 0.9, the solved costs at theta0 +- 0.02 (the finite
difference), and ``optimize_switch_times``' event times and costs for 5
upper-level iterations, which ``chip_smoke.py`` holds the card's run
against.  About a minute; imports only the JAX package (and
``chip_smoke``'s constants).
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
DEFAULT_RECORD = os.path.join(ROOT, "tests", "torch_data", "hybrid_bouncing_mass_reference.npz")
SWITCH_RECORD = os.path.join(ROOT, "tests", "torch_data", "switch_time_exp0_reference.npz")


def solve_reference():
    import jax
    import jax.numpy as jnp

    from chip_smoke import BALL_G, BALL_RESTITUTION, HYB_KW, HYB_T_FINAL, HYB_TARGET
    from ocs2_tpu.core.reference import TargetTrajectories
    from ocs2_tpu.oc.hybrid_rollout import HybridSystem
    from ocs2_tpu.oc.problem import OptimalControlProblem, quadratic_cost
    from ocs2_tpu.solvers import ddp
    from ocs2_tpu.solvers.hybrid_ddp import solve_state_triggered

    def flow(t, x, u, p, mode=None):
        return jnp.array([x[1], u[0] - BALL_G])

    def bounce(t, x, p):
        return jnp.array([1e-4, -BALL_RESTITUTION * x[1]])

    system = HybridSystem(dynamics=flow, guard=lambda t, x, p, mode: x[0],
                          jump=lambda t, x, p, mode: (bounce(t, x, p), mode + 1))
    problem = OptimalControlProblem(
        dynamics=lambda t, x, u, p: flow(t, x, u, p), jump_map=bounce,
        cost_terms=(quadratic_cost(jnp.diag(jnp.array([4.0, 0.1])), 0.05 * jnp.eye(1)),),
        nx=2, nu=1)
    params = {"target": TargetTrajectories.constant(jnp.asarray(HYB_TARGET), jnp.zeros(1))}
    settings = ddp.DdpSettings(max_iterations=25, min_rel_cost=1e-4)
    sol = jax.jit(lambda x: solve_state_triggered(
        system, problem, 0.0, HYB_T_FINAL, x, params, settings=settings, **HYB_KW))(
        jnp.array([1.0, 0.0]))
    return {
        "event_times": np.asarray(sol.event_times, np.float32),
        "mode_sequence": np.asarray(sol.mode_sequence, np.int64),
        "cost": np.float32(sol.ddp.performance.cost),
        "xs": np.asarray(sol.ddp.xs, np.float32), "us": np.asarray(sol.ddp.us, np.float32),
        "iterations": np.int32(sol.ddp.iterations),
        "grid_times": np.asarray(sol.grid.times, np.float32),
        "event_drift": np.asarray(sol.event_drift, np.float32),
    }


def switch_reference():
    import jax
    import jax.numpy as jnp

    from chip_smoke import (SWITCH_A, SWITCH_B, SWITCH_FD_EPS, SWITCH_ITERATIONS, SWITCH_SHAPE,
                            SWITCH_THETA0)
    from ocs2_tpu.oc.problem import OptimalControlProblem
    from ocs2_tpu.oc.time_discretization import make_time_grid
    from ocs2_tpu.solvers import sqp, switch_time

    a_modes, b = np.asarray(SWITCH_A, np.float32), np.asarray(SWITCH_B, np.float32)

    def dynamics(t, x, u, p):
        a = jax.lax.switch(p["mode"], [lambda: jnp.asarray(a_modes[0]),
                                       lambda: jnp.asarray(a_modes[1])])
        return a @ x + jnp.asarray(b) @ u

    def cost(t, x, u, p):
        return 0.5 * (x @ x) + 0.5 * (u @ u)

    problem = OptimalControlProblem(dynamics=dynamics, cost_terms=(cost,), nx=2, nu=1)
    n, x0 = SWITCH_SHAPE[3], jnp.array([1.0, 0.0])
    settings = sqp.SqpSettings(max_iterations=15)
    solve_fn = jax.jit(lambda grid, x, p: sqp.solve(problem, grid, x, p, settings=settings))

    def solve_at(theta):
        grid = make_time_grid(0.0, 2.0, n, event_times=[theta], mode_sequence=[0, 1])
        return solve_fn(grid, x0, {}), grid

    sol, grid = solve_at(SWITCH_THETA0)
    gradient = float(jnp.sum(switch_time.switch_time_gradients(
        problem, grid, sol.xs, sol.us, sol.value_s, {})))
    cost_plus = float(solve_at(SWITCH_THETA0 + SWITCH_FD_EPS)[0].performance.cost)
    cost_minus = float(solve_at(SWITCH_THETA0 - SWITCH_FD_EPS)[0].performance.cost)
    res = switch_time.optimize_switch_times(
        problem, solve_fn, x0, {}, 0.0, 2.0, n, [SWITCH_THETA0], [0, 1],
        iterations=SWITCH_ITERATIONS)
    return {
        "gradient_at_theta0": np.float64(gradient),
        "cost_plus": np.float64(cost_plus), "cost_minus": np.float64(cost_minus),
        "finite_difference_at_theta0": np.float64((cost_plus - cost_minus) / (2 * SWITCH_FD_EPS)),
        "theta_history": np.asarray([t[0] for t, _ in res.history], np.float64),
        "cost_history": np.asarray([c for _, c in res.history], np.float64),
        "event_time_found": np.float64(res.event_times[0]), "cost": np.float64(res.cost),
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    group = ap.add_mutually_exclusive_group(required=True)
    group.add_argument("--record", nargs="?", const=DEFAULT_RECORD, metavar="PATH",
                       help=f"write the record (default {DEFAULT_RECORD})")
    group.add_argument("--compare", metavar="CARD_JSON",
                       help="print the largest differences of chip_smoke.py --hybrid-out's "
                            "JSON from the record")
    ap.add_argument("--reference", default=DEFAULT_RECORD, metavar="PATH",
                    help="the record --compare reads")
    ap.add_argument("--switch-record", default=SWITCH_RECORD, metavar="PATH",
                    help=f"where --record writes the switch-time record (default {SWITCH_RECORD})")
    args = ap.parse_args()

    if args.record:
        rec = solve_reference()
        np.savez_compressed(args.record, **rec)
        print(json.dumps({"record": os.path.relpath(args.record, ROOT),
                          "event_times": rec["event_times"].tolist(),
                          "mode_sequence": rec["mode_sequence"].tolist(),
                          "cost": float(rec["cost"]), "iterations": int(rec["iterations"]),
                          "event_drift": rec["event_drift"].tolist()}))
        sw = switch_reference()
        np.savez_compressed(args.switch_record, **sw)
        print(json.dumps({"record": os.path.relpath(args.switch_record, ROOT),
                          **{k: v.tolist() for k, v in sw.items()}}))
        return 0

    with np.load(args.reference) as f:
        ref = {k: f[k] for k in f.files}
    with open(args.compare) as f:
        card = json.load(f)
    ev = np.asarray(card["event_times"], np.float32)
    fin = np.isfinite(ref["event_times"])
    print(json.dumps({
        "events_active_equal": bool(np.array_equal(np.isfinite(ev), fin)),
        "event_max_abs_diff": float(np.abs(ev[fin] - ref["event_times"][fin]).max()),
        "mode_sequence_equal": card["mode_sequence"] == ref["mode_sequence"].tolist(),
        "cost_rel_diff": abs(card["cost"] - float(ref["cost"])) / abs(float(ref["cost"])),
        "xs_max_abs_diff": float(np.abs(np.asarray(card["xs"]) - ref["xs"]).max()),
        "us_max_abs_diff": float(np.abs(np.asarray(card["us"]) - ref["us"]).max()),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
