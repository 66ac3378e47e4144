#!/usr/bin/env python3
"""Per-scenario SQP iterations of the JAX package on the quadrotor batch of
``chip_smoke.py`` (phase ``quadrotor_sqp_b4096``), on the CPU.

    JAX_PLATFORMS=cpu python3 tools/quadrotor_reference_iterations.py \\
        [--chunk 4096] [--out jax.json] [--compare quadrotor_iterations.json]
    JAX_PLATFORMS=cpu python3 tools/quadrotor_reference_iterations.py --trace 67

Solves the same inputs as the chip phase: ``chip_smoke.quadrotor_x0s()``
(4096 hover states from a numpy seed), ``uniform_grid(0, 2, 40)``,
``SqpSettings(max_iterations=8, integrator="rk4")``, through
``jax.jit(jax.vmap(sqp.solve))`` of ``ocs2_tpu``, ``--chunk`` scenarios at a
time (XLA's vectorisation, and so the last bit of a merit, depends on the
batch size).  Prints one JSON line with the histogram of iterations; ``--out``
writes the per-scenario record.  With ``--compare`` (a record of
``chip_smoke.py --iterations-out`` on the card, of
``tools/quadrotor_port_iterations.py`` on the CPU, or of this script at
another ``--chunk``) it also says, scenario for scenario, where that record's
iteration counts differ from these, and by how much the two final merits
differ there (a tie: the same merit reached some iterations apart).  With
``--trace I`` it solves scenario I alone instead and prints its line search,
as ``tools/quadrotor_port_iterations.py --trace I`` does for the port.
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
    ap.add_argument("--compare", metavar="JSON", nargs="+", default=[],
                    help="per-scenario records to hold against")
    ap.add_argument("--chunk", type=int, default=4096, help="scenarios solved at once")
    ap.add_argument("--out", metavar="JSON", help="write this run's per-scenario record")
    ap.add_argument("--trace", type=int, metavar="I", help="trace scenario I's line search")
    ap.add_argument("--tie-rtol", type=float, default=1e-5,
                    help="relative merit difference under which a differing scenario is a tie")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    jax.config.update("jax_platforms", "cpu")
    from chip_smoke import QUAD_BATCH, QUAD_HORIZON, QUAD_N, QUAD_SEED, quadrotor_x0s
    from ocs2_tpu.models import quadrotor
    from ocs2_tpu.oc.time_discretization import uniform_grid
    from ocs2_tpu.solvers import sqp

    x0s = quadrotor_x0s(QUAD_BATCH, QUAD_SEED)
    problem, params = quadrotor.make_problem(), quadrotor.make_params()
    grid = uniform_grid(0.0, QUAD_HORIZON, QUAD_N)
    settings = sqp.SqpSettings(max_iterations=8, integrator="rk4")
    if args.trace is not None:
        return trace(args.trace, jax, sqp, problem, grid, params, settings, x0s)
    solve = jax.jit(jax.vmap(lambda x: sqp.solve(problem, grid, x, params, settings=settings)))
    t0 = time.perf_counter()
    sols = [jax.block_until_ready(solve(jnp.asarray(x0s[lo:lo + args.chunk])))
            for lo in range(0, QUAD_BATCH, args.chunk)]
    seconds = time.perf_counter() - t0
    its = np.concatenate([np.asarray(s.iterations) for s in sols]).tolist()
    merit = np.concatenate([np.asarray(s.performance.merit) for s in sols])
    converged = np.concatenate([np.asarray(s.converged) for s in sols])
    rec = {
        "reference": "ocs2_tpu (JAX, CPU)", "B": QUAD_BATCH, "N": QUAD_N, "seed": QUAD_SEED,
        "chunk": args.chunk,
        "iterations_histogram": {str(k): its.count(k) for k in sorted(set(its))},
        "converged_share": float(np.mean(converged)),
        "compile_and_solve_seconds_cpu": seconds,
    }
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"seed": QUAD_SEED, "B": QUAD_BATCH, "N": QUAD_N,
                       "device": f"jax_cpu_chunk{args.chunk}", "iterations": its,
                       "merit": merit.tolist(), "converged": converged.tolist()}, f)
    for path in args.compare:
        with open(path) as f:
            other = json.load(f)
        assert other["seed"] == QUAD_SEED and other["B"] == QUAD_BATCH and other["N"] == QUAD_N
        # The record's route (the port's kernel on the card, the port's plain
        # version on the CPU, or the JAX package at another chunk) and, where
        # recorded, the plain version's route on the card.
        device = other.get("device", "cuda")
        for key, prefix in ((f"vs_{device}", ""), (f"vs_{device}_plain", "plain_")):
            if prefix + "iterations" in other:
                rec[key] = compare(np.asarray(other[prefix + "iterations"]),
                                   np.asarray(other[prefix + "merit"], np.float32),
                                   np.asarray(its), merit, args.tie_rtol)
    print(json.dumps(rec), flush=True)
    return 0


def trace(scenario, jax, sqp, problem, grid, params, settings, x0s):
    """Scenario ``scenario``'s line search, from every merit the solver
    computes (a host callback on ``sqp.al_merit``, one call per candidate)."""
    from tools.quadrotor_port_iterations import line_search_trace

    seen, al_merit = [], sqp.al_merit

    def hooked(m, al):
        r = al_merit(m, al)
        jax.debug.callback(lambda v: seen.append(float(v)), r, ordered=True)
        return r

    sqp.al_merit = hooked
    try:
        sol = jax.block_until_ready(jax.jit(
            lambda x: sqp.solve(problem, grid, x, params, settings=settings))(x0s[scenario]))
    finally:
        sqp.al_merit = al_merit
    its = int(sol.iterations)
    assert len(seen) == 2 + 9 * its, (len(seen), its)
    # Initial merit, then per iteration 8 candidates and the accepted one's.
    groups = [seen[:1]]
    for k in range(its):
        groups += [seen[1 + 9 * k:9 + 9 * k], seen[9 + 9 * k:10 + 9 * k]]
    groups.append(seen[1 + 9 * its:])
    print(json.dumps(line_search_trace(groups, np.asarray(sol.history.step_size).tolist(),
                                       its, "ocs2_tpu (JAX, CPU)", scenario)), flush=True)
    return 0


def compare(p_its, p_merit, its, merit, tie_rtol):
    """Scenario-for-scenario agreement of another record with this run."""
    differ = np.nonzero(p_its != its)[0]
    rel = np.abs(p_merit - merit) / np.maximum(np.abs(merit), 1e-30)
    pairs = {}
    for i in differ:
        key = f"{its[i]}->{p_its[i]}"
        pairs[key] = pairs.get(key, 0) + 1
    return {
        "iterations_histogram": {str(k): int(np.sum(p_its == k)) for k in np.unique(p_its)},
        "scenarios_equal_iterations": int(len(its) - len(differ)),
        "scenarios_differing": int(len(differ)),
        "differing_that_tie": int(np.sum(rel[differ] <= tie_rtol)), "tie_rtol": tie_rtol,
        "differing_pairs_this_to_record": pairs,
        "merit_rel_diff_max_where_differing": float(rel[differ].max()) if len(differ) else None,
        "merit_rel_diff_max_where_equal": float(np.max(np.delete(rel, differ)))
        if len(differ) < len(its) else None,
    }


if __name__ == "__main__":
    sys.exit(main())
