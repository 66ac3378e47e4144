#!/usr/bin/env python3
"""Per-scenario SQP iterations of the port on the quadrotor batch of
``chip_smoke.py`` (phase ``quadrotor_sqp_b4096``), on the CPU by default.

    python3 tools/quadrotor_port_iterations.py --out quadrotor_cpu.json \\
        [--device cpu] [--chunk 512]
    python3 tools/quadrotor_port_iterations.py --trace 67

Solves the same inputs as the chip phase: ``chip_smoke.quadrotor_x0s()``
(4096 hover states from a numpy seed), ``uniform_grid(0, 2, 40)``,
``SqpSettings(max_iterations=8, integrator="rk4")``, through the port's
``sqp.solve`` (on the CPU its backward sweep is the plain version).  The
scenarios of a solve are independent, so ``--chunk`` bounds the memory (on
the CPU the iterations do not depend on it: 512, 1024 and 4096 agree
scenario for scenario).  Writes the record that
``tools/quadrotor_reference_iterations.py --compare`` reads, in the format of
``chip_smoke.py --iterations-out``, and prints the histogram of iterations.
With ``--trace I`` it solves scenario I alone instead and prints its line
search: per iteration the merit the candidates are held against, the 8
candidate merits, the accepted step, and the merit's float32 spacing (the
same trace as ``tools/quadrotor_reference_iterations.py --trace I``).
Imports neither JAX nor the JAX package.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", metavar="JSON", help="the per-scenario record")
    ap.add_argument("--trace", type=int, metavar="I", help="trace scenario I's line search")
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--chunk", type=int, default=512, help="scenarios solved at once")
    args = ap.parse_args()
    if (args.out is None) == (args.trace is None):
        ap.error("give --out or --trace")

    import torch

    from chip_smoke import QUAD_BATCH, QUAD_HORIZON, QUAD_N, QUAD_SEED, quadrotor_x0s
    from ocs2_tpu_torch.models import quadrotor
    from ocs2_tpu_torch.oc.time_discretization import uniform_grid
    from ocs2_tpu_torch.solvers import sqp

    dev = args.device
    problem = quadrotor.make_problem(device=dev)
    params = quadrotor.make_params(device=dev)
    grid = uniform_grid(0.0, QUAD_HORIZON, QUAD_N)
    settings = sqp.SqpSettings(max_iterations=8, integrator="rk4")
    x0s = torch.as_tensor(quadrotor_x0s(QUAD_BATCH, QUAD_SEED), device=dev)
    if args.trace is not None:
        # Every merit the solver computes, in order: the initial one, then per
        # iteration the candidates' [1, 8] and the accepted candidate's.
        seen, al_merit = [], sqp.al_merit
        sqp.al_merit = lambda m, al: seen.append(al_merit(m, al)) or seen[-1]
        try:
            sol = sqp.solve(problem, grid, x0s[args.trace:args.trace + 1], params,
                            settings=settings, device=dev)
        finally:
            sqp.al_merit = al_merit
        steps = sol.history.step_size[0].tolist()
        print(json.dumps(line_search_trace(
            [v.flatten().tolist() for v in seen], steps, int(sol.iterations[0]),
            "ocs2_tpu_torch", args.trace)), flush=True)
        return 0
    its, merit, converged = [], [], []
    t0 = time.perf_counter()
    for lo in range(0, QUAD_BATCH, args.chunk):
        sol = sqp.solve(problem, grid, x0s[lo:lo + args.chunk], params,
                        settings=settings, device=dev)
        its += sol.iterations.tolist()
        merit += sol.performance.merit.tolist()
        converged += sol.converged.tolist()
    seconds = time.perf_counter() - t0
    with open(args.out, "w") as f:
        json.dump({"seed": QUAD_SEED, "B": QUAD_BATCH, "N": QUAD_N, "device": dev,
                   "iterations": its, "merit": merit, "converged": converged}, f)
    print(json.dumps({
        "port": f"ocs2_tpu_torch ({dev})", "B": QUAD_BATCH, "N": QUAD_N, "seed": QUAD_SEED,
        "chunk": args.chunk,
        "iterations_histogram": {str(k): its.count(k) for k in sorted(set(its))},
        "converged_share": sum(converged) / len(converged), "seconds": seconds,
    }), flush=True)
    return 0


def line_search_trace(seen, steps, iterations, package, scenario):
    """Group the merits a solve computed (initial, then per iteration 8
    candidates and the accepted candidate's merit, then the final one) into
    what each iteration's line search held against what."""
    import numpy as np

    assert len(seen) == 2 + 2 * iterations, (len(seen), iterations)
    merit, rows = seen[0][0], []
    for k in range(iterations):
        cand = seen[1 + 2 * k]
        rows.append({"iteration": k, "merit": merit, "candidates": cand,
                     "candidates_at_or_below": sum(c <= merit for c in cand),
                     "ulp": float(np.spacing(np.float32(merit))), "step_size": steps[k]})
        if steps[k] > 0:
            merit = seen[2 + 2 * k][0]
    return {"package": package, "scenario": scenario, "iterations": iterations, "trace": rows}


if __name__ == "__main__":
    sys.exit(main())
