#!/usr/bin/env python3
"""The SLQ solve of ``chip_smoke.py``'s phase ``slq_ballbot_b4096`` in the JAX
package, on the CPU.

    JAX_PLATFORMS=cpu python3 tools/slq_reference.py --record [PATH]

Solves ``ddp.solve`` with ``DdpSettings(algorithm="slq", max_iterations=8)``
on the ballbot problem (N = 32 over 1 s) under ``jax.vmap``: for the first
``SLQ_RECORD_BATCH`` (64) of ``chip_smoke.ballbot_batch``'s seeded starts
(numpy seed 0) the whole solution, and for all 4,096 the iterations and
convergence, so the lane's converged share can be set beside the JAX
package's on the same scenarios.  The 64 are also solved one at a time and
vmapped one at a time: the JAX package's own spread (``tools/_spread.py``).
Writes ``tests/torch_data/slq_ballbot_reference.npz`` (numpy
``savez_compressed``): the 64 starts, their xs, us, iterations, merit, cost,
convergence, each other route's iterations and distance in xs and us per
start, and the 4,096 iterations and convergence flags.
``chip_smoke.py`` holds the card's lane against it.  A few minutes; imports
only the JAX package (and ``chip_smoke``'s constants).
"""
from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> int:
    import chip_smoke as cs

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--record", nargs="?", const=cs.SLQ_RECORD, metavar="PATH", required=True,
                    help=f"write the record (default {cs.SLQ_RECORD})")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from ocs2_tpu.models import ballbot
    from ocs2_tpu.oc.time_discretization import uniform_grid
    from ocs2_tpu.solvers import ddp
    from tools._spread import describe, routes_of, spread_fields

    batch, n = cs.MAIN_SHAPE[2], cs.MAIN_SHAPE[3]
    rng = np.random.default_rng(0)  # chip_smoke.ballbot_batch's seed
    x0_all = (0.1 * rng.standard_normal((batch, ballbot.NX))).astype(np.float32)
    x0s = x0_all[: cs.SLQ_RECORD_BATCH]
    grid = uniform_grid(0.0, 1.0, n)
    settings = ddp.DdpSettings(algorithm="slq", max_iterations=8)

    def solve(x):
        return ddp.solve(ballbot.make_problem(), grid, x, ballbot.make_params(),
                         settings=settings)

    t0 = time.perf_counter()
    batched = jax.jit(jax.vmap(solve))
    sol = batched(jnp.asarray(x0s))
    whole = batched(jnp.asarray(x0_all))
    xs, us, its = np.asarray(sol.xs), np.asarray(sol.us), np.asarray(sol.iterations)
    rec = {
        "x0s": x0s, "xs": xs, "us": us, "iterations": its,
        "merit": np.asarray(sol.performance.merit), "cost": np.asarray(sol.performance.cost),
        "converged": np.asarray(sol.converged),
        "all_iterations": np.asarray(whole.iterations),
        "all_converged": np.asarray(whole.converged),
    }
    rec.update(spread_fields("", xs, us, its, routes_of(solve, batched, jnp.asarray(x0s))))
    os.makedirs(os.path.dirname(os.path.abspath(args.record)), exist_ok=True)
    np.savez_compressed(args.record, **rec)
    print(f"wrote {args.record} in {time.perf_counter() - t0:.1f} s: iterations of the "
          f"{len(x0s)} {np.bincount(rec['iterations']).tolist()} (index = iterations), "
          f"converged {rec['converged'].mean():.4f}; all {batch}: converged "
          f"{rec['all_converged'].mean():.4f}, at the budget "
          f"{int((rec['all_iterations'] == settings.max_iterations).sum())}; {describe(rec, '')}; "
          f"iterations of the other routes differ in "
          f"{int((rec['iterations_lo'] != rec['iterations_hi']).sum())}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
