#!/usr/bin/env python3
"""The SLP solve of ``chip_smoke.py``'s phase ``slp_ballbot_b256`` in the JAX
package, on the CPU.

    JAX_PLATFORMS=cpu python3 tools/slp_reference.py --record [PATH]

Solves ``slp.solve`` (``SlpSettings(integrator="rk4")``: PIPG with 3000
iterations a QP, 10 SLP iterations at most) and ``sqp.solve`` with the same
integrator on the ballbot problem (N = 32 over 1 s) for the first 256 of
``chip_smoke.py``'s main-path initial states (numpy seed 0), both under
``jax.vmap``, and writes ``tests/torch_data/slp_ballbot_reference.npz`` (numpy
``savez_compressed``): the initial states, SLP's inputs, iterations,
convergence, merit and dynamics-violation SSE, and the largest difference
between SLP's and SQP's inputs per scenario.  ``chip_smoke.py`` holds the
card's SLP against it, and ``tests/test_torch_pipg.py`` the port's on the CPU.
The JAX package's own SLP stops 0.026-2.2 from its SQP in the inputs on this
problem (dynamics SSE to 3.4e-3), so the record, not SQP, is the reference
for SLP here.  About two minutes; imports only the JAX package (and
``chip_smoke``'s constants).
"""
from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
DEFAULT_RECORD = os.path.join(ROOT, "tests", "torch_data", "slp_ballbot_reference.npz")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--record", nargs="?", const=DEFAULT_RECORD, metavar="PATH", required=True,
                    help=f"write the record (default {DEFAULT_RECORD})")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from chip_smoke import MAIN_SHAPE, SLP_SHAPE
    from ocs2_tpu.models import ballbot
    from ocs2_tpu.oc.time_discretization import uniform_grid
    from ocs2_tpu.solvers import slp, sqp

    _, _, batch, n = SLP_SHAPE
    rng = np.random.default_rng(0)  # chip_smoke.main_path's seed
    x0s = (0.1 * rng.standard_normal((MAIN_SHAPE[2], ballbot.NX))).astype(np.float32)[:batch]
    grid = uniform_grid(0.0, 1.0, n)

    def batched(solve, settings):
        return jax.jit(jax.vmap(lambda x: solve(
            ballbot.make_problem(), grid, x, ballbot.make_params(), settings=settings)))

    t0 = time.perf_counter()
    ref = batched(slp.solve, slp.SlpSettings(integrator="rk4"))(jnp.asarray(x0s))
    sq = batched(sqp.solve, sqp.SqpSettings(integrator="rk4"))(jnp.asarray(x0s))
    us, us_sqp = np.asarray(ref.us), np.asarray(sq.us)
    rec = {
        "x0s": x0s, "us": us, "iterations": np.asarray(ref.iterations),
        "converged": np.asarray(ref.converged), "merit": np.asarray(ref.performance.merit),
        "dynamics_violation_sse": np.asarray(ref.performance.dynamics_violation_sse),
        "us_max_abs_diff_vs_sqp": np.abs(us - us_sqp).max(axis=(1, 2)),
        "sqp_iterations": np.asarray(sq.iterations),
    }
    os.makedirs(os.path.dirname(os.path.abspath(args.record)), exist_ok=True)
    np.savez_compressed(args.record, **rec)
    print(f"wrote {args.record} in {time.perf_counter() - t0:.1f} s: SLP iterations "
          f"{np.bincount(rec['iterations']).tolist()} (index = iterations), SLP vs SQP inputs "
          f"{rec['us_max_abs_diff_vs_sqp'].min():.3g}-{rec['us_max_abs_diff_vs_sqp'].max():.3g}, "
          f"dynamics SSE max {rec['dynamics_violation_sse'].max():.3g}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
