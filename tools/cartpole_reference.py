#!/usr/bin/env python3
"""The cartpole swing-ups of ``chip_smoke.py``'s phase
``cartpole_swingup_b4096`` in the JAX package, on the CPU.

    JAX_PLATFORMS=cpu python3 tools/cartpole_reference.py --record [PATH]

For the first ``CARTPOLE_RECORD_BATCH`` (64) of the phase's seeded starts
(``chip_smoke.cartpole_x0s``) it solves both lanes of ``CARTPOLE_SOLVES`` with
the JAX package's ``ddp.solve`` on ``uniform_grid(0, 3, 60)``: SLQ on the
unconstrained problem and iLQR with the input bound as a hard (augmented
Lagrangian) inequality, 10 iterations each.  Each lane is solved under
``jax.vmap`` over the 64 starts (the record), and by two other routes: one
start at a time, and vmapped over a batch of that one start
(``tools/_spread.py``: the JAX package's own spread, which bounds what a
comparison may allow a scenario that the JAX package decides by rounding).  Writes
``tests/torch_data/cartpole_swingup_reference.npz`` (numpy
``savez_compressed``): per lane the vmapped solve's xs, us, iterations, merit
and convergence, and per start each route's iterations and distance in xs
and us.  ``chip_smoke.py`` and
``tests/test_torch_cartpole.py`` hold the port against it.  A few minutes;
imports only the JAX package (and ``chip_smoke``'s constants).
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
    ap.add_argument("--record", nargs="?", const=cs.CARTPOLE_RECORD, metavar="PATH",
                    required=True, help=f"write the record (default {cs.CARTPOLE_RECORD})")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from ocs2_tpu.models import cartpole
    from ocs2_tpu.oc.time_discretization import uniform_grid
    from ocs2_tpu.solvers import ddp
    from tools._spread import describe, routes_of, spread_fields

    x0s = cs.cartpole_x0s(cs.CARTPOLE_SHAPE[2])[: cs.CARTPOLE_RECORD_BATCH]
    grid = uniform_grid(0.0, cs.CARTPOLE_HORIZON, cs.CARTPOLE_SHAPE[3])
    rec = {"x0s": x0s}
    t0 = time.perf_counter()
    for lane, (mode, kw) in cs.CARTPOLE_SOLVES.items():
        settings = ddp.DdpSettings(**kw)

        def solve(x):
            return ddp.solve(cartpole.make_problem(mode), grid, x, cartpole.make_params(),
                             settings=settings)

        batched = jax.jit(jax.vmap(solve))
        sol = batched(jnp.asarray(x0s))
        xs, us, its = np.asarray(sol.xs), np.asarray(sol.us), np.asarray(sol.iterations)
        rec.update({
            f"{lane}_xs": xs, f"{lane}_us": us, f"{lane}_iterations": its,
            f"{lane}_merit": np.asarray(sol.performance.merit),
            f"{lane}_converged": np.asarray(sol.converged),
        })
        rec.update(spread_fields(f"{lane}_", xs, us, its,
                                 routes_of(solve, batched, jnp.asarray(x0s))))
        print(f"{lane}: iterations {np.bincount(its).tolist()} (index = iterations), "
              f"{describe(rec, f'{lane}_')}, upright "
              f"{int((np.abs(xs[:, -1, 0]) < cs.CARTPOLE_UPRIGHT_RAD).sum())} of {len(x0s)}",
              flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.record)), exist_ok=True)
    np.savez_compressed(args.record, **rec)
    print(f"wrote {args.record} in {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
