#!/usr/bin/env python3
"""The JAX package's side of ``chip_smoke.py``'s associative-scan Riccati
lanes, on the CPU.

    JAX_PLATFORMS=cpu python3 tools/parallel_riccati_reference.py --record [PATH]

Writes ``tests/torch_data/parallel_riccati_reference.npz`` (numpy
``savez_compressed``) with:

* ``flagship_*``: the flagship SQP (``bench.py:73-86``'s problem: the legged
  robot at N = 100 over 1 s, trot, rk2, 10 iterations at most) from the
  default state with ``parallel_riccati=True``: xs, us, iterations, merit, and
  its spread (``tools/_spread.py``) over the solve vmapped alone and from
  the start one float32 ulp above and below; beside it the same solve with
  the sequential sweep (``flagship_seq_*``), so that a reader can tell
  whether the JAX package's parallel route solves this problem;
* ``ballbot_*``: iLQR (``DdpSettings(max_iterations=8,
  parallel_riccati=True)``) under ``jax.vmap`` on the first 64 of
  ``chip_smoke.ballbot_batch``'s starts (numpy seed 0), with the spread of
  each start solved alone and vmapped alone; and on all 4,096 the
  iterations and, per start, the distance in xs, us and merit between the
  JAX package's associative scan and its sequential sweep
  (``ballbot_all_*``);
* ``entry_*``: ``__graft_entry__.entry()``'s jitted step (xs, us, cost) at
  N = 32 and the same solve's iterations;
* ``k7_*``: on ``chip_smoke.K7_SHAPES``' ``random_lq_numpy`` data (the card's
  inputs), the JAX package's own distance from its associative scan
  (``jax.vmap(lqr_backward_parallel)``) to its sequential sweep
  (``lqr_backward`` under ``vmap``) per field: the largest absolute
  difference and the largest ratio to ``K7_ATOL + K7_RTOL |value|``.

About 10 minutes, most of it XLA compiling; imports only the JAX package
(and ``chip_smoke``'s constants).
"""
from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def ulp(x, direction):
    """x one float32 ulp toward +inf (direction 1) or -inf (-1), every
    component."""
    x = np.asarray(x, np.float32)
    return np.nextafter(x, np.float32(direction * np.inf)).astype(np.float32)


def record_flagship(cs, rec):
    import jax
    import jax.numpy as jnp

    from ocs2_tpu.models.legged_robot import interface, model
    from ocs2_tpu.models.legged_robot.gait import GaitSchedule, trot_gait
    from ocs2_tpu.oc.time_discretization import make_time_grid
    from ocs2_tpu.solvers import sqp
    from tools._spread import spread_fields

    n = cs.LEGGED_N
    ms = GaitSchedule(trot_gait(0.7)).mode_schedule(0.0, cs.LEGGED_HORIZON)
    grid = make_time_grid(0.0, cs.LEGGED_HORIZON, n, event_times=np.asarray(ms.event_times),
                          mode_sequence=np.asarray(ms.mode_sequence))
    problem, params = interface.make_problem(), interface.make_params(grid)
    us_init = jnp.tile(model.weight_compensating_input(jnp.ones(4))[None], (n, 1))
    x0 = np.asarray(model.default_state(), np.float32)

    def solver(parallel):
        st = sqp.SqpSettings(max_iterations=10, integrator="rk2", parallel_riccati=parallel)
        return lambda x: sqp.solve(problem, grid, x, params, us_init=us_init, settings=st)

    solve = solver(True)
    jitted = jax.jit(solve)
    sol = jitted(jnp.asarray(x0))
    xs, us, its = np.asarray(sol.xs), np.asarray(sol.us), np.asarray(sol.iterations)
    rec.update({"flagship_x0": x0, "flagship_xs": xs, "flagship_us": us,
                "flagship_iterations": its, "flagship_merit": np.asarray(sol.performance.merit)})
    routes = {
        "vmapped_one": jax.tree.map(lambda v: v[0], jax.jit(jax.vmap(solve))(
            jnp.asarray(x0)[None])),
        "ulp_up": jitted(jnp.asarray(ulp(x0, 1))),
        "ulp_down": jitted(jnp.asarray(ulp(x0, -1))),
    }
    fields = spread_fields("flagship_", xs[None], us[None], its[None], {
        name: (np.asarray(r.xs)[None], np.asarray(r.us)[None], np.asarray(r.iterations)[None])
        for name, r in routes.items()})
    rec.update({k: v[0] for k, v in fields.items()})
    seq = jax.jit(solver(False))(jnp.asarray(x0))
    rec.update({"flagship_seq_xs": np.asarray(seq.xs), "flagship_seq_us": np.asarray(seq.us),
                "flagship_seq_iterations": np.asarray(seq.iterations),
                "flagship_seq_merit": np.asarray(seq.performance.merit)})
    print(f"flagship: iterations {int(its)} (sequential {int(seq.iterations)}), finite "
          f"{bool(np.isfinite(xs).all())}, from sequential xs "
          f"{np.abs(xs - rec['flagship_seq_xs']).max():.3g} us "
          f"{np.abs(us - rec['flagship_seq_us']).max():.3g}; spread xs "
          f"{rec['flagship_spread_xs']:.3g} us {rec['flagship_spread_us']:.3g}", flush=True)


def record_ballbot(cs, rec):
    import jax
    import jax.numpy as jnp

    from ocs2_tpu.models import ballbot
    from ocs2_tpu.oc.time_discretization import uniform_grid
    from ocs2_tpu.solvers import ddp
    from tools._spread import describe, routes_of, spread_fields

    batch, n = cs.MAIN_SHAPE[2], cs.MAIN_SHAPE[3]
    rng = np.random.default_rng(0)  # chip_smoke.ballbot_batch's seed
    x0_all = (0.1 * rng.standard_normal((batch, ballbot.NX))).astype(np.float32)
    x0s = x0_all[: cs.PR_BALLBOT_RECORD_BATCH]
    grid = uniform_grid(0.0, 1.0, n)
    settings = ddp.DdpSettings(algorithm="ilqr", max_iterations=8, parallel_riccati=True)

    def solve(x):
        return ddp.solve(ballbot.make_problem(), grid, x, ballbot.make_params(),
                         settings=settings)

    batched = jax.jit(jax.vmap(solve))
    sol = batched(jnp.asarray(x0s))
    xs, us, its = np.asarray(sol.xs), np.asarray(sol.us), np.asarray(sol.iterations)
    rec.update({"ballbot_x0s": x0s, "ballbot_xs": xs, "ballbot_us": us,
                "ballbot_iterations": its, "ballbot_merit": np.asarray(sol.performance.merit)})
    rec.update(spread_fields("ballbot_", xs, us, its,
                             routes_of(solve, batched, jnp.asarray(x0s))))
    print(f"ballbot: iterations {np.bincount(its).tolist()} (index = iterations); "
          f"{describe(rec, 'ballbot_')}", flush=True)

    # The whole batch by both of the JAX package's sweeps: how far its own
    # associative scan and sequential sweep part, scenario by scenario.
    seq_settings = ddp.DdpSettings(algorithm="ilqr", max_iterations=8)
    whole = batched(jnp.asarray(x0_all))
    seq = jax.jit(jax.vmap(lambda x: ddp.solve(ballbot.make_problem(), grid, x,
                                               ballbot.make_params(), settings=seq_settings)))(
        jnp.asarray(x0_all))

    def dist(f):
        d = np.abs(np.asarray(getattr(whole, f), np.float64) - np.asarray(getattr(seq, f)))
        return d.reshape(len(x0_all), -1).max(axis=1).astype(np.float32)

    merit, merit_seq = np.asarray(whole.performance.merit), np.asarray(seq.performance.merit)
    rec.update({
        "ballbot_all_iterations": np.asarray(whole.iterations),
        "ballbot_all_seq_iterations": np.asarray(seq.iterations),
        "ballbot_all_k7_seq_xs": dist("xs"), "ballbot_all_k7_seq_us": dist("us"),
        "ballbot_all_k7_seq_merit_rel": (np.abs(merit - merit_seq) / np.abs(merit_seq)).astype(
            np.float32),
    })
    apart = (rec["ballbot_all_k7_seq_xs"] > 1e-3) | (rec["ballbot_all_k7_seq_us"] > 1e-3)
    print(f"ballbot, all {len(x0_all)}: K7 and the sequential sweep part by more than 1e-3 on "
          f"{int(apart.sum())} ({apart.mean():.4f}), iterations on "
          f"{int((rec['ballbot_all_iterations'] != rec['ballbot_all_seq_iterations']).sum())}; "
          f"largest xs {rec['ballbot_all_k7_seq_xs'].max():.3g} us "
          f"{rec['ballbot_all_k7_seq_us'].max():.3g}", flush=True)


def record_entry(rec):
    import jax
    import jax.numpy as jnp

    import __graft_entry__ as graft
    from ocs2_tpu.models.legged_robot import interface, model
    from ocs2_tpu.models.legged_robot.gait import GaitSchedule, trot_gait
    from ocs2_tpu.oc.time_discretization import make_time_grid
    from ocs2_tpu.solvers import sqp

    step, (x0,) = graft.entry()
    xs, us, cost = jax.jit(step)(x0)
    # The step returns no iterations: the same solve, built as _flagship builds it.
    n = 32
    ms = GaitSchedule(trot_gait(0.7)).mode_schedule(0.0, 1.0)
    grid = make_time_grid(0.0, 1.0, n, event_times=np.asarray(ms.event_times),
                          mode_sequence=np.asarray(ms.mode_sequence))
    sol = jax.jit(lambda x: sqp.solve(
        interface.make_problem(), grid, x, interface.make_params(grid),
        us_init=jnp.tile(model.weight_compensating_input(jnp.ones(4))[None], (n, 1)),
        settings=sqp.SqpSettings(max_iterations=10, integrator="rk2")))(x0)
    assert np.abs(np.asarray(sol.xs) - np.asarray(xs)).max() <= 1e-6
    rec.update({"entry_x0": np.asarray(x0), "entry_xs": np.asarray(xs),
                "entry_us": np.asarray(us), "entry_cost": np.asarray(cost),
                "entry_iterations": np.asarray(sol.iterations)})
    print(f"entry: iterations {int(sol.iterations)}, cost {float(cost):.6g}", flush=True)


def record_k7_distances(cs, rec):
    import jax
    import jax.numpy as jnp

    from ocs2_tpu.ops import riccati

    par = jax.jit(jax.vmap(riccati.lqr_backward_parallel))
    seq = jax.jit(jax.vmap(riccati.lqr_backward))
    for shape, seed in zip(cs.K7_SHAPES, cs.K7_SEEDS):
        leaves, reg = cs.random_lq_numpy(*shape, seed)
        coeffs = riccati.LqrCoeffs(**{k: jnp.asarray(v) for k, v in leaves.items()})
        a, b = par(coeffs, jnp.asarray(reg)), seq(coeffs, jnp.asarray(reg))
        key = "k7_{}_{}_{}_{}".format(*shape)
        parts = []
        for f in cs.K7_FIELDS:
            x, y = np.asarray(getattr(a, f), np.float64), np.asarray(getattr(b, f), np.float64)
            d = np.abs(x - y)
            rec[f"{key}_{f}_max_abs"] = np.float64(d.max())
            rec[f"{key}_{f}_max_ratio"] = np.float64(
                (d / (cs.K7_ATOL + cs.K7_RTOL * np.abs(y))).max())
            parts.append(f"{f} {d.max():.3g}")
        print(f"K7 vs sequential at {shape}: " + ", ".join(parts), flush=True)


def main() -> int:
    import chip_smoke as cs

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--record", nargs="?", const=cs.PR_RECORD, metavar="PATH", required=True,
                    help=f"write the record (default {cs.PR_RECORD})")
    args = ap.parse_args()

    import jax

    jax.config.update("jax_platforms", "cpu")
    t0 = time.perf_counter()
    rec = {}
    record_k7_distances(cs, rec)
    record_entry(rec)
    record_ballbot(cs, rec)
    record_flagship(cs, rec)
    os.makedirs(os.path.dirname(os.path.abspath(args.record)), exist_ok=True)
    np.savez_compressed(args.record, **rec)
    print(f"wrote {args.record} ({os.path.getsize(args.record)} bytes) in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
