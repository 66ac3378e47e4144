#!/usr/bin/env python3
"""The mobile-manipulator and URDF-arm solves of ``chip_smoke.py``'s phases
``manipulator_sqp_b1`` and ``urdf_variants_b1`` in the JAX package, on the CPU.

    JAX_PLATFORMS=cpu python3 tools/manipulator_reference.py --record [PATH]

Solves with the JAX package's ``sqp.solve``:

* the built-in arm (``make_problem("soft")`` with self-collision, rk2,
  N = 40 over 3 s, 40 iterations at most) from ``home_state()`` to the two
  targets of ``chip_smoke.MANIP_TARGETS`` (``tests/test_robot_zoo.py:98-130``),
  and, with the b256 lane's 30, to the first 32 of ``manipulator_sqp_b256``'s
  seeded targets (``chip_smoke.manipulator_targets``) under ``jax.vmap``;
* the URDF arms of ``chip_smoke.URDF_VARIANTS`` on their base types (rk4,
  N = 40 over 2 s, 25 iterations at most, the target ``URDF_TARGET_OFFSET``
  from the home EE position: ``tests/test_manipulator_variants.py:40-72``);
* the fully actuated UR5 to the far target (2.0, 1.0, 0.8) with an 80-
  iteration budget (``tests/test_manipulator_variants.py:94-111``).

A single problem's record is its solve as it is, and its spread the
distance to the JAX package's vmapped solve of a batch of that one problem;
the 32 targets' record is their vmapped solve, and its spread the distance
to each target solved alone and vmapped alone (``tools/_spread.py``).
Writes ``tests/torch_data/manipulator_reference.npz`` (numpy
``savez_compressed``): per solve the start, target, xs, us, iterations,
merit, and each other route's iterations and distance in xs and us.  ``chip_smoke.py`` and
``tests/test_torch_manipulator.py`` hold the port against it.  A few
minutes, most of it compiling; imports only the JAX package (and
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

FAR_TARGET, FAR_N, FAR_HORIZON, FAR_MAX_ITERATIONS = (2.0, 1.0, 0.8), 45, 3.0, 80


def main() -> int:
    import chip_smoke as cs

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--record", nargs="?", const=cs.MANIP_RECORD, metavar="PATH",
                    required=True, help=f"write the record (default {cs.MANIP_RECORD})")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from ocs2_tpu.models import mobile_manipulator as mm
    from ocs2_tpu.models.urdf import asset_path, chain_from_urdf
    from ocs2_tpu.oc.time_discretization import uniform_grid
    from ocs2_tpu.solvers import sqp
    from tools._spread import describe, routes_of, spread_fields

    rec = {}
    t_start = time.perf_counter()

    def record(key, problem, grid, x0, target, settings):
        params = mm.make_params(ee_target=tuple(np.asarray(target, np.float64)))
        sol = jax.jit(lambda x: sqp.solve(problem, grid, x, params, settings=settings))(x0)
        one = jax.jit(jax.vmap(lambda x: sqp.solve(problem, grid, x, params,
                                                   settings=settings)))(x0[None])
        xs, us, its = np.asarray(sol.xs), np.asarray(sol.us), np.asarray(sol.iterations)
        rec.update({
            f"{key}_x0": np.asarray(x0), f"{key}_target": np.asarray(target, np.float32),
            f"{key}_xs": xs, f"{key}_us": us, f"{key}_iterations": its,
            f"{key}_merit": np.asarray(sol.performance.merit),
        })
        fields = spread_fields(f"{key}_", xs[None], us[None], its[None], {
            "vmapped_one": (np.asarray(one.xs), np.asarray(one.us), np.asarray(one.iterations))})
        rec.update({k: v[0] for k, v in fields.items()})
        print(f"{key}: iterations {int(its)}, {describe(rec, f'{key}_')}, "
              f"{time.perf_counter() - t_start:.0f} s", flush=True)
        return xs

    grid = uniform_grid(0.0, cs.MANIP_HORIZON, cs.MANIP_N)
    st = sqp.SqpSettings(max_iterations=cs.MANIP_MAX_ITERATIONS, integrator="rk2")
    for name, target in cs.MANIP_TARGETS.items():
        xs = record(f"builtin_{name}", mm.make_problem("soft"), grid, mm.home_state(), target, st)
        rec[f"builtin_{name}_ee_error"] = np.linalg.norm(
            np.asarray(mm.ee_pose(jnp.asarray(xs[-1]))[0]) - np.asarray(target))
        rec[f"builtin_{name}_min_sphere_distance"] = np.asarray(
            jax.vmap(lambda x: mm.self_collision(0.0, x, {}))(jnp.asarray(xs)).min())

    # The first MANIP_PLAIN_BATCH of manipulator_sqp_b256's targets: the
    # vmapped solve (the record) and each target alone (the spread).
    targets = jnp.asarray(cs.manipulator_targets(cs.MANIP_BATCH)[: cs.MANIP_PLAIN_BATCH])

    st_b256 = sqp.SqpSettings(max_iterations=cs.MANIP_B256_MAX_ITERATIONS, integrator="rk2")

    def to_target(tgt):
        return sqp.solve(mm.make_problem("soft"), grid, mm.home_state(), {"ee_target": tgt},
                         settings=st_b256)

    batched = jax.jit(jax.vmap(to_target))
    sol = batched(targets)
    xs, us, its = np.asarray(sol.xs), np.asarray(sol.us), np.asarray(sol.iterations)
    rec.update({"b256_targets": np.asarray(targets), "b256_xs": xs, "b256_us": us,
                "b256_iterations": its, "b256_merit": np.asarray(sol.performance.merit)})
    rec.update(spread_fields("b256_", xs, us, its, routes_of(to_target, batched, targets)))
    print(f"b256's first {len(targets)}: iterations {its.tolist()}, {describe(rec, 'b256_')}, "
          f"{time.perf_counter() - t_start:.0f} s", flush=True)

    loaded = {arm: chain_from_urdf(asset_path(cfg["urdf"]), cfg["base"], cfg["ee"],
                                   remove_joints=cfg["remove"])
              for arm, cfg in cs.URDF_ARMS.items()}
    grid = uniform_grid(0.0, cs.URDF_HORIZON, cs.URDF_N)
    st = sqp.SqpSettings(max_iterations=cs.URDF_MAX_ITERATIONS, integrator="rk4")
    for arm, base_type in cs.URDF_VARIANTS:
        lc = loaded[arm]
        x0 = mm.variant_home_state(lc, base_type, q_home=cs.URDF_ARMS[arm]["q_home"])
        nb = mm._base_dims(base_type, lc.chain.num_dof)[0]
        target = (np.asarray(lc.chain.forward(x0[nb:])[0])
                  + np.asarray(cs.URDF_TARGET_OFFSET, np.float32))
        problem = mm.make_urdf_manipulator_problem(lc, base_type=base_type)
        record(cs.urdf_variant_key(arm, base_type), problem, grid, x0, target, st)

    base_type = "fully_actuated_floating_arm"
    lc = loaded["ur5"]
    record("far", mm.make_urdf_manipulator_problem(lc, base_type=base_type,
                                                   base_velocity_limit=2.0),
           uniform_grid(0.0, FAR_HORIZON, FAR_N),
           mm.variant_home_state(lc, base_type, q_home=cs.URDF_ARMS["ur5"]["q_home"]),
           np.asarray(FAR_TARGET, np.float32),
           sqp.SqpSettings(max_iterations=FAR_MAX_ITERATIONS, integrator="rk4"))

    os.makedirs(os.path.dirname(os.path.abspath(args.record)), exist_ok=True)
    np.savez_compressed(args.record, **rec)
    print(f"wrote {args.record} in {time.perf_counter() - t_start:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
