#!/usr/bin/env python3
"""The loopshaped legged solves and closed loop of ``chip_smoke.py``'s phases
``loopshaping_trot_b1`` and ``loopshaping_closed_loop`` in the JAX package, on
the CPU.

    JAX_PLATFORMS=cpu python3 tools/loopshaping_reference.py --record [PATH]
    JAX_PLATFORMS=cpu python3 tools/loopshaping_reference.py --compare CARD.json

``--record`` runs, with the JAX package's ``sqp.solve`` (jitted):

* the loopshaped trot of ``tests/test_legged_loopshaping.py:29-110``
  (``make_loopshaping_problem()``, trot 0.7 s, N = 40 over 1 s, from the
  augmented default state warm-started by ``loopshaped_warm_start``) at
  ``make_solver_settings()``'s 12 iterations and at 3;
* the unshaped solve of the same task (``:142-149``: ``make_problem()``,
  rk2, 12 iterations, from the weight-compensating input) and both shaping
  functionals (``chip_smoke.shaping_functional``);
* the dummy MRT loop of ``:158-199`` (``Mpc`` with the
  ``SwitchedModelReferenceManager``, N = 28 over 0.7 s, 6 iterations, 12.5 Hz
  MPC, 50 Hz control, 1.2 s): every tick's time, observed state, iterations
  and merit, and the loop's states;

and each one's spread (``tools/_spread.py``; here the largest distance
between any two of the routes, the record among them): a solve against the same solve
under ``jax.vmap`` on a batch of one, against the solve from the start one
float32 ulp above and below (every component, ``np.nextafter``) and against
the solve whose Hessian correction's eigendecomposition runs in float64
(``Eigh64``); the loop against the same loop whose every tick is solved
under ``jax.vmap``, from the start one ulp above, and with the float64
eigendecomposition (the difference of the loop's states at each control
step, and the range of the iterations and merits at each tick).  The ulp
and float64 routes are there because these solves are decided by float32
rounding: the loopshaped problem has no cost on the filter state at the
last node, the eigenvalues of that zero block come out of a float32 eigh as
rounding noise and are clamped or kept by their sign, and the first SQP
step moves by 1.4 in xs when the port's eigh runs in float64; the
12-iteration trot then wanders on a merit plateau (164.0 +- 0.2 from its
fourth iteration on).  Writes
``tests/torch_data/loopshaping_reference.npz``, which ``chip_smoke.py`` and
``tests/test_torch_loopshaping.py`` hold the port against.  ``--compare``
reads the JSON that ``chip_smoke.py --loopshaping-out`` wrote on the card and
prints its distance from the record.  About 20 minutes on the CPU, most of
it compiling and the float64-eigh routes' host callbacks; imports only the JAX package (and ``chip_smoke``'s constants).
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
# The JAX test's loop (1.2 s, 15 ticks); chip_smoke.py runs the first 10.
RECORD_LOOP_DURATION = 1.2
# The LQ data (tests/test_torch_loopshaping.py): N = 4 over 0.1 s.
LQ_N, LQ_HORIZON = 4, 0.1


def lq_trajectory(xa0, seed=12):
    """A seeded trajectory around the augmented stance xa0 [48] for the LQ
    data of the record: xs [1, N+1, 48], us [1, N, 24] (forces within
    about 5 N, joint rates 0.5 rad/s of the filter state's input)."""
    rng = np.random.default_rng(seed)
    xs = xa0 + 0.05 * rng.standard_normal((1, LQ_N + 1, 48))
    us = xa0[24:] + np.concatenate([5.0 * rng.standard_normal((1, LQ_N, 12)),
                                    0.5 * rng.standard_normal((1, LQ_N, 12))], -1)
    return xs.astype(np.float32), us.astype(np.float32)


def trot_fixture():
    """(problem, defn, grid, params, x0, u0, xa0, xs_init, us_init) of the
    loopshaped trot, as the JAX test's ``trot_setup`` builds it."""
    import jax.numpy as jnp

    import chip_smoke as cs
    from ocs2_tpu.models.legged_robot import interface, model
    from ocs2_tpu.models.legged_robot.gait import GaitSchedule, trot_gait
    from ocs2_tpu.models.legged_robot.loopshaping_mpc import (
        augment_state,
        loopshaped_warm_start,
        make_loopshaping_problem,
    )
    from ocs2_tpu.oc.time_discretization import make_time_grid

    problem, defn = make_loopshaping_problem()
    ms = GaitSchedule(trot_gait(0.7)).mode_schedule(0.0, cs.LS_HORIZON)
    grid = make_time_grid(0.0, cs.LS_HORIZON, cs.LS_N, event_times=np.asarray(ms.event_times),
                          mode_sequence=np.asarray(ms.mode_sequence))
    params = interface.make_params(grid)
    x0 = model.default_state()
    u0 = model.weight_compensating_input(jnp.ones(4))
    xs_init, us_init = loopshaped_warm_start(defn, grid, x0)
    return problem, defn, grid, params, x0, u0, augment_state(defn, x0, u0), xs_init, us_init


class Eigh64:
    """Within the block, the eigendecomposition of SQP's Hessian correction
    (``jnp.linalg.eigh`` in ``ops/riccati.convexify``) runs in float64 on the
    host and is rounded to float32: the same function, another rounding.
    The stage Hessians of the loopshaped problem have an exactly zero block
    (no cost on the filter state at the last node), whose eigenvalues come
    out of a float32 eigh as rounding noise around 1e-4 and are clamped or
    kept by their sign, so this rounding decides the QP's step there."""

    def __enter__(self):
        import jax
        import jax.numpy as jnp

        self._saved = jnp.linalg.eigh

        def host(a):
            w, v = np.linalg.eigh(np.asarray(a, np.float64))
            return w.astype(np.float32), v.astype(np.float32)

        def eigh64(z, *args, **kwargs):
            out = (jax.ShapeDtypeStruct(z.shape[:-1], z.dtype),
                   jax.ShapeDtypeStruct(z.shape, z.dtype))
            return jax.pure_callback(host, out, z, vmap_method="expand_dims")

        jnp.linalg.eigh = eigh64
        return self

    def __exit__(self, *exc):
        import jax.numpy as jnp

        jnp.linalg.eigh = self._saved


def pairwise_max(arrays, axis=None):
    """The largest absolute difference between any two of ``arrays`` (over
    all but ``axis``, which is kept)."""
    out = [np.abs(a.astype(np.float64) - b).max(axis=tuple(
        i for i in range(a.ndim) if i != axis) if axis is not None else None)
        for k, a in enumerate(arrays) for b in arrays[k + 1:]]
    return np.max(out, axis=0).astype(np.float32)


def ulp(x, direction):
    """x one float32 ulp toward +inf (direction 1) or -inf (-1), every
    component."""
    x = np.asarray(x, np.float32)
    return np.nextafter(x, np.float32(direction * np.inf)).astype(np.float32)


def closed_loop(vmapped: bool, start_ulp: int = 0):
    """The JAX test's dummy loop; with ``vmapped`` every tick is solved inside
    ``jax.vmap`` on a batch of one, with ``start_ulp`` the start moved by one
    ulp.  Returns (per-tick records, states)."""
    import jax
    import jax.numpy as jnp

    import chip_smoke as cs
    from ocs2_tpu.models.legged_robot import interface, model
    from ocs2_tpu.models.legged_robot.gait import GaitSchedule, trot_gait
    from ocs2_tpu.models.legged_robot.loopshaping_mpc import (
        augment_state,
        make_loopshaping_problem,
        make_solver_settings,
    )
    from ocs2_tpu.mpc.mpc import Mpc, MpcSettings
    from ocs2_tpu.mpc.mrt import MpcMrtInterface, dummy_loop
    from ocs2_tpu.oc.time_discretization import make_time_grid

    problem, defn = make_loopshaping_problem()
    gs = GaitSchedule(trot_gait(0.7))
    ms0 = gs.mode_schedule(0.0, cs.LS_LOOP_HORIZON)
    grid0 = make_time_grid(0.0, cs.LS_LOOP_HORIZON, cs.LS_LOOP_N,
                           event_times=np.asarray(ms0.event_times),
                           mode_sequence=np.asarray(ms0.mode_sequence))
    mpc = Mpc(problem, interface.make_params(grid0),
              settings=MpcSettings(time_horizon=cs.LS_LOOP_HORIZON, num_intervals=cs.LS_LOOP_N,
                                   solver="sqp"),
              solver_settings=make_solver_settings(max_iterations=cs.LS_LOOP_MAX_ITERATIONS),
              reference_manager=interface.SwitchedModelReferenceManager(gs))
    solve = mpc._jitted
    if vmapped:
        wide = jax.jit(jax.vmap(mpc._device_solve, in_axes=(None, 0, None, None, None, None)))

        def solve(grid, x, *rest):
            return jax.tree.map(lambda v: v[0], wide(grid, x[None], *rest))

    ticks = []

    def counted(grid, x, *rest):
        sol, ctrl = solve(grid, x, *rest)
        ticks.append({"t": float(grid.times[0]), "x": np.asarray(x),
                      "iterations": int(sol.iterations),
                      "merit": float(sol.performance.merit)})
        return sol, ctrl

    mpc._jitted = counted
    xa0 = augment_state(defn, model.default_state(), model.weight_compensating_input(jnp.ones(4)))
    if start_ulp:
        xa0 = jnp.asarray(ulp(xa0, start_ulp))
    _, xs, _ = dummy_loop(MpcMrtInterface(mpc), xa0, duration=RECORD_LOOP_DURATION,
                          mrt_frequency=cs.LS_MRT_HZ, mpc_frequency=cs.LS_MPC_HZ)
    return ticks, np.asarray(xs)


def lq_record() -> dict:
    """The JAX package's ``approximate_lq`` of the loopshaped problem
    (AL-augmented, the foot constraint kept for the projection) on a trot
    grid of ``LQ_N`` intervals over ``LQ_HORIZON``, rk2 with 2
    substeps, at one seeded trajectory around the augmented stance: ``lq_xs``,
    ``lq_us`` and every leaf as ``lq_<record>.<field>``."""
    import jax
    import jax.numpy as jnp

    from ocs2_tpu.models.legged_robot import interface, model
    from ocs2_tpu.models.legged_robot.gait import GaitSchedule, trot_gait
    from ocs2_tpu.models.legged_robot.loopshaping_mpc import (
        anymal_loopshaping_definition,
        augment_state,
        make_loopshaping_problem,
    )
    from ocs2_tpu.oc import approx
    from ocs2_tpu.oc.time_discretization import make_time_grid
    from ocs2_tpu.solvers import al

    n = LQ_N
    ms = GaitSchedule(trot_gait(0.7)).mode_schedule(0.0, LQ_HORIZON)
    grid = make_time_grid(0.0, LQ_HORIZON, n, event_times=np.asarray(ms.event_times),
                          mode_sequence=np.asarray(ms.mode_sequence))
    xs, us = lq_trajectory(np.asarray(augment_state(
        anymal_loopshaping_definition(), model.default_state(),
        model.weight_compensating_input(jnp.ones(4)))))
    problem, _ = make_loopshaping_problem()
    aug = al.augment_problem(problem, project_equalities=True)
    params = interface.make_params(grid)
    dims = problem.constraint_dims(dict(params, mode=jnp.int32(0), node=jnp.int32(0)))
    lq = jax.jit(jax.vmap(lambda x, u: approx.approximate_lq(
        aug, grid, x, u, dict(params, al=al.AlState.init(dims, n, 10.0)), method="rk2",
        substeps=2)))(jnp.asarray(xs), jnp.asarray(us))
    out = {"lq_xs": xs, "lq_us": us, "lq_grid_times": np.asarray(grid.times)}
    for name, part in lq._asdict().items():
        if part is None:
            continue
        for field, v in part._asdict().items():
            if v is not None:
                out[f"lq_{name}.{field}"] = np.asarray(v)
    return out


def record(path) -> dict:
    import jax
    import jax.numpy as jnp

    import chip_smoke as cs
    from ocs2_tpu.models.legged_robot import interface, model
    from ocs2_tpu.models.legged_robot.gait import contact_flags_static
    from ocs2_tpu.models.legged_robot.loopshaping_mpc import make_solver_settings
    from ocs2_tpu.solvers import sqp
    from tools._spread import describe, spread_fields

    t_start = time.perf_counter()
    problem, defn, grid, params, x0, u0, xa0, xs_init, us_init = trot_fixture()
    modes = np.asarray(grid.modes)
    swing = np.asarray([[contact_flags_static(int(m))[leg] < 0.5 for leg in range(4)]
                        for m in modes[:-1]])
    p_diag, g_diag = -np.diag(np.asarray(defn.A)), np.diag(np.asarray(defn.D))
    dt = float(grid.times[1] - grid.times[0])
    rec = {"xa0": np.asarray(xa0), "xs_init": np.asarray(xs_init),
           "us_init": np.asarray(us_init), "grid_times": np.asarray(grid.times),
           "grid_modes": modes, "u0": np.asarray(u0)}

    def solve_and_spread(key, prob, x, settings, **init):
        def solve(xx):
            return sqp.solve(prob, grid, xx, params, settings=settings, **init)

        jitted = jax.jit(solve)
        sol = jitted(x)
        xs, us, its = np.asarray(sol.xs), np.asarray(sol.us), np.asarray(sol.iterations)
        rec.update({f"{key}_xs": xs, f"{key}_us": us, f"{key}_iterations": its,
                    f"{key}_merit": np.asarray(sol.performance.merit),
                    f"{key}_dynamics_violation_sse":
                        np.asarray(sol.performance.dynamics_violation_sse)})
        routes = {"vmapped_one": jax.jit(jax.vmap(solve))(x[None])}
        routes["ulp_up"] = jitted(jnp.asarray(ulp(x, 1)))
        routes["ulp_down"] = jitted(jnp.asarray(ulp(x, -1)))
        with Eigh64():
            routes["eigh64"] = jax.jit(lambda xx: solve(xx))(x)
            routes["eigh64_vmapped_one"] = jax.jit(jax.vmap(lambda xx: solve(xx)))(x[None])
            routes["eigh64_ulp_up"] = jax.jit(lambda xx: solve(xx))(jnp.asarray(ulp(x, 1)))
        for name, r in routes.items():
            rec[f"{key}_{name}_merit"] = np.asarray(r.performance.merit).reshape(())
            rec[f"{key}_{name}_xs"] = np.asarray(r.xs).reshape(xs.shape)
            rec[f"{key}_{name}_us"] = np.asarray(r.us).reshape(us.shape)
        fields = spread_fields(f"{key}_", xs[None], us[None], its[None], {
            name: (np.asarray(r.xs).reshape(1, *xs.shape), np.asarray(r.us).reshape(1, *us.shape),
                   np.asarray(r.iterations).reshape(1))
            for name, r in routes.items()})
        rec.update({k: v[0] for k, v in fields.items()})
        # The spread is the largest distance between any two of the routes
        # (the record among them), not only from the record; the float64-eigh
        # family's (eigh64 and its vmapped and one-ulp twins) apart.
        family = [n for n in routes if n.startswith("eigh64")]
        for f, mine in (("xs", xs), ("us", us)):
            rec[f"{key}_spread_{f}"] = pairwise_max(
                [mine] + [rec[f"{key}_{name}_{f}"] for name in routes])
            rec[f"{key}_eigh64_family_spread_{f}"] = pairwise_max(
                [rec[f"{key}_{name}_{f}"] for name in family])
        forces = us[:, :12].reshape(-1, 4, 3)
        rec[f"{key}_max_swing_force"] = np.float32(np.abs(forces[swing]).max())
        rec[f"{key}_base_height_max_abs_dev"] = np.float32(
            np.abs(xs[:, 8] - model.STAND_HEIGHT).max())
        print(f"{key}: iterations {int(its)}, merit {float(sol.performance.merit):.6g} (routes "
              f"{[float(rec[f'{key}_{n}_merit']) for n in routes]}), {describe(rec, f'{key}_')}, "
              f"pairwise spread xs {rec[f'{key}_spread_xs']:.3g} us {rec[f'{key}_spread_us']:.3g} "
              f"(float64-eigh family {rec[f'{key}_eigh64_family_spread_xs']:.3g} / "
              f"{rec[f'{key}_eigh64_family_spread_us']:.3g}), "
              f"{time.perf_counter() - t_start:.0f} s", flush=True)
        return us

    for key, its in (("trot", None), ("trot3", 3)):
        st = make_solver_settings() if its is None else make_solver_settings(max_iterations=its)
        us = solve_and_spread(key, problem, xa0, st, xs_init=xs_init, us_init=us_init)
        rec[f"{key}_shaping_functional"] = np.float64(
            cs.shaping_functional(us, p_diag, g_diag, dt, np.asarray(u0)))
    us = solve_and_spread("unshaped", interface.make_problem(), x0,
                          sqp.SqpSettings(max_iterations=12, integrator="rk2"),
                          us_init=jnp.tile(u0[None], (cs.LS_N, 1)))
    rec["unshaped_shaping_functional"] = np.float64(
        cs.shaping_functional(us, p_diag, g_diag, dt, np.asarray(u0)))
    print(f"shaping functional: shaped {rec['trot_shaping_functional']:.6g}, unshaped "
          f"{rec['unshaped_shaping_functional']:.6g}", flush=True)

    loop_routes = ("", "vmapped_", "ulp_up_", "eigh64_", "eigh64_vmapped_", "eigh64_ulp_up_")
    for route in loop_routes:
        with Eigh64() if route.startswith("eigh64") else contextlib.nullcontext():
            ticks, xs = closed_loop(vmapped=route.endswith("vmapped_"),
                                    start_ulp=int(route.endswith("ulp_up_")))
        rec.update({f"loop_{route}tick_t": np.asarray([k["t"] for k in ticks]),
                    f"loop_{route}tick_x": np.stack([k["x"] for k in ticks]),
                    f"loop_{route}iterations": np.asarray([k["iterations"] for k in ticks]),
                    f"loop_{route}merit": np.asarray([k["merit"] for k in ticks]),
                    f"loop_{route}states": xs})
        print(f"loop {route or 'jit '}: iterations {[k['iterations'] for k in ticks]}, "
              f"{time.perf_counter() - t_start:.0f} s", flush=True)
    xs = rec["loop_states"]
    routes = loop_routes
    rec["loop_spread_states"] = pairwise_max([rec[f"loop_{r}states"] for r in routes], axis=0)
    rec["loop_eigh64_family_spread_states"] = pairwise_max(
        [rec[f"loop_{r}states"] for r in routes if r.startswith("eigh64")], axis=0)
    rec["loop_iterations_lo"] = np.min([rec[f"loop_{r}iterations"] for r in routes], axis=0)
    rec["loop_iterations_hi"] = np.max([rec[f"loop_{r}iterations"] for r in routes], axis=0)
    rec["loop_merit_lo"] = np.min([rec[f"loop_{r}merit"] for r in routes], axis=0)
    rec["loop_merit_hi"] = np.max([rec[f"loop_{r}merit"] for r in routes], axis=0)
    rec["loop_base_height_max_abs_dev"] = np.float32(np.abs(xs[:, 8] - model.STAND_HEIGHT).max())
    rec["loop_attitude_max_abs"] = np.float32(np.abs(xs[:, 9:12]).max())
    print(f"loop spread: states {rec['loop_spread_states'].max():.3g} (float64-eigh family "
          f"{rec['loop_eigh64_family_spread_states'].max():.3g}), height dev "
          f"{rec['loop_base_height_max_abs_dev']:.4g}", flush=True)

    rec.update(lq_record())
    print(f"LQ data at N = {LQ_N}: {time.perf_counter() - t_start:.0f} s", flush=True)

    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez_compressed(path, **rec)
    print(f"wrote {path} in {time.perf_counter() - t_start:.1f} s", flush=True)
    return rec


def compare(rec, port) -> dict:
    """The card's run (``chip_smoke.py --loopshaping-out``) against the record."""
    out = {}
    for key in ("trot", "unshaped"):
        p = port[key]
        out[key] = {
            "iterations": [int(p["iterations"]), int(rec[f"{key}_iterations"])],
            "max_abs_xs": float(np.abs(np.asarray(p["xs"], np.float32) - rec[f"{key}_xs"]).max()),
            "max_abs_us": float(np.abs(np.asarray(p["us"], np.float32) - rec[f"{key}_us"]).max()),
            "jax_spread": [float(rec[f"{key}_spread_xs"]), float(rec[f"{key}_spread_us"])],
            "max_abs_from_eigh64_route": [
                float(np.abs(np.asarray(p[f], np.float32) - rec[f"{key}_eigh64_{f}"]).max())
                for f in ("xs", "us")],
            "shaping_functional": [p["shaping_functional"],
                                   float(rec[f"{key}_shaping_functional"])],
        }
    loop = port["loop"]
    its = np.asarray(loop["iterations_per_tick"])
    ref_its = rec["loop_iterations"][: len(its)]
    states = np.asarray(loop["states"], np.float32)
    out["loop"] = {
        "ticks": len(its), "ticks_with_equal_iterations": int((its == ref_its).sum()),
        "iterations_per_tick": [its.tolist(), ref_its.tolist()],
        "max_abs_state_difference": float(
            np.abs(states - rec["loop_states"][: len(states)]).max()),
        "jax_spread_states_max": float(rec["loop_spread_states"][: len(states)].max()),
        "max_abs_state_difference_from_eigh64_loop": float(
            np.abs(states - rec["loop_eigh64_states"][: len(states)]).max()),
    }
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--record", nargs="?", const="", metavar="PATH",
                    help="write the record (default tests/torch_data/loopshaping_reference.npz)")
    ap.add_argument("--compare", metavar="JSON", help="the card's --loopshaping-out record")
    args = ap.parse_args()
    if args.record is None and not args.compare:
        ap.error("give --record or --compare")

    import jax

    jax.config.update("jax_platforms", "cpu")
    import chip_smoke as cs

    if args.record is not None:
        rec = record(args.record or cs.LS_RECORD)
    else:
        with np.load(cs.LS_RECORD) as f:
            rec = {k: f[k] for k in f.files}
    if args.compare:
        with open(args.compare) as f:
            print(json.dumps(compare(rec, json.load(f))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
