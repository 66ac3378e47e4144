#!/usr/bin/env python3
"""Re-solve ticks of the card's perceptive loops in the port, on the CPU or the card.

    python3 tools/perceptive_port_resolve.py perceptive.json [--tick K] [--device cuda]

Reads the record ``chip_smoke.py --perceptive-out`` writes on the card and
solves, through the port on ``--device`` (the CPU by default):

* tick K (default 7) of ``perceptive_mpc`` from its exact inputs (the
  recorded state and warm start; the plan is the host planner's on that
  state, as on the card), by each backward-sweep route of the device (on the
  card: the kernel, the single-scenario sweep of torch ops and the plain
  batched version; on the CPU: the last two), and gives each route's merit
  per iteration and how far its next state lies from the card's;
* the third re-solved tick of ``perceptive_closed_loop`` from its recorded
  solver arguments, through the single-scenario sweep and through the plain
  batched sweep (clamped pivots), and gives how far the contact forces of the
  two routes lie from each other and from the card's recorded kernel and
  single-sweep results.

The counterpart of ``tools/perceptive_reference.py --resolve K
--force-spread`` for the JAX package.  Imports neither JAX nor the JAX
package.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _tensors(rec, device):
    """The recorded solver arguments as the port's records on ``device``."""
    import torch

    from ocs2_tpu_torch import convert
    from ocs2_tpu_torch.solvers.al import AlState

    f32 = lambda v: torch.as_tensor(np.asarray(v, np.float32), device=device)  # noqa: E731
    return dict(
        grid=convert.time_grid_from_numpy(rec["grid"], device=device),
        x0=f32(rec["x0"]), xs_init=f32(rec["xs_init"]), us_init=f32(rec["us_init"]),
        al_init=AlState(**{k: f32(v) for k, v in rec["al_init"].items()}),
        params=convert.params_from_numpy(rec["params"], device=device))


def resolve_mpc_tick(port, k, device):
    import torch

    import chip_smoke as cs
    from ocs2_tpu_torch.models.legged_robot.foothold_planner import plan_footholds, plan_to_params
    from ocs2_tpu_torch.solvers import sqp

    cs.DEVICE = device
    cfg = cs.perceptive_setup(torch)
    x = torch.as_tensor(np.asarray(port["states"][k], np.float32), device=device)
    us = torch.as_tensor(np.asarray(port["us_init_per_tick"][k], np.float32), device=device)
    plan = plan_footholds(cfg["terrain_host"], cfg["em_host"], cfg["grid"].times,
                          cfg["grid"].modes, x, cfg["target_host"])
    params = plan_to_params(plan, cfg["params"])
    card_next = np.asarray(port["states"][k + 1], np.float32)
    routes = {"single_sweep": dict(force_single_riccati=True),
              "plain_batched": dict(force_plain_riccati=True)}
    if device == "cuda":
        routes = {"kernel": {}, **routes}
    out = {"tick": k, "device": device, "card_iterations": port["iterations_per_tick"][k],
           "card_merit": port["merit_per_tick"][k]}
    for name, kw in routes.items():
        sol = sqp.solve(cfg["problem"], cfg["grid"], x, params, us_init=us,
                        settings=cfg["settings"], device=device, **kw)
        out[name] = {"iterations": int(sol.iterations[0]),
                     "merit": float(sol.performance.merit[0]),
                     "merit_per_iteration": sol.history.merit[0].tolist(),
                     "step_size_per_iteration": sol.history.step_size[0].tolist(),
                     "next_state_vs_card": float(np.abs(card_next
                                                        - sol.xs[0, 1].cpu().numpy()).max())}
    return out


def force_spread(port, device, tick=2):
    from ocs2_tpu_torch.models.legged_robot.foothold_planner import (
        make_segmented_perceptive_problem,
    )
    from ocs2_tpu_torch.solvers import sqp

    rec = port["resolved_ticks"][tick]
    inp = _tensors(rec["inputs"], device)
    problem = make_segmented_perceptive_problem(device=device)
    st = sqp.SqpSettings(max_iterations=6, integrator="rk2")

    def solve(**kw):
        return sqp.solve(problem, inp["grid"], inp["x0"], inp["params"], xs_init=inp["xs_init"],
                         us_init=inp["us_init"], al_init=inp["al_init"], settings=st,
                         device=device, **kw)

    routes = {f"{device}_single_sweep": solve(force_single_riccati=True),
              f"{device}_plain_batched": solve(force_plain_riccati=True)}
    forces = {k: v.us[0, :, :12].cpu().numpy() for k, v in routes.items()}
    forces["card_kernel"] = np.asarray(rec["kernel"]["us"], np.float32)[:, :12]
    forces["card_single_sweep"] = np.asarray(rec["single_sweep"]["us"], np.float32)[:, :12]
    names = sorted(forces)
    return {"tick": tick,
            "iterations": {k: int(v.iterations[0]) for k, v in routes.items()},
            "contact_force_max_abs_diff": {
                f"{a} vs {b}": float(np.abs(forces[a] - forces[b]).max())
                for i, a in enumerate(names) for b in names[i + 1:]}}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("record", help="the card's perceptive record (chip_smoke.py --perceptive-out)")
    ap.add_argument("--tick", type=int, default=7, help="the perceptive MPC tick to re-solve")
    ap.add_argument("--device", default="cpu", choices=("cpu", "cuda"))
    args = ap.parse_args()
    with open(args.record) as f:
        port = json.load(f)
    t0 = time.perf_counter()
    rec = {"port": "ocs2_tpu_torch", "device": args.device,
           "resolve": resolve_mpc_tick(port["perceptive_mpc"], args.tick, args.device),
           "force_spread": force_spread(port["perceptive_closed_loop"], args.device)}
    rec["seconds_cpu"] = time.perf_counter() - t0
    print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
