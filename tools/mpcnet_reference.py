#!/usr/bin/env python3
"""MPC-Net's training runs of ``chip_smoke.py``'s phases
``mpcnet_legged_train``, ``mpcnet_legged_datagen_b256`` and
``mpcnet_ballbot_train`` in the JAX package, on the CPU.

    JAX_PLATFORMS=cpu python3 tools/mpcnet_reference.py --record [PATH]
    JAX_PLATFORMS=cpu python3 tools/mpcnet_reference.py --compare CARD.json

``--record`` runs ``ocs2_tpu.learning``'s training loop (``Mpcnet.train``,
step by step as it runs it: the same key splits, the data round jitted, the
Adam steps jitted) for ``make_legged_mpcnet()`` from ``PRNGKey(5)`` and
``make_ballbot_mpcnet()`` from ``PRNGKey(2)`` (``chip_smoke.MPCNET_KEYS``),
each at its robot's default settings, and writes for each:

* the initial flax weights, every round's starts (the JAX sampler's draws)
  and alpha, and every round's Adam losses;
* round 0 (alpha 1): its samples, their spread (``spread_of``: each
  scenario rolled out alone, vmapped on a batch of itself, and alone from
  its start one ulp above and below; per scenario the largest distance of
  each field from the record), the
  indices of its Adam steps' draws (computed from the JAX keys as
  ``CircularMemory.sample`` draws them) and the weights after those steps;
* the trained weights and ``evaluate`` from the first start of round 0
  (legged) or the JAX test's lean x[3] = 0.12 (ballbot: also the test's
  closed-loop state error of the trained and of a fresh ``PRNGKey(3)``
  policy, whose weights are stored);
* the count of non-finite QP steps in every round (a QP whose forward pass
  is not finite: the JAX package's vmapped strict sweep gives NaN where the
  reduced Hessian is not positive definite), over every scenario of every
  iteration the batched loop ran.

Then the alpha = 1 data round of ``mpcnet_legged_datagen_b256``: the 256
starts of ``chip_smoke.mpcnet_b256_x0s`` vmapped in one program, of which the
first 32 scenarios' samples are stored with their spread; and the small case
of ``tests/test_learning.py:311-366`` (2 scenarios x 2 steps, SQP 3
iterations, 5 Adam steps from ``fold_in`` keys, their draws stored).

Writes ``tests/torch_data/mpcnet_reference.npz`` (flat keys, e.g.
``legged/r0/samples/Huu``; weights in the export's keys under
``<lane>/init/``, ``<lane>/r0/weights/``, ``<lane>/final/``).
``--compare`` reads ``chip_smoke.py --mpcnet-out``'s JSON and prints the
card's numbers beside the record's.  About 15 minutes, most of it XLA
compiling the legged data rounds; imports only the JAX package (and
``chip_smoke``'s constants).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
FIELDS = ("t", "x", "u_star", "h0", "hu", "Huu")
SMALL = dict(rollout_steps=2, control_dt=0.05, batch_size=8, learning_rate=5e-3,
             learning_iterations=10, memory_capacity=64, data_scenarios=2, rounds=1,
             mpc_horizon=0.7, mpc_intervals=14)  # tests/test_learning.py:329-342
SMALL_KEY, SMALL_STEPS, FRESH_KEY = 5, 5, 3


class NonFiniteSteps:
    """Counts QP solves whose forward pass is not finite, through a host
    callback in ``ocs2_tpu.solvers.sqp``'s ``lqr_forward`` (installed before
    anything is traced)."""

    def __init__(self):
        import jax
        import jax.numpy as jnp

        from ocs2_tpu.solvers import sqp as jsqp

        self.count = 0
        original = jsqp.lqr_forward

        def forward(coeffs, sol, dx0):
            dxs, dus = original(coeffs, sol, dx0)
            bad = jnp.logical_not(jnp.all(jnp.isfinite(dxs)) & jnp.all(jnp.isfinite(dus)))
            jax.debug.callback(self._add, bad)
            return dxs, dus

        jsqp.lqr_forward = forward

    def _add(self, bad):
        self.count += int(np.sum(np.asarray(bad)))

    def take(self) -> int:
        out, self.count = self.count, 0
        return out


def flat(prefix, tree):
    return {f"{prefix}/{k}": np.asarray(v) for k, v in tree.items()}


def samples_dict(samples):
    return {f: np.asarray(getattr(samples, f)) for f in FIELDS}


def spread_of(net, params, samples, x0s, steps):
    """Per scenario, the largest distance of each field from ``samples`` (the
    vmapped record, [S * steps, ...]) to four other routes of the JAX
    package to it: the scenario rolled out alone, vmapped on a batch of
    itself, and alone from its start one float32 ulp above and below (every
    component, ``np.nextafter``).  The legged robot's contact forces are
    decided by rounding: their split between the stance legs is held by a
    1e-3 weight only, and a start one ulp away moves u* by up to 7.5e-3
    (the port's own route on the CPU likewise)."""
    import jax
    import jax.numpy as jnp

    single = jax.jit(lambda x: net.rollout_scenario(params, jnp.float32(1.0), jnp.float32(0.0), x))
    one = jax.jit(lambda x: net.generate_data(params, jnp.float32(1.0), jnp.zeros(1), x[None]))
    routes = (single, one,
              lambda x: single(np.nextafter(x, np.float32(np.inf)).astype(np.float32)),
              lambda x: single(np.nextafter(x, np.float32(-np.inf)).astype(np.float32)))
    rec = samples_dict(samples)
    out = {f: np.zeros(len(x0s), np.float32) for f in FIELDS}
    for i, x0 in enumerate(x0s):
        rows = slice(i * steps, (i + 1) * steps)
        for route in routes:
            got = samples_dict(route(np.asarray(x0, np.float32)))
            for f in FIELDS:
                d = np.abs(got[f].astype(np.float64) - rec[f][rows]).max()
                out[f][i] = max(out[f][i], d)
    return out


def train_capture(net, key, sampler, counter, spread_rounds=(0,)):
    """``Mpcnet.train`` of the JAX package step by step, recording what the
    card's lane is held to."""
    import jax
    import jax.numpy as jnp

    from ocs2_tpu.learning.export import export_params
    from ocs2_tpu.learning.memory import CircularMemory
    from ocs2_tpu.learning.mpcnet import MpcnetSample

    s = net.s
    out = {}
    key, k0 = jax.random.split(key)
    example_x = sampler(k0, 1)[0]
    params = net.init_policy(k0, example_x)
    out["example_x"] = np.asarray(example_x)
    out.update(flat("init", export_params(params)))
    opt_state = net.optimizer.init(params)
    nu = net.problem.nu
    memory = CircularMemory.create(MpcnetSample(
        t=jnp.zeros(()), x=jnp.zeros_like(example_x), u_star=jnp.zeros((nu,)), h0=jnp.zeros(()),
        hu=jnp.zeros((nu,)), Huu=jnp.zeros((nu, nu))), s.memory_capacity)
    gen = jax.jit(net.generate_data)
    step = jax.jit(net.train_step)
    push = jax.jit(lambda mem, smp: mem.push_batch(smp))
    for rnd in range(s.rounds):
        alpha = 1.0 - rnd / max(s.rounds - 1, 1)
        key, kx, _ = jax.random.split(key, 3)
        x0s = sampler(kx, s.data_scenarios)
        counter.take()
        samples = gen(params, jnp.asarray(alpha), jnp.zeros((s.data_scenarios,)), x0s)
        jax.block_until_ready(samples)
        r = f"r{rnd}"
        out[f"{r}/x0s"] = np.asarray(x0s)
        out[f"{r}/alpha"] = np.float32(alpha)
        out[f"{r}/nonfinite_qp_steps"] = np.int64(counter.take())
        if rnd in spread_rounds:
            out.update(flat(f"{r}/samples", samples_dict(samples)))
            out.update(flat(f"{r}/spread", spread_of(net, params, samples, np.asarray(x0s),
                                                      s.rollout_steps)))
            counter.take()
        memory = push(memory, samples)
        indices, losses = [], []
        for _ in range(s.learning_iterations):
            key, kb = jax.random.split(key)
            indices.append(np.asarray(jax.random.randint(
                kb, (s.batch_size,), 0, jnp.maximum(memory.size, 1))))
            params, opt_state, loss = step(params, opt_state, memory, kb)
            losses.append(float(loss))
        out[f"{r}/losses"] = np.asarray(losses, np.float32)
        if rnd == 0:
            out[f"{r}/indices"] = np.stack(indices).astype(np.int64)
            out.update(flat(f"{r}/weights", export_params(params)))
        print(f"  round {rnd}: alpha {alpha:.2f}, loss {losses[0]:.4g} -> {losses[-1]:.4g}, "
              f"non-finite QP steps {int(out[f'{r}/nonfinite_qp_steps'])}", flush=True)
    out.update(flat("final", export_params(params)))
    return out, params


def record(path) -> int:
    import jax
    import jax.numpy as jnp

    jax.config.update("jax_platforms", "cpu")
    import chip_smoke as cs

    counter = NonFiniteSteps()  # before anything is traced
    from ocs2_tpu.core.integrate import discretize
    from ocs2_tpu.learning import robots
    from ocs2_tpu.learning.export import export_params
    from ocs2_tpu.learning.memory import CircularMemory
    from ocs2_tpu.learning.mpcnet import MpcnetSettings
    from ocs2_tpu.models.legged_robot import model as jmodel
    from ocs2_tpu.solvers import sqp as jsqp

    rec = {}
    t_start = time.perf_counter()

    # -- the legged robot --------------------------------------------------
    print("legged (make_legged_mpcnet()):", flush=True)
    net = robots.make_legged_mpcnet()
    out, params = train_capture(net, jax.random.PRNGKey(cs.MPCNET_KEYS["legged"]),
                                robots.legged_x0_sampler, counter)
    eval_x0 = out["r0/x0s"][0]
    metrics = jax.jit(lambda p: net.evaluate(p, jnp.zeros(()), jnp.asarray(eval_x0)))(params)
    out.update({"eval/x0": eval_x0, "eval/survival_time": np.asarray(metrics["survival_time"]),
                "eval/incurred_hamiltonian": np.asarray(metrics["incurred_hamiltonian"])})
    rec.update(flat("legged", out))
    init_params = net.init_policy(jax.random.PRNGKey(cs.MPCNET_KEYS["legged"]),
                                  jnp.asarray(out["example_x"]))
    print(f"  evaluate: {jax.tree.map(float, metrics)} ({time.perf_counter() - t_start:.0f} s)",
          flush=True)

    # -- the b256 data round ------------------------------------------------
    x0s = cs.mpcnet_b256_x0s(np.asarray(jmodel.default_state()))
    w0 = init_params  # round 0's weights: alpha = 1, the policy is not acted on
    counter.take()
    gen = jax.jit(net.generate_data)
    samples = gen(w0, jnp.float32(1.0), jnp.zeros((cs.MPCNET_B256,)), jnp.asarray(x0s))
    jax.block_until_ready(samples)
    nonfinite = counter.take()
    keep = cs.MPCNET_B256_RECORD * net.s.rollout_steps
    head = jax.tree.map(lambda a: a[:keep], samples)
    rec.update(flat("b256", {"x0s": x0s[:cs.MPCNET_B256_RECORD],
                             "nonfinite_qp_steps": np.int64(nonfinite)}))
    rec.update(flat("b256/samples", samples_dict(head)))
    rec.update(flat("b256/spread", spread_of(net, w0, head, x0s[:cs.MPCNET_B256_RECORD],
                                             net.s.rollout_steps)))
    rec.update(flat("b256/init", export_params(w0)))
    print(f"b256: {cs.MPCNET_B256} starts, non-finite QP steps {nonfinite}, largest spread "
          f"{ {f: float(rec[f'b256/spread/{f}'].max()) for f in FIELDS} } "
          f"({time.perf_counter() - t_start:.0f} s)", flush=True)

    # -- the small case of tests/test_learning.py:311-366 --------------------
    small = robots.make_legged_mpcnet(settings=MpcnetSettings(
        **SMALL, solver_settings=jsqp.SqpSettings(max_iterations=3, integrator="rk2")))
    key = jax.random.PRNGKey(SMALL_KEY)
    sx0s = robots.legged_x0_sampler(key, 2)
    sparams = small.init_policy(key, sx0s[0])
    counter.take()
    ssamples = jax.jit(lambda p, xs: small.generate_data(p, jnp.asarray(1.0), jnp.zeros(2), xs))(
        sparams, sx0s)
    jax.block_until_ready(ssamples)
    snonfinite = counter.take()
    mem = CircularMemory.create(jax.tree.map(lambda a: a[0], ssamples), 64)
    mem = jax.jit(lambda m, smp: m.push_batch(smp))(mem, ssamples)
    opt_state = small.optimizer.init(sparams)
    indices, losses = [], []
    for it in range(SMALL_STEPS):
        k = jax.random.fold_in(key, it)
        indices.append(np.asarray(jax.random.randint(k, (8,), 0, jnp.maximum(mem.size, 1))))
        sparams, opt_state, loss = jax.jit(small.train_step)(sparams, opt_state, mem, k)
        losses.append(float(loss))
    rec.update(flat("small", {"x0s": np.asarray(sx0s), "indices": np.stack(indices),
                              "losses": np.asarray(losses, np.float32),
                              "nonfinite_qp_steps": np.int64(snonfinite)}))
    rec.update(flat("small/samples", samples_dict(ssamples)))
    rec.update(flat("small/spread", spread_of(small, small.init_policy(key, sx0s[0]), ssamples,
                                              np.asarray(sx0s), SMALL["rollout_steps"])))
    rec.update(flat("small/init", export_params(small.init_policy(key, sx0s[0]))))
    print(f"small: losses {np.round(losses, 4).tolist()} ({time.perf_counter() - t_start:.0f} s)",
          flush=True)

    # -- the ballbot -----------------------------------------------------------
    print("ballbot (make_ballbot_mpcnet()):", flush=True)
    bnet = robots.make_ballbot_mpcnet()
    out, bparams = train_capture(bnet, jax.random.PRNGKey(cs.MPCNET_KEYS["ballbot"]),
                                 robots.ballbot_x0_sampler, counter)
    x_lean = jnp.zeros(10).at[3].set(cs.MPCNET_BALLBOT_LEAN)
    metrics = jax.jit(lambda p: bnet.evaluate(p, jnp.zeros(()), x_lean))(bparams)
    fresh = bnet.init_policy(jax.random.PRNGKey(FRESH_KEY), x_lean)
    flow = discretize(lambda t, x, u: bnet.problem.dynamics(t, x, u, bnet.params), "rk4", 2)

    def closed_loop_err(p):  # tests/test_learning.py:293-307
        x, err = x_lean, 0.0
        for k in range(6):
            u = bnet.policy_u(p, jnp.asarray(0.1 * k), x)
            x = flow(jnp.asarray(0.1 * k), x, u, 0.1)
            err += float(jnp.sum(x[:5] ** 2))
        return err

    out.update({"eval/x0": np.asarray(x_lean),
                "eval/survival_time": np.asarray(metrics["survival_time"]),
                "eval/incurred_hamiltonian": np.asarray(metrics["incurred_hamiltonian"]),
                "closed_loop_err/trained": np.float32(closed_loop_err(bparams)),
                "closed_loop_err/fresh": np.float32(closed_loop_err(fresh))})
    out.update(flat("fresh", export_params(fresh)))
    rec.update(flat("ballbot", out))
    print(f"  evaluate: {jax.tree.map(float, metrics)}, closed-loop error trained "
          f"{float(out['closed_loop_err/trained']):.4g} vs fresh "
          f"{float(out['closed_loop_err/fresh']):.4g}", flush=True)

    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez_compressed(path, **rec)
    print(f"wrote {path} ({os.path.getsize(path)} bytes) in "
          f"{time.perf_counter() - t_start:.0f} s", flush=True)
    return 0


def compare(record_path, card_path) -> int:
    """The card's numbers (``chip_smoke.py --mpcnet-out``) beside the
    record's."""
    with np.load(record_path) as f:
        rec = {k: f[k] for k in f.files}
    with open(card_path) as f:
        card = json.load(f)
    rows = []
    for lane in ("legged", "ballbot"):
        mine = card.get(lane, {})
        rows.append({
            "lane": lane,
            "round0_loss_first_last": [mine.get("round0_losses", [None])[0],
                                       mine.get("round0_losses", [None])[-1]],
            "jax_round0_loss_first_last": [float(rec[f"{lane}/r0/losses"][0]),
                                           float(rec[f"{lane}/r0/losses"][-1])],
            "round_last_losses": mine.get("losses"),
            "jax_round_last_losses": [float(rec[f"{lane}/r{r}/losses"][-1])
                                      for r in range(sum(1 for k in rec
                                                         if k.startswith(f"{lane}/r")
                                                         and k.endswith("/alpha")))],
            "evaluate": mine.get("evaluate"),
            "jax_evaluate": {k: float(rec[f"{lane}/eval/{k}"])
                             for k in ("survival_time", "incurred_hamiltonian")},
            "nonfinite_qp_steps": mine.get("nonfinite_qp_steps"),
            "jax_nonfinite_qp_steps": [int(rec[k]) for k in sorted(rec)
                                       if k.startswith(f"{lane}/r") and k.endswith("nonfinite_qp_steps")],
        })
    rows.append({"lane": "b256", "sample_distance": card.get("b256", {}).get("vs_record"),
                 "nonfinite_qp_steps": card.get("b256", {}).get("nonfinite_qp_steps"),
                 "jax_nonfinite_qp_steps": int(rec["b256/nonfinite_qp_steps"])})
    for row in rows:
        print(json.dumps(row))
    return 0


def main() -> int:
    import chip_smoke as cs

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--record", nargs="?", const=cs.MPCNET_RECORD, metavar="PATH",
                    help=f"write the record (default {cs.MPCNET_RECORD})")
    ap.add_argument("--compare", metavar="JSON", help="the card's --mpcnet-out record")
    args = ap.parse_args()
    if args.record:
        return record(args.record)
    if args.compare:
        return compare(cs.MPCNET_RECORD, args.compare)
    ap.error("give --record or --compare")
    return 2


if __name__ == "__main__":
    sys.exit(main())
