"""MPC-Net on the robots: the port against the JAX package's record
(``tools/mpcnet_reference.py``, ``tests/torch_data/mpcnet_reference.npz``)
on the CPU; a live JAX legged data round compiles for a minute.

* the legged small case of ``tests/test_learning.py:311-366`` (2 starts x 2
  control steps, SQP 3 iterations): the record's weights and starts carried
  across, the samples' shapes ([4, 24], [4, 24, 24]) and finite ``hu``, the
  samples held to the record, its 5 Adam steps on the record's draws;
* round 0 of ``chip_smoke.py``'s ``mpcnet_ballbot_train`` and
  ``mpcnet_legged_train`` (``make_ballbot_mpcnet()`` and
  ``make_legged_mpcnet()`` as the JAX package sets them, one round at alpha
  1): samples, Adam losses on the record's draws and the weights after them
  (``chip_smoke.hold_mpcnet_round0``).

Samples are held scenario by scenario within 1e-3 + 1e-4 |value|, or within
the JAX package's own spread where its routes part by more
(``chip_smoke.hold_mpcnet_samples``: the legged contact forces, which a
start one float32 ulp away moves by up to 7.5e-3); losses within 1e-3 +
1e-3 |loss| and weights within 1e-3 (``chip_smoke.MPCNET_*``).  The port's
sweep here is the kernel's plain version with clamped pivots (the card's
route at these batches); the JAX package's vmapped solve is strict on the
CPU, and no QP step of either is non-finite.
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

import chip_smoke as cs
from ocs2_tpu_torch import convert
from ocs2_tpu_torch.learning import export, robots
from ocs2_tpu_torch.learning.memory import CircularMemory
from ocs2_tpu_torch.learning.mpcnet import MpcnetSettings
from ocs2_tpu_torch.models.legged_robot import model
from ocs2_tpu_torch.solvers import sqp

torch.set_num_threads(1)  # one intra-op thread a test process: the suite runs in several
# processes at once (pytest-xdist), and these small tensors gain nothing from more.

SMALL = dict(rollout_steps=2, control_dt=0.05, batch_size=8, learning_rate=5e-3,
             learning_iterations=10, memory_capacity=64, data_scenarios=2, rounds=1,
             mpc_horizon=0.7, mpc_intervals=14)  # tests/test_learning.py:329-342


@functools.lru_cache(maxsize=None)
def record():
    return cs.load_record(cs.MPCNET_RECORD)


class CountNonFinite(cs.NonFiniteQpSteps):
    def __init__(self):
        super().__init__(torch)


@functools.lru_cache(maxsize=None)
def small_case():
    rec = record()
    net = robots.make_legged_mpcnet(settings=MpcnetSettings(
        **SMALL, solver_settings=sqp.SqpSettings(max_iterations=3, integrator="rk2")),
        device="cpu")
    policy = convert.policy_from_numpy(cs.mpcnet_record_weights(rec, "small/init"),
                                       net.init_policy(None, rec["small/x0s"][0]))
    with CountNonFinite() as nonfinite:
        samples = net.generate_data(policy, 1.0, np.zeros(2, np.float32), rec["small/x0s"])
        bad = nonfinite.take()
    memory = CircularMemory.create(net.example_sample(24), 64, device="cpu").push_batch(samples)
    optimizer = net.make_optimizer(policy)
    losses = [float(net.train_step(policy, optimizer, memory, None, indices=idx))
              for idx in rec["small/indices"]]
    return samples, losses, bad


def test_legged_small_case_samples_match_the_record():
    samples, _, bad = small_case()
    assert samples.x.shape == (4, 24) and samples.u_star.shape == (4, 24)
    assert samples.Huu.shape == (4, 24, 24) and samples.hu.shape == (4, 24)
    assert bool(torch.isfinite(samples.hu).all())
    err = cs.hold_mpcnet_samples(samples, record(), "small", SMALL["rollout_steps"], "small case",
                                 force_cols=cs.MPCNET_FORCE_COLS["small"])
    assert err["t"] == 0.0 and err["Huu"] < 1e-3
    assert bad == int(record()["small/nonfinite_qp_steps"]) == 0


def test_legged_small_case_huu_is_the_unprojected_input_block():
    """``Huu`` is the full [24, 24] input block of the unprojected cost plus
    B'S B (tests/test_learning.py:351), symmetric positive definite."""
    samples, _, _ = small_case()
    huu = samples.Huu.double()
    assert float((huu - huu.transpose(-1, -2)).abs().max()) < 1e-3 * float(huu.abs().max())
    assert float(torch.linalg.eigvalsh(0.5 * (huu + huu.transpose(-1, -2))).min()) > 0.0


def test_legged_small_case_adam_steps_on_the_record_draws():
    _, losses, _ = small_case()
    ref = record()["small/losses"]
    np.testing.assert_allclose(losses, ref, rtol=cs.MPCNET_LOSS_RTOL, atol=cs.MPCNET_LOSS_ATOL)
    assert np.isfinite(losses).all() and losses[-1] <= cs.MPCNET_DIVERGENCE * losses[0]


def _round0(lane):
    """Round 0 of the card lane's training loop (one round: alpha 1), from
    the record's weights and starts, its Adam steps on the record's draws."""
    rec = record()
    make = {"ballbot": robots.make_ballbot_mpcnet, "legged": robots.make_legged_mpcnet}[lane]
    default = make(device="cpu").s
    net = make(settings=dataclasses.replace(default, rounds=1), device="cpu")
    policy = convert.policy_from_numpy(cs.mpcnet_record_weights(rec, f"{lane}/init"),
                                       net.init_policy(None, rec[f"{lane}/example_x"]))
    rounds, iterations = [], []

    def on_round(info):
        rounds.append(dict(info, weights=export.export_params(info["policy"]),
                           nonfinite_qp_steps=nonfinite.take()))

    with CountNonFinite() as nonfinite:
        net.train(None, cs.mpcnet_record_sampler(torch, rec, lane, device="cpu"), policy=policy,
                  indices=[torch.as_tensor(rec[f"{lane}/r0/indices"])], on_round=on_round,
                  on_solve=lambda sol: iterations.append(sol.iterations))
    assert len(rounds) == 1 and rounds[0]["alpha"] == 1.0
    return rounds[0], torch.stack(iterations), default


@functools.lru_cache(maxsize=None)
def round0(lane):
    info, iterations, default = _round0(lane)
    return info, iterations, default, cs.hold_mpcnet_round0(info, record(), lane, lane)


@pytest.mark.parametrize("lane", ["ballbot", "legged"])
def test_round0_matches_the_record(lane):
    info, iterations, default, err = round0(lane)
    steps, scenarios = default.rollout_steps, default.data_scenarios
    assert info["samples"].x.shape[0] == steps * scenarios
    assert iterations.shape == (steps, scenarios)
    assert int(iterations.max()) <= default.solver_settings.max_iterations
    assert err["loss_max_abs_err"] <= cs.MPCNET_LOSS_ATOL + cs.MPCNET_LOSS_RTOL * float(
        np.abs(record()[f"{lane}/r0/losses"]).max())
    assert info["nonfinite_qp_steps"] == int(record()[f"{lane}/r0/nonfinite_qp_steps"]) == 0


@pytest.mark.parametrize("lane", ["ballbot", "legged"])
def test_round0_losses_fall(lane):
    """Round 0 imitates the MPC: the Hamiltonian loss on the record's draws
    ends below where it starts, as in the JAX package's run."""
    info, _, _, _ = round0(lane)
    losses = info["step_losses"].numpy()
    ref = record()[f"{lane}/r0/losses"]
    assert losses[-1] < losses[0] and ref[-1] < ref[0]


def test_b256_starts_are_the_record_s():
    """The b256 lane's starts (numpy-seeded, legged_x0_sampler's scales) are
    the record's first 32 and lie around the stance."""
    x0s = cs.mpcnet_b256_x0s(model.default_state("cpu").numpy())
    assert x0s.shape == (cs.MPCNET_B256, 24) and x0s.dtype == np.float32
    np.testing.assert_array_equal(x0s[:cs.MPCNET_B256_RECORD], record()["b256/x0s"])
    np.testing.assert_array_equal(cs.MPCNET_LEGGED_X0_SCALE, robots.LEGGED_X0_SCALE)
    z = (x0s - model.default_state("cpu").numpy()) / robots.LEGGED_X0_SCALE
    assert abs(float(z.std()) - 1.0) < 0.05
