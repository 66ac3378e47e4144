"""MPC-Net of the port (``ocs2_tpu_torch/learning/``) vs the JAX package's
(``ocs2_tpu/learning/``), live on the CPU at small sizes.

* the losses and ``hamiltonian_from_lq`` on seeded LQ data (rtol 1e-5 /
  atol 1e-5);
* ``CircularMemory``: wraparound of single and batched pushes (a batch
  longer than the buffer included) equal to the JAX package's, and its
  draws replayed through ``sample(indices=...)``;
* the four policy families and their gates, the JAX package's flax weights
  carried across (``convert.policy_from_numpy``), within 1e-5; the port's
  own initialisation has flax's scale;
* ``export_params`` keys and arrays equal to the JAX export of the same
  weights, checkpoints loading across, ``numpy_policy`` equal, and the
  shared failure of ``numpy_policy`` on the mixture of linear experts;
* 20 ``train_step``s against ``optax.adam`` on one memory with the JAX
  package's draws (losses rtol 1e-4, weights atol 1e-5);
* the double integrator at ``tests/test_learning.py``'s settings:
  ``_mpc_step``, ``generate_data`` (alpha 1 and 0.5) and ``evaluate``,
  within 1e-4 + 1e-4 |value|;
* ``legged_observation`` and ``legged_action_transform`` at every control
  step k * 0.05 s up to 0.7 s, with time carried in float32 as the JAX
  scan carries it: the contact pattern equal at every step, values within
  1e-6.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ocs2_tpu.learning import export as jexport
from ocs2_tpu.learning import loss as jloss
from ocs2_tpu.learning import policy as jpolicy
from ocs2_tpu.learning import robots as jrobots
from ocs2_tpu.learning.memory import CircularMemory as JCircularMemory
from ocs2_tpu.learning.mpcnet import Mpcnet as JMpcnet
from ocs2_tpu.learning.mpcnet import MpcnetSample as JMpcnetSample
from ocs2_tpu.learning.mpcnet import MpcnetSettings as JMpcnetSettings
from ocs2_tpu.models import double_integrator as jdi
from ocs2_tpu.solvers import sqp as jsqp

from ocs2_tpu_torch import convert
from ocs2_tpu_torch.learning import export, loss, policy, robots
from ocs2_tpu_torch.learning.memory import CircularMemory
from ocs2_tpu_torch.learning.mpcnet import Mpcnet, MpcnetSample, MpcnetSettings
from ocs2_tpu_torch.models import double_integrator as di
from ocs2_tpu_torch.solvers import sqp

torch.set_num_threads(1)  # one intra-op thread a test process: the suite runs in several
# processes at once (pytest-xdist), and these small tensors gain nothing from more.

RTOL, ATOL = 1e-5, 1e-5
T = lambda v: torch.as_tensor(np.array(v, np.float32))  # noqa: E731


def _np(v):
    return v.detach().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def close(mine, ref, rtol=RTOL, atol=ATOL, **kw):
    np.testing.assert_allclose(_np(mine), _np(ref), rtol=rtol, atol=atol, **kw)


# -- losses ---------------------------------------------------------------------------


def _lq_data(b=3, n=5, nx=4, nu=2, seed=0):
    """Seeded LQ data [B, N, ...] and a value function [B, N+1, ...]."""
    rng = np.random.default_rng(seed)
    f32 = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    s = f32(b, n + 1, nx, nx)
    r = f32(b, n + 1, nu, nu)
    return dict(
        dfdx=f32(b, n, nx, nx), dfdu=f32(b, n, nx, nu), f=f32(b, n, nx),
        cost_f=f32(b, n + 1), cost_dfdu=f32(b, n + 1, nu),
        cost_dfduu=(r @ np.swapaxes(r, -1, -2) + np.eye(nu, dtype=np.float32)).astype(np.float32),
        value_S=(s @ np.swapaxes(s, -1, -2)).astype(np.float32), value_s=f32(b, n + 1, nx),
        xs=f32(b, n + 1, nx))


def _lq_view(d, wrap):
    from types import SimpleNamespace as NS

    return NS(dynamics=NS(dfdx=wrap(d["dfdx"]), dfdu=wrap(d["dfdu"]), f=wrap(d["f"])),
              cost=NS(f=wrap(d["cost_f"]), dfdu=wrap(d["cost_dfdu"]), dfduu=wrap(d["cost_dfduu"])))


def test_hamiltonian_from_lq_matches_jax():
    d = _lq_data()
    mine = loss.hamiltonian_from_lq(_lq_view(d, T), T(d["value_S"]), T(d["value_s"]), T(d["xs"]))
    ref = [jloss.hamiltonian_from_lq(
        _lq_view({k: v[i] for k, v in d.items()}, jnp.asarray), jnp.asarray(d["value_S"][i]),
        jnp.asarray(d["value_s"][i]), jnp.asarray(d["xs"][i])) for i in range(3)]
    for f in ("h0", "hu", "Huu"):
        close(getattr(mine, f), np.stack([np.asarray(getattr(r, f)) for r in ref]), err_msg=f)
    assert mine.Huu.shape == (3, 5, 2, 2)


def test_losses_match_jax():
    rng = np.random.default_rng(1)
    n, nu = 7, 3
    h0, hu = rng.standard_normal(n).astype(np.float32), rng.standard_normal((n, nu)).astype(
        np.float32)
    a = rng.standard_normal((n, nu, nu)).astype(np.float32)
    huu = (a @ np.swapaxes(a, -1, -2)).astype(np.float32)
    u_pred, u_star = (rng.standard_normal((n, nu)).astype(np.float32) for _ in range(2))
    mine = loss.HamiltonianApprox(T(h0), T(hu), T(huu))
    ref = jloss.HamiltonianApprox(jnp.asarray(h0), jnp.asarray(hu), jnp.asarray(huu))
    close(mine.value(T(u_pred - u_star)), ref.value(jnp.asarray(u_pred - u_star)))
    close(loss.hamiltonian_loss(mine, T(u_pred), T(u_star)),
          jloss.hamiltonian_loss(ref, jnp.asarray(u_pred), jnp.asarray(u_star)))
    r = np.diag([1.0, 2.0, 0.5]).astype(np.float32)
    close(loss.behavioral_cloning_loss(T(u_pred), T(u_star), T(r)),
          jloss.behavioral_cloning_loss(jnp.asarray(u_pred), jnp.asarray(u_star), jnp.asarray(r)))
    gates = np.exp(rng.standard_normal((n, 4))).astype(np.float32)
    gates /= gates.sum(-1, keepdims=True)
    target = np.eye(4, dtype=np.float32)[rng.integers(0, 4, n)]
    close(loss.cross_entropy_loss(T(gates), T(target)),
          jloss.cross_entropy_loss(jnp.asarray(gates), jnp.asarray(target)))
    # The loss is zero at u* with a zero gradient term and h0 = 0.
    zero = loss.HamiltonianApprox(torch.zeros(()), torch.zeros(2), torch.eye(2))
    assert float(loss.hamiltonian_loss(zero, T([0.3, -0.1]), T([0.3, -0.1]))) == 0.0


# -- replay memory ---------------------------------------------------------------------


def _jax_memory_state(mem):
    return np.asarray(mem.data["x"]), int(mem.size), int(mem.head)


@pytest.mark.parametrize("pushes", [
    [1, 1, 1, 1, 1, 1],  # single pushes past the capacity
    [3, 2, 4],  # batches that wrap
    [2, 7],  # a batch longer than the buffer keeps its tail
])
def test_memory_wraparound_matches_jax(pushes):
    cap = 5
    jmem = JCircularMemory.create({"x": jnp.zeros(2)}, capacity=cap)
    mem = CircularMemory.create({"x": torch.zeros(2)}, capacity=cap, device="cpu")
    count = 0
    for n in pushes:
        rows = np.stack([np.full(2, count + i, np.float32) for i in range(n)])
        count += n
        if n == 1:
            jmem = jmem.push({"x": jnp.asarray(rows[0])})
            assert mem.push({"x": T(rows[0])}) is mem
        else:
            jmem = jmem.push_batch({"x": jnp.asarray(rows)})
            mem.push_batch({"x": T(rows)})
        data, size, head = _jax_memory_state(jmem)
        np.testing.assert_array_equal(mem.data["x"].numpy(), data)
        assert (mem.size, mem.head) == (size, head)
    assert mem.capacity == cap


def test_memory_replays_jax_draws_and_draws_in_the_valid_region():
    jmem = JCircularMemory.create({"x": jnp.zeros(1)}, capacity=16)
    mem = CircularMemory.create({"x": torch.zeros(1)}, capacity=16, device="cpu")
    rows = np.arange(6, dtype=np.float32)[:, None]
    jmem = jmem.push_batch({"x": jnp.asarray(rows)})
    mem.push_batch({"x": T(rows)})
    key = jax.random.PRNGKey(3)
    want = jmem.sample(key, 9)["x"]
    idx = jax.random.randint(key, (9,), 0, max(int(jmem.size), 1))
    np.testing.assert_array_equal(mem.sample(None, 9, indices=np.asarray(idx))["x"].numpy(),
                                  np.asarray(want))
    got = mem.sample(torch.Generator().manual_seed(0), 500)["x"].numpy()
    assert set(got[:, 0].tolist()) == set(range(6))  # only written rows
    empty = CircularMemory.create({"x": torch.zeros(1)}, capacity=4, device="cpu")
    assert empty.sample(torch.Generator().manual_seed(0), 3)["x"].shape == (3, 1)


# -- policies ---------------------------------------------------------------------------

FAMILIES = {
    "linear": (jpolicy.LinearPolicy, policy.LinearPolicy, {}),
    "nonlinear": (jpolicy.NonlinearPolicy, policy.NonlinearPolicy, {}),
    "nonlinear_two_hidden": (jpolicy.NonlinearPolicy, policy.NonlinearPolicy,
                             {"hidden": (16, 8)}),
    "mixture_of_nonlinear_experts": (jpolicy.MixtureOfNonlinearExpertsPolicy,
                                     policy.MixtureOfNonlinearExpertsPolicy, {"num_experts": 3}),
    "mixture_of_linear_experts": (jpolicy.MixtureOfLinearExpertsPolicy,
                                  policy.MixtureOfLinearExpertsPolicy, {"num_experts": 4}),
}
OBS, ACT = 10, 3


@functools.lru_cache(maxsize=None)
def carried(family):
    """The JAX module, its flax params, and the port's module with them."""
    jcls, cls, kw = FAMILIES[family]
    jmod = jcls(action_dim=ACT, **kw)
    params = jmod.init(jax.random.PRNGKey(0), jnp.ones(OBS))
    mod = convert.policy_from_numpy(jexport.export_params(params),
                                    cls(OBS, ACT, device="cpu", **kw))
    return jmod, params, mod


def _obs(seed=1, n=6):
    return np.random.default_rng(seed).standard_normal((n, OBS)).astype(np.float32)


@pytest.mark.parametrize("family", FAMILIES)
def test_policy_with_carried_weights_matches_jax(family):
    jmod, params, mod = carried(family)
    obs = _obs()
    close(mod(T(obs)), jmod.apply(params, jnp.asarray(obs)))
    close(mod(T(obs[0])), jmod.apply(params, jnp.asarray(obs[0])))  # one observation
    if hasattr(mod, "apply_with_gates"):
        u, gates = mod.apply_with_gates(T(obs))
        ju, jgates = jmod.apply(params, jnp.asarray(obs), method=jmod.apply_with_gates)
        close(u, ju)
        close(gates, jgates)
        close(gates.sum(-1), np.ones(len(obs)))


@pytest.mark.parametrize("family", FAMILIES)
def test_layer_names_and_default_widths_are_the_jax_package_s(family):
    _, params, mod = carried(family)
    jshapes = {k: v.shape for k, v in jexport.export_params(params).items()}
    assert {k: v.shape for k, v in export.export_params(mod).items()} == jshapes


@pytest.mark.parametrize("family", ["linear", "mixture_of_linear_experts", "nonlinear"])
def test_port_initialisation_has_flax_scale(family):
    """Kernels from lecun_normal (truncated at 2 sigma, variance 1 / fan_in),
    biases zero: the statistics of a wide layer's init match flax's."""
    jcls, cls, kw = FAMILIES[family]
    obs = 400
    mod = cls(obs, 64, generator=torch.Generator().manual_seed(0), device="cpu", **kw)
    params = jcls(action_dim=64, **kw).init(jax.random.PRNGKey(0), jnp.ones(obs))
    mine = export.export_params(mod)
    theirs = jexport.export_params(params)
    for key, want in theirs.items():
        got = mine[key]
        if key.endswith("bias"):
            assert not got.any() and not want.any()
            continue
        bound = 2.0 / np.sqrt(want.shape[0]) / 0.87962566103423978
        assert np.abs(got).max() <= bound * (1 + 1e-6) and np.abs(want).max() <= bound * (1 + 1e-6)
        np.testing.assert_allclose(got.std(), want.std(), rtol=0.1, err_msg=key)
    torch.manual_seed(0)
    a = cls(obs, 64, generator=torch.Generator().manual_seed(5), device="cpu", **kw)
    b = cls(obs, 64, generator=torch.Generator().manual_seed(5), device="cpu", **kw)
    assert all(torch.equal(p, q) for p, q in zip(a.parameters(), b.parameters()))


def test_policy_from_numpy_refuses_a_mismatched_checkpoint():
    _, params, _ = carried("linear")
    with pytest.raises(ValueError, match="layers"):
        convert.policy_from_numpy(jexport.export_params(params),
                                  policy.NonlinearPolicy(OBS, ACT, device="cpu"))
    with pytest.raises(ValueError, match="kernel"):
        convert.policy_from_numpy(jexport.export_params(params),
                                  policy.LinearPolicy(OBS + 1, ACT, device="cpu"))


def test_make_policy_fn_applies_a_module_or_its_parameters():
    _, params, mod = carried("nonlinear")
    fn = policy.make_policy_fn(mod, action_transform=lambda t, x, a: a + 1.0)
    jfn = jpolicy.make_policy_fn(FAMILIES["nonlinear"][0](action_dim=ACT),
                                 action_transform=lambda t, x, a: a + 1.0)
    x = _obs()
    want = jax.vmap(lambda xx: jfn(params, 0.0, xx))(jnp.asarray(x))
    close(fn(mod, torch.zeros(()), T(x)), want)
    close(fn(dict(mod.named_parameters()), torch.zeros(()), T(x)), want)
    assert policy.default_observation(0.0, "x") == "x"


# -- export -----------------------------------------------------------------------------


@pytest.mark.parametrize("family", FAMILIES)
def test_export_equals_the_jax_export_and_checkpoints_load_across(family, tmp_path):
    jmod, params, mod = carried(family)
    mine, theirs = export.export_params(mod), jexport.export_params(params)
    assert mine.keys() == theirs.keys()
    for k in theirs:
        assert mine[k].dtype == np.float32
        np.testing.assert_array_equal(mine[k], theirs[k], err_msg=k)
    export.save_checkpoint(str(tmp_path / "port.npz"), mod)
    jexport.save_checkpoint(str(tmp_path / "jax.npz"), params)
    from_port = jexport.load_checkpoint(str(tmp_path / "port.npz"))
    from_jax = export.load_checkpoint(str(tmp_path / "jax.npz"))
    assert from_port.keys() == from_jax.keys() == theirs.keys()
    back = convert.policy_from_numpy(from_jax, FAMILIES[family][1](
        OBS, ACT, device="cpu", **FAMILIES[family][2]))
    close(back(T(_obs())), mod(T(_obs())), 0, 0)


@pytest.mark.parametrize("family", [f for f in FAMILIES if f != "mixture_of_linear_experts"])
def test_numpy_policy_matches_both_packages(family):
    jmod, params, mod = carried(family)
    obs = _obs(seed=2)
    mine, theirs = export.numpy_policy(export.export_params(mod)), jexport.numpy_policy(
        jexport.export_params(params))
    np.testing.assert_allclose(mine(obs), theirs(obs), rtol=0, atol=0)
    close(mine(obs), mod(T(obs)).detach().numpy())


def test_numpy_policy_fails_on_linear_experts_in_both_packages():
    """The JAX package's numpy forward has no branch for the mixture of
    linear experts: its keys fall through to the MLP branch and fail the
    assert.  The port's copy keeps the gap."""
    _, params, mod = carried("mixture_of_linear_experts")
    with pytest.raises(AssertionError) as theirs:
        jexport.numpy_policy(jexport.export_params(params))
    with pytest.raises(AssertionError) as mine:
        export.numpy_policy(export.export_params(mod))
    assert str(mine.value) == str(theirs.value)


# -- Adam steps against optax -----------------------------------------------------------


def _ballbot_pair(lr=1e-2, batch=32):
    kw = dict(rollout_steps=6, control_dt=0.1, batch_size=batch, learning_rate=lr,
              learning_iterations=20, memory_capacity=64, data_scenarios=8, rounds=1,
              mpc_horizon=1.0, mpc_intervals=16)
    jnet = jrobots.make_ballbot_mpcnet(settings=JMpcnetSettings(**kw))
    net = robots.make_ballbot_mpcnet(settings=MpcnetSettings(**kw), device="cpu")
    return jnet, net


def _seeded_samples(n, nx, nu, seed=4):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((n, nu, nu)).astype(np.float32)
    return dict(t=(0.1 * np.arange(n) % 0.6).astype(np.float32),
                x=(0.15 * rng.standard_normal((n, nx))).astype(np.float32),
                u_star=rng.standard_normal((n, nu)).astype(np.float32),
                h0=rng.standard_normal(n).astype(np.float32),
                hu=rng.standard_normal((n, nu)).astype(np.float32),
                Huu=(a @ np.swapaxes(a, -1, -2) + np.eye(nu)).astype(np.float32))


def test_train_steps_match_optax_adam_on_the_jax_draws():
    """20 Adam steps of the ballbot's MLP on one memory of 48 seeded samples,
    the port replaying the JAX package's draws: the losses within rtol 1e-4
    and the weights within 1e-5 (Adam's update is lr m_hat / (sqrt(v_hat) +
    eps) in both; they differ by float32 rounding of the same formula)."""
    jnet, net = _ballbot_pair()
    data = _seeded_samples(48, 10, 3)
    params = jnet.init_policy(jax.random.PRNGKey(7), jnp.zeros(10))
    mod = convert.policy_from_numpy(jexport.export_params(params),
                                    net.init_policy(None, torch.zeros(10)))
    jmem = JCircularMemory.create(JMpcnetSample(**{k: jnp.asarray(v[0]) for k, v in data.items()}),
                                  64).push_batch(JMpcnetSample(**{k: jnp.asarray(v)
                                                                  for k, v in data.items()}))
    mem = CircularMemory.create(net.example_sample(10), 64, device="cpu").push_batch(
        convert.mpcnet_sample_from_numpy(data, device="cpu"))
    opt_state = jnet.optimizer.init(params)
    opt = net.make_optimizer(mod)
    step = jax.jit(jnet.train_step)
    key = jax.random.PRNGKey(11)
    for it in range(20):
        key, kb = jax.random.split(key)
        idx = np.asarray(jax.random.randint(kb, (32,), 0, max(int(jmem.size), 1)))
        params, opt_state, jl = step(params, opt_state, jmem, kb)
        ml = net.train_step(mod, opt, mem, None, indices=idx)
        close(ml, jl, rtol=1e-4, atol=0, err_msg=f"loss at step {it}")
    for k, want in jexport.export_params(params).items():
        close(export.export_params(mod)[k], want, rtol=0, atol=1e-5, err_msg=k)
    assert isinstance(jnet.optimizer, optax.GradientTransformation)


def test_train_step_draws_from_a_generator():
    _, net = _ballbot_pair(batch=8)
    data = _seeded_samples(20, 10, 3)
    mod = net.init_policy(torch.Generator().manual_seed(0), torch.zeros(10))
    mem = CircularMemory.create(net.example_sample(10), 64, device="cpu").push_batch(
        convert.mpcnet_sample_from_numpy(data, device="cpu"))
    opt = net.make_optimizer(mod)
    losses = [float(net.train_step(mod, opt, mem, torch.Generator().manual_seed(it)))
              for it in range(30)]
    assert np.isfinite(losses).all() and np.mean(losses[-5:]) < np.mean(losses[:5])


# -- the double integrator: the data round and the evaluation ----------------------------

DI_SETTINGS = dict(rollout_steps=5, control_dt=0.1, batch_size=16, learning_rate=1e-2,
                   learning_iterations=250, memory_capacity=512, data_scenarios=4, rounds=3,
                   mpc_horizon=1.0, mpc_intervals=10)
DI_SQP = dict(max_iterations=4)


@functools.lru_cache(maxsize=None)
def di_pair():
    jnet = JMpcnet(jdi.make_problem(), jdi.make_params(),
                   jpolicy.LinearPolicy(action_dim=1),
                   settings=JMpcnetSettings(**DI_SETTINGS,
                                            solver_settings=jsqp.SqpSettings(**DI_SQP)))
    net = Mpcnet(di.make_problem(device="cpu"), di.make_params(device="cpu"),
                 functools.partial(policy.LinearPolicy, action_dim=1),
                 settings=MpcnetSettings(**DI_SETTINGS, solver_settings=sqp.SqpSettings(**DI_SQP)),
                 device="cpu")
    params = jnet.init_policy(jax.random.PRNGKey(0), jnp.zeros(2))
    mod = convert.policy_from_numpy(jexport.export_params(params), net.init_policy(None, [0, 0]))
    return jnet, net, params, mod


DI_X0S = np.random.default_rng(0).uniform(-1.0, 1.0, (4, 2)).astype(np.float32)
DI_SOLVE = dict(rtol=1e-4, atol=1e-4)


def test_di_mpc_step_matches_jax():
    jnet, net, _, _ = di_pair()
    u, hammy, sol = net._mpc_step(np.float32(0.2), T(DI_X0S))
    ju, jh = jax.jit(jax.vmap(lambda x: jnet._mpc_step(jnp.float32(0.2), x)))(jnp.asarray(DI_X0S))
    assert sol.xs.shape == (4, 11, 2)
    close(u, ju, **DI_SOLVE)
    for f in ("h0", "hu", "Huu"):
        close(getattr(hammy, f), getattr(jh, f), **DI_SOLVE, err_msg=f)


@functools.lru_cache(maxsize=None)
def di_data(alpha):
    jnet, net, params, mod = di_pair()
    ref = jax.jit(jnet.generate_data)(params, jnp.float32(alpha), jnp.zeros(4),
                                      jnp.asarray(DI_X0S))
    return net.generate_data(mod, alpha, np.zeros(4, np.float32), DI_X0S), ref


@pytest.mark.parametrize("alpha", [1.0, 0.5])
@pytest.mark.parametrize("field", MpcnetSample._fields)
def test_di_generate_data_matches_jax(alpha, field):
    mine, ref = di_data(alpha)
    a, b = getattr(mine, field), np.asarray(getattr(ref, field))
    assert tuple(a.shape) == b.shape and b.shape[0] == 4 * DI_SETTINGS["rollout_steps"]
    close(a, b, **DI_SOLVE)


def test_di_generate_data_refuses_distinct_start_times():
    _, net, _, mod = di_pair()
    with pytest.raises(ValueError, match="t0"):
        net.generate_data(mod, 1.0, np.float32([0.0, 0.1]), DI_X0S[:2])


def test_di_evaluate_matches_jax():
    jnet, net, params, mod = di_pair()
    x0 = np.float32([1.0, 0.0])
    ref = jax.jit(lambda p: jnet.evaluate(p, jnp.zeros(()), jnp.asarray(x0)))(params)
    mine = net.evaluate(mod, 0.0, x0)
    for k in ("survival_time", "incurred_hamiltonian"):
        close(mine[k], ref[k], **DI_SOLVE, err_msg=k)
    batch = net.evaluate(mod, 0.0, np.stack([x0, x0]))
    assert batch["survival_time"].shape == (2,)


def test_di_evaluate_stops_counting_a_diverged_scenario():
    """A policy that drives the state past x_max: the scenario is frozen and
    survives fewer steps, as under the JAX package's masking."""
    jnet, net, params, mod = di_pair()
    wild = jax.tree.map(lambda a: 1e4 * jnp.ones_like(a), params)
    ref = jax.jit(lambda p: jnet.evaluate(p, jnp.zeros(()), jnp.float32([1.0, 0.0])))(wild)
    mine = net.evaluate(convert.policy_from_numpy(jexport.export_params(wild),
                                                  net.init_policy(None, [0, 0])),
                        0.0, np.float32([1.0, 0.0]))
    assert float(mine["survival_time"]) == pytest.approx(float(ref["survival_time"]))
    assert float(mine["survival_time"]) < DI_SETTINGS["rollout_steps"] * 0.1


def test_uniform_grid_matches_jax():
    """Node times within one float32 ulp of the JAX package's (XLA's
    rewrite of jnp.linspace's division decides the last bit)."""
    from ocs2_tpu.learning.mpcnet import uniform_grid_fn as juniform_grid_fn

    from ocs2_tpu_torch.learning.mpcnet import uniform_grid_fn

    for horizon, n, t0 in ((1.0, 10, 0.3), (0.7, 14, 0.35), (1.0, 16, 0.0)):
        g, jg = uniform_grid_fn(horizon, n)(np.float32(t0)), juniform_grid_fn(horizon, n)(
            jnp.float32(t0))
        np.testing.assert_array_max_ulp(g.times, np.asarray(jg.times), maxulp=1)
        np.testing.assert_array_equal(g.modes, np.asarray(jg.modes))


# -- the legged observation and action transform at the control steps --------------------


def _scan_times(steps=15, dt=0.05):
    """t_k as the JAX scan carries it: float32, t_{k+1} = t_k + dt."""
    ts = [np.float32(0.0)]
    for _ in range(steps - 1):
        ts.append(np.float32(ts[-1] + np.float32(dt)))
    return np.asarray(ts, np.float32)


@pytest.mark.parametrize("times", ["scan", "product"])
def test_legged_observation_and_action_transform_at_every_step(times):
    ts = _scan_times() if times == "scan" else (np.arange(15) * np.float32(0.05)).astype(
        np.float32)
    x = (np.asarray(jrobots.model.default_state())[None]
         + 0.01 * np.random.default_rng(3).standard_normal((15, 24))).astype(np.float32)
    a = np.random.default_rng(4).standard_normal((15, 24)).astype(np.float32)
    ref_obs = jax.vmap(jrobots.legged_observation)(jnp.asarray(ts), jnp.asarray(x))
    ref_u = jax.vmap(jrobots.legged_action_transform)(jnp.asarray(ts), jnp.asarray(x),
                                                      jnp.asarray(a))
    close(robots.legged_observation(T(ts), T(x)), ref_obs, 0, 1e-6)
    mine_u = robots.legged_action_transform(T(ts), T(x), T(a))
    # The contact pattern (which legs carry 147.15 N) equal at every step.
    np.testing.assert_array_equal((mine_u - T(a))[:, 2:12:3].numpy() > 1.0,
                                  (np.asarray(ref_u) - a)[:, 2:12:3] > 1.0)
    close(mine_u, ref_u, 0, 1e-5)
    for k in range(15):  # one step at a time, as the rollout calls them
        close(robots.legged_observation(T(ts[k]), T(x[k])), ref_obs[k], 0, 1e-6)
        close(robots.legged_action_transform(T(ts[k]), T(x[k]), T(a[k])), ref_u[k], 0, 1e-5)


def test_samplers_draw_from_their_generator():
    g = torch.Generator().manual_seed(0)
    a, b = robots.legged_x0_sampler(g, 5), robots.legged_x0_sampler(g, 5)
    assert a.shape == (5, 24) and not torch.equal(a, b)
    again = robots.legged_x0_sampler(torch.Generator().manual_seed(0), 5)
    assert torch.equal(a, again)
    base = np.asarray(jrobots.model.default_state())
    z = (a.numpy() - base) / robots.LEGGED_X0_SCALE
    assert np.abs(z).max() < 6.0
    bb = robots.ballbot_x0_sampler(torch.Generator().manual_seed(1), 1000)
    assert bb.shape == (1000, 10) and abs(float(bb.std()) - 0.15) < 0.01
