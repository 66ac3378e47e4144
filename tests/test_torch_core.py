"""Core modules of the port vs the JAX package: integrator steps,
interpolation, target trajectories, penalties, value types.  Inputs are drawn
with numpy from a seed and handed to both sides; float32, atol 1e-6 unless a
case says otherwise."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ocs2_tpu.core import integrate as jintegrate
from ocs2_tpu.core import interpolation as jinterp
from ocs2_tpu.core import penalties as jpen
from ocs2_tpu.core import reference as jref
from ocs2_tpu.core import types as jtypes
from ocs2_tpu.oc import time_discretization as jtd

from ocs2_tpu_torch import convert
from ocs2_tpu_torch.core import integrate, interpolation, penalties, reference, types
from ocs2_tpu_torch.oc import time_discretization as td

torch.set_num_threads(1)  # one intra-op thread a test process: the suite runs in several
# processes at once (pytest-xdist), and these small tensors gain nothing from more.

ATOL = 1e-6
T = lambda v: torch.as_tensor(np.asarray(v, np.float32))  # noqa: E731


def _osc(lib):
    def f(t, x, u):
        return lib.stack([x[..., 1] + 0.1 * lib.sin(t), -4.0 * x[..., 0] - 0.3 * x[..., 1] + u[..., 0]], -1)
    return f


@pytest.mark.parametrize("method", ["euler", "rk2", "rk4"])
@pytest.mark.parametrize("substeps", [1, 3])
def test_discretize_steps(method, substeps):
    rng = np.random.default_rng(0)
    x = rng.standard_normal(2).astype(np.float32)
    u = rng.standard_normal(1).astype(np.float32)
    ref = jintegrate.discretize(_osc(jnp), method, substeps)(
        jnp.float32(0.3), jnp.asarray(x), jnp.asarray(u), jnp.float32(0.05))
    mine = integrate.discretize(_osc(torch), method, substeps)(T(0.3), T(x), T(u), T(0.05))
    np.testing.assert_allclose(mine.numpy(), np.asarray(ref), atol=ATOL)


def test_steps_take_batches():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((5, 3, 2)).astype(np.float32)
    u = rng.standard_normal((5, 3, 1)).astype(np.float32)
    step = integrate.discretize(_osc(torch), "rk4", 1)
    whole = step(T(0.0), T(x), T(u), T(0.1))
    one = step(T(0.0), T(x[2, 1]), T(u[2, 1]), T(0.1))
    np.testing.assert_allclose(whole[2, 1].numpy(), one.numpy(), atol=ATOL)


def test_ode45_is_not_ported():
    """Named when ``discretize("ode45")`` raised in the port; it now holds the
    port's adaptive Dormand-Prince step against the JAX package's on the
    forced oscillator (the same accepted steps: atol 1e-6)."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal(2).astype(np.float32)
    u = rng.standard_normal(1).astype(np.float32)
    ref = jintegrate.discretize(_osc(jnp), "ode45")(
        jnp.float32(0.3), jnp.asarray(x), jnp.asarray(u), jnp.float32(0.4))
    mine = integrate.discretize(_osc(torch), "ode45")(T(0.3), T(x), T(u), T(0.4))
    np.testing.assert_allclose(mine.numpy(), np.asarray(ref), atol=ATOL)


def test_trapezoidal():
    rng = np.random.default_rng(2)
    ts = np.sort(rng.uniform(0, 2, 9)).astype(np.float32)
    vals = rng.standard_normal(9).astype(np.float32)
    np.testing.assert_allclose(
        integrate.trapezoidal(T(vals), T(ts)).numpy(),
        np.asarray(jintegrate.trapezoidal(jnp.asarray(vals), jnp.asarray(ts))), atol=ATOL)


@pytest.mark.parametrize("t", [-1.0, 0.0, 0.37, 1.0, 1.99, 2.0, 5.0])
def test_interpolate_scalar_query(t):
    rng = np.random.default_rng(3)
    times = np.float32([0.0, 0.5, 1.0, 2.0])
    vals = rng.standard_normal((4, 3)).astype(np.float32)
    ref = jinterp.interpolate(jnp.asarray(times), jnp.asarray(vals), jnp.float32(t))
    np.testing.assert_allclose(
        interpolation.interpolate(T(times), T(vals), t).numpy(), np.asarray(ref), atol=ATOL)
    assert int(interpolation.lookup_index(T(times), t)) == int(
        jinterp.lookup_index(jnp.asarray(times), jnp.float32(t)))


def test_interpolate_many_queries_and_vmap():
    rng = np.random.default_rng(4)
    times = np.float32([0.0, 0.5, 1.0, 2.0])
    vals = rng.standard_normal((4, 3)).astype(np.float32)
    ts = rng.uniform(-0.5, 2.5, 11).astype(np.float32)
    ref = jinterp.interpolate_batch(jnp.asarray(times), jnp.asarray(vals), jnp.asarray(ts))
    mine = interpolation.interpolate_batch(T(times), T(vals), T(ts))
    np.testing.assert_allclose(mine.numpy(), np.asarray(ref), atol=ATOL)
    mapped = torch.func.vmap(lambda t: interpolation.interpolate(T(times), T(vals), t))(T(ts))
    np.testing.assert_allclose(mapped.numpy(), np.asarray(ref), atol=ATOL)


def test_target_state_under_jacrev_inside_vmap():
    """A residual that reads the target at its node's time, differentiated by
    jacrev inside a vmap over nodes (the Gauss-Newton path of the
    motion-tracking cost).  Indexing with the 0-dim segment index made inside
    the function raised there; the rows are gathered by index_select."""
    rng = np.random.default_rng(6)
    times = np.float32([0.0, 1.0, 3.0])
    states = rng.standard_normal((3, 4)).astype(np.float32)
    jt = jref.TargetTrajectories.create(times, states, states[:, :2])
    tt = reference.TargetTrajectories.create(times, states, states[:, :2], device="cpu")
    ts = np.float32([0.2, 1.5, 2.9, 4.0])
    xs = rng.standard_normal((4, 4)).astype(np.float32)
    ref = jax.vmap(jax.jacrev(lambda x, t: (x - jt.state_at(t)) ** 2), (0, 0))(
        jnp.asarray(xs), jnp.asarray(ts))
    mine = torch.func.vmap(torch.func.jacrev(lambda x, t: (x - tt.state_at(t)) ** 2))(T(xs), T(ts))
    np.testing.assert_allclose(mine.numpy(), np.asarray(ref), atol=ATOL)


def test_target_trajectories_state_and_input_at():
    rng = np.random.default_rng(5)
    times = np.float32([0.0, 1.0, 3.0])
    states = rng.standard_normal((3, 4)).astype(np.float32)
    inputs = rng.standard_normal((3, 2)).astype(np.float32)
    jt = jref.TargetTrajectories.create(times, states, inputs)
    tt = reference.TargetTrajectories.create(times, states, inputs, device="cpu")
    for t in (-0.5, 0.4, 2.0, 9.0):
        np.testing.assert_allclose(tt.state_at(t).numpy(), np.asarray(jt.state_at(t)), atol=ATOL)
        np.testing.assert_allclose(tt.input_at(t).numpy(), np.asarray(jt.input_at(t)), atol=ATOL)
    # A constant target answers with its one sample, for any query shape.
    ct = reference.TargetTrajectories.constant(states[0], inputs[0], device="cpu")
    np.testing.assert_array_equal(ct.state_at(T([0.1, 0.2])).numpy(), states[0])
    # Carried across through numpy.
    conv = convert.target_trajectories_from_numpy(
        jax.tree.map(np.asarray, jt)._asdict(), device="cpu")
    np.testing.assert_array_equal(conv.states.numpy(), tt.states.numpy())


def test_mode_schedule():
    js = jref.ModeSchedule.create([0.5, 1.5], [0, 1, 2], capacity=4)
    ms = reference.ModeSchedule.create([0.5, 1.5], [0, 1, 2], capacity=4)
    np.testing.assert_array_equal(ms.event_times, js.event_times)
    np.testing.assert_array_equal(ms.mode_sequence, js.mode_sequence)
    for t in (0.0, 0.5, 1.0, 2.0):
        assert int(ms.mode_at_time(t)) == int(js.mode_at_time(t))
        assert int(ms.mode_at_time(T(t))) == int(js.mode_at_time(t))
    assert reference.ModeSchedule.single_mode(3, 2).capacity == 2


PENALTIES = {
    "relaxed_barrier": lambda m: m.relaxed_barrier(0.7, 0.2),
    "squared_hinge": lambda m: m.squared_hinge(2.0, 0.1),
    "quadratic": lambda m: m.quadratic(3.0),
    "smooth_absolute": lambda m: m.smooth_absolute(1.5, 0.05),
}


@pytest.mark.parametrize("name", list(PENALTIES) + ["double_sided"])
def test_penalty_value_and_derivatives(name):
    h = np.random.default_rng(6).uniform(-1.0, 1.5, (3, 5)).astype(np.float32)
    if name == "double_sided":
        ref = jpen.double_sided(-0.5, 0.8, jpen.relaxed_barrier(0.7, 0.2))(jnp.asarray(h))
        mine = penalties.double_sided(-0.5, 0.8, penalties.relaxed_barrier(0.7, 0.2))(T(h))
    else:
        ref = PENALTIES[name](jpen)(jnp.asarray(h))
        mine = PENALTIES[name](penalties)(T(h))
    for a, b in zip(mine, ref):
        assert a.shape == h.shape
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("name", ["al_quadratic_equality", "al_hinge_inequality",
                                  "modified_relaxed_barrier"])
def test_augmented_penalties(name):
    rng = np.random.default_rng(7)
    h = rng.uniform(-1.0, 1.0, (4, 3)).astype(np.float32)
    lm = rng.uniform(0.0, 2.0, (4, 3)).astype(np.float32)
    jp, tp = getattr(jpen, name)(), getattr(penalties, name)()
    rho = 7.0
    np.testing.assert_allclose(
        tp.value(T(lm), T(rho), T(h)).numpy(),
        np.asarray(jp.value(jnp.asarray(lm), rho, jnp.asarray(h))), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(
        tp.multiplier_update(T(lm), T(rho), T(h)).numpy(),
        np.asarray(jp.multiplier_update(jnp.asarray(lm), rho, jnp.asarray(h))),
        atol=1e-5, rtol=1e-5)
    for a, b in zip(tp.derivatives(T(lm), T(rho), T(h)),
                    jp.derivatives(jnp.asarray(lm), rho, jnp.asarray(h))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5, rtol=1e-5)


def test_value_types():
    rng = np.random.default_rng(8)
    m = rng.standard_normal((4, 4)).astype(np.float32)
    np.testing.assert_allclose(
        types.make_psd(T(m), 0.1).numpy(), np.asarray(jtypes.make_psd(jnp.asarray(m), 0.1)),
        atol=1e-5)
    np.testing.assert_allclose(
        types.symmetrize(T(m)).numpy(), np.asarray(jtypes.symmetrize(jnp.asarray(m))), atol=ATOL)
    q = types.ScalarQuadraticApproximation.zeros(3, 2, device="cpu")
    s = types.ScalarQuadraticApproximation(
        f=T(1.0), dfdx=torch.ones(3), dfdu=None, dfdxx=torch.eye(3), dfdux=None, dfduu=None)
    tot = s + s
    assert tot.dfdu is None and float(tot.f) == 2.0 and (q + q).dfduu.shape == (2, 2)
    p = types.PerformanceIndex.zeros(device="cpu")
    assert float((p + p).merit) == 0.0
    v = types.VectorLinearApproximation.zeros(2, 3, device="cpu")
    assert v.dfdu is None and v.dfdx.shape == (2, 3)


@pytest.mark.parametrize("events, modes, n", [((), None, 8), ((0.4, 1.1), (0, 1, 2), 12)])
def test_time_grid_matches_and_moves_to_device(events, modes, n):
    jg = jtd.make_time_grid(0.0, 2.0, n, events, modes)
    tg = td.make_time_grid(0.0, 2.0, n, events, modes)
    for a, b in zip(tg, jg):
        np.testing.assert_array_equal(a, b)
    dev = tg.device("cpu")
    assert dev.times.dtype == torch.float32 and dev.modes.dtype == torch.int64
    assert dev.num_intervals == n == tg.num_intervals
    np.testing.assert_allclose(dev.dts.numpy(), np.asarray(jg.dts), atol=ATOL)
    conv = convert.time_grid_from_numpy(jg._asdict(), device="cpu")
    np.testing.assert_array_equal(conv.times.numpy(), dev.times.numpy())
    np.testing.assert_array_equal(conv.modes.numpy(), dev.modes.numpy())
    with pytest.raises(ValueError, match="too small"):
        td.make_time_grid(0.0, 2.0, 2, (0.5, 1.0))
