"""The quadrotor model of the port vs the JAX package on the CPU: dynamics
and their Jacobians, the LQ approximation, and an SQP solve of a batch of 8
scenarios (N = 10, rk4, 8 iterations at most) against ``jax.vmap(sqp.solve)``
with per-scenario iterations equal.

Inputs come from a numpy seed.  Pure functions within rtol 2e-4 / atol 1e-5,
solves within 1e-3 + 1e-4 |value|.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ocs2_tpu.models import quadrotor as jquad
from ocs2_tpu.oc.approx import approximate_lq as japproximate_lq
from ocs2_tpu.oc.time_discretization import uniform_grid as juniform_grid
from ocs2_tpu.solvers import sqp as jsqp

from ocs2_tpu_torch.models import quadrotor
from ocs2_tpu_torch.oc.approx import approximate_lq
from ocs2_tpu_torch.oc.time_discretization import uniform_grid
from ocs2_tpu_torch.solvers import sqp

torch.set_num_threads(1)  # one intra-op thread a test process: the suite runs in several
# processes at once (pytest-xdist), and these small tensors gain nothing from more.

RTOL, ATOL = 2e-4, 1e-5
SOLVE_ATOL, SOLVE_RTOL = 1e-3, 1e-4
B, N, HORIZON = 8, 10, 2.0
SETTINGS = dict(max_iterations=8, integrator="rk4")


def close(mine, ref, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(mine.detach().numpy(), np.asarray(ref), rtol=rtol, atol=atol)


def _samples(seed, scale=1.0, n=16):
    rng = np.random.default_rng(seed)
    x = (scale * rng.standard_normal((n, quadrotor.NX))).astype(np.float32)
    u = (scale * rng.standard_normal((n, quadrotor.NU))).astype(np.float32)
    return x, u


def hover_batch(batch, seed=1):
    """Hover at z = 1 plus 0.05 N(0, 1), as the chip lane draws it."""
    x0s = np.zeros((batch, quadrotor.NX), np.float32)
    x0s[:, 2] = 1.0
    return x0s + (0.05 * np.random.default_rng(seed).standard_normal(x0s.shape)).astype(np.float32)


@pytest.mark.parametrize("scale", [0.1, 1.0, 3.0])
def test_dynamics_match(scale):
    x, u = _samples(0, scale)
    ref = jax.vmap(lambda xx, uu: jquad.dynamics(0.0, xx, uu, None))(x, u)
    mine = quadrotor.dynamics(0.0, torch.as_tensor(x), torch.as_tensor(u), None)
    close(mine, ref)


def test_dynamics_near_the_pitch_guard():
    """|cos pitch| at and below the 1e-3 guard, both signs."""
    x, u = _samples(2, 0.5, n=4)
    x[:, 4] = np.float32([np.pi / 2, -np.pi / 2, np.pi / 2 + 5e-4, np.pi / 2 - 2e-3])
    ref = jax.vmap(lambda xx, uu: jquad.dynamics(0.0, xx, uu, None))(x, u)
    mine = quadrotor.dynamics(0.0, torch.as_tensor(x), torch.as_tensor(u), None)
    close(mine, ref, rtol=1e-3)


def test_rotation_and_rate_matrix_match():
    x, _ = _samples(3)
    for jf, tf in ((jquad.euler_zyx_to_rotation, quadrotor.euler_zyx_to_rotation),
                   (jquad.euler_zyx_rate_matrix, quadrotor.euler_zyx_rate_matrix)):
        close(tf(torch.as_tensor(x[:, 3:6])), jax.vmap(jf)(x[:, 3:6]))
    r = quadrotor.euler_zyx_to_rotation(torch.as_tensor(x[:, 3:6]))
    close(r @ r.transpose(-1, -2), np.broadcast_to(np.eye(3), r.shape), atol=1e-5)


def test_jacobians_match_and_stay_float32():
    """Under torch.func.jacfwd of one sample (0-dim time) the model computes
    in float32: no 0-dim select meets a Python float."""
    x, u = _samples(4, 0.5, n=1)
    t = torch.zeros(())
    xt, ut = torch.as_tensor(x[0]), torch.as_tensor(u[0])
    ja = torch.func.jacfwd(lambda xx: quadrotor.dynamics(t, xx, ut, None))(xt)
    jb = torch.func.jacfwd(lambda uu: quadrotor.dynamics(t, xt, uu, None))(ut)
    assert ja.dtype == jb.dtype == torch.float32
    close(ja, jax.jacfwd(lambda xx: jquad.dynamics(0.0, xx, u[0], None))(x[0]))
    close(jb, jax.jacfwd(lambda uu: jquad.dynamics(0.0, x[0], uu, None))(u[0]))


def test_approximate_lq_matches_and_is_float32():
    x, u = _samples(5, 0.3, n=N + 1)
    xs = x[None]
    us = u[None, :N]
    ref = jax.jit(lambda xx, uu: japproximate_lq(
        jquad.make_problem(), juniform_grid(0.0, HORIZON, N), xx, uu, jquad.make_params(),
        method="rk4"))(x, u[:N])
    mine = approximate_lq(quadrotor.make_problem(device="cpu"), uniform_grid(0.0, HORIZON, N),
                          torch.as_tensor(xs), torch.as_tensor(us),
                          quadrotor.make_params(device="cpu"), method="rk4")
    for name in ("f", "dfdx", "dfdu"):
        leaf = getattr(mine.dynamics, name)
        assert leaf.dtype == torch.float32
        close(leaf[0], getattr(ref.dynamics, name))
    for name in ("f", "dfdx", "dfdu", "dfdxx", "dfduu", "dfdux"):
        leaf = getattr(mine.cost, name)
        assert leaf.dtype == torch.float32
        close(leaf[0], getattr(ref.cost, name), rtol=1e-3, atol=1e-4)


def test_hover_is_an_equilibrium():
    x = torch.zeros(quadrotor.NX)
    x[2] = 1.0
    dx = quadrotor.dynamics(0.0, x, quadrotor.hover_input("cpu"), None)
    assert float(dx.abs().max()) < 1e-6


@functools.lru_cache(maxsize=None)
def _solves():
    x0s = hover_batch(B)
    one = lambda x: jsqp.solve(  # noqa: E731
        jquad.make_problem(), juniform_grid(0.0, HORIZON, N), x, jquad.make_params(),
        settings=jsqp.SqpSettings(**SETTINGS))
    ref = jax.tree.map(np.asarray, jax.jit(jax.vmap(one))(jnp.asarray(x0s)))
    mine = sqp.solve(quadrotor.make_problem(device="cpu"), uniform_grid(0.0, HORIZON, N), x0s,
                     quadrotor.make_params(device="cpu"), settings=sqp.SqpSettings(**SETTINGS),
                     device="cpu")
    return mine, ref


def test_sqp_batch_iterations_match_per_scenario():
    mine, ref = _solves()
    np.testing.assert_array_equal(mine.iterations.numpy(), ref.iterations)
    np.testing.assert_array_equal(mine.converged.numpy(), ref.converged)


@pytest.mark.parametrize("field", ["xs", "us", "gains"])
def test_sqp_batch_trajectories_match(field):
    mine, ref = _solves()
    rtol = SOLVE_RTOL if field != "gains" else 1e-3
    close(getattr(mine, field), getattr(ref, field), rtol=rtol, atol=SOLVE_ATOL)


def test_sqp_batch_performance_matches():
    mine, ref = _solves()
    for name in ("merit", "cost", "dynamics_violation_sse"):
        close(getattr(mine.performance, name), getattr(ref.performance, name),
              rtol=1e-3, atol=1e-6)
    # Step sizes agree except at each scenario's last iteration: there the
    # iterate is stationary (merit moves by 1e-9) and the filter's "merit
    # fell" test is decided by float32 rounding in either package.
    before_last = np.arange(SETTINGS["max_iterations"])[None] < ref.iterations[:, None] - 1
    np.testing.assert_array_equal(mine.history.step_size.numpy()[before_last],
                                  ref.history.step_size[before_last])
    assert before_last.sum() >= 2 * B
