"""The ported slice as a whole: batched ballbot iLQR, port vs jax.vmap(ddp.solve).

Both sides get the same numpy-seeded initial states.  At B=8 the JAX side
takes vmap(_lqr_backward_single) on the CPU and the port the entry-form plain
version of its kernel: the difference is float32 reassociation, hence the
1e-3 control-trajectory tolerance and not bit equality.  The JAX package's
solve (``JAX_RECORDS``) is stored in
``tests/torch_data/test_torch_ddp_ballbot_jax.npz`` by
``tools/torch_test_records.py --record test_torch_ddp_ballbot``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ocs2_tpu.models import ballbot as jballbot
from ocs2_tpu.oc.time_discretization import uniform_grid as juniform_grid
from ocs2_tpu.solvers import ddp as jddp

from ocs2_tpu_torch.models import ballbot
from ocs2_tpu_torch.oc.time_discretization import uniform_grid
from ocs2_tpu_torch.solvers import ddp
from tools._records import Records

torch.set_num_threads(1)  # one intra-op thread a test process: the suite runs in several
# processes at once (pytest-xdist), and these small tensors gain nothing from more.

B, N, MAX_IT = 8, 16, 8
# Seed fixed: the comparison holds iteration counts equal, and a line-search
# tie between two step sizes could flip one under another seed.
SEED = 0


def _x0s(batch=B, seed=SEED):
    rng = np.random.default_rng(seed)
    return (0.1 * rng.standard_normal((batch, ballbot.NX))).astype(np.float32)


def _jax_solve(parallel_riccati=False):
    problem = jballbot.make_problem()
    grid = juniform_grid(0.0, 1.0, N)
    params = jballbot.make_params()
    st = jddp.DdpSettings(algorithm="ilqr", max_iterations=MAX_IT,
                          parallel_riccati=parallel_riccati)
    solve = jax.jit(jax.vmap(
        lambda x, p: jddp.solve(problem, grid, x, p, settings=st),
        in_axes=(0, None),
    ))
    return dict(x0=_x0s(), sol=solve(jnp.asarray(_x0s()), params))


JAX_RECORDS = {"ilqr_b8": _jax_solve,
               "ilqr_b8_parallel_riccati": lambda: _jax_solve(parallel_riccati=True)}
RECORDS = Records(__file__)


@pytest.fixture(scope="module")
def jax_solution():
    rec = RECORDS["ilqr_b8"]
    np.testing.assert_array_equal(rec["x0"], _x0s())  # the record solved these starts
    return rec["sol"]


def _torch_solve(x0s, **kw):
    return ddp.solve(
        ballbot.make_problem(device="cpu"), uniform_grid(0.0, 1.0, N), x0s,
        ballbot.make_params(device="cpu"),
        settings=ddp.DdpSettings(algorithm="ilqr", max_iterations=MAX_IT),
        device="cpu", **kw,
    )


@pytest.fixture(scope="module")
def torch_solution():
    return _torch_solve(_x0s())


def test_iterations_and_convergence_match(jax_solution, torch_solution):
    np.testing.assert_array_equal(
        torch_solution.iterations.numpy(), jax_solution.iterations)
    np.testing.assert_array_equal(
        torch_solution.converged.numpy(), jax_solution.converged)
    # The fixture is not trivial: scenarios stop at different iterations.
    assert len(set(jax_solution.iterations.tolist())) > 1


@pytest.mark.parametrize("field", ["xs", "us"])
def test_trajectories_match(jax_solution, torch_solution, field):
    # 1e-3 absolute, plus 1e-4 of the value: the first inputs of a hard
    # scenario reach |u| ~ 50, where float32 reassociation through feedback
    # gains of order 1e2 is itself above 1e-3.
    np.testing.assert_allclose(
        getattr(torch_solution, field).numpy(), getattr(jax_solution, field),
        atol=1e-3, rtol=1e-4,
    )


def test_final_cost_and_value_function_match(jax_solution, torch_solution):
    np.testing.assert_allclose(
        torch_solution.performance.cost.numpy(), jax_solution.performance.cost,
        rtol=1e-3,
    )
    np.testing.assert_allclose(
        torch_solution.performance.merit.numpy(), jax_solution.performance.merit,
        rtol=1e-3,
    )
    np.testing.assert_allclose(
        torch_solution.gains.numpy(), jax_solution.gains, atol=2e-3, rtol=1e-3)
    np.testing.assert_allclose(
        torch_solution.value_S.numpy(), jax_solution.value_S, atol=2e-3, rtol=1e-3)


@pytest.mark.parametrize("field", ddp.DdpIterationLog._fields)
def test_history_matches_with_nan_padding(jax_solution, torch_solution, field):
    mine = getattr(torch_solution.history, field).numpy()
    ref = getattr(jax_solution.history, field)
    assert mine.shape == ref.shape == (B, MAX_IT)
    np.testing.assert_array_equal(np.isnan(mine), np.isnan(ref))
    np.testing.assert_allclose(mine, ref, rtol=1e-3, atol=1e-6)


def test_solution_shapes_and_dtypes(torch_solution):
    s = torch_solution
    assert s.xs.shape == (B, N + 1, ballbot.NX) and s.us.shape == (B, N, ballbot.NU)
    assert s.gains.shape == (B, N, ballbot.NU, ballbot.NX)
    assert s.value_S.shape == (B, N + 1, ballbot.NX, ballbot.NX)
    assert s.value_s.shape == (B, N + 1, ballbot.NX)
    assert s.iterations.shape == (B,) and s.converged.dtype == torch.bool
    for leaf in (s.xs, s.us, s.gains, s.value_S, s.performance.cost):
        assert leaf.dtype == torch.float32
    assert torch.isfinite(s.xs).all() and torch.isfinite(s.us).all()
    merit = s.history.merit
    last = merit[torch.arange(B), s.iterations.long() - 1]
    assert (last <= merit[:, 0] + 1e-4).all()


def test_frozen_scenario_equals_solving_it_alone():
    """A scenario that finishes early is frozen while the others go on: in a
    mixed batch the already-optimal x0 = 0 gets the result it gets alone."""
    x0s = _x0s(4, seed=3)
    x0s[1] = 0.0
    mixed = _torch_solve(x0s)
    alone = _torch_solve(x0s[1:2])
    assert int(mixed.iterations[1]) == int(alone.iterations[0])
    assert int(mixed.iterations[1]) < int(mixed.iterations.max())
    assert bool(mixed.converged[1]) and bool(alone.converged[0])
    # Not bit equality: the CPU's reductions vectorize differently at B=1
    # and B=4 (last-bit differences).
    for f in ("xs", "us", "gains", "value_S", "value_s"):
        np.testing.assert_allclose(
            getattr(mixed, f)[1].numpy(), getattr(alone, f)[0].numpy(),
            atol=1e-5, rtol=2e-5, err_msg=f,
        )
    np.testing.assert_array_equal(
        np.isnan(mixed.history.merit[1].numpy()),
        np.isnan(alone.history.merit[0].numpy()),
    )


def test_shared_us_init_broadcasts():
    x0s = _x0s(3, seed=5)
    us = np.zeros((N, ballbot.NU), np.float32)
    a = _torch_solve(x0s, us_init=torch.as_tensor(us))
    b = _torch_solve(x0s, us_init=torch.as_tensor(np.broadcast_to(us, (3,) + us.shape).copy()))
    np.testing.assert_array_equal(a.xs.numpy(), b.xs.numpy())


def test_hessian_correction_leaves_a_psd_problem_where_it_was():
    """Ballbot's cost terms are PSD by construction, so "auto" skips the
    correction; forcing it clamps eigenvalues that are already above the
    floor and moves the solve at rounding level only."""
    x0s = _x0s(2, seed=7)
    solve = lambda **kw: ddp.solve(  # noqa: E731
        ballbot.make_problem(device="cpu"), uniform_grid(0.0, 1.0, 6), x0s,
        ballbot.make_params(device="cpu"),
        settings=ddp.DdpSettings(max_iterations=3, **kw), device="cpu")
    auto = solve()
    for method in ("eigh", "gershgorin"):
        forced = solve(convexify=True, hessian_correction=method)
        np.testing.assert_array_equal(forced.iterations.numpy(), auto.iterations.numpy())
        np.testing.assert_allclose(forced.us.numpy(), auto.us.numpy(), atol=1e-3, rtol=1e-4)


@pytest.mark.parametrize("kwargs", [{"parallel_riccati": True}])
def test_parallel_riccati_matches_the_reference(kwargs):
    """The batch with the associative-scan Riccati against ``jax.vmap`` of the
    JAX package's solve with it: iterations equal, ``xs`` / ``us`` within
    1e-3 + 1e-4 |value|, as the sequential sweep is held above."""
    rec = RECORDS["ilqr_b8_parallel_riccati"]
    np.testing.assert_array_equal(rec["x0"], _x0s())  # the record solved these starts
    mine = ddp.solve(
        ballbot.make_problem(device="cpu"), uniform_grid(0.0, 1.0, N), _x0s(),
        ballbot.make_params(device="cpu"),
        settings=ddp.DdpSettings(algorithm="ilqr", max_iterations=MAX_IT, **kwargs),
        device="cpu",
    )
    ref = rec["sol"]
    np.testing.assert_array_equal(mine.iterations.numpy(), ref.iterations)
    for field in ("xs", "us"):
        np.testing.assert_allclose(getattr(mine, field).numpy(), getattr(ref, field),
                                   atol=1e-3, rtol=1e-4, err_msg=field)
