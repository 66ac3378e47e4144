"""SLQ (DDP with the continuous-time Riccati sweep) of the port vs the JAX
package, on the CPU: the ballbot batch against ``jax.vmap(ddp.solve)``, EXP0
(a switched system with a jump) against the JAX solve and against its known
optimal cost, the ``Solver("slq")`` facade and ``Mpc`` with SLQ settings on
the double integrator.  The port's sweep here is the kernel's plain version.

Tolerances: solves with equal iteration counts within 1e-3 + 1e-4 |value| in
states and inputs (float32 reassociation through feedback gains, as for the
iLQR batch); value functions, gains and merits within rtol 1e-3 (the
ballbot's value Hessian reaches 2.6e3); EXP0's cost within the JAX package's
own COST_RTOL of the reference's 9.766.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import exp_fixtures as jexp0
from ocs2_tpu.mpc import mpc as jmpc
from ocs2_tpu.models import ballbot as jballbot
from ocs2_tpu.models import double_integrator as jdi
from ocs2_tpu.oc.time_discretization import uniform_grid as juniform_grid
from ocs2_tpu.solvers import ddp as jddp
from ocs2_tpu.solvers.api import Solver as JSolver

from ocs2_tpu_torch.core.reference import TargetTrajectories
from ocs2_tpu_torch.models import ballbot, double_integrator as di
from ocs2_tpu_torch.mpc.mpc import Mpc, MpcSettings
from ocs2_tpu_torch.oc.problem import (
    OptimalControlProblem,
    quadratic_cost,
    quadratic_final_cost,
)
from ocs2_tpu_torch.oc.time_discretization import make_time_grid, uniform_grid
from ocs2_tpu_torch.solvers import ddp
from ocs2_tpu_torch.solvers.api import Solver

torch.set_num_threads(1)  # one intra-op thread a test process: the suite runs in several
# processes at once (pytest-xdist), and these small tensors gain nothing from more.

SOLVE_ATOL, SOLVE_RTOL = 1e-3, 1e-4
VALUE_RTOL, VALUE_ATOL = 1e-3, 2e-3
COST_RTOL = 7e-3  # tests/test_exp_fixtures.py: fixed-step transcription vs ODE45

B, N, MAX_IT = 3, 8, 8


# -- EXP0, the torch twin of tests/exp_fixtures.py's -----------------------------

_EXP0_A = np.stack([np.array([[0.6, 1.2], [-0.8, 3.4]], np.float32),
                    np.array([[4.0, 3.0], [-1.0, 0.0]], np.float32)])
_EXP0_B = np.stack([np.array([[1.0], [1.0]], np.float32),
                    np.array([[2.0], [-1.0]], np.float32)])
EXP0_X0 = np.array([0.0, 2.0], np.float32)


def exp0_problem() -> OptimalControlProblem:
    """Two linear modes selected by the node's mode (an index tensor, also
    under ``vmap``); batch-polymorphic in x and u."""
    a_modes, b_modes = torch.as_tensor(_EXP0_A), torch.as_tensor(_EXP0_B)

    def dynamics(t, x, u, p):
        # The node's mode: one index, or one per node of a batch of nodes.
        mode = p["mode"]
        a = a_modes.index_select(0, mode.reshape(-1)).reshape(mode.shape + (2, 2))
        b = b_modes.index_select(0, mode.reshape(-1)).reshape(mode.shape + (2, 1))
        return (a @ x.unsqueeze(-1) + b @ u.unsqueeze(-1)).squeeze(-1)

    return OptimalControlProblem(
        dynamics=dynamics,
        cost_terms=(quadratic_cost(np.diag([0.0, 1.0]).astype(np.float32),
                                   np.eye(1, dtype=np.float32), device="cpu"),),
        final_cost_terms=(quadratic_final_cost(np.eye(2, dtype=np.float32), device="cpu"),),
        nx=2,
        nu=1,
    )


def exp0_params() -> dict:
    return {"target": TargetTrajectories.constant(
        np.array([4.0, 2.0], np.float32), np.zeros(1, np.float32), device="cpu")}


def exp0_grid(num_intervals: int = 100):
    return make_time_grid(jexp0.EXP0_T0, jexp0.EXP0_TF, num_intervals,
                          event_times=jexp0.EXP0_EVENT_TIMES,
                          mode_sequence=jexp0.EXP0_MODE_SEQUENCE)


def close(mine, ref, rtol=SOLVE_RTOL, atol=SOLVE_ATOL, err_msg=""):
    mine = mine.detach().cpu().numpy() if isinstance(mine, torch.Tensor) else np.asarray(mine)
    np.testing.assert_allclose(mine, np.asarray(ref), rtol=rtol, atol=atol, err_msg=err_msg)


# -- the ballbot batch ------------------------------------------------------------

def _x0s(batch=B, seed=0):
    rng = np.random.default_rng(seed)
    return (0.1 * rng.standard_normal((batch, ballbot.NX))).astype(np.float32)


@pytest.fixture(scope="module")
def ballbot_pair():
    st = jddp.DdpSettings(algorithm="slq", max_iterations=MAX_IT)
    solve = jax.jit(jax.vmap(
        lambda x, p: jddp.solve(jballbot.make_problem(), juniform_grid(0.0, 1.0, N), x, p,
                                settings=st), in_axes=(0, None)))
    ref = jax.tree.map(np.asarray, solve(jnp.asarray(_x0s()), jballbot.make_params()))
    mine = ddp.solve(ballbot.make_problem(device="cpu"), uniform_grid(0.0, 1.0, N), _x0s(),
                     ballbot.make_params(device="cpu"),
                     settings=ddp.DdpSettings(algorithm="slq", max_iterations=MAX_IT),
                     device="cpu")
    return mine, ref


def test_ballbot_iterations_and_convergence_match(ballbot_pair):
    mine, ref = ballbot_pair
    np.testing.assert_array_equal(mine.iterations.numpy(), ref.iterations)
    np.testing.assert_array_equal(mine.converged.numpy(), ref.converged)


@pytest.mark.parametrize("field", ["xs", "us"])
def test_ballbot_trajectories_match(ballbot_pair, field):
    mine, ref = ballbot_pair
    close(getattr(mine, field), getattr(ref, field))


@pytest.mark.parametrize("field", ["gains", "value_S", "value_s"])
def test_ballbot_value_function_matches(ballbot_pair, field):
    mine, ref = ballbot_pair
    close(getattr(mine, field), getattr(ref, field), VALUE_RTOL, VALUE_ATOL)


@pytest.mark.parametrize("field", ddp.DdpIterationLog._fields)
def test_ballbot_iteration_log_matches(ballbot_pair, field):
    mine, ref = ballbot_pair
    a, b = getattr(mine.history, field).numpy(), getattr(ref.history, field)
    np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
    np.testing.assert_allclose(a, b, rtol=VALUE_RTOL, atol=1e-6)


def test_ballbot_slq_is_not_ilqr(ballbot_pair):
    """The continuous-time sweep gives another value function than the
    discrete recursion on the same problem: SLQ really ran."""
    mine, _ = ballbot_pair
    ilqr = ddp.solve(ballbot.make_problem(device="cpu"), uniform_grid(0.0, 1.0, N), _x0s(),
                     ballbot.make_params(device="cpu"),
                     settings=ddp.DdpSettings(algorithm="ilqr", max_iterations=1),
                     device="cpu")
    assert float((mine.value_S[:, 0] - ilqr.value_S[:, 0]).abs().max()) > 1.0


def test_slq_solve_goes_through_the_ct_sweep(monkeypatch):
    """One CT sweep per iteration of the batch and no discrete sweep; the
    test hook routes the same sweep through its plain version."""
    calls = {"ct": 0, "discrete": 0}
    ct_sweep, discrete = ddp.slq_backward, ddp.lqr_backward

    def count_ct(*a, **k):
        calls["ct"] += 1
        return ct_sweep(*a, **k)

    def count_discrete(*a, **k):
        calls["discrete"] += 1
        return discrete(*a, **k)

    monkeypatch.setattr(ddp, "slq_backward", count_ct)
    monkeypatch.setattr(ddp, "lqr_backward", count_discrete)
    kw = dict(settings=ddp.DdpSettings(algorithm="slq", max_iterations=3), device="cpu")
    args = (ballbot.make_problem(device="cpu"), uniform_grid(0.0, 1.0, 4), _x0s(2),
            ballbot.make_params(device="cpu"))
    sol = ddp.solve(*args, **kw)
    assert calls == {"ct": int(sol.iterations.max()), "discrete": 0}
    plain = ddp.solve(*args, force_plain_riccati=True, **kw)
    np.testing.assert_array_equal(plain.us.numpy(), sol.us.numpy())


def test_slq_rollouts_take_at_least_two_substeps():
    assert ddp.DdpSettings(algorithm="slq")._substeps == 2
    assert ddp.DdpSettings(algorithm="slq", substeps=3)._substeps == 3
    assert ddp.DdpSettings(algorithm="ilqr")._substeps == 1


def test_unknown_algorithm_raises():
    with pytest.raises(ValueError, match="unknown algorithm"):
        ddp.solve(ballbot.make_problem(device="cpu"), uniform_grid(0.0, 1.0, 4), _x0s(1),
                  ballbot.make_params(device="cpu"),
                  settings=ddp.DdpSettings(algorithm="nope"), device="cpu")


# -- EXP0 at B = 1 -----------------------------------------------------------------

@pytest.fixture(scope="module")
def exp0_pair():
    st = jddp.DdpSettings(algorithm="slq", max_iterations=30)
    jgrid, jproblem, jparams = jexp0.exp0_grid(100), jexp0.exp0_problem(), jexp0.exp0_params()
    ref = jax.jit(lambda x: jddp.solve(jproblem, jgrid, x, jparams, settings=st))(
        jnp.asarray(EXP0_X0))
    ref = jax.tree.map(np.asarray, ref)
    mine = ddp.solve(exp0_problem(), exp0_grid(100), EXP0_X0[None], exp0_params(),
                     settings=ddp.DdpSettings(algorithm="slq", max_iterations=30),
                     device="cpu")
    return mine, ref


def test_exp0_hits_the_reference_cost(exp0_pair):
    mine, _ = exp0_pair
    cost = float(mine.performance.cost[0])
    assert abs(cost - jexp0.EXP0_EXPECTED_COST) < COST_RTOL * jexp0.EXP0_EXPECTED_COST, cost


def test_exp0_matches_jax(exp0_pair):
    mine, ref = exp0_pair
    assert int(mine.iterations[0]) == int(ref.iterations)
    assert bool(mine.converged[0]) == bool(ref.converged)
    close(mine.performance.cost[0], ref.performance.cost, 1e-5, 1e-6)
    close(mine.xs[0], ref.xs)
    close(mine.us[0], ref.us)
    close(mine.value_S[0], ref.value_S, VALUE_RTOL, VALUE_ATOL)


# -- the facade and the MPC runtime on the double integrator ----------------------

def test_solver_facade_slq_matches_jax():
    grid, jgrid = uniform_grid(0.0, 2.0, 25), juniform_grid(0.0, 2.0, 25)
    x0 = np.array([1.0, 0.0], np.float32)
    ref_solver = JSolver(jdi.make_problem(), algorithm="slq")
    ref = ref_solver.run(jgrid, jnp.asarray(x0), jdi.make_params())
    solver = Solver(di.make_problem(device="cpu"), algorithm="slq", device="cpu")
    sol = solver.run(grid, x0, di.make_params(device="cpu"))
    assert solver.settings.algorithm == "slq"
    assert int(sol.iterations[0]) == int(ref.iterations)
    close(sol.us[0], ref.us)
    close(sol.value_S[0], ref.value_S, VALUE_RTOL, VALUE_ATOL)
    t8 = torch.tensor(float(grid.times[8]))
    v = solver.get_value_function(t8, sol.xs[0, 8])
    v_ref = ref_solver.get_value_function(jnp.float32(grid.times[8]), ref.xs[8])
    close(v.f, v_ref.f, 1e-4, 1e-5)


def test_mpc_with_slq_settings_matches_jax():
    st = dict(time_horizon=1.0, num_intervals=20, solver="ddp")
    slq = dict(algorithm="slq", max_iterations=10)
    ref = jmpc.Mpc(jdi.make_problem(), jdi.make_params(), settings=jmpc.MpcSettings(**st),
                   solver_settings=jddp.DdpSettings(**slq))
    mine = Mpc(di.make_problem(device="cpu"), di.make_params(device="cpu"),
               settings=MpcSettings(**st), solver_settings=ddp.DdpSettings(**slq), device="cpu")
    assert mine.solver_settings.algorithm == "slq"
    for t, x in ((0.0, [1.0, 0.0]), (0.05, [0.98, -0.2]), (0.1, [0.93, -0.4])):
        x = np.asarray(x, np.float32)
        pr, pm = ref.run(t, jnp.asarray(x)), mine.run(t, torch.as_tensor(x))
        close(pm.times, pr.times, 1e-6, 1e-6)
        close(pm.xs, pr.xs)
        close(pm.us, pr.us)
        close(pm.controller.gains, pr.controller.gains, VALUE_RTOL, VALUE_ATOL)
        close(pm.performance.cost, pr.performance.cost, 1e-3, 1e-6)
    assert mine.solve_timer.count == 3


def test_slq_ignores_parallel_riccati():
    """SLQ's sweep is the Riccati ODE whatever ``parallel_riccati`` says (the
    JAX package's SLQ returns before it reads the flag): the same solution,
    to the bit, with and without it."""
    solve = lambda **kw: ddp.solve(  # noqa: E731
        ballbot.make_problem(device="cpu"), uniform_grid(0.0, 1.0, 4), _x0s(2),
        ballbot.make_params(device="cpu"),
        settings=ddp.DdpSettings(algorithm="slq", max_iterations=3, **kw), device="cpu")
    a, b = solve(), solve(parallel_riccati=True)
    np.testing.assert_array_equal(b.iterations.numpy(), a.iterations.numpy())
    for field in ("xs", "us", "gains"):
        np.testing.assert_array_equal(getattr(b, field).numpy(), getattr(a, field).numpy())


def test_slq_with_constraints_reads_the_last_multiplier_row_at_node_n():
    """The rate quadratization evaluates the running cost at node N, past the
    multipliers' N rows of a state-input constraint: the port reads the last
    row there, as the reference's gather clamps, and the constrained solve
    (|u| <= 1 through the augmented Lagrangian) matches the JAX package's."""
    problem = dataclasses.replace(
        di.make_problem(device="cpu"),
        inequality_terms=(lambda t, x, u, p: torch.stack([1.0 - u[..., 0], 1.0 + u[..., 0]], -1),),
    )
    jproblem = dataclasses.replace(
        jdi.make_problem(), inequality_terms=(lambda t, x, u, p: jnp.stack([1.0 - u[0], 1.0 + u[0]]),))
    x0 = np.array([2.0, 0.0], np.float32)
    settings = dict(algorithm="slq", max_iterations=6)
    sol = ddp.solve(problem, uniform_grid(0.0, 1.0, 10), x0[None], di.make_params(device="cpu"),
                    settings=ddp.DdpSettings(**settings), device="cpu")
    jgrid, jparams = juniform_grid(0.0, 1.0, 10), jdi.make_params()
    ref = jax.jit(lambda x: jddp.solve(jproblem, jgrid, x, jparams,
                                       settings=jddp.DdpSettings(**settings)))(jnp.asarray(x0))
    assert sol.al.lmbd_ineq.shape == (1, 10, 2)
    assert int(sol.iterations[0]) == int(ref.iterations)
    close(sol.us[0], ref.us)
    close(sol.al.lmbd_ineq[0], ref.al.lmbd_ineq)
