"""Whole interior-point solves of the port vs the JAX package on the CPU.

Fixtures (inputs from numpy seeds or fixed numbers):

* the double integrator over 2 s at N = 20 with a native inequality of each
  family and both together: the input box |u| <= 1.5 (``tests/test_ipm.py``'s
  bounded integrator, active from x0 = (2, 0)), the position ceiling
  x <= 1.2 (a state-only inequality, which also condenses into the terminal
  cost), and the box with the speed floor v >= -0.8, both active;
* the legged robot (SRBD) with the hard friction cone, standing and trotting
  at N = 20, 4 iterations, from the weight-compensating guess; the foot
  constraint is projected, the cone is the barrier's;
* the reference's zero-input fault on the legged trot (ROADMAP.md §3).

A batch of one is held against ``ipm.solve``, a batch of three against
``jax.vmap(ipm.solve)`` (which takes ``vmap(_lqr_backward_single)`` on the
CPU where the port takes the plain version of its kernel: float32
reassociation).  Iterations and convergence equal, ``xs`` / ``us`` within
1e-3 + 1e-4 |value| (standing contact forces at 5e-3, as in
``tests/test_torch_sqp.py``), slacks, duals, mu, the performance index, the
gains and the AL state within the tolerances stated at each test.

The JAX package's solves and its closed loop (``JAX_RECORDS``) are stored in
``tests/torch_data/test_torch_ipm_jax.npz`` by
``tools/torch_test_records.py --record test_torch_ipm``, with the starts
they solved from; the port runs live.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ocs2_tpu.models import double_integrator as jdi
from ocs2_tpu.models.legged_robot import gait as jgait
from ocs2_tpu.models.legged_robot import interface as jinterface
from ocs2_tpu.models.legged_robot import model as jmodel
from ocs2_tpu.mpc import mpc as jmpc
from ocs2_tpu.mpc import mrt as jmrt
from ocs2_tpu.oc.time_discretization import make_time_grid as jmake_time_grid
from ocs2_tpu.oc.time_discretization import uniform_grid as juniform_grid
from ocs2_tpu.solvers import ipm as jipm

from ocs2_tpu_torch.models import double_integrator as di
from ocs2_tpu_torch.models.legged_robot import constraints as con
from ocs2_tpu_torch.models.legged_robot import interface
from ocs2_tpu_torch.mpc.mpc import Mpc, MpcSettings
from ocs2_tpu_torch.mpc.mrt import MpcMrtInterface, dummy_loop
from ocs2_tpu_torch.oc.time_discretization import make_time_grid, uniform_grid
from ocs2_tpu_torch.solvers import ipm
from tools._records import Records

torch.set_num_threads(1)  # one intra-op thread a test process: the suite runs in several
# processes at once (pytest-xdist), and these small tensors gain nothing from more.

SOLVE_ATOL, SOLVE_RTOL = 1e-3, 1e-4
FORCE_ATOL = 5e-3
DI_N, LEGGED_N = 20, 20
DI_SETTINGS = dict(max_iterations=20)
LEGGED_SETTINGS = dict(max_iterations=4)
CAP, CEILING, V_FLOOR = 1.5, 1.2, -0.8
DI_X0 = {
    "bounds": [[2.0, 0.0], [1.0, 1.5], [1.5, -0.5]],
    "ceiling": [[1.0, 1.5], [0.9, 1.2], [1.0, 1.0]],
    "both": [[2.0, 0.0], [1.8, 0.2], [2.2, -0.1]],
}


def jax_di_problem(kind):
    kw = {}
    if kind in ("bounds", "both"):
        kw["inequality_terms"] = (lambda t, x, u, p: jnp.array([CAP - u[0], u[0] + CAP]),)
    if kind == "ceiling":
        kw["state_inequality_terms"] = (lambda t, x, p: jnp.array([CEILING - x[0]]),)
    if kind == "both":
        kw["state_inequality_terms"] = (lambda t, x, p: jnp.array([x[1] - V_FLOOR]),)
    return dataclasses.replace(jdi.make_problem(), **kw)


def torch_di_problem(kind):
    kw = {}
    if kind in ("bounds", "both"):
        kw["inequality_terms"] = (
            lambda t, x, u, p: torch.cat([CAP - u[..., 0:1], u[..., 0:1] + CAP], dim=-1),)
    if kind == "ceiling":
        kw["state_inequality_terms"] = (lambda t, x, p: CEILING - x[..., 0:1],)
    if kind == "both":
        kw["state_inequality_terms"] = (lambda t, x, p: x[..., 1:2] - V_FLOOR,)
    return dataclasses.replace(di.make_problem(device="cpu"), **kw)


@functools.lru_cache(maxsize=None)
def _jax_di_solve(kind, batch):
    one = lambda x: jipm.solve(  # noqa: E731
        jax_di_problem(kind), juniform_grid(0.0, 2.0, DI_N), x, jdi.make_params(),
        settings=jipm.IpmSettings(**DI_SETTINGS))
    return jax.jit(one if batch == 1 else jax.vmap(one))


def _jax_di_case(kind, batch):
    x0 = np.asarray(DI_X0[kind], np.float32)[:batch]
    return dict(x0=x0, sol=_jax_di_solve(kind, batch)(jnp.asarray(x0[0] if batch == 1 else x0)))


def _di_case(kind, batch):
    x0 = np.asarray(DI_X0[kind], np.float32)[:batch]
    mine = ipm.solve(
        torch_di_problem(kind), uniform_grid(0.0, 2.0, DI_N), x0[0] if batch == 1 else x0,
        di.make_params(device="cpu"), settings=ipm.IpmSettings(**DI_SETTINGS), device="cpu")
    return mine, x0


def _legged_grids(kind):
    if kind == "trot":
        ms = jgait.GaitSchedule(jgait.trot_gait(0.7)).mode_schedule(0.0, 1.0)
        events, seq = np.asarray(ms.event_times), np.asarray(ms.mode_sequence)
    else:
        events, seq = (), np.asarray([15])
    kw = dict(event_times=events, mode_sequence=seq)
    return (jmake_time_grid(0.0, 1.0, LEGGED_N, **kw), make_time_grid(0.0, 1.0, LEGGED_N, **kw))


@functools.lru_cache(maxsize=None)
def _jax_legged_solve(batch):
    """One compiled program per batch size: x0, the initial inputs, the grid
    and the params are arguments, so standing, trot and the zero-input start
    share it."""
    problem = jinterface.make_problem(friction_cone="hard")
    one = lambda x, u, g, p: jipm.solve(  # noqa: E731
        problem, g, x, p, us_init=u, settings=jipm.IpmSettings(**LEGGED_SETTINGS))
    return jax.jit(one if batch == 1 else jax.vmap(one, in_axes=(0, None, None, None)))


def _legged_inputs(batch):
    x0 = np.asarray(jmodel.default_state())
    x0s = x0[None] + 1e-2 * np.sin(np.arange(3)[:, None] * np.arange(24)[None, :] + 1.0)
    u0 = np.asarray(jmodel.weight_compensating_input(jnp.ones(4)))
    return x0s.astype(np.float32)[:batch], np.tile(u0[None], (LEGGED_N, 1)).astype(np.float32)


def _jax_legged_solve_of(kind, x0, us):
    jgrid, _ = _legged_grids(kind)
    batch = 1 if x0.ndim == 1 else x0.shape[0]
    return dict(x0=x0, sol=_jax_legged_solve(batch)(jnp.asarray(x0), jnp.asarray(us), jgrid,
                                                     jinterface.make_params(jgrid)))


def _legged_solve(kind, x0, us):
    _, tgrid = _legged_grids(kind)
    mine = ipm.solve(
        interface.make_problem(friction_cone="hard", device="cpu"), tgrid, x0,
        interface.make_params(tgrid, device="cpu"), us_init=torch.as_tensor(us),
        settings=ipm.IpmSettings(**LEGGED_SETTINGS), device="cpu")
    return mine, x0


def _legged_start(batch):
    x0s, us = _legged_inputs(batch)
    return x0s[0] if batch == 1 else x0s, us


def _jax_legged_case(kind, batch):
    return _jax_legged_solve_of(kind, *_legged_start(batch))


def _legged_case(kind, batch):
    return _legged_solve(kind, *_legged_start(batch))


CASES = {
    f"{prefix}_{kind}_b{batch}": (fn, jax_fn, kind, batch)
    for prefix, fn, jax_fn, kinds in (
        ("di", _di_case, _jax_di_case, ("bounds", "ceiling", "both")),
        ("legged", _legged_case, _jax_legged_case, ("standing", "trot")))
    for kind in kinds
    for batch in (1, 3)
}
LEGGED_CASES = [name for name in CASES if name.startswith("legged")]


def _as_batch(ref, batch):
    ref = jax.tree.map(np.asarray, ref)
    return jax.tree.map(lambda a: a[None], ref) if batch == 1 else ref


def _recorded(name, x0):
    rec = RECORDS[name]
    np.testing.assert_array_equal(rec["x0"], x0)  # the record solved this start
    return rec["sol"]


@functools.lru_cache(maxsize=None)
def _run(name):
    fn, _, kind, batch = CASES[name]
    mine, x0 = fn(kind, batch)
    return name, batch, mine, _as_batch(_recorded(name, x0), batch)


@pytest.fixture(scope="module", params=list(CASES))
def case(request):
    return _run(request.param)


def test_iterations_and_convergence_match(case):
    _, batch, mine, ref = case
    assert mine.iterations.shape == (batch,) and mine.iterations.dtype == torch.int32
    np.testing.assert_array_equal(mine.iterations.numpy(), ref.iterations)
    np.testing.assert_array_equal(mine.converged.numpy(), ref.converged)


@pytest.mark.parametrize("field", ["xs", "us"])
def test_trajectories_match(case, field):
    name, _, mine, ref = case
    a, b = getattr(mine, field).numpy(), getattr(ref, field)
    assert a.dtype == np.float32 and a.shape == b.shape
    if field == "us" and "standing" in name:
        # Standing, the force split between the legs is held by a 1e-3 weight
        # only (tests/test_torch_sqp.py): forces at 5e-3.
        np.testing.assert_allclose(a[..., :12], b[..., :12], atol=FORCE_ATOL, rtol=SOLVE_RTOL)
        a, b = a[..., 12:], b[..., 12:]
    np.testing.assert_allclose(a, b, atol=SOLVE_ATOL, rtol=SOLVE_RTOL)


def test_slacks_duals_and_mu_match(case):
    """Slacks (to 100 on the legged cone) at the trajectories' tolerance;
    duals within 1e-3 + 1e-3 |value| (a dual is mu / s at the iterate, so it
    inherits the slack's relative error and the step's); mu bit-near."""
    _, _, mine, ref = case
    for f in ("slack_ineq", "slack_state_ineq"):
        a, b = getattr(mine.ipm, f).numpy(), getattr(ref.ipm, f)
        assert a.shape == b.shape, f
        np.testing.assert_allclose(a, b, atol=SOLVE_ATOL, rtol=SOLVE_RTOL, err_msg=f)
    for f in ("dual_ineq", "dual_state_ineq"):
        a, b = getattr(mine.ipm, f).numpy(), getattr(ref.ipm, f)
        assert a.shape == b.shape, f
        np.testing.assert_allclose(a, b, atol=1e-3, rtol=1e-3, err_msg=f)
    np.testing.assert_allclose(mine.ipm.mu.numpy(), ref.ipm.mu, rtol=1e-5)


def test_performance_index_matches(case):
    _, _, mine, ref = case
    for f in ("merit", "cost", "inequality_lagrangian", "equality_lagrangian"):
        np.testing.assert_allclose(
            getattr(mine.performance, f).numpy(), getattr(ref.performance, f), rtol=1e-3,
            atol=1e-5, err_msg=f)
    for f in ("dynamics_violation_sse", "equality_constraints_sse",
              "inequality_constraints_sse"):
        np.testing.assert_allclose(
            getattr(mine.performance, f).numpy(), getattr(ref.performance, f), rtol=2e-2,
            atol=1e-8, err_msg=f)


def test_gains_and_value_function_match(case):
    """Held relative to their own scale (gains reach 1e3) and, element by
    element, within 5e-3 of the value: where the ceiling is active its slack
    is s ~ 8e-6 = 1.2 - x, so float32 rounding of x (1e-7) is a 1e-2 relative
    error of s, and the barrier curvature mu / s^2 (to 1.3e6 in value_S)
    carries twice that.  Observed: 2.1e-3 at one entry of 84."""
    _, _, mine, ref = case
    for f in ("gains", "value_S", "value_s"):
        b = getattr(ref, f)
        np.testing.assert_allclose(
            getattr(mine, f).numpy(), b, atol=2e-4 * max(1.0, float(np.abs(b).max())),
            rtol=5e-3, err_msg=f)


def test_al_state_matches(case):
    _, _, mine, ref = case
    for a, b in zip(mine.al, ref.al):
        assert tuple(a.shape) == b.shape
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-3, atol=1e-5)


def test_history_is_the_solution_s(case):
    """The port's iteration log (the JAX package keeps none): NaN beyond each
    scenario's iterations; its last row is the solution's mu and rho; the
    accepted steps lie in (0, 1]."""
    _, batch, mine, _ = case
    h = mine.history
    cols = h.mu.shape[1]
    ran = torch.arange(cols)[None, :] < mine.iterations[:, None]
    for f in h._fields:
        v = getattr(h, f)
        assert v.shape == (batch, cols)
        assert bool(torch.isnan(v[~ran]).all()) and bool(torch.isfinite(v[ran]).all()), f
    last = mine.iterations.long() - 1
    rows = torch.arange(batch)
    np.testing.assert_array_equal(h.mu[rows, last].numpy(), mine.ipm.mu.numpy())
    np.testing.assert_array_equal(h.rho[rows, last].numpy(), mine.al.rho.numpy())
    assert bool(((h.step_size[ran] >= 0) & (h.step_size[ran] <= 1)).all())


@pytest.mark.parametrize("kind", ["bounds", "ceiling", "both"])
def test_di_inequalities_are_active_and_held(kind):
    """Each fixture's inequality binds and the solution stays interior:
    slacks positive, duals non-negative, the constraint within 1e-3."""
    _, _, mine, _ = _run(f"di_{kind}_b3")
    assert bool(mine.converged.all())
    if kind in ("bounds", "both"):
        assert float(mine.us.abs().max()) <= CAP * (1 + 1e-3)
        assert float(mine.us.abs().max()) > CAP * 0.99
        assert float(mine.ipm.slack_ineq.min()) > 0 and float(mine.ipm.dual_ineq.min()) >= 0
    if kind == "ceiling":
        assert CEILING * 0.99 < float(mine.xs[..., 0].max()) <= CEILING * (1 + 1e-3)
    if kind == "both":
        assert V_FLOOR * 0.99 > float(mine.xs[..., 1].min()) >= V_FLOOR * (1 + 1e-3)
    if kind != "bounds":
        assert float(mine.ipm.slack_state_ineq.min()) > 0
        assert float(mine.ipm.dual_state_ineq.min()) >= 0
    else:
        assert mine.ipm.slack_state_ineq.shape == (3, DI_N + 1, 0)


@pytest.mark.parametrize("name", LEGGED_CASES)
def test_legged_solution_holds_the_foot_constraint_and_cone(name):
    """The projected foot constraint within 1e-3 at every node, the cone's
    slacks interior.  On flat ground from the weight-compensating guess the
    cone is inactive (the smallest stance slack is far from 0)."""
    _, _, mine, _ = _run(name)
    _, tgrid = _legged_grids("trot" if "trot" in name else "standing")
    g = tgrid.device("cpu")
    nodes = torch.arange(LEGGED_N)
    p = dict(interface.make_params(tgrid, device="cpu"), mode=g.modes[nodes], node=nodes)
    assert float(con.foot_constraint(g.times[:-1], mine.xs[:, :-1], mine.us, p).abs().max()) < 1e-3
    assert float(mine.ipm.slack_ineq.min()) > 0.5
    assert mine.ipm.slack_ineq.shape == (mine.xs.shape[0], LEGGED_N, 4)  # a row a leg


# -- the reference's zero-input fault (ROADMAP.md §3) --------------------------


def _zero_start_inputs():
    return np.array(jmodel.default_state(), np.float32), np.zeros((LEGGED_N, 24), np.float32)


@functools.lru_cache(maxsize=None)
def _zero_start():
    """The legged trot from the default state and zero inputs (the JAX
    package's Mpc cold start): zero contact forces put every stance slack at
    its floor, and the jump nodes' reduced Hessians become rank-deficient up
    to the 1e-6 regularization."""
    mine, x0 = _legged_solve("trot", *_zero_start_inputs())
    return mine, _as_batch(_recorded("legged_trot_zero_start", x0), 1)


def test_zero_input_stall_matches_the_reference():
    """Both packages accept the first step (a filter step of 1/64), reject
    every later one, freeze mu at 3.98e-3 and grow the AL penalty tenfold
    on each rejection: 4 iterations, not converged, rho 1e4."""
    mine, ref = _zero_start()
    assert int(ref.iterations[0]) == int(mine.iterations[0]) == 4
    assert not bool(ref.converged[0]) and not bool(mine.converged[0])
    step = mine.history.step_size[0].numpy()
    assert step[0] > 0 and (step[1:] == 0).all(), step
    np.testing.assert_allclose(mine.ipm.mu.numpy(), ref.ipm.mu, rtol=1e-6)
    np.testing.assert_allclose(mine.ipm.mu.numpy(), [0.01 ** 1.2], rtol=1e-5)
    np.testing.assert_allclose(mine.al.rho.numpy(), ref.al.rho)
    np.testing.assert_allclose(mine.history.rho[0].numpy(), [10.0, 100.0, 1e3, 1e4], rtol=1e-6)
    np.testing.assert_array_equal(mine.history.mu[0].numpy(), np.full(4, mine.ipm.mu[0].item()))


def test_zero_input_stall_merit_and_states_match_the_reference():
    """The merit (which climbs with rho) and the one accepted step's states
    agree.  The inputs are not held: that step solves a QP whose jump nodes
    carry eigenvalues of 1e-6 beside 49 (the cone's condensation at zero
    force, which no dt weighs), so float32 rounding moves its inputs by up to
    0.15 between the packages while the states and the merit stay within
    6e-5 and 3e-5 relative."""
    mine, ref = _zero_start()
    np.testing.assert_allclose(mine.performance.merit.numpy(), ref.performance.merit, rtol=1e-4)
    np.testing.assert_allclose(mine.performance.cost.numpy(), ref.performance.cost, rtol=1e-5)
    np.testing.assert_allclose(mine.xs.numpy(), ref.xs, atol=SOLVE_ATOL, rtol=SOLVE_RTOL)
    np.testing.assert_allclose(mine.ipm.slack_ineq.numpy(), ref.ipm.slack_ineq, atol=SOLVE_ATOL,
                               rtol=SOLVE_RTOL)
    merit = mine.history.merit[0].numpy()
    assert np.isfinite(merit).all() and (merit == merit[0]).all()  # no later step accepted


# -- behaviour of the batch-first loop ----------------------------------------


def _solve_di(kind, x0, **kw):
    st = ipm.IpmSettings(**dict(DI_SETTINGS, **kw.pop("settings", {})))
    return ipm.solve(torch_di_problem(kind), uniform_grid(0.0, 2.0, DI_N), x0,
                     di.make_params(device="cpu"), settings=st, device="cpu", **kw)


def test_frozen_scenario_equals_solving_it_alone():
    """Scenario 2 of the box fixture converges after 5 iterations while
    scenario 1 runs 14: it is frozen, and equals its own solve."""
    x0s = np.asarray(DI_X0["bounds"], np.float32)
    mixed = _solve_di("bounds", x0s)
    alone = _solve_di("bounds", x0s[2:3], force_plain_riccati=True)
    assert int(mixed.iterations[2]) == int(alone.iterations[0]) < int(mixed.iterations.max())
    for f in ("xs", "us", "gains", "value_S", "value_s"):
        np.testing.assert_allclose(getattr(mixed, f)[2].numpy(), getattr(alone, f)[0].numpy(),
                                   atol=1e-5, rtol=2e-5, err_msg=f)
    for f in ("slack_ineq", "dual_ineq", "mu"):
        np.testing.assert_allclose(getattr(mixed.ipm, f)[2].numpy(),
                                   getattr(alone.ipm, f)[0].numpy(), atol=1e-5, rtol=2e-5)
    np.testing.assert_array_equal(np.isnan(mixed.history.mu[2].numpy()),
                                  np.isnan(alone.history.mu[0].numpy()))


@pytest.mark.parametrize("kind", ["bounds", "ceiling", "both"])
def test_single_and_plain_riccati_routes_agree_at_batch_one(kind):
    """B = 1 takes the NaN-on-failure sweep, force_plain_riccati the clamped
    entry form; on these positive-definite problems they give the same
    solve."""
    x0 = np.asarray(DI_X0[kind], np.float32)[:1]
    a = _solve_di(kind, x0)
    b = _solve_di(kind, x0, force_plain_riccati=True)
    np.testing.assert_array_equal(a.iterations.numpy(), b.iterations.numpy())
    np.testing.assert_allclose(a.xs.numpy(), b.xs.numpy(), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(a.us.numpy(), b.us.numpy(), atol=1e-4, rtol=1e-5)


def test_force_single_riccati_refuses_a_batch():
    x0s = np.asarray(DI_X0["bounds"], np.float32)
    one = _solve_di("bounds", x0s[:1], force_single_riccati=True)
    np.testing.assert_array_equal(one.us.numpy(), _solve_di("bounds", x0s[:1]).us.numpy())
    with pytest.raises(ValueError, match="batch of one"):
        _solve_di("bounds", x0s, force_single_riccati=True)


def _jax_di_parallel_riccati():
    x0 = np.asarray(DI_X0["bounds"], np.float32)
    one = lambda x: jipm.solve(  # noqa: E731
        jax_di_problem("bounds"), juniform_grid(0.0, 2.0, DI_N), x, jdi.make_params(),
        settings=jipm.IpmSettings(**DI_SETTINGS, parallel_riccati=True))
    return dict(x0=x0, sol=jax.jit(jax.vmap(one))(jnp.asarray(x0)))


def test_parallel_riccati_matches_the_reference():
    """The box fixture's three scenarios with the associative-scan Riccati
    against ``jax.vmap`` of the JAX package's solve with it: iterations,
    ``xs`` / ``us`` (1e-3 + 1e-4 |value|) and mu as the cases above."""
    rec = RECORDS["di_bounds_b3_parallel_riccati"]
    x0s = np.asarray(DI_X0["bounds"], np.float32)
    np.testing.assert_array_equal(rec["x0"], x0s)  # the record solved these starts
    mine, ref = _solve_di("bounds", x0s, settings=dict(parallel_riccati=True)), rec["sol"]
    np.testing.assert_array_equal(mine.iterations.numpy(), ref.iterations)
    np.testing.assert_array_equal(mine.converged.numpy(), ref.converged)
    for field in ("xs", "us"):
        np.testing.assert_allclose(getattr(mine, field).numpy(), getattr(ref, field),
                                   atol=1e-3, rtol=1e-4, err_msg=field)


def test_zero_width_families_take_no_part():
    """An absent family has zero-width slacks: its fraction-to-boundary step
    is 1 for every scenario and it adds nothing to the barrier."""
    s = torch.zeros((2, 5, 0))
    np.testing.assert_array_equal(ipm._ftb_alpha(s, s, 0.995).numpy(), [1.0, 1.0])
    np.testing.assert_array_equal(ipm._ftb_alpha(s, None, 0.995).numpy(), [1.0, 1.0])
    vars_ = ipm.IpmVars(s, s, torch.zeros((2, 6, 0)), torch.zeros((2, 6, 0)),
                        torch.tensor([0.1, 0.2]))
    np.testing.assert_array_equal(ipm._barrier_term(vars_).numpy(), [0.0, 0.0])
    # Per scenario, not over the batch: scenario 1's tight step leaves 0's.
    s = torch.ones((2, 3, 2))
    ds = torch.zeros((2, 3, 2))
    ds[1, 2, 1] = -10.0
    np.testing.assert_allclose(ipm._ftb_alpha(s, ds, 0.995).numpy(), [1.0, 0.0995], rtol=1e-6)


MPC_LOOP = dict(settings=dict(time_horizon=1.0, num_intervals=DI_N, solver="ipm"),
                x0=(2.0, 0.0), loop=dict(duration=1.0, mrt_frequency=100.0, mpc_frequency=20.0))


def _jax_mpc_closed_loop():
    ref_mpc = jmpc.Mpc(jax_di_problem("bounds"), jdi.make_params(),
                       settings=jmpc.MpcSettings(**MPC_LOOP["settings"]))
    return jmrt.dummy_loop(jmrt.MpcMrtInterface(ref_mpc),
                           jnp.asarray(MPC_LOOP["x0"], jnp.float32), **MPC_LOOP["loop"])


JAX_RECORDS = dict(
    {name: functools.partial(jax_fn, kind, batch)
     for name, (_, jax_fn, kind, batch) in CASES.items()},
    legged_trot_zero_start=lambda: _jax_legged_solve_of("trot", *_zero_start_inputs()),
    mpc_closed_loop=_jax_mpc_closed_loop,
    di_bounds_b3_parallel_riccati=_jax_di_parallel_riccati,
)
RECORDS = Records(__file__)


def test_mpc_ipm_closed_loop_matches_the_reference():
    """``Mpc(solver="ipm")`` in ``dummy_loop`` against the JAX package's, on
    the bounded double integrator: 1 s at 100 Hz control and 20 Hz MPC, the
    box active over the first ticks."""
    mine_mpc = Mpc(torch_di_problem("bounds"), di.make_params(device="cpu"),
                   settings=MpcSettings(**MPC_LOOP["settings"]), device="cpu")
    assert isinstance(mine_mpc.solver_settings, ipm.IpmSettings)
    x0 = np.array(MPC_LOOP["x0"], np.float32)
    ts_r, xs_r, us_r = RECORDS["mpc_closed_loop"]
    ts, xs, us = dummy_loop(MpcMrtInterface(mine_mpc), torch.as_tensor(x0), **MPC_LOOP["loop"])
    assert xs.shape == xs_r.shape == (101, 2) and mine_mpc.solve_timer.count == 20
    np.testing.assert_allclose(xs.numpy(), xs_r, atol=SOLVE_ATOL, rtol=SOLVE_RTOL)
    np.testing.assert_allclose(us.numpy(), us_r, atol=SOLVE_ATOL, rtol=SOLVE_RTOL)
    assert float(us.abs().max()) <= CAP * (1 + 1e-3) and float(us.abs().max()) > 0.99 * CAP
    assert isinstance(mine_mpc.last_solution, ipm.IpmSolution)
