"""The MPC runtime's supporting modules of the port vs the JAX package on the
CPU: controllers, initializers, trajectory spreading, the value-function and
Hamiltonian queries, the ``Solver`` facade, the gait additions (gait
adaptation / early touchdown, ``GaitSequenceSchedule``, ``GaitReceiver``),
and the port's copies of the policy serialization and of the native store
and rate loop.

Inputs come from a numpy seed; pure functions agree within rtol 2e-4 /
atol 1e-5, solves (equal iteration counts) within 1e-3 + 1e-4 |value|, host
data (mode schedules, event matching) exactly.
"""
import functools
import os
import threading
import uuid

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ocs2_tpu.core import controllers as jcontrollers
from ocs2_tpu.core.reference import ModeSchedule as JModeSchedule
from ocs2_tpu.models import double_integrator as jdi
from ocs2_tpu.models.legged_robot import gait as jgait
from ocs2_tpu.oc import initialization as jinit
from ocs2_tpu.oc import queries as jqueries
from ocs2_tpu.oc import spreading as jspreading
from ocs2_tpu.oc.time_discretization import uniform_grid as juniform_grid
from ocs2_tpu.runtime import serialization as jser
from ocs2_tpu.solvers import sqp as jsqp
from ocs2_tpu.solvers.api import Solver as JSolver

from ocs2_tpu_torch import convert
from ocs2_tpu_torch.core import controllers
from ocs2_tpu_torch.core.reference import ModeSchedule
from ocs2_tpu_torch.models import double_integrator as di
from ocs2_tpu_torch.models.legged_robot import gait
from ocs2_tpu_torch.oc import initialization, queries, spreading
from ocs2_tpu_torch.oc.time_discretization import uniform_grid
from ocs2_tpu_torch.runtime import native, serialization
from ocs2_tpu_torch.solvers import sqp
from ocs2_tpu_torch.solvers.api import Solver
from ocs2_tpu_torch.utils.timers import RepeatedTimer

torch.set_num_threads(1)  # one intra-op thread a test process: the suite runs in several
# processes at once (pytest-xdist), and these small tensors gain nothing from more.

RTOL, ATOL = 2e-4, 1e-5
SOLVE_ATOL, SOLVE_RTOL = 1e-3, 1e-4


def close(mine, ref, rtol=RTOL, atol=ATOL):
    mine = mine.detach().cpu().numpy() if isinstance(mine, torch.Tensor) else np.asarray(mine)
    np.testing.assert_allclose(mine, np.asarray(ref), rtol=rtol, atol=atol)


def t32(a):
    return torch.as_tensor(np.asarray(a, np.float32))


# -- controllers ------------------------------------------------------------

def _controller_data(seed=0, n=7, nu=2, nx=3):
    rng = np.random.default_rng(seed)
    times = np.sort(rng.uniform(0.0, 1.0, n)).astype(np.float32)
    return dict(
        times=times,
        uff=rng.standard_normal((n, nu)).astype(np.float32),
        gains=rng.standard_normal((n, nu, nx)).astype(np.float32),
        x_nom=rng.standard_normal((n, nx)).astype(np.float32),
    )


@pytest.mark.parametrize("t", [-0.1, 0.0, 0.37, 0.99, 1.3])
def test_linear_controller_matches(t):
    data = _controller_data()
    x = np.random.default_rng(1).standard_normal(3).astype(np.float32)
    ref = jcontrollers.LinearController(**{k: jnp.asarray(v) for k, v in data.items()})(
        jnp.float32(t), jnp.asarray(x))
    mine = convert.linear_controller_from_numpy(data, device="cpu")(
        torch.tensor(t, dtype=torch.float32), t32(x))
    close(mine, ref)


def test_linear_controller_batch_polymorphic_in_x():
    data = _controller_data(seed=2)
    xs = np.random.default_rng(3).standard_normal((5, 3)).astype(np.float32)
    ts = np.linspace(0.0, 1.0, 5).astype(np.float32)
    ctrl = jcontrollers.LinearController(**{k: jnp.asarray(v) for k, v in data.items()})
    ref = jax.vmap(ctrl)(jnp.asarray(ts), jnp.asarray(xs))
    mine_ctrl = convert.linear_controller_from_numpy(data, device="cpu")
    close(mine_ctrl(t32(ts), t32(xs)), ref)
    # One query time for a batch of states.
    ref_one = jax.vmap(lambda x: ctrl(jnp.float32(0.4), x))(jnp.asarray(xs))
    close(mine_ctrl(torch.tensor(0.4), t32(xs)), ref_one)


def test_feedforward_and_zero_controller():
    data = _controller_data(seed=4)
    ff = jcontrollers.FeedforwardController(jnp.asarray(data["times"]), jnp.asarray(data["uff"]))
    mine = controllers.FeedforwardController(t32(data["times"]), t32(data["uff"]))
    close(mine(torch.tensor(0.5), torch.zeros(3)), ff(jnp.float32(0.5), jnp.zeros(3)))
    z = controllers.zero_controller(t32(data["times"]), 2, 3)
    assert z.gains.shape == (7, 2, 3) and float(z(torch.tensor(0.2), torch.ones(3)).abs().max()) == 0.0


def test_interpolate_batch_of_one_sample_matches():
    """A trajectory of one sample gives that sample at every query time,
    [M, ...] as the JAX package's vmapped interpolation does (the port once
    returned the bare sample, [...])."""
    from ocs2_tpu.core.interpolation import interpolate_batch as jinterpolate_batch

    from ocs2_tpu_torch.core.interpolation import interpolate_batch

    values = np.arange(6, dtype=np.float32).reshape(1, 2, 3)
    ts = np.array([0.0, 0.5, 2.0], np.float32)
    ref = jinterpolate_batch(jnp.zeros(1), jnp.asarray(values), jnp.asarray(ts))
    mine = interpolate_batch(torch.zeros(1), t32(values), t32(ts))
    assert mine.shape == ref.shape == (3, 2, 3)
    close(mine, ref)


# -- initialization ---------------------------------------------------------

def test_default_initializer_matches():
    x0 = np.array([0.3, -0.2], np.float32)
    xs_r, us_r = jinit.DefaultInitializer()(juniform_grid(0.0, 1.0, 6), jnp.asarray(x0), 1)
    xs, us = initialization.DefaultInitializer()(uniform_grid(0.0, 1.0, 6), t32(x0), 1)
    close(xs, xs_r)
    close(us, us_r)


def test_operating_points_match():
    rng = np.random.default_rng(5)
    times = np.array([0.0, 0.4, 1.0], np.float32)
    states = rng.standard_normal((3, 2)).astype(np.float32)
    inputs = rng.standard_normal((3, 1)).astype(np.float32)
    x0 = np.array([1.0, 2.0], np.float32)
    ref = jinit.OperatingPoints(times, states, inputs)(juniform_grid(0.0, 1.0, 8), jnp.asarray(x0), 1)
    mine = initialization.OperatingPoints(times, states, inputs, device="cpu")(
        uniform_grid(0.0, 1.0, 8), t32(x0), 1)
    close(mine[0], ref[0])
    close(mine[1], ref[1])
    const = initialization.OperatingPoints.constant(states[0], inputs[0], device="cpu")
    xs, us = const(uniform_grid(0.0, 1.0, 4), t32(x0), 1)
    close(xs[1:], np.tile(states[0], (4, 1)))
    close(xs[0], x0)
    wrapped = initialization.CustomInitializer(lambda g, x, nu: ("xs", "us"))
    assert wrapped(None, None, 1) == ("xs", "us")


# -- spreading --------------------------------------------------------------

def _ms(events, modes, capacity=8):
    return (ModeSchedule.create(events, modes, capacity=capacity),
            JModeSchedule.create(np.asarray(events, np.float32), modes, capacity=capacity))


# (old schedule, new schedule): the new one gains an event, loses one,
# shifts one, and changes the leading mode.
SPREAD_CASES = {
    "gains_event": (([0.35, 0.7], [9, 6, 9]), ([0.35, 0.7, 1.05], [9, 6, 9, 6])),
    "loses_event": (([0.35, 0.7, 1.05], [9, 6, 9, 6]), ([0.7, 1.05], [6, 9, 6])),
    "shifts_event": (([0.35, 0.7], [9, 6, 9]), ([0.38, 0.71], [9, 6, 9])),
    "no_common_mode": (([0.5], [15, 9]), ([0.5], [6, 3])),
}


@pytest.mark.parametrize("case", list(SPREAD_CASES))
def test_match_event_times_matches(case):
    (old_e, old_m), (new_e, new_m) = SPREAD_CASES[case]
    old, old_j = _ms(old_e, old_m)
    new, new_j = _ms(new_e, new_m)
    for lo, hi in ((0.0, 1.0), (0.06, 1.06), (0.4, 1.4)):
        a = spreading.match_event_times(old, new, lo, hi)
        b = jspreading.match_event_times(old_j, new_j, lo, hi)
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])
    assert spreading.mode_schedules_differ(old, new) == jspreading.mode_schedules_differ(old_j, new_j)


@pytest.mark.parametrize("case", list(SPREAD_CASES))
def test_spread_trajectories_matches(case):
    (old_e, old_m), (new_e, new_m) = SPREAD_CASES[case]
    old, old_j = _ms(old_e, old_m)
    new, new_j = _ms(new_e, new_m)
    rng = np.random.default_rng(6)
    prev_times = np.sort(np.concatenate([[0.0, 1.0], rng.uniform(0, 1, 14)])).astype(np.float32)
    prev_xs = rng.standard_normal((16, 3)).astype(np.float32)
    prev_us = rng.standard_normal((15, 2)).astype(np.float32)
    new_times = np.linspace(0.06, 1.06, 12).astype(np.float32)
    ref = jspreading.spread_trajectories(
        jnp.asarray(prev_times), jnp.asarray(prev_xs), jnp.asarray(prev_us), old_j, new_j,
        new_times)
    mine = spreading.spread_trajectories(
        t32(prev_times), t32(prev_xs), t32(prev_us), old, new, new_times)
    close(mine[0], ref[0])
    close(mine[1], ref[1])
    # The new times as a tensor give the same.
    again = spreading.spread_trajectories(
        t32(prev_times), t32(prev_xs), t32(prev_us), old, new, t32(new_times))
    close(again[0], ref[0])


def test_warp_times_matches():
    q = np.linspace(0.0, 1.0, 21).astype(np.float32)
    for a_new, a_old in (([], []), ([0.3], [0.35]), ([0.2, 0.5, 0.8], [0.25, 0.5, 0.9])):
        a_new, a_old = np.asarray(a_new), np.asarray(a_old)
        close(spreading.warp_times(t32(q), a_new, a_old),
              jspreading.warp_times(jnp.asarray(q), a_new, a_old))


# -- queries and the Solver facade -----------------------------------------

@functools.lru_cache(maxsize=None)
def _di_solutions():
    """The double integrator solved by SQP in both packages (the value
    function and the Hamiltonian read the solution)."""
    x0 = np.array([1.0, 0.0], np.float32)
    st = dict(max_iterations=15, integrator="rk2")
    ref = jax.jit(lambda x: jsqp.solve(
        jdi.make_problem(), juniform_grid(0.0, 2.0, 20), x, jdi.make_params(),
        settings=jsqp.SqpSettings(**st)))(jnp.asarray(x0))
    mine = sqp.solve(di.make_problem(device="cpu"), uniform_grid(0.0, 2.0, 20), x0,
                     di.make_params(device="cpu"), settings=sqp.SqpSettings(**st), device="cpu")
    return jax.tree.map(np.asarray, ref), mine


def _query_args(mine_or_ref, port):
    sol = mine_or_ref
    if port:
        return (uniform_grid(0.0, 2.0, 20), sol.xs[0], sol.value_S[0], sol.value_s[0])
    return (juniform_grid(0.0, 2.0, 20), jnp.asarray(sol.xs), jnp.asarray(sol.value_S),
            jnp.asarray(sol.value_s))


def test_solutions_for_queries_match():
    ref, mine = _di_solutions()
    assert int(mine.iterations[0]) == int(ref.iterations)
    close(mine.xs[0], ref.xs, SOLVE_RTOL, SOLVE_ATOL)
    close(mine.value_S[0], ref.value_S, 1e-3, 1e-3)


@pytest.mark.parametrize("t", [0.0, 0.45, 0.9, 1.95])
def test_value_function_matches(t):
    ref, mine = _di_solutions()
    dx = np.array([0.1, -0.05], np.float32)
    # Query at the JAX solution's nominal state plus dx on both sides.
    x = np.interp(t, np.asarray(juniform_grid(0.0, 2.0, 20).times), ref.xs[:, 0])
    x = np.array([x, np.interp(t, np.asarray(juniform_grid(0.0, 2.0, 20).times), ref.xs[:, 1])],
                 np.float32) + dx
    vr = jqueries.value_function(*_query_args(ref, False), jnp.float32(t), jnp.asarray(x))
    vm = queries.value_function(*_query_args(mine, True), torch.tensor(t), t32(x))
    for a, b in zip(vm, vr):
        close(a, b, 1e-3, 1e-3)


@pytest.mark.parametrize("quadratic", [False, True])
def test_hamiltonian_matches(quadratic):
    ref, mine = _di_solutions()
    t = np.float32(0.8)
    x = np.array([0.4, -0.3], np.float32)
    u = np.array([0.2], np.float32)
    fr = jqueries.hamiltonian_approx if quadratic else jqueries.hamiltonian
    fm = queries.hamiltonian_approx if quadratic else queries.hamiltonian
    hr = fr(jdi.make_problem(), *_query_args(ref, False), jnp.asarray(t), jnp.asarray(x),
            jnp.asarray(u), jdi.make_params())
    hm = fm(di.make_problem(device="cpu"), *_query_args(mine, True), torch.tensor(t), t32(x),
            t32(u), di.make_params(device="cpu"))
    if quadratic:
        for a, b in zip(hm, hr):
            close(a, b, 1e-3, 1e-3)
    else:
        close(hm, hr, 1e-3, 1e-3)


def test_hamiltonian_gradient_is_autograd_of_hamiltonian():
    _, mine = _di_solutions()
    args = _query_args(mine, True)
    problem, params = di.make_problem(device="cpu"), di.make_params(device="cpu")
    x = torch.tensor([0.4, -0.3])
    u = torch.tensor([0.2])
    hq = queries.hamiltonian_approx(problem, *args, torch.tensor(0.8), x, u, params)
    eps = 1e-2
    for i in range(2):
        e = torch.zeros(2)
        e[i] = eps
        hp = queries.hamiltonian(problem, *args, torch.tensor(0.8), x + e, u, params)
        hm = queries.hamiltonian(problem, *args, torch.tensor(0.8), x - e, u, params)
        assert abs(float((hp - hm) / (2 * eps)) - float(hq.dfdx[i])) < 2e-2


@pytest.mark.parametrize("algorithm", ["sqp", "ilqr"])
def test_solver_facade_matches(algorithm):
    grid_args = (0.0, 2.0, 25)
    x0 = np.array([1.0, 0.0], np.float32)
    jsolver = JSolver(jdi.make_problem(), algorithm=algorithm)
    ref = jax.tree.map(np.asarray, jsolver.run(juniform_grid(*grid_args), jnp.asarray(x0),
                                               jdi.make_params()))
    solver = Solver(di.make_problem(device="cpu"), algorithm=algorithm, device="cpu")
    mine = solver.run(uniform_grid(*grid_args), x0, di.make_params(device="cpu"))
    assert int(mine.iterations[0]) == int(ref.iterations)
    close(mine.xs[0], ref.xs, SOLVE_RTOL, SOLVE_ATOL)
    close(mine.us[0], ref.us, SOLVE_RTOL, SOLVE_ATOL)
    times, xs, us, gains = solver.primal_solution()
    assert xs.shape == (1, 26, 2) and us.shape == (1, 25, 1) and gains.shape == (1, 25, 1, 2)
    assert float(solver.performance_indices().cost[0]) >= 0.0
    t8 = torch.tensor(float(times[8]))
    v = solver.get_value_function(t8, mine.xs[0, 8])
    assert abs(float(v.f)) < 1e-4
    h_opt = solver.get_hamiltonian(t8, mine.xs[0, 8], mine.us[0, 8])
    h_off = solver.get_hamiltonian(t8, mine.xs[0, 8], mine.us[0, 8] + 1.0)
    assert float(h_off) > float(h_opt)
    assert solver.get_hamiltonian(t8, mine.xs[0, 8], mine.us[0, 8], quadratic=True).dfduu.shape == (1, 1)


@pytest.mark.parametrize("algorithm", ["slq"])
def test_solver_facade_later_algorithms_raise(algorithm):
    """Named when ``Solver("slq")`` raised in the port; it now solves: the
    unconstrained double integrator to the SQP facade's inputs within 5e-2
    (SLQ's sweep integrates the Riccati ODE where SQP's recursion runs on the
    discretized transitions: at dt = 0.08 the two policies differ by 2.2e-2),
    with a finite value function; ``tests/test_torch_slq.py`` holds it to the
    JAX package's ``Solver("slq")``."""
    grid, x0 = uniform_grid(0.0, 2.0, 25), np.array([1.0, 0.0], np.float32)
    ref = Solver(di.make_problem(device="cpu"), algorithm="sqp", device="cpu").run(
        grid, x0, di.make_params(device="cpu"))
    solver = Solver(di.make_problem(device="cpu"), algorithm=algorithm, device="cpu")
    sol = solver.run(grid, x0, di.make_params(device="cpu"))
    assert solver.settings.algorithm == "slq" and bool(sol.converged[0])
    close(sol.us[0], ref.us[0], 0.0, 5e-2)
    v = solver.get_value_function(torch.tensor(float(grid.times[8])), sol.xs[0, 8])
    assert bool(torch.isfinite(v.f).all())


@pytest.mark.parametrize("algorithm", ["ipm", "slp"])
def test_solver_facade_ipm_and_slp_solve(algorithm):
    """``Solver("ipm" | "slp")`` solves the unconstrained double integrator
    to the SQP facade's inputs (IPM to 1e-3, SLP to tests/test_pipg.py's
    5e-2); IPM's value function is the Riccati one, SLP's is NaN (PIPG
    computes none)."""
    grid, x0 = uniform_grid(0.0, 2.0, 25), np.array([1.0, 0.0], np.float32)
    ref = Solver(di.make_problem(device="cpu"), algorithm="sqp", device="cpu").run(
        grid, x0, di.make_params(device="cpu"))
    solver = Solver(di.make_problem(device="cpu"), algorithm=algorithm, device="cpu")
    sol = solver.run(grid, x0, di.make_params(device="cpu"))
    close(sol.us[0], ref.us[0], 0.0, 1e-3 if algorithm == "ipm" else 5e-2)
    times, xs, us, gains = solver.primal_solution()
    assert xs.shape == (1, 26, 2) and gains.shape == (1, 25, 1, 2)
    v = solver.get_value_function(torch.tensor(float(times[8])), sol.xs[0, 8])
    assert bool(torch.isnan(v.f).any()) == (algorithm == "slp")


def test_solver_facade_unknown_algorithm():
    with pytest.raises(ValueError):
        Solver(di.make_problem(device="cpu"), algorithm="nope", device="cpu")


def test_solver_facade_uses_initializer():
    seen = []

    def init(grid, x0, nu):
        seen.append(True)
        return initialization.DefaultInitializer()(grid, x0, nu)

    solver = Solver(di.make_problem(device="cpu"), settings=sqp.SqpSettings(max_iterations=2),
                    initializer=initialization.CustomInitializer(init), device="cpu")
    solver.run(uniform_grid(0.0, 1.0, 5), np.array([1.0, 0.0], np.float32),
               di.make_params(device="cpu"))
    assert seen


# -- gait additions ---------------------------------------------------------

def _both(fn_name, *args):
    return getattr(gait, fn_name)(*args), getattr(jgait, fn_name)(*args)


def _trot_schedules(t0=0.0, tf=1.4):
    return (gait.GaitSchedule(gait.trot_gait(0.7)).mode_schedule(t0, tf),
            jgait.GaitSchedule(jgait.trot_gait(0.7)).mode_schedule(t0, tf))


def assert_same_schedule(mine, ref):
    np.testing.assert_array_equal(np.asarray(mine.event_times), np.asarray(ref.event_times))
    np.testing.assert_array_equal(np.asarray(mine.mode_sequence), np.asarray(ref.mode_sequence))
    assert int(mine.num_events) == int(ref.num_events)


@pytest.mark.parametrize("t", [0.0, 0.05, 0.36, 0.69, 1.2])
def test_time_until_next_touchdown_matches(t):
    ms, ms_j = _trot_schedules()
    for leg in range(4):
        assert gait.time_until_next_touchdown(ms, t, leg) == jgait.time_until_next_touchdown(
            ms_j, t, leg)


@pytest.mark.parametrize("early", [[1, 0, 0, 0], [0, 1, 1, 0], [1, 1, 1, 1]])
def test_apply_early_touchdown_matches(early):
    ms, ms_j = _trot_schedules()
    for t in (0.05, 0.4):
        assert_same_schedule(gait.apply_early_touchdown(ms, t, early),
                             jgait.apply_early_touchdown(ms_j, t, early))


@pytest.mark.parametrize("window", [0.05, 0.1])
def test_gait_adaptation_matches(window):
    ms, ms_j = _trot_schedules()
    mine = gait.GaitAdaptation(gait.GaitAdaptationSettings(early_touchdown_window=window))
    ref = jgait.GaitAdaptation(jgait.GaitAdaptationSettings(early_touchdown_window=window))
    rng = np.random.default_rng(7)
    adapted = 0
    for t in np.arange(0.0, 1.4, 0.02):
        measured = rng.random(4) < 0.5
        a, b = mine.advance(ms, measured, float(t)), ref.advance(ms_j, measured, float(t))
        assert_same_schedule(a, b)
        adapted += int(np.any(np.asarray(a.mode_sequence) != np.asarray(ms.mode_sequence)))
    assert adapted > 0


def _script(schedule_cls, g, receiver_cls=None):
    """A scripted run of gait commands; the mode schedules it produces."""
    sched = schedule_cls(0.0, g.trot_gait(0.7))
    out = [sched.mode_schedule(0.0, 1.0)]
    sched.advance_to_time(0.2)
    sched.set_next_gait(g.static_walk_gait(1.2))
    out.append(sched.mode_schedule(0.2, 1.2))
    sched.set_gait_at_time(g.pace_gait(0.6), 1.5)
    out.append(sched.mode_schedule(0.9, 2.4))
    sched.set_gait_after_time(g.stance_gait(), 2.0)
    out.append(sched.mode_schedule(1.0, 3.0))
    sched.advance_to_time(2.5)
    out.append(sched.mode_schedule(2.5, 4.0))
    out.append((sched.current_phase(2.6), sched.time_left_in_gait(2.6),
                g.is_standing(sched, 0.5), sched.current_gait().mode_sequence))
    if receiver_cls is not None:
        rcv = receiver_cls(sched)
        rcv.command_gait("trot")
        rcv.command_gait_sequence(["pace", g.static_walk_gait(1.2)], at_time=3.3)
        rcv.pre_solver_run(2.7, 3.7, None)
        out.append(sched.mode_schedule(2.7, 4.7))
        rcv.command_gait("pace", at_time=4.0)
        rcv.command_gait_sequence(["trot"])
        rcv.pre_solver_run(3.0, 4.0, None)
        out.append(sched.mode_schedule(3.0, 5.0))
    return out


@pytest.mark.parametrize("with_receiver", [False, True])
def test_gait_sequence_schedule_and_receiver_match(with_receiver):
    mine = _script(gait.GaitSequenceSchedule, gait, gait.GaitReceiver if with_receiver else None)
    ref = _script(jgait.GaitSequenceSchedule, jgait,
                  jgait.GaitReceiver if with_receiver else None)
    assert len(mine) == len(ref)
    for a, b in zip(mine, ref):
        if isinstance(a, tuple):
            for p, q in zip(a, b):
                np.testing.assert_array_equal(p, q)
        else:
            assert_same_schedule(a, b)


def test_is_standing_on_stance():
    sched = gait.GaitSequenceSchedule(0.0, gait.stance_gait())
    assert gait.is_standing(sched, 1.0)
    sched.set_next_gait(gait.trot_gait(0.7))
    assert not gait.is_standing(sched, 3.0)


# -- serialization, native store, rate loop, timer ---------------------------

def test_serialization_roundtrip_and_parity():
    arrays = {
        "times": np.linspace(0, 1, 11).astype(np.float32),
        "xs": np.random.default_rng(0).normal(size=(11, 4)).astype(np.float32),
        "gains": np.zeros((10, 2, 4), np.float32),
        "modes": np.array([0, 1, 1], np.int32),
        "count": np.array(3, np.int64),
    }
    blob = serialization.flatten_policy(arrays)
    assert blob == jser.flatten_policy(arrays)
    out = serialization.unflatten_policy(blob)
    assert set(out) == set(arrays)
    for k in arrays:
        np.testing.assert_array_equal(out[k], arrays[k])
        assert out[k].dtype == arrays[k].dtype


def test_linear_policy_packer_of_a_port_policy():
    data = _controller_data(seed=8)
    ctrl = convert.linear_controller_from_numpy(data, device="cpu")
    leaves = dict(times=ctrl.times.numpy(), xs=ctrl.x_nom.numpy(), us=ctrl.uff.numpy(),
                  gains=ctrl.gains.numpy(), modes=np.arange(7))
    blob = serialization.flatten_linear_policy(**leaves)
    assert blob == jser.flatten_linear_policy(**leaves)
    out = serialization.unflatten_policy(blob)
    assert out["gains"].shape == (7, 2, 3) and out["modes"].dtype == np.int32


def test_policy_store_write_read_only_new():
    s = native.PolicyStore(1 << 12)
    assert s.read() is None
    s.write(b"abc")
    assert s.read() == b"abc"
    assert s.read() is None
    s.write(b"def")
    assert s.read() == b"def"
    with pytest.raises(ValueError):
        s.write(b"x" * (1 << 13))
    s.close()


def test_policy_store_shared_memory_carries_a_policy():
    # A name of this process's own: two test runs on one host never share it.
    name = f"/ocs2rt_torch_pytest_{os.getpid()}_{uuid.uuid4().hex[:8]}"
    w = native.PolicyStore(1 << 14, name=name, create=True)
    r = None
    try:
        r = native.PolicyStore(16, name=name, create=False)
        assert r.capacity == 1 << 14
        data = _controller_data(seed=9)
        w.write(serialization.flatten_policy(data))
        got = serialization.unflatten_policy(r.read())
        ctrl = convert.linear_controller_from_numpy(got, device="cpu")
        close(ctrl(torch.tensor(0.5), torch.zeros(3)),
              convert.linear_controller_from_numpy(data, device="cpu")(
                  torch.tensor(0.5), torch.zeros(3)))
    finally:
        if r is not None:
            r.close()
        w.close(unlink=True)


def test_policy_store_no_torn_reads_under_concurrency():
    s = native.PolicyStore(1 << 12)
    stop = threading.Event()

    def writer():
        i = 0
        while not stop.is_set():
            s.write(np.full(128, i % 251, np.float64).tobytes())
            i += 1

    t = threading.Thread(target=writer)
    t.start()
    torn = 0
    try:
        for _ in range(3000):
            blob = s.read(only_new=False)
            if blob:
                a = np.frombuffer(blob, np.float64)
                torn += int(not np.all(a == a[0]))
    finally:
        stop.set()
        t.join(timeout=10)
    assert not t.is_alive()
    s.close()
    assert torn == 0


def test_rate_loop_and_clock():
    loop = native.RateLoop(500.0)
    t0 = native.monotonic_time()
    for _ in range(25):
        loop.wait()
    elapsed = native.monotonic_time() - t0
    assert 0.045 <= elapsed < 0.5
    assert loop.ticks == 25 and loop.missed >= 0
    assert isinstance(native.set_realtime_priority(1), bool)


def test_native_library_builds_beside_the_reference_copy():
    native.load_library()
    assert native.LIB_PATH.exists()
    assert native.LIB_PATH.parent.parent == native.NATIVE_DIR / "build"


def test_repeated_timer():
    timer = RepeatedTimer()
    assert timer.summary("x") == "x: no samples"
    timer.record(0.002)
    timer.start()
    dt = timer.stop()
    assert timer.count == 2 and timer.last == dt and timer.min <= 0.002 <= timer.max
    assert abs(timer.average - (0.002 + dt) / 2) < 1e-12


def test_new_entry_points_default_to_the_card():
    import inspect

    from ocs2_tpu_torch.models import quadrotor
    from ocs2_tpu_torch.models.legged_robot import interface
    from ocs2_tpu_torch.mpc.mpc import Mpc

    fns = [
        Mpc.__init__, interface.SwitchedModelReferenceManager.__init__, di.make_problem,
        di.make_params, quadrotor.make_problem, quadrotor.make_params, quadrotor.hover_input,
        initialization.OperatingPoints.__init__, initialization.OperatingPoints.constant,
        Solver.__init__, convert.linear_controller_from_numpy, convert.mpc_policy_from_numpy,
    ]
    for fn in fns:
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn
