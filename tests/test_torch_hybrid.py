"""The hybrid path of the port vs the JAX package, on the CPU: the adaptive
integrator family, the event grid built from event tensors, the
state-triggered rollout, the state-triggered hybrid DDP, the switch-time
gradients and their upper-level loop, and the CARE.

Fixtures are the JAX tests' own (tests/test_integrate.py,
tests/test_hybrid_ddp.py, tests/test_hybrid.py), written again with torch
ops; inputs are the same numbers on both sides.  Tolerances are stated at
each test: pure functions 1e-5 or tighter; event times 1e-5 (24 bisection
halvings of a step of 0.0125 s resolve 7e-10 s, float32 time 6e-8); solves
with ties at a stationary iterate decided by the last float32 bit held to
their merit (1e-5 relative) and their states and inputs to 1e-3.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ocs2_tpu.core import integrate as jintegrate
from ocs2_tpu.core.reference import TargetTrajectories as JTarget
from ocs2_tpu.oc import hybrid_rollout as jhr
from ocs2_tpu.oc.problem import OptimalControlProblem as JProblem
from ocs2_tpu.oc.problem import quadratic_cost as jquadratic_cost
from ocs2_tpu.oc.time_discretization import make_event_grid_traced as jmake_event_grid
from ocs2_tpu.oc.time_discretization import make_time_grid as jmake_time_grid
from ocs2_tpu.ops import care as jcare
from ocs2_tpu.solvers import ddp as jddp
from ocs2_tpu.solvers import sqp as jsqp
from ocs2_tpu.solvers import switch_time as jswitch
from ocs2_tpu.solvers.hybrid_ddp import solve_state_triggered as jsolve_state_triggered

from ocs2_tpu_torch.core import integrate
from ocs2_tpu_torch.core.reference import TargetTrajectories
from ocs2_tpu_torch.oc.hybrid_rollout import HybridSystem, rollout_state_triggered
from ocs2_tpu_torch.oc.problem import OptimalControlProblem, quadratic_cost
from ocs2_tpu_torch.oc.time_discretization import make_event_grid_traced, make_time_grid
from ocs2_tpu_torch.ops import care
from ocs2_tpu_torch.solvers import ddp, sqp, switch_time
from ocs2_tpu_torch.solvers.hybrid_ddp import _detect_events, solve_state_triggered

torch.set_num_threads(1)  # one intra-op thread a test process: the suite runs in several
# processes at once (pytest-xdist), and these small tensors gain nothing from more.

T = lambda v: torch.as_tensor(np.asarray(v, np.float32))  # noqa: E731
G = 9.81


def close(mine, ref, rtol, atol, err_msg=""):
    mine = mine.detach().cpu().numpy() if isinstance(mine, torch.Tensor) else np.asarray(mine)
    np.testing.assert_allclose(mine, np.asarray(ref), rtol=rtol, atol=atol, err_msg=err_msg)


# -- the integrators (tests/test_integrate.py's cases) ----------------------------

def _oscillator(lib, omega=12.0):
    def f(t, x, u):
        return lib.stack([x[..., 1], -omega * omega * x[..., 0]], -1) + u
    return f


def _pendulum3(lib):
    def f(t, x, u):
        return lib.stack([x[..., 1], -lib.sin(x[..., 0]) + u[..., 0], 0.1 * x[..., 0] * x[..., 1]], -1)
    return f


@pytest.mark.parametrize("case", ["decay", "oscillator", "forced"])
def test_integrate_adaptive_matches_jax(case):
    """Exact to 1e-6 relative: the same accepted steps in the same order."""
    if case == "decay":
        fj, ft, x0, u, dt, tol = (lambda t, x, u: -2.0 * x), (lambda t, x, u: -2.0 * x), [1.0], [0.0], 1.0, {}
    elif case == "oscillator":
        fj, ft, x0, u, dt = _oscillator(jnp), _oscillator(torch), [1.0, 0.0], [0.0, 0.0], 0.5
        tol = dict(rtol=1e-6, atol=1e-9)
    else:
        fj, ft, x0, u, dt, tol = (lambda t, x, u: -x + u), (lambda t, x, u: -x + u), [1.0], [0.5], 0.7, {}
    ref = jintegrate.integrate_adaptive(fj, 0.0, jnp.asarray(x0, jnp.float32),
                                        jnp.asarray(u, jnp.float32), dt, **tol)
    mine = integrate.integrate_adaptive(ft, 0.0, T(x0), T(u), dt, **tol)
    close(mine, ref, 1e-5, 1e-6)


def test_integrate_adaptive_beats_one_rk4_step_and_runs_out_like_jax():
    """The oscillator's interval: the adaptive result is 50x closer to the
    exact solution than one RK4 step; with max_steps 3 both packages finish
    with the same conservative tail."""
    omega, dt = 12.0, 0.5
    exact = np.array([np.cos(omega * dt), -omega * np.sin(omega * dt)])
    x_ad = integrate.integrate_adaptive(_oscillator(torch), 0.0, T([1.0, 0.0]), T([0.0, 0.0]), dt,
                                        rtol=1e-6, atol=1e-9)
    x_rk4 = integrate.discretize(_oscillator(torch), "rk4")(0.0, T([1.0, 0.0]), T([0.0, 0.0]), dt)
    err_ad = float(np.abs(x_ad.numpy() - exact).max())
    assert err_ad < np.abs(x_rk4.numpy() - exact).max() / 50.0
    short = integrate.integrate_adaptive(_oscillator(torch), 0.0, T([1.0, 0.0]), T([0.0, 0.0]),
                                         dt, max_steps=3)
    ref = jintegrate.integrate_adaptive(_oscillator(jnp), 0.0, jnp.array([1.0, 0.0]),
                                        jnp.zeros(2), dt, max_steps=3)
    close(short, ref, 1e-5, 1e-6)


def test_ode45_step_is_differentiable_and_maps():
    """``discretize("ode45")`` under ``jacfwd`` and ``vmap``: the Jacobian of
    x' = -x + u over 0.7 s is exp(-0.7) (the JAX test's 1e-3), and a mapped
    batch equals each sample alone."""
    step = integrate.discretize(lambda t, x, u: -x + u, "ode45")
    jac = torch.func.jacfwd(lambda x: step(0.0, x, T([0.5]), 0.7))(T([1.0]))
    assert abs(float(jac[0, 0]) - np.exp(-0.7)) < 1e-3
    jref = jax.jacfwd(lambda x: jintegrate.discretize(lambda t, x, u: -x + u, "ode45")(
        0.0, x, jnp.array([0.5]), 0.7))(jnp.array([1.0]))
    close(jac, jref, 1e-5, 1e-6)
    xs = T([[1.0], [2.0], [-0.5]])
    mapped = torch.func.vmap(lambda x: step(0.0, x, T([0.5]), 0.7))(xs)
    for i in range(3):
        close(mapped[i], step(0.0, xs[i], T([0.5]), 0.7), 0.0, 1e-7)


def test_sensitivity_step_matches_jax():
    """tests/test_integrate.py's nonlinear 3-state case with rk2."""
    x, u = np.float32([0.3, -0.2, 0.1]), np.float32([0.5])
    ref = jintegrate.sensitivity_step(jintegrate.discretize(_pendulum3(jnp), "rk2"))(
        0.0, jnp.asarray(x), jnp.asarray(u), 0.05)
    mine = integrate.sensitivity_step(integrate.discretize(_pendulum3(torch), "rk2"))(
        0.0, T(x), T(u), 0.05)
    for f in ("f", "dfdx", "dfdu"):
        close(getattr(mine, f), getattr(ref, f), 1e-5, 1e-7, err_msg=f)


@pytest.mark.parametrize("method", ["rk4", "ode45"])
def test_integrate_trajectory_matches_jax(method):
    def lin(lib):
        a = lib.asarray(np.float32([[0.0, 1.0], [0.0, 0.0]])) if lib is jnp else T([[0.0, 1.0], [0.0, 0.0]])
        b = lib.asarray(np.float32([[0.0], [1.0]])) if lib is jnp else T([[0.0], [1.0]])
        return lambda t, x, u: a @ x + b @ u
    ts = np.linspace(0.0, 1.0, 11).astype(np.float32)
    us = np.ones((10, 1), np.float32)
    ref = jintegrate.integrate_trajectory(lin(jnp), jnp.zeros(2), jnp.asarray(ts), jnp.asarray(us), method)
    mine = integrate.integrate_trajectory(lin(torch), torch.zeros(2), T(ts), T(us), method)
    assert mine.shape == (11, 2)
    close(mine, ref, 1e-5, 1e-6)
    close(mine[-1], [0.5, 1.0], 0.0, 1e-5)


# -- the event grid (tests/test_hybrid_ddp.py's cases) ------------------------------

GRID_CASES = {
    "two_events": (0.0, 1.5, 20, [0.45, 1.17], [0, 1, 2]),
    "inactive_slots": (0.0, 1.0, 10, [0.5, np.inf, np.inf], [0, 0, 0, 0]),
    "on_base_node": (0.0, 1.0, 10, [0.5], [0, 0]),
    "on_base_node_and_outside": (0.0, 1.2, 40, [0.3, 1.25, -0.1], [0, 1, 2, 3]),
    "unsorted_close": (0.0, 1.0, 10, [0.71, 0.33, 0.3301], [0, 2, 1, 3]),
}


@pytest.mark.parametrize("case", list(GRID_CASES))
def test_event_grid_matches_jax(case):
    """Times within 1e-6 (the base nodes are a linspace in each package),
    the jump mask and the modes exactly."""
    t0, tf, nb, ev, modes = GRID_CASES[case]
    ev = np.asarray(ev, np.float32)
    ref = jmake_event_grid(t0, tf, nb, jnp.asarray(ev), jnp.asarray(modes, jnp.int32))
    mine = make_event_grid_traced(t0, tf, nb, T(ev), torch.as_tensor(modes), device="cpu")
    assert mine.times.shape == (nb + 2 * len(ev) + 1,)
    close(mine.times, ref.times, 0.0, 1e-6)
    np.testing.assert_array_equal(mine.is_jump.numpy(), np.asarray(ref.is_jump))
    np.testing.assert_array_equal(mine.modes.numpy(), np.asarray(ref.modes))
    assert mine.modes.dtype == torch.int64


def test_event_grid_marks_one_jump_per_active_event():
    g = make_event_grid_traced(0.0, 1.0, 10, T([0.5, np.inf, np.inf]), torch.zeros(4, dtype=torch.int64),
                               device="cpu")
    assert float(g.is_jump.sum()) == 1.0 and float(g.times[-1]) == 1.0
    assert (torch.diff(g.times) >= 0).all()
    k = int(torch.argmax(g.is_jump))
    assert float(g.times[k + 1] - g.times[k]) == 0.0


# -- the state-triggered rollout -----------------------------------------------------

RESTITUTION = 0.8


def ball_system(lib, restitution=RESTITUTION, thrust=True):
    stack = torch.stack if lib is torch else jnp.stack

    def dynamics(t, x, u, p, mode):
        return stack([x[..., 1], (u[..., 0] if thrust else 0.0 * x[..., 0]) - G], -1)

    def guard(t, x, p, mode):
        return x[..., 0]

    def jump(t, x, p, mode):
        return stack([1e-4 + 0.0 * x[..., 0], -restitution * x[..., 1]], -1), mode + 1

    cls = HybridSystem if lib is torch else jhr.HybridSystem
    return cls(dynamics=dynamics, guard=guard, jump=jump)


WALL, E_REST = -0.2, 0.85


def pendulum_system(lib):
    stack = torch.stack if lib is torch else jnp.stack

    def dynamics(t, x, u, p, mode):
        return stack([x[..., 1], -G * lib.sin(x[..., 0]) + u[..., 0]], -1)

    def guard(t, x, p, mode):
        return x[..., 0] - WALL

    def jump(t, x, p, mode):
        return stack([WALL + 1e-4 + 0.0 * x[..., 0], -E_REST * x[..., 1]], -1), mode + 1

    cls = HybridSystem if lib is torch else jhr.HybridSystem
    return cls(dynamics=dynamics, guard=guard, jump=jump)


ROLLOUTS = {
    "bouncing_mass": (ball_system, [1.0, 0.0], 0.0125, 120),
    "pendulum_wall": (pendulum_system, [0.8, 0.0], 0.01, 150),
}


@pytest.fixture(scope="module", params=list(ROLLOUTS))
def rollout_pair(request):
    make, x0, dt, steps = ROLLOUTS[request.param]
    ref = jax.jit(lambda x: jhr.rollout_state_triggered(
        make(jnp), 0.0, x, lambda t, xx, k: jnp.zeros(1), dt, steps, {}))(jnp.asarray(x0, jnp.float32))
    mine = rollout_state_triggered(make(torch), 0.0, T(x0), lambda t, x, k: torch.zeros(1),
                                   dt, steps, {})
    return request.param, mine, jax.tree.map(np.asarray, ref)


def test_rollout_events_match_jax(rollout_pair):
    """Event mask and modes exactly; event times within 1e-5 (the bisection's
    midpoints are the same float32 numbers until the guard's last bit)."""
    _, mine, ref = rollout_pair
    np.testing.assert_array_equal(mine.event_mask.numpy(), ref.event_mask)
    np.testing.assert_array_equal(mine.modes.numpy(), ref.modes)
    close(mine.event_times, ref.event_times, 0.0, 1e-5)
    close(mine.times, ref.times, 0.0, 1e-6)
    assert mine.event_mask.sum() >= 1


def test_rollout_states_match_jax(rollout_pair):
    """States within 1e-4: a bounce re-enters at the guard, so a crossing
    time 1e-6 apart moves the post-jump state by the impact speed times it."""
    _, mine, ref = rollout_pair
    close(mine.xs, ref.xs, 1e-4, 1e-4)


def test_bounce_times_match_analytic():
    """tests/test_hybrid.py: free fall from 1 m, restitution 0.9: the first
    impact at sqrt(2 h / g) within 1e-3, the mode counter one per bounce."""
    traj = rollout_state_triggered(ball_system(torch, 0.9, thrust=False), 0.0, T([1.0, 0.0]),
                                   lambda t, x, k: torch.zeros(1), 0.02, 100, {})
    events = traj.event_times[traj.event_mask > 0.5].numpy()
    assert len(events) >= 2 and abs(events[0] - np.sqrt(2.0 / G)) < 1e-3
    assert int(traj.modes[-1]) == len(events)
    assert float(traj.xs[:, 0].min()) > -1e-2


def test_rollout_of_a_batch_equals_each_scenario_alone():
    """Scenarios cross at different steps: the masked event branch gives each
    what it gets alone (to the last bits of the batched RK4)."""
    x0s = T([[1.0, 0.0], [0.5, 1.0], [2.0, -0.5]])
    policy = lambda t, x, k: torch.zeros(x.shape[:-1] + (1,))  # noqa: E731
    batch = rollout_state_triggered(ball_system(torch), 0.0, x0s, policy, 0.0125, 80, {})
    assert batch.xs.shape == (3, 81, 2) and batch.modes.shape == (3, 81)
    for i in range(3):
        alone = rollout_state_triggered(ball_system(torch), 0.0, x0s[i], policy, 0.0125, 80, {})
        np.testing.assert_array_equal(batch.event_mask[i].numpy(), alone.event_mask.numpy())
        close(batch.event_times[i], alone.event_times, 0.0, 1e-6)
        close(batch.xs[i], alone.xs, 0.0, 1e-5)


def test_detect_events_sorts_stably_with_inactive_slots_last(rollout_pair):
    name, mine, ref = rollout_pair
    ev, modes = _detect_events(mine, 3, 0)
    masked = np.where(ref.event_mask > 0, ref.event_times, np.inf)
    order = np.argsort(masked, kind="stable")[:3]
    close(ev, masked[order], 0.0, 1e-5)
    np.testing.assert_array_equal(modes.numpy(), np.concatenate([[0], ref.modes[1:][order]]))


# -- the state-triggered hybrid DDP on the bouncing mass ----------------------------

def ball_problem_pair():
    q, r = np.diag([4.0, 0.1]).astype(np.float32), 0.05 * np.eye(1, dtype=np.float32)
    mine = OptimalControlProblem(
        dynamics=lambda t, x, u, p: torch.stack([x[..., 1], u[..., 0] - G], -1),
        jump_map=lambda t, x, p: torch.stack([1e-4 + 0.0 * x[..., 0], -RESTITUTION * x[..., 1]], -1),
        cost_terms=(quadratic_cost(q, r, device="cpu"),), nx=2, nu=1)
    ref = JProblem(
        dynamics=lambda t, x, u, p: jnp.array([x[1], u[0] - G]),
        jump_map=lambda t, x, p: jnp.array([1e-4, -RESTITUTION * x[1]]),
        cost_terms=(jquadratic_cost(jnp.asarray(q), jnp.asarray(r)),), nx=2, nu=1)
    return mine, ref


HYBRID_KW = dict(num_base_intervals=40, max_events=3, outer_rounds=3)


@pytest.fixture(scope="module")
def hybrid_pair():
    problem, jproblem = ball_problem_pair()
    target = np.array([0.8, 0.0], np.float32)
    jparams = {"target": JTarget.constant(jnp.asarray(target), jnp.zeros(1))}
    jsys = ball_system(jnp)
    st = dict(max_iterations=25, min_rel_cost=1e-4)
    ref = jax.jit(lambda x: jsolve_state_triggered(
        jsys, jproblem, 0.0, 1.2, x, jparams, settings=jddp.DdpSettings(**st), **HYBRID_KW))(
        jnp.array([1.0, 0.0]))
    params = {"target": TargetTrajectories.constant(target, np.zeros(1, np.float32), device="cpu")}
    mine = solve_state_triggered(ball_system(torch), problem, 0.0, 1.2, T([1.0, 0.0]), params,
                                 settings=ddp.DdpSettings(**st), device="cpu", **HYBRID_KW)
    return mine, jax.tree.map(np.asarray, ref), problem, params


def test_hybrid_events_and_modes_match_jax(hybrid_pair):
    mine, ref, _, _ = hybrid_pair
    np.testing.assert_array_equal(np.isfinite(mine.event_times.numpy()), np.isfinite(ref.event_times))
    close(mine.event_times, ref.event_times, 0.0, 1e-5)
    np.testing.assert_array_equal(mine.mode_sequence.numpy(), ref.mode_sequence)
    np.testing.assert_array_equal(mine.grid.is_jump.numpy(), ref.grid.is_jump)
    close(mine.grid.times, ref.grid.times, 0.0, 1e-5)
    assert mine.rounds_run == int(ref.rounds_run) == 3


def test_hybrid_drift_matches_jax(hybrid_pair):
    mine, ref, _, _ = hybrid_pair
    d, r = mine.event_drift.numpy(), ref.event_drift
    np.testing.assert_array_equal(np.isnan(d), np.isnan(r))
    np.testing.assert_array_equal(np.isinf(d), np.isinf(r))
    ok = np.isfinite(r)
    close(d[ok], r[ok], 0.0, 1e-5)


def test_hybrid_solution_matches_jax(hybrid_pair):
    """The final round's solve stops at a stationary iterate where a step of
    1e-7 in merit is accepted or refused by the last bit (JAX 2 iterations,
    the port 3 on this fixture): held to the cost at 1e-5 relative and to
    the states and inputs at 1e-3, not to the iteration count."""
    mine, ref, _, _ = hybrid_pair
    close(mine.ddp.performance.cost[0], ref.ddp.performance.cost, 1e-5, 1e-7)
    close(mine.ddp.xs[0], ref.ddp.xs, 1e-4, 1e-3)
    close(mine.ddp.us[0], ref.ddp.us, 1e-4, 1e-3)
    close(mine.rollout.xs, ref.rollout.xs, 1e-4, 1e-3)
    np.testing.assert_array_equal(mine.rollout.event_mask.numpy(), ref.rollout.event_mask)


def test_hybrid_solve_is_self_consistent_and_beats_free_fall(hybrid_pair):
    """tests/test_hybrid_ddp.py's assertions on the port: finite states, the
    grid's events within 4 rollout steps of those the final policy triggers,
    at least one bounce, a cost below free fall's."""
    from ocs2_tpu_torch.oc.metrics import evaluate_trajectory
    from ocs2_tpu_torch.oc.rollout import open_loop_policy, rollout

    mine, _, problem, params = hybrid_pair
    assert torch.isfinite(mine.ddp.xs).all()
    grid_ev = mine.event_times[torch.isfinite(mine.event_times)].numpy()
    final_ev = mine.rollout.event_times[mine.rollout.event_mask > 0].numpy()
    assert len(final_ev) >= 1
    for ge in grid_ev:
        assert np.min(np.abs(final_ev - ge)) < 4 * 1.2 / 80
    xs0, us0 = rollout(problem, mine.grid, T([[1.0, 0.0]]),
                       open_loop_policy(torch.zeros_like(mine.ddp.us[0])), params)
    free_fall = evaluate_trajectory(problem, mine.grid, xs0, us0, params).cost
    assert float(mine.ddp.performance.cost[0]) < float(free_fall[0])


def test_event_tol_stops_the_outer_loop_once_events_stand_still():
    """The pendulum against the wall with event_tol 0.05 (the reference's
    test outside jit): when the loop stops before its 6 rounds, the last
    drift it measured is below the tolerance and the returned grid is the
    previous round's."""
    problem = OptimalControlProblem(
        dynamics=lambda t, x, u, p: torch.stack([x[..., 1], -G * torch.sin(x[..., 0]) + u[..., 0]], -1),
        jump_map=lambda t, x, p: torch.stack([WALL + 1e-4 + 0.0 * x[..., 0], -E_REST * x[..., 1]], -1),
        cost_terms=(quadratic_cost(np.diag([6.0, 0.3]).astype(np.float32),
                                   0.02 * np.eye(1, dtype=np.float32), device="cpu"),), nx=2, nu=1)
    params = {"target": TargetTrajectories.constant(np.float32([0.4, 0.0]), np.zeros(1, np.float32),
                                                    device="cpu")}
    sol = solve_state_triggered(
        pendulum_system(torch), problem, 0.0, 1.5, T([0.8, 0.0]), params, num_base_intervals=40,
        max_events=2, outer_rounds=6, settings=ddp.DdpSettings(max_iterations=15, min_rel_cost=1e-4),
        event_tol=0.05, device="cpu")
    drift = sol.event_drift.numpy()
    assert 1 <= sol.rounds_run <= 6 and torch.isfinite(sol.ddp.xs).all()
    assert np.isnan(drift[sol.rounds_run:]).all()
    if sol.rounds_run < 6:
        assert drift[sol.rounds_run - 1] < 0.05
        assert sol.grid.times.shape == (40 + 4 + 1,)


# -- switch-time optimization (tests/test_hybrid.py's switched linear system) ------

_A0 = np.float32([[-0.1, 1.0], [0.0, -0.2]])
_A1 = np.float32([[-0.5, 0.0], [1.0, -0.1]])
_B = np.float32([[0.0], [1.0]])


def switched_problem():
    a_modes, b = torch.as_tensor(np.stack([_A0, _A1])), torch.as_tensor(_B)

    def dynamics(t, x, u, p):
        # The node's mode: one index, or one per node of a batch of nodes.
        mode = p["mode"]
        a = a_modes.index_select(0, mode.reshape(-1)).reshape(mode.shape + (2, 2))
        return (a @ x.unsqueeze(-1)).squeeze(-1) + u @ b.T

    def cost(t, x, u, p):
        return 0.5 * torch.sum(x * x, -1) + 0.5 * torch.sum(u * u, -1)

    return OptimalControlProblem(dynamics=dynamics, cost_terms=(cost,), nx=2, nu=1)


def jswitched_problem():
    def dynamics(t, x, u, p):
        a = jax.lax.switch(p["mode"], [lambda: jnp.asarray(_A0), lambda: jnp.asarray(_A1)])
        return a @ x + jnp.asarray(_B) @ u

    def cost(t, x, u, p):
        return 0.5 * (x @ x) + 0.5 * (u @ u)

    return JProblem(dynamics=dynamics, cost_terms=(cost,), nx=2, nu=1)


SWITCH_N = 40
SQP_SETTINGS = dict(max_iterations=15)


def _solve(theta):
    grid = make_time_grid(0.0, 2.0, SWITCH_N, event_times=[theta], mode_sequence=[0, 1])
    return sqp.solve(switched_problem(), grid, T([1.0, 0.0]), {},
                     settings=sqp.SqpSettings(**SQP_SETTINGS), device="cpu"), grid


def test_switch_time_gradient_matches_jax_and_finite_differences():
    """At theta = 0.9: the gradient equals the JAX package's within 1e-4
    relative (same Hamiltonian jump from the same solve), and a central
    difference of the solved cost at eps = 0.02 within the JAX test's 25 %."""
    sol, grid = _solve(0.9)
    g_nodes = switch_time_gradients(sol, grid)
    assert g_nodes.shape == (1, SWITCH_N)
    g = float(g_nodes.sum())
    jgrid = jmake_time_grid(0.0, 2.0, SWITCH_N, event_times=[0.9], mode_sequence=[0, 1])
    jsol = jsqp.solve(jswitched_problem(), jgrid, jnp.array([1.0, 0.0]), {},
                      settings=jsqp.SqpSettings(**SQP_SETTINGS))
    jg = jswitch.switch_time_gradients(jswitched_problem(), jgrid, jsol.xs, jsol.us, jsol.value_s, {})
    close(g_nodes[0], jg, 1e-4, 1e-6)
    eps = 0.02
    fd = (float(_solve(0.9 + eps)[0].performance.cost[0])
          - float(_solve(0.9 - eps)[0].performance.cost[0])) / (2 * eps)
    assert abs(g - fd) < 0.25 * max(abs(fd), 0.1), (g, fd)


def switch_time_gradients(sol, grid):
    return switch_time.switch_time_gradients(switched_problem(), grid, sol.xs, sol.us,
                                             sol.value_s, {})


def test_optimize_switch_times_matches_jax_for_three_iterations():
    """Three upper-level iterations from theta = 0.9: every iterate's event
    time within 1e-5 and cost within 1e-5 relative of the JAX package's."""
    kw = dict(t0=0.0, tf=2.0, num_intervals=SWITCH_N, event_times0=[0.9], mode_sequence=[0, 1],
              iterations=3, step_size=0.1)
    mine = switch_time.optimize_switch_times(
        switched_problem(), lambda grid, x0, p: sqp.solve(
            switched_problem(), grid, x0, p, settings=sqp.SqpSettings(**SQP_SETTINGS), device="cpu"),
        T([1.0, 0.0]), {}, **kw)
    jproblem = jswitched_problem()
    ref = jswitch.optimize_switch_times(
        jproblem, lambda grid, x0, p: jsqp.solve(jproblem, grid, x0, p,
                                                 settings=jsqp.SqpSettings(**SQP_SETTINGS)),
        jnp.array([1.0, 0.0]), {}, **kw)
    assert len(mine.history) == len(ref.history) == 3
    for (th, c), (jth, jc) in zip(mine.history, ref.history):
        close(th, jth, 0.0, 1e-5)
        close(c, jc, 1e-5, 1e-7)
    close(mine.event_times, ref.event_times, 0.0, 1e-5)
    assert abs(mine.cost - ref.cost) <= 1e-5 * abs(ref.cost)


def test_isotonic_projection_orders_and_keeps_gaps():
    theta = switch_time._isotonic_project(np.array([0.9, 0.1, 0.1000001, 5.0]), 0.0, 2.0, 1e-2)
    assert (np.diff(theta) >= 0).all() and theta[0] >= 1e-2 and theta[-1] <= 2.0 - 1e-2
    np.testing.assert_allclose(
        theta, jswitch._isotonic_project(np.array([0.9, 0.1, 0.1000001, 5.0]), 0.0, 2.0, 1e-2))


# -- the CARE -------------------------------------------------------------------------

def test_care_double_integrator_matches_the_analytic_solution():
    """A = [[0, 1], [0, 0]], B = [0, 1]', Q = I, R = 1: P = [[sqrt 3, 1],
    [1, sqrt 3]], K = [1, sqrt 3]; float32 to 1e-5."""
    sol = care.solve_care(T([[0, 1], [0, 0]]), T([[0], [1]]), torch.eye(2), torch.eye(1))
    s3 = np.sqrt(3.0)
    close(sol.P, [[s3, 1.0], [1.0, s3]], 0.0, 1e-5)
    close(sol.K, [[1.0, s3]], 0.0, 1e-5)
    assert float(sol.residual) < 1e-5


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_care_matches_jax(seed):
    """A random unstable 4-state system, through the QR least squares that
    the port takes on either device: P and K within 1e-4 of the JAX
    package's (the sign iteration's 40 inversions in float32 accumulate a few
    1e-6), residual below 1e-3 in both."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((4, 4)).astype(np.float32)
    b = rng.standard_normal((4, 2)).astype(np.float32)
    q, r = np.eye(4, dtype=np.float32), np.eye(2, dtype=np.float32)
    ref = jcare.solve_lqr(*map(jnp.asarray, (a, b, q, r)))
    mine = care.solve_lqr(*map(T, (a, b, q, r)))
    close(mine.P, ref.P, 1e-4, 1e-4)
    close(mine.K, ref.K, 1e-4, 1e-4)
    assert float(mine.residual) < 1e-3 and float(ref.residual) < 1e-3
    # The closed loop A - B K is stable.
    assert np.linalg.eigvals(a - b @ mine.K.numpy()).real.max() < 0.0


def test_care_takes_a_batch():
    a = torch.stack([T([[0, 1], [0, 0]]), T([[0, 1], [1, 0]])])
    b = T([[0], [1]]).expand(2, 2, 1)
    sol = care.solve_care(a, b, torch.eye(2).expand(2, 2, 2), torch.eye(1).expand(2, 1, 1))
    one = care.solve_care(a[1], b[1], torch.eye(2), torch.eye(1))
    assert sol.P.shape == (2, 2, 2) and sol.residual.shape == (2,)
    close(sol.P[1], one.P, 1e-5, 1e-6)
