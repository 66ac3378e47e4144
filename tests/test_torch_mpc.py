"""The MPC⇄MRT runtime of the port vs the JAX package on the CPU.

* the double-integrator ``Mpc``: one tick, a warm-started tick, a retarget,
  the DDP solver, and the closed loop of ``dummy_loop``;
* MRT gating, the rollout backends, and a JAX policy (through
  ``convert.mpc_policy_from_numpy``) driving both packages' ``Mrt``;
* the legged robot (SRBD, trot, N = 20) for three ticks at t = 0, 0.02, 0.06:
  the trot event at 1.05 s enters the horizon between the second and the
  third tick, so the third tick's warm start goes through
  ``spread_trajectories`` and the second's through plain interpolation;
  policies, solutions and the carried AL state against
  ``ocs2_tpu.mpc.mpc.Mpc`` with the same settings.

Inputs come from a numpy seed; solves with equal iteration counts agree
within 1e-3 + 1e-4 |value| (contact forces at 5e-3), pure functions within
rtol 2e-4 / atol 1e-5.  The JAX package's three legged ticks (``JAX_RECORDS``)
are stored in ``tests/torch_data/test_torch_mpc_jax.npz`` by
``tools/torch_test_records.py --record test_torch_mpc``.
"""
import functools
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ocs2_tpu.core.reference import TargetTrajectories as JTargetTrajectories
from ocs2_tpu.models import double_integrator as jdi
from ocs2_tpu.models.legged_robot import gait as jgait
from ocs2_tpu.models.legged_robot import interface as jinterface
from ocs2_tpu.models.legged_robot import model as jmodel
from ocs2_tpu.mpc import mpc as jmpc
from ocs2_tpu.mpc import mrt as jmrt
from ocs2_tpu.oc.time_discretization import make_time_grid as jmake_time_grid
from ocs2_tpu.solvers import ddp as jddp
from ocs2_tpu.solvers import sqp as jsqp

from ocs2_tpu_torch import convert
from ocs2_tpu_torch.core.reference import TargetTrajectories
from ocs2_tpu_torch.models import double_integrator as di
from ocs2_tpu_torch.models.legged_robot import gait, interface, model
from ocs2_tpu_torch.mpc.mpc import Mpc, MpcSettings
from ocs2_tpu_torch.mpc.mrt import (
    ExternalSimRollout,
    FlowMapRollout,
    MpcMrtInterface,
    Mrt,
    dummy_loop,
)
from ocs2_tpu_torch.oc.time_discretization import make_time_grid
from ocs2_tpu_torch.solvers import ddp, sqp
from tools._records import Records

torch.set_num_threads(1)  # one intra-op thread a test process: the suite runs in several
# processes at once (pytest-xdist), and these small tensors gain nothing from more.

RTOL, ATOL = 2e-4, 1e-5
SOLVE_ATOL, SOLVE_RTOL = 1e-3, 1e-4
FORCE_ATOL = 5e-3
LEGGED_N = 20
LEGGED_TICKS = (0.0, 0.02, 0.06)
LEGGED_SETTINGS = dict(max_iterations=4, integrator="rk2")


def close(mine, ref, rtol=RTOL, atol=ATOL):
    mine = mine.detach().cpu().numpy() if isinstance(mine, torch.Tensor) else np.asarray(mine)
    np.testing.assert_allclose(mine, np.asarray(ref), rtol=rtol, atol=atol)


def close_solve(mine, ref):
    close(mine, ref, SOLVE_RTOL, SOLVE_ATOL)


# -- the double integrator --------------------------------------------------

def di_pair(solver="sqp", n=20, horizon=1.0):
    st = dict(time_horizon=horizon, num_intervals=n, solver=solver)
    ref = jmpc.Mpc(jdi.make_problem(), jdi.make_params(), settings=jmpc.MpcSettings(**st))
    mine = Mpc(di.make_problem(device="cpu"), di.make_params(device="cpu"),
               settings=MpcSettings(**st), device="cpu")
    return mine, ref


def assert_same_policy(mine, ref, force_cols=None):
    close(mine.times, ref.times)
    for name in ("xs", "us"):
        a, b = getattr(mine, name), np.asarray(getattr(ref, name))
        if name == "us" and force_cols is not None:
            close(a[:, force_cols], b[:, force_cols], SOLVE_RTOL, FORCE_ATOL)
            rest = [i for i in range(b.shape[1]) if i not in force_cols]
            close_solve(a[:, rest], b[:, rest])
        else:
            close_solve(a, b)
    ctrl, ctrl_ref = mine.controller, ref.controller
    close(ctrl.times, ctrl_ref.times)
    close_solve(ctrl.x_nom, ctrl_ref.x_nom)
    # Gains (up to 1e3 on the legged robot) are held relative to their own
    # scale, as in the SQP parity tests.
    scale = max(1.0, float(np.abs(np.asarray(ctrl_ref.gains)).max()))
    close(ctrl.gains, ctrl_ref.gains, 1e-3, 2e-4 * scale)


@pytest.mark.parametrize("solver", ["sqp", "ddp"])
def test_di_tick_and_warm_tick_match(solver):
    mine, ref = di_pair(solver)
    for t, x in ((0.0, [1.0, 0.0]), (0.02, [0.99, -0.05]), (0.1, [0.9, -0.3])):
        x = np.asarray(x, np.float32)
        pr = ref.run(t, jnp.asarray(x))
        pm = mine.run(t, torch.as_tensor(x))
        assert_same_policy(pm, pr)
        close(pm.performance.cost, pr.performance.cost, 1e-3, 1e-6)
    assert mine.solve_timer.count == 3 and mine.solve_timer.last > 0.0
    assert mine.last_solution.iterations.shape == (1,)
    u0 = pm.controller(torch.tensor(0.1), torch.as_tensor(x))
    assert u0.shape == (1,)


def test_di_first_tick_decelerates():
    mine, _ = di_pair()
    pol = mine.run(0.0, torch.tensor([1.0, 0.0]))
    assert pol.xs.shape == (21, 2)
    assert float(pol.controller(torch.tensor(0.0), torch.tensor([1.0, 0.0]))[0]) < 0.0


def test_di_retarget_matches():
    mine, ref = di_pair()
    ref.run(0.0, jnp.zeros(2))
    mine.run(0.0, torch.zeros(2))
    ref.reference_manager.set_target(JTargetTrajectories.constant(jnp.array([2.0, 0.0]),
                                                                  jnp.zeros(1)))
    mine.reference_manager.set_target(TargetTrajectories.constant([2.0, 0.0], [0.0],
                                                                  device="cpu"))
    pr = ref.run(0.1, jnp.zeros(2))
    pm = mine.run(0.1, torch.zeros(2))
    assert_same_policy(pm, pr)
    assert float(pm.controller(torch.tensor(0.1), torch.zeros(2))[0]) > 0.1


def test_di_cold_start_and_reset():
    st = MpcSettings(time_horizon=1.0, num_intervals=10, cold_start=True)
    mine = Mpc(di.make_problem(device="cpu"), di.make_params(device="cpu"), settings=st,
               device="cpu")
    mine.run(0.0, torch.tensor([1.0, 0.0]))
    mine.run(0.05, torch.tensor([0.9, 0.0]))
    warm = mine.last_solve_inputs
    close(warm["xs_init"], np.tile([0.9, 0.0], (11, 1)))
    close(warm["us_init"], np.zeros((10, 1)))
    assert mine.last_policy is not None
    mine.reset()
    assert mine.last_policy is None and mine.solve_timer.count == 0


@pytest.mark.parametrize("solver", ["ipm", "slp"])
def test_ipm_and_slp_mpc_construct_and_solve(solver):
    """``Mpc(solver="ipm" | "slp")`` takes the solver's own settings and
    solves a tick of the unconstrained double integrator to the SQP tick's
    policy (IPM to 1e-3, SLP to tests/test_pipg.py's 5e-2); SLP's policy is
    feedforward.  (The IPM loop is held against the JAX package's in
    tests/test_torch_ipm.py.)"""
    from ocs2_tpu_torch.solvers import ipm, slp

    mine, _ = di_pair(solver)
    assert isinstance(mine.solver_settings, {"ipm": ipm.IpmSettings, "slp": slp.SlpSettings}[solver])
    sqp_mpc, _ = di_pair("sqp")
    x = torch.tensor([1.0, 0.0])
    pol, ref = mine.run(0.0, x), sqp_mpc.run(0.0, x)
    atol = 1e-3 if solver == "ipm" else 5e-2
    close(pol.us, ref.us, 0.0, atol)
    assert mine.last_solution.iterations.shape == (1,) and mine.solve_timer.count == 1
    assert bool(pol.controller.gains.any()) == (solver == "ipm")
    # The next tick is warm-started from this one.
    mine.run(0.05, torch.tensor([0.99, -0.1]))
    assert mine.solve_timer.count == 2 and mine.spread_count == 0


def test_unknown_mpc_solver_raises():
    with pytest.raises(ValueError, match="unknown solver"):
        Mpc(di.make_problem(device="cpu"), di.make_params(device="cpu"),
            settings=MpcSettings(solver="nope"), device="cpu")


@functools.lru_cache(maxsize=None)
def _di_closed_loops():
    x0 = np.array([1.0, 0.0], np.float32)
    kw = dict(duration=2.0, mrt_frequency=100.0, mpc_frequency=20.0)
    mine_mpc, ref_mpc = di_pair()
    ref = jmrt.dummy_loop(jmrt.MpcMrtInterface(ref_mpc), jnp.asarray(x0), **kw)
    seen = []
    mine = dummy_loop(MpcMrtInterface(mine_mpc), torch.as_tensor(x0),
                      observers=[lambda t, x, u: seen.append(t)], **kw)
    return mine, tuple(np.asarray(a) for a in ref), seen, mine_mpc


def test_di_closed_loop_matches():
    (ts, xs, us), (ts_r, xs_r, us_r), seen, mpc = _di_closed_loops()
    assert xs.shape == xs_r.shape == (201, 2) and us.shape == us_r.shape == (200, 1)
    close(ts, ts_r)
    close_solve(xs, xs_r)
    close_solve(us, us_r)
    assert len(seen) == 200 and mpc.solve_timer.count == 40


def test_di_closed_loop_regulates():
    (_, xs, _), _, _, _ = _di_closed_loops()
    assert float(xs[-1].norm()) < 0.2
    assert float(xs[-1].norm()) < 0.25 * float(xs[0].norm())


def test_dummy_loop_without_rollout_tracks_the_plan():
    mine, _ = di_pair()
    ts, xs, us = dummy_loop(MpcMrtInterface(mine), torch.tensor([1.0, 0.0]), duration=0.2,
                            mrt_frequency=100.0, mpc_frequency=20.0, use_rollout=False)
    pol = mine.last_policy
    from ocs2_tpu_torch.core.interpolation import interpolate

    close(xs[-1], interpolate(pol.controller.times, pol.controller.x_nom,
                              torch.tensor(float(ts[-1]))))


# -- the MRT side -----------------------------------------------------------

def test_mrt_gating_before_first_policy():
    mrt = Mrt(di.make_problem(device="cpu"))
    assert not mrt.initialized
    assert not mrt.update_policy()
    with pytest.raises(AssertionError, match="MRT gating"):
        mrt.evaluate_policy(0.0, torch.zeros(2))


def test_mrt_buffer_swap():
    mine, _ = di_pair()
    mrt = Mrt(di.make_problem(device="cpu"))
    first = mine.run(0.0, torch.tensor([1.0, 0.0]))
    mrt.move_to_buffer(first)
    assert mrt.update_policy() and mrt.policy is first
    second = mine.run(0.05, torch.tensor([0.9, 0.0]))
    mrt.move_to_buffer(second)
    assert mrt.policy is first  # not swapped until update_policy
    assert mrt.update_policy() and mrt.policy is second and not mrt.update_policy()


@functools.lru_cache(maxsize=None)
def _jax_di_policy():
    _, ref = di_pair(n=16)
    return ref.run(0.0, jnp.array([0.8, -0.1]))


def _as_numpy_policy(pol):
    return dict(
        controller=pol.controller._asdict(), xs=pol.xs, us=pol.us, times=pol.times,
        performance=pol.performance._asdict(), mode_schedule=pol.mode_schedule._asdict())


@pytest.mark.parametrize("t", [0.0, 0.013, 0.37, 0.99])
def test_jax_policy_drives_both_mrts(t):
    pol = _jax_di_policy()
    ref_mrt = jmrt.Mrt(jdi.make_problem())
    ref_mrt.move_to_buffer(pol)
    ref_mrt.update_policy()
    mrt = Mrt(di.make_problem(device="cpu"))
    mrt.move_to_buffer(convert.mpc_policy_from_numpy(
        jax.tree.map(np.asarray, _as_numpy_policy(pol)), device="cpu"))
    mrt.update_policy()
    x = np.array([0.7, 0.05], np.float32)
    close(mrt.evaluate_policy(t, torch.as_tensor(x)), ref_mrt.evaluate_policy(t, jnp.asarray(x)))
    for substeps in (1, 3):
        close(mrt.rollout_policy(t, torch.as_tensor(x), 0.01, di.make_params(device="cpu"),
                                 substeps=substeps),
              ref_mrt.rollout_policy(t, jnp.asarray(x), 0.01, jdi.make_params(),
                                     substeps=substeps))


def test_policy_conversion_keeps_the_schedule_and_performance():
    pol = _jax_di_policy()
    mine = convert.mpc_policy_from_numpy(jax.tree.map(np.asarray, _as_numpy_policy(pol)),
                                         device="cpu")
    assert mine.mode_schedule.mode_sequence.dtype == np.int32
    assert int(mine.mode_schedule.num_events) == 0
    close(mine.performance.cost, pol.performance.cost)
    assert mine.controller.gains.shape == (16, 1, 2)


@pytest.mark.parametrize("method,substeps", [("rk4", 2), ("rk2", 1), ("euler", 3)])
def test_rollout_backends_match(method, substeps):
    rng = np.random.default_rng(11)
    x = rng.standard_normal(2).astype(np.float32)
    u = rng.standard_normal(1).astype(np.float32)
    args = (jnp.float32(0.1), jnp.asarray(x), jnp.asarray(u), jnp.float32(0.05),
            jdi.make_params())
    targs = (torch.tensor(0.1), torch.as_tensor(x), torch.as_tensor(u), torch.tensor(0.05),
             di.make_params(device="cpu"))
    ref = jmrt.FlowMapRollout(jdi.make_problem(), method, substeps).step(*args)
    close(FlowMapRollout(di.make_problem(device="cpu"), method, substeps).step(*targs), ref)
    # An external simulator with state conversions: a damped plant in
    # doubled coordinates.
    jsim = jmrt.ExternalSimRollout(
        lambda t, xx, uu, p: jnp.array([xx[1], 2.0 * uu[0] - 0.1 * xx[1]]), method, substeps,
        state_to_sim=lambda xx: 2.0 * xx, sim_to_state=lambda xx: 0.5 * xx)
    sim = ExternalSimRollout(
        lambda t, xx, uu, p: torch.cat([xx[..., 1:2], 2.0 * uu[..., 0:1] - 0.1 * xx[..., 1:2]],
                                       -1), method, substeps,
        state_to_sim=lambda xx: 2.0 * xx, sim_to_state=lambda xx: 0.5 * xx)
    close(sim.step(*targs), jsim.step(*args))


# -- the legged robot: three ticks across a mode-schedule change ------------

def _legged_reference_pair():
    """(port Mpc, JAX Mpc) on a 1 s horizon of 20 intervals, trot."""
    settings = dict(time_horizon=1.0, num_intervals=LEGGED_N, solver="sqp")
    ms = jgait.GaitSchedule(jgait.trot_gait(0.7)).mode_schedule(0.0, 1.0)
    jgrid = jmake_time_grid(0.0, 1.0, LEGGED_N, event_times=np.asarray(ms.event_times),
                            mode_sequence=np.asarray(ms.mode_sequence))
    ref = jmpc.Mpc(
        jinterface.make_problem(), jinterface.make_params(jgrid),
        settings=jmpc.MpcSettings(**settings),
        solver_settings=jsqp.SqpSettings(**LEGGED_SETTINGS),
        reference_manager=jinterface.SwitchedModelReferenceManager(
            jgait.GaitSchedule(jgait.trot_gait(0.7))))
    tms = gait.GaitSchedule(gait.trot_gait(0.7)).mode_schedule(0.0, 1.0)
    tgrid = make_time_grid(0.0, 1.0, LEGGED_N, event_times=tms.event_times,
                           mode_sequence=tms.mode_sequence)
    mine = Mpc(
        interface.make_problem(device="cpu"), interface.make_params(tgrid, device="cpu"),
        settings=MpcSettings(**settings), solver_settings=sqp.SqpSettings(**LEGGED_SETTINGS),
        reference_manager=interface.SwitchedModelReferenceManager(
            gait.GaitSchedule(gait.trot_gait(0.7)), device="cpu"),
        device="cpu")
    return mine, ref


def _jax_legged_ticks():
    """The JAX package's ticks from the default state, each next tick from
    its solution's xs[1]: the start, the policy and the carried AL state."""
    _, ref = _legged_reference_pair()
    x = np.array(jmodel.default_state())
    ticks = []
    for t in LEGGED_TICKS:
        pr = ref.run(t, jnp.asarray(x))
        ticks.append(dict(x=x, policy=vars(pr), al=ref._prev_al))
        x = np.array(pr.xs[1])
    return ticks


JAX_RECORDS = {"legged_ticks": _jax_legged_ticks}
RECORDS = Records(__file__)


@functools.lru_cache(maxsize=None)
def _legged_ticks():
    """The port's ticks from the JAX package's starts (the default state,
    then each JAX tick's xs[1])."""
    mine, _ = _legged_reference_pair()
    ticks = []
    for t, rec in zip(LEGGED_TICKS, RECORDS["legged_ticks"]):
        pm = mine.run(t, torch.as_tensor(rec["x"]))
        ticks.append(dict(
            mine=pm, ref=SimpleNamespace(**rec["policy"]), spread=mine.spread_count, solution=mine.last_solution,
            inputs=mine.last_solve_inputs, ref_al=rec["al"]))
    return ticks, mine


@pytest.mark.parametrize("tick", range(len(LEGGED_TICKS)))
def test_legged_tick_policy_matches(tick):
    ticks, _ = _legged_ticks()
    rec = ticks[tick]
    assert_same_policy(rec["mine"], rec["ref"], force_cols=list(range(12)))
    assert int(rec["solution"].iterations[0]) == LEGGED_SETTINGS["max_iterations"]
    close(rec["mine"].performance.cost, rec["ref"].performance.cost, 1e-3, 1e-6)


def test_legged_warm_starts_spread_only_across_a_schedule_change():
    ticks, mine = _legged_ticks()
    assert [rec["spread"] for rec in ticks] == [0, 0, 1]
    assert mine.spread_count == 1
    ms = [rec["mine"].mode_schedule for rec in ticks]
    assert [int(m.num_events) for m in ms] == [2, 2, 3]
    np.testing.assert_array_equal(ms[0].event_times, ticks[0]["ref"].mode_schedule.event_times)


def test_legged_grid_and_swing_references_follow_the_tick():
    ticks, _ = _legged_ticks()
    for t, rec in zip(LEGGED_TICKS, ticks):
        grid = rec["inputs"]["grid"]
        close(grid.times, rec["ref"].times)
        assert abs(float(grid.times[0]) - t) < 1e-6
        params = rec["inputs"]["params"]
        assert params["swing_z"].shape == (LEGGED_N + 1, 4)
        # Swing legs of the first interval have a non-zero height reference
        # at their next node; stance legs none.
        flags = gait.contact_flags_static(int(grid.modes[1]))
        assert bool((params["swing_z"][1][flags > 0.5] == 0).all())


def test_legged_al_state_round_trips_across_ticks():
    """The carried AL state reaches the next solve unchanged, with its
    leading [1], and equals the JAX package's (the projected foot
    constraint's 12 equality multipliers stay zero; the other families are
    empty)."""
    ticks, _ = _legged_ticks()
    for prev, rec in zip(ticks, ticks[1:]):
        assert rec["inputs"]["al_init"] is prev["solution"].al
    for rec in ticks:
        al = rec["solution"].al
        assert al.lmbd_eq.shape == (1, LEGGED_N, 12) and al.lmbd_ineq.shape == (1, LEGGED_N, 0)
        assert al.rho.shape == (1,)
        for mine_leaf, ref_leaf in zip(al, rec["ref_al"]):
            assert mine_leaf.shape == (1,) + ref_leaf.shape
            close(mine_leaf[0], ref_leaf)


def test_legged_resolve_from_recorded_inputs_is_the_tick():
    """``last_solve_inputs`` re-solves the last tick to the same result (the
    chip script re-solves the closed loop's first ticks this way through the
    single-scenario sweep)."""
    ticks, mine = _legged_ticks()
    inp = ticks[-1]["inputs"]
    again = sqp.solve(mine.problem, inp["grid"], inp["x0"], inp["params"],
                      xs_init=inp["xs_init"], us_init=inp["us_init"], al_init=inp["al_init"],
                      settings=mine.solver_settings, device="cpu", force_single_riccati=True)
    sol = ticks[-1]["solution"]
    assert torch.equal(again.iterations, sol.iterations)
    close_solve(again.xs, sol.xs)
    close_solve(again.us, sol.us)


def test_legged_closed_loop_runs_a_few_steps():
    """The legged Mpc in dummy_loop (two MPC ticks, eight control steps):
    finite states, the base stays near its stand height."""
    mine, _ = _legged_reference_pair()
    ts, xs, us = dummy_loop(MpcMrtInterface(mine), model.default_state("cpu"), duration=0.02,
                            mrt_frequency=400.0, mpc_frequency=100.0)
    assert xs.shape == (9, 24) and us.shape == (8, 24)
    assert bool(torch.isfinite(xs).all())
    assert float((xs[:, 8] - model.STAND_HEIGHT).abs().max()) < 0.05
    assert mine.solve_timer.count == 2


def test_ddp_mpc_passes_its_own_warm_start():
    """The DDP route takes the inputs' warm start only, as the JAX Mpc does."""
    st = MpcSettings(time_horizon=1.0, num_intervals=10, solver="ddp")
    mine = Mpc(di.make_problem(device="cpu"), di.make_params(device="cpu"), settings=st,
               solver_settings=ddp.DdpSettings(max_iterations=5), device="cpu")
    pol = mine.run(0.0, torch.tensor([1.0, 0.0]))
    ref = jmpc.Mpc(jdi.make_problem(), jdi.make_params(), settings=jmpc.MpcSettings(
        time_horizon=1.0, num_intervals=10, solver="ddp"),
        solver_settings=jddp.DdpSettings(max_iterations=5)).run(0.0, jnp.array([1.0, 0.0]))
    assert_same_policy(pol, ref)
