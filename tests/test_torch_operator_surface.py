"""The operator surface of the port vs the JAX package, on the CPU: term-wise
solver observers (term names and row slices, per-node term values of every
constraint family, the observer with its callbacks and AL multipliers on a
hard-constrained cartpole swing-up), the closed-loop trajectory recorder
with its npz and png exports on the double integrator's MPC loop, target
commands and the keyboard command loop (the twins of
``tests/test_operator_surface.py``).

Tolerance: term values atol 1e-5 against the JAX package's on the same
trajectory (float32, one evaluation); slices and names exact.  The
swing-up's trajectory for the per-node values is the JAX package's own
(iLQR with the hard input bound, ``tests/torch_data/
cartpole_swingup_reference.npz``), so no solve of either package differs in
the inputs.
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke as cs
import torch_toy_problem as toy
from ocs2_tpu.core.types import PerformanceIndex as JPerformanceIndex
from ocs2_tpu.models import cartpole as jcp
from ocs2_tpu.models.legged_robot import interface as jinterface
from ocs2_tpu.oc.time_discretization import uniform_grid as juniform_grid
from ocs2_tpu.utils import observers as jobs
from ocs2_tpu.utils import recorder as jrec

from ocs2_tpu_torch.core.types import PerformanceIndex
from ocs2_tpu_torch.models import cartpole, double_integrator
from ocs2_tpu_torch.models.legged_robot import interface
from ocs2_tpu_torch.mpc.mpc import Mpc, MpcSettings
from ocs2_tpu_torch.mpc.mrt import MpcMrtInterface, dummy_loop
from ocs2_tpu_torch.oc.time_discretization import uniform_grid
from ocs2_tpu_torch.solvers import ddp
from ocs2_tpu_torch.utils import observers, timers
from ocs2_tpu_torch.utils.recorder import (
    TrajectoryRecorder,
    keyboard_command_loop,
    pose_command_to_target,
)

torch.set_num_threads(1)  # one intra-op thread a test process: the suite runs in several
# processes at once (pytest-xdist), and these small tensors gain nothing from more.

T = lambda v: torch.as_tensor(np.array(v, np.float32))  # noqa: E731


# -- term observers ---------------------------------------------------------------


def test_term_slices_names_and_offsets_match_jax():
    mine = observers.term_slices(interface.make_problem(device="cpu"), "equality",
                                 {"swing_vz": np.zeros((49, 4))}, device="cpu")
    ref = jobs.term_slices(jinterface.make_problem(), "equality", {"swing_vz": np.zeros((49, 4))})
    assert mine == ref and mine["foot_constraint"] == slice(0, 12)


def test_term_name():
    def my_fn(t, x, u, p):
        return u

    class Named:
        name = "cone"

    assert observers.term_name(my_fn) == jobs.term_name(my_fn) == "my_fn"
    assert observers.term_name(Named()) == "cone"


@pytest.fixture(scope="module")
def swing_up():
    """The JAX package's hard-constrained swing-up (scenario 0 of the
    cartpole record: iLQR, N = 60 over 3 s)."""
    with np.load(cs.CARTPOLE_RECORD) as f:
        return f["ilqr_xs"][0], f["ilqr_us"][0]


def test_evaluate_term_matches_jax_and_a_direct_call(swing_up):
    xs, us = swing_up
    n = us.shape[0]
    grid = uniform_grid(0.0, cs.CARTPOLE_HORIZON, n)
    problem = cartpole.make_problem("hard", device="cpu")
    vals = observers.evaluate_term(problem, grid, T(xs), T(us), cartpole.make_params("cpu"),
                                   "inequality", "input_bounds")
    ref = jobs.evaluate_term(jcp.make_problem("hard"), juniform_grid(0.0, cs.CARTPOLE_HORIZON, n),
                             jnp.asarray(xs), jnp.asarray(us), jcp.make_params(), "inequality",
                             "input_bounds")
    assert vals.shape == (n, 2)
    np.testing.assert_allclose(vals.numpy(), np.asarray(ref), atol=1e-5)
    k = 7
    direct = problem.inequality_terms[0](grid.times[k], T(xs[k]), T(us[k]), {})
    np.testing.assert_allclose(vals[k].numpy(), direct.numpy(), rtol=1e-6)
    # The swing-up saturates the bound: some node touches 0.
    assert float(vals.min()) < 1e-2


@pytest.mark.parametrize("family", ["equality", "inequality", "state_inequality",
                                    "final_equality"])
def test_evaluate_term_of_every_family_matches_jax(family):
    """Per-node values of the toy problem's term in each constraint family on
    a random trajectory (N = 6), with a batch of two trajectories in the
    port."""
    rng = np.random.default_rng(0)
    n = 6
    xs = rng.standard_normal((2, n + 1, 2)).astype(np.float32)
    us = rng.standard_normal((2, n, 1)).astype(np.float32)
    got = observers.evaluate_term(toy.torch_problem(), uniform_grid(0.0, 1.2, n), T(xs), T(us),
                                  toy.torch_params(), family, "<lambda>")
    for b in range(2):
        ref = jobs.evaluate_term(toy.jax_problem(), juniform_grid(0.0, 1.2, n),
                                 jnp.asarray(xs[b]), jnp.asarray(us[b]), toy.jax_params(),
                                 family, "<lambda>")
        assert got[b].shape == ref.shape
        np.testing.assert_allclose(got[b].numpy(), np.asarray(ref), atol=1e-5)


@pytest.fixture(scope="module")
def cartpole_solve():
    """The port's hard-constrained swing-up of tests/test_operator_surface.py
    (iLQR with the AL input bound, N = 40 over 2 s, 30 iterations)."""
    problem = cartpole.make_problem("hard", device="cpu")
    grid = uniform_grid(0.0, 2.0, 40)
    params = cartpole.make_params("cpu")
    sol = ddp.solve(problem, grid, cartpole.initial_state_down("cpu")[None], params,
                    settings=ddp.DdpSettings(max_iterations=30), device="cpu")
    return problem, grid, params, sol


def test_observe_with_callbacks_and_multipliers(cartpole_solve):
    problem, grid, params, sol = cartpole_solve
    got = {}
    obs = observers.TermObserver(
        problem, "inequality", "input_bounds",
        constraint_callback=lambda ts, vs: got.update(c=(ts, vs)),
        multiplier_callback=lambda ts, ms: got.update(m=(ts, ms)),
    )
    obs.observe(0.0, grid, sol, params)
    assert obs.latest() is not None and len(obs.history) == 1
    ts, vs = got["c"]
    assert isinstance(vs, np.ndarray) and vs.shape == (40, 2) and ts.shape == (40,)
    assert vs.min() < 1e-2  # the bound is active
    _, ms = got["m"]
    assert ms.shape == (40, 2) and ms.min() >= 0.0
    np.testing.assert_array_equal(ms, sol.al.lmbd_ineq[0].numpy())


def test_solver_observers_and_performance_log(cartpole_solve):
    _, _, _, sol = cartpole_solve
    eq = observers.constraint_observer()
    mult = observers.multiplier_observer()
    for t in (0.0, 0.1):
        eq.observe(t, sol)
        mult.observe(t, sol)
    t, value = eq.latest()
    assert t == 0.1 and isinstance(value, np.ndarray)
    assert isinstance(mult.latest()[1].lmbd_ineq, np.ndarray)
    log = observers.PerformanceLog()
    log.append(PerformanceIndex(*(v[0] for v in sol.performance)))
    assert set(log.as_arrays()) == set(JPerformanceIndex._fields)
    assert log.latest().merit == pytest.approx(float(sol.performance.merit[0]))
    timer = timers.RepeatedTimer()
    timer.record(0.002)
    report = observers.benchmark_report({"solve": timer})
    assert "solve" in report and "100.0%" in report


# -- recorder ---------------------------------------------------------------------


@pytest.fixture(scope="module")
def recorded():
    """tests/test_operator_surface.py's loop: the double integrator's SQP MPC
    (N = 20 over 1 s) in dummy_loop for 1 s at 50 Hz control and 10 Hz MPC."""
    mpc = Mpc(double_integrator.make_problem(device="cpu"), double_integrator.make_params(
        device="cpu"), settings=MpcSettings(time_horizon=1.0, num_intervals=20, solver="sqp"),
        device="cpu")
    rec = TrajectoryRecorder()
    ts, xs, us = dummy_loop(MpcMrtInterface(mpc), torch.tensor([1.0, 0.0]), duration=1.0,
                            mrt_frequency=50.0, mpc_frequency=10.0, observers=[rec])
    for k in range(mpc.solve_timer.count):
        rec.record_solve(0.1 * k, mpc.last_policy.performance)
    return rec, xs, us


def test_record_and_npz(recorded, tmp_path):
    rec, xs, us = recorded
    assert len(rec.times) == 50
    np.testing.assert_array_equal(np.stack(rec.states), xs[1:].numpy())
    np.testing.assert_array_equal(np.stack(rec.inputs), us.numpy())
    path = os.path.join(str(tmp_path), "run.npz")
    rec.save_npz(path)
    data = np.load(path)
    assert data["x"].shape == (50, 2) and data["u"].shape == (50, 1)
    assert {f"perf_{f}" for f in JPerformanceIndex._fields} <= set(data.files)


def test_plots_export(recorded, tmp_path):
    rec, _, _ = recorded
    path = os.path.join(str(tmp_path), "run.png")
    rec.save_plots(path)
    assert os.path.exists(path) and os.path.getsize(path) > 10_000


def test_term_trace_in_npz(tmp_path):
    rec = TrajectoryRecorder()
    rec(0.0, torch.zeros(2), torch.zeros(1))
    rec.record_term("cone", np.arange(5.0), torch.ones((5, 4)))
    path = os.path.join(str(tmp_path), "run2.npz")
    rec.save_npz(path)
    assert np.load(path)["term_cone_v"].shape == (5, 4)


# -- target commands ----------------------------------------------------------------


@pytest.mark.parametrize("nx, command", [(12, [2.0, 0.0, 0.0, 0.5]), (2, [0.5, 0.0, 0.0])])
def test_pose_command_to_target_matches_jax(nx, command):
    x0 = np.zeros(nx, np.float32)
    x0[6 if nx >= 10 else 0] = 1.0
    kw = dict(t0=1.0, target_velocity=0.5, u_target=np.zeros(3, np.float32))
    mine = pose_command_to_target(x0, command, device="cpu", **kw)
    ref = jrec.pose_command_to_target(jnp.asarray(x0), command, **kw)
    for f in ("times", "states", "inputs"):
        np.testing.assert_allclose(getattr(mine, f).numpy(), np.asarray(getattr(ref, f)),
                                   rtol=1e-6, err_msg=f)
    if nx == 12:  # arrival after |d| / v = 4 s
        assert float(mine.times[-1]) == 5.0
        assert float(mine.states[-1, 6]) == pytest.approx(3.0)
        assert float(mine.states[-1, 9]) == pytest.approx(0.5)


def test_keyboard_command_loop():
    mpc = Mpc(double_integrator.make_problem(device="cpu"),
              double_integrator.make_params(device="cpu"),
              settings=MpcSettings(time_horizon=1.0, num_intervals=20, solver="sqp"),
              device="cpu")
    out = []
    keyboard_command_loop(mpc, stream=["0.5 0 0"], out=out)
    assert out[-1] == "no policy yet"
    mpc.run(0.0, torch.tensor([1.0, 0.0]))
    out = []
    keyboard_command_loop(mpc, stream=["garbage", "0.5 0 0", "q", "0 0 0"], out=out)
    assert any("cannot parse" in line for line in out)
    assert sum("target set" in line for line in out) == 1
    # The command becomes active at the next solve (the buffered target).
    mpc.run(0.1, torch.tensor([1.0, 0.0]))
    assert abs(float(mpc.reference_manager.target.states[-1, 0]) - 1.5) < 0.2
