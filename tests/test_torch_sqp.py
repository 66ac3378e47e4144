"""Whole SQP solves of the port vs the JAX package on the CPU.

Fixtures: the hard-constrained toy problem without projection (its plain cost
term makes the Hessian correction run; every constraint family goes through
the augmented Lagrangian), its nu = 2 variant with the equality projected,
and the legged robot standing and trotting at N = 20 with the 12-row foot
constraint projected.  A batch of one is held against ``sqp.solve``, a batch
of three against ``jax.vmap(sqp.solve)`` (which takes
``vmap(_lqr_backward_single)`` on the CPU where the port takes the entry-form
plain version of its kernel: float32 reassociation, hence tolerances).

``iterations`` and ``converged`` equal, ``xs``/``us`` within
1e-3 + 1e-4 |value|, history step sizes equal.

The JAX package's ten solves (``JAX_RECORDS``, the last two with the
associative-scan Riccati and the horizon-sharded PIPG; XLA takes minutes to
compile the legged ones) are stored in ``tests/torch_data/test_torch_sqp_jax.npz``
by ``tools/torch_test_records.py --record test_torch_sqp``, with the
starts they solved from; the port solves live.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_toy_problem as toy
from ocs2_tpu.models.legged_robot import gait as jgait
from ocs2_tpu.models.legged_robot import interface as jinterface
from ocs2_tpu.models.legged_robot import model as jmodel
from ocs2_tpu.oc.time_discretization import make_time_grid as jmake_time_grid
from ocs2_tpu.oc.time_discretization import uniform_grid as juniform_grid
from ocs2_tpu.solvers import sqp as jsqp

from ocs2_tpu_torch import convert
from ocs2_tpu_torch.models.legged_robot import constraints as con
from ocs2_tpu_torch.models.legged_robot import interface, model
from ocs2_tpu_torch.oc.time_discretization import make_time_grid, uniform_grid
from ocs2_tpu_torch.solvers import sqp
from tools._records import Records

torch.set_num_threads(1)  # one intra-op thread a test process: the suite runs in several
# processes at once (pytest-xdist), and these small tensors gain nothing from more.

TOY_N, LEGGED_N = 12, 20
# Seeds and iteration budgets fixed: the comparison holds step sizes equal,
# and at a stationary iterate (step at rounding level) the filter's
# "merit fell" test is a coin toss between the two packages.  The projected
# toy's inner problem is stationary after two iterations, so it gets two.
TOY_SETTINGS = {
    "unprojected": dict(max_iterations=6, project_equalities=False),
    "projected": dict(max_iterations=2),
}
TOY_SEEDS = {"unprojected": 1, "projected": 4}
LEGGED_SETTINGS = dict(max_iterations=4, integrator="rk2")


def _toy_x0(batch, seed=0):
    return (0.5 * np.random.default_rng(seed).standard_normal((3, 2))).astype(np.float32)[:batch]


def _jax_toy_case(kind, batch):
    nu = 1 if kind == "unprojected" else 2
    x0 = _toy_x0(batch, TOY_SEEDS[kind])
    one = lambda x: jsqp.solve(  # noqa: E731
        toy.jax_problem(nu), juniform_grid(0.0, 1.0, TOY_N), x, toy.jax_params(nu),
        settings=jsqp.SqpSettings(**TOY_SETTINGS[kind]))
    ref = jax.jit(one)(jnp.asarray(x0[0])) if batch == 1 else jax.jit(jax.vmap(one))(
        jnp.asarray(x0))
    return dict(x0=x0, sol=ref)


def _toy_case(kind, batch):
    nu = 1 if kind == "unprojected" else 2
    x0 = _toy_x0(batch, TOY_SEEDS[kind])
    mine = sqp.solve(
        toy.torch_problem(nu), uniform_grid(0.0, 1.0, TOY_N), x0 if batch > 1 else x0[0],
        toy.torch_params(nu), settings=sqp.SqpSettings(**TOY_SETTINGS[kind]), device="cpu")
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
    """One compiled program per batch size: the grid and the params are
    arguments, so standing and trot share it."""
    problem = jinterface.make_problem()
    one = lambda x, u, g, p: jsqp.solve(  # noqa: E731
        problem, g, x, p, us_init=u, settings=jsqp.SqpSettings(**LEGGED_SETTINGS))
    return jax.jit(one if batch == 1 else jax.vmap(one, in_axes=(0, None, None, None)))


def _legged_inputs(batch):
    x0 = np.asarray(jmodel.default_state())
    x0s = x0[None] + 1e-2 * np.sin(np.arange(3)[:, None] * np.arange(24)[None, :] + 1.0)
    u0 = np.asarray(jmodel.weight_compensating_input(jnp.ones(4)))
    return x0s.astype(np.float32)[:batch], np.tile(u0[None], (LEGGED_N, 1)).astype(np.float32)


def _jax_legged_case(kind, batch):
    jgrid, _ = _legged_grids(kind)
    x0s, us = _legged_inputs(batch)
    ref = _jax_legged_solve(batch)(
        jnp.asarray(x0s if batch > 1 else x0s[0]), jnp.asarray(us), jgrid,
        jinterface.make_params(jgrid))
    return dict(x0=x0s, sol=ref)


def _legged_case(kind, batch):
    _, tgrid = _legged_grids(kind)
    x0s, us = _legged_inputs(batch)
    mine = sqp.solve(
        interface.make_problem(device="cpu"), tgrid, x0s if batch > 1 else x0s[0],
        interface.make_params(tgrid, device="cpu"), us_init=torch.as_tensor(us),
        settings=sqp.SqpSettings(**LEGGED_SETTINGS), device="cpu")
    return mine, x0s


CASES = {
    "toy_unprojected_b1": (_toy_case, _jax_toy_case, "unprojected", 1),
    "toy_unprojected_b3": (_toy_case, _jax_toy_case, "unprojected", 3),
    "toy_projected_b1": (_toy_case, _jax_toy_case, "projected", 1),
    "toy_projected_b3": (_toy_case, _jax_toy_case, "projected", 3),
    "legged_standing_b1": (_legged_case, _jax_legged_case, "standing", 1),
    "legged_standing_b3": (_legged_case, _jax_legged_case, "standing", 3),
    "legged_trot_b1": (_legged_case, _jax_legged_case, "trot", 1),
    "legged_trot_b3": (_legged_case, _jax_legged_case, "trot", 3),
}
# The solver options that split the work: the associative-scan Riccati and
# the horizon-sharded PIPG (on TOY_SHARDS shards of the CPU: TOY_N divides).
TOY_SHARDS = 4
OPTION_CASES = {
    "parallel_riccati": (dict(parallel_riccati=True), 3),
    "pipg_sharded": (dict(qp_solver="pipg_sharded", pipg_iterations=1000), 1),
}


def _jax_toy_option_case(option):
    from jax.sharding import Mesh

    kw, batch = OPTION_CASES[option]
    if option == "pipg_sharded":
        kw = dict(kw, time_mesh=Mesh(np.asarray(jax.devices()[:TOY_SHARDS]), ("time",)))
    x0 = _toy_x0(batch, TOY_SEEDS["projected"])
    one = lambda x: jsqp.solve(  # noqa: E731
        toy.jax_problem(2), juniform_grid(0.0, 1.0, TOY_N), x, toy.jax_params(2),
        settings=jsqp.SqpSettings(**dict(TOY_SETTINGS["projected"], **kw)))
    ref = jax.jit(one)(jnp.asarray(x0[0])) if batch == 1 else jax.jit(jax.vmap(one))(
        jnp.asarray(x0))
    return dict(x0=x0, sol=ref)


JAX_RECORDS = dict(
    {name: functools.partial(jax_fn, kind, batch)
     for name, (_, jax_fn, kind, batch) in CASES.items()},
    **{f"toy_projected_{option}": functools.partial(_jax_toy_option_case, option)
       for option in OPTION_CASES},
)
RECORDS = Records(__file__)


LEGGED_CASES = [name for name in CASES if name.startswith("legged")]


@functools.lru_cache(maxsize=None)
def _run(name):
    fn, _, kind, batch = CASES[name]
    mine, x0 = fn(kind, batch)
    rec = RECORDS[name]
    np.testing.assert_array_equal(rec["x0"], x0)  # the record solved these starts
    ref = rec["sol"]
    if batch == 1:  # the port's batch of one against the un-vmapped solve
        ref = jax.tree.map(lambda a: a[None], ref)
    return name, batch, mine, ref


@pytest.fixture(scope="module", params=list(CASES))
def case(request):
    return _run(request.param)


def test_iterations_and_convergence_match(case):
    _, batch, mine, ref = case
    assert mine.iterations.shape == (batch,) and mine.iterations.dtype == torch.int32
    assert mine.converged.dtype == torch.bool
    np.testing.assert_array_equal(mine.iterations.numpy(), ref.iterations)
    np.testing.assert_array_equal(mine.converged.numpy(), ref.converged)
    assert int(mine.iterations.min()) >= 1


@pytest.mark.parametrize("field", ["xs", "us"])
def test_trajectories_match(case, field):
    name, _, mine, ref = case
    a, b = getattr(mine, field), getattr(ref, field)
    assert a.dtype == torch.float32 and tuple(a.shape) == b.shape
    if field == "us" and "standing" in name:
        # Standing still, the split of the contact forces between the legs
        # is held only by their 1e-3 weight: after ONE iteration from the same
        # inputs the two float32 solves are 8e-4 (port) and 4e-4 (JAX) from a
        # float64 solve of the same QP.  Forces (|f| to 85 N) get 5e-3; the
        # joint velocities keep the tolerance of every other case.
        np.testing.assert_allclose(a.numpy()[..., :12], b[..., :12], atol=5e-3, rtol=1e-4)
        a, b = a[..., 12:], b[..., 12:]
    np.testing.assert_allclose(a.numpy(), b, atol=1e-3, rtol=1e-4)


def test_step_sizes_match(case):
    _, _, mine, ref = case
    np.testing.assert_array_equal(mine.history.step_size.numpy(), ref.history.step_size)


@pytest.mark.parametrize("field", [f for f in sqp.IterationLog._fields if f != "step_size"])
def test_history_matches_with_nan_padding(case, field):
    _, batch, mine, ref = case
    a, b = getattr(mine.history, field).numpy(), getattr(ref.history, field)
    assert a.shape == b.shape == (batch, mine.history.merit.shape[1])
    np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
    # Violations fall to float32 rounding of the defects (1e-7) when converged.
    np.testing.assert_allclose(a, b, rtol=2e-3, atol=2e-6)


def test_performance_index_matches(case):
    _, _, mine, ref = case
    for f in ("merit", "cost"):
        np.testing.assert_allclose(
            getattr(mine.performance, f).numpy(), getattr(ref.performance, f), rtol=1e-3,
            err_msg=f)
    for f in ("dynamics_violation_sse", "equality_constraints_sse",
              "inequality_constraints_sse"):
        np.testing.assert_allclose(
            getattr(mine.performance, f).numpy(), getattr(ref.performance, f), rtol=2e-2,
            atol=1e-8, err_msg=f)


def test_gains_and_value_function_match(case):
    """Gains are remapped through the projection on both sides; they and the
    cost-to-go are held relative to their own scale (gains reach 1e3)."""
    _, _, mine, ref = case
    for f in ("gains", "value_S", "value_s"):
        b = getattr(ref, f)
        np.testing.assert_allclose(
            getattr(mine, f).numpy(), b, atol=2e-4 * max(1.0, float(np.abs(b).max())),
            rtol=1e-3, err_msg=f)


def test_al_state_matches(case):
    _, _, mine, ref = case
    for a, b in zip(mine.al, ref.al):
        assert tuple(a.shape) == b.shape
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-3, atol=1e-5)


@pytest.mark.parametrize("name", LEGGED_CASES)
def test_accepted_steps_passed_the_filter(name):
    """Every accepted step lowered the merit or the total violation.  (The
    projected legged problem has no AL term, so the merits of two history
    rows are under the same multipliers and compare.)"""
    _, _, mine, _ = _run(name)
    merit, viol, step = (
        getattr(mine.history, f).numpy() for f in ("merit", "total_viol", "step_size"))
    for b in range(merit.shape[0]):
        for i in range(1, int(mine.iterations[b])):
            if step[b, i] > 0:
                assert merit[b, i] < merit[b, i - 1] or viol[b, i] < viol[b, i - 1], (b, i)


@pytest.mark.parametrize("name", LEGGED_CASES)
def test_legged_solution_satisfies_the_projected_equality(name):
    _, _, mine, _ = _run(name)
    _, tgrid = _legged_grids("trot" if "trot" in name else "standing")
    g = tgrid.device("cpu")
    nodes = torch.arange(LEGGED_N)
    p = dict(interface.make_params(tgrid, device="cpu"), mode=g.modes[nodes], node=nodes)
    res = con.foot_constraint(g.times[:-1], mine.xs[:, :-1], mine.us, p)
    assert float(res.abs().max()) < 1e-3


# -- behaviour of the batch-first loop ----------------------------------------


def _solve_toy(x0, kind="projected", **kw):
    nu = 1 if kind == "unprojected" else 2
    settings = sqp.SqpSettings(**dict(TOY_SETTINGS[kind], **kw.pop("settings", {})))
    return sqp.solve(
        toy.torch_problem(nu), uniform_grid(0.0, 1.0, TOY_N), x0, toy.torch_params(nu),
        settings=settings, device="cpu", **kw)


def test_convexify_runs_on_the_toy_and_not_on_the_legged_problem():
    from ocs2_tpu_torch.solvers.al import augment_problem

    assert not augment_problem(toy.torch_problem(1)).cost_structure_psd
    assert augment_problem(
        interface.make_problem(device="cpu"), project_equalities=True).cost_structure_psd
    a = _solve_toy(_toy_x0(2), "unprojected")
    b = _solve_toy(_toy_x0(2), "unprojected", settings=dict(hessian_correction="gershgorin"))
    assert torch.isfinite(b.xs).all() and not torch.equal(a.xs, b.xs)


def test_frozen_scenario_equals_solving_it_alone():
    """A scenario that finishes early is frozen while the others go on."""
    x0s = _toy_x0(3, seed=0)
    st = dict(max_iterations=8)
    mixed = _solve_toy(x0s, settings=st)
    alone = _solve_toy(x0s[0:1], settings=st, force_plain_riccati=True)
    assert int(mixed.iterations[0]) == int(alone.iterations[0])
    assert int(mixed.iterations[0]) < int(mixed.iterations.max())
    assert bool(mixed.converged[0]) and bool(alone.converged[0])
    for f in ("xs", "us", "gains", "value_S", "value_s"):
        np.testing.assert_allclose(
            getattr(mixed, f)[0].numpy(), getattr(alone, f)[0].numpy(), atol=1e-5, rtol=2e-5,
            err_msg=f)
    np.testing.assert_array_equal(
        np.isnan(mixed.history.merit[0].numpy()), np.isnan(alone.history.merit[0].numpy()))


def test_single_and_plain_riccati_routes_agree_at_batch_one():
    """B = 1 takes the NaN-on-failure sweep, force_plain_riccati the clamped
    entry form; on a positive-definite problem they give the same solve."""
    a = _solve_toy(_toy_x0(1)[0])
    b = _solve_toy(_toy_x0(1), force_plain_riccati=True)
    assert a.xs.shape == (1, TOY_N + 1, 2)
    np.testing.assert_array_equal(a.iterations.numpy(), b.iterations.numpy())
    np.testing.assert_allclose(a.xs.numpy(), b.xs.numpy(), atol=1e-5)
    np.testing.assert_allclose(a.us.numpy(), b.us.numpy(), atol=1e-4)


def test_force_single_riccati_is_the_cpu_route_at_batch_one_and_refuses_a_batch():
    """The hook that holds the card's B = 1 kernel route against the
    single-scenario sweep: on the CPU that sweep is the B = 1 route already,
    so the solve is the same bit for bit; a larger batch is refused."""
    a = _solve_toy(_toy_x0(1))
    b = _solve_toy(_toy_x0(1), force_single_riccati=True)
    np.testing.assert_array_equal(a.iterations.numpy(), b.iterations.numpy())
    np.testing.assert_array_equal(a.xs.numpy(), b.xs.numpy())
    np.testing.assert_array_equal(a.us.numpy(), b.us.numpy())
    with pytest.raises(ValueError, match="batch of one"):
        _solve_toy(_toy_x0(2), force_single_riccati=True)


def test_non_finite_step_is_rejected_and_grows_the_regularization():
    """An indefinite reduced Hessian at B = 1 gives NaN from the sweep: the
    step is zeroed, the line search rejects, reg grows tenfold, and the
    iterate stays where it was."""
    from ocs2_tpu_torch.oc.problem import OptimalControlProblem, quadratic_cost

    problem = OptimalControlProblem(
        dynamics=lambda t, x, u, p: torch.cat([x[..., 1:2], u[..., 0:1]], dim=-1),
        cost_terms=(quadratic_cost(np.eye(2), -np.eye(1), device="cpu"),),
        nx=2, nu=1,
    )
    sol = sqp.solve(
        problem, uniform_grid(0.0, 1.0, 4), np.float32([0.3, 0.0]), toy.torch_params(1),
        settings=sqp.SqpSettings(max_iterations=3, convexify=False), device="cpu")
    assert int(sol.iterations[0]) == 3 and not bool(sol.converged[0])
    np.testing.assert_array_equal(sol.history.step_size.numpy(), np.zeros((1, 3), np.float32))
    np.testing.assert_allclose(sol.history.reg.numpy(), [[1e-6, 1e-5, 1e-4]], rtol=1e-5)
    np.testing.assert_array_equal(sol.xs[0].numpy(), np.tile(np.float32([0.3, 0.0]), (5, 1)))
    assert torch.isfinite(sol.us).all()


def test_initial_guesses_broadcast_and_pin_the_first_state():
    x0s = _toy_x0(2)
    us = np.full((TOY_N, 2), 0.05, np.float32)
    xs = np.zeros((TOY_N + 1, 2), np.float32)
    a = _solve_toy(x0s, us_init=torch.as_tensor(us), xs_init=torch.as_tensor(xs))
    b = _solve_toy(x0s, us_init=torch.as_tensor(np.stack([us, us])),
                   xs_init=torch.as_tensor(np.stack([xs, xs])))
    np.testing.assert_array_equal(a.xs.numpy(), b.xs.numpy())
    np.testing.assert_array_equal(a.xs[:, 0].numpy(), x0s)


@pytest.mark.parametrize("option", list(OPTION_CASES))
def test_parallel_options_match_the_reference(option):
    """The projected toy with the associative-scan Riccati (a batch of three,
    against ``jax.vmap``) and with the horizon-sharded PIPG (4 shards on the
    CPU, against the JAX package's solve on a 4-device time mesh of the CPU):
    iterations, ``xs`` and ``us`` as in the solves above (1e-3 + 1e-4
    |value|)."""
    from ocs2_tpu_torch.parallel.mesh import make_mesh

    kw, batch = OPTION_CASES[option]
    if option == "pipg_sharded":
        kw = dict(kw, time_mesh=make_mesh(["cpu"] * TOY_SHARDS, "time"))
    x0 = _toy_x0(batch, TOY_SEEDS["projected"])
    mine = _solve_toy(x0 if batch > 1 else x0[0], settings=kw)
    rec = RECORDS[f"toy_projected_{option}"]
    np.testing.assert_array_equal(rec["x0"], x0)  # the record solved these starts
    ref = rec["sol"] if batch > 1 else jax.tree.map(lambda a: a[None], rec["sol"])
    np.testing.assert_array_equal(mine.iterations.numpy(), ref.iterations)
    for field in ("xs", "us"):
        np.testing.assert_allclose(getattr(mine, field).numpy(), getattr(ref, field),
                                   atol=1e-3, rtol=1e-4, err_msg=field)


def test_qp_solver_pipg_solves_the_projected_toy():
    """``qp_solver="pipg"`` (Ruiz + PIPG in place of the Riccati sweep) runs
    the projected toy to the Riccati route's inputs within
    tests/test_pipg.py's 5e-2, with NaN for the value function it does not
    compute; an unknown back end is refused.  (Parity with the JAX package:
    tests/test_torch_pipg.py.)"""
    x0 = _toy_x0(2)
    ref = _solve_toy(x0)
    sol = _solve_toy(x0, settings=dict(qp_solver="pipg", pipg_iterations=1000))
    np.testing.assert_allclose(sol.us.numpy(), ref.us.numpy(), atol=5e-2)
    assert bool(torch.isnan(sol.value_S).all()) and bool(torch.isnan(sol.value_s).all())
    with pytest.raises(ValueError, match="qp_solver"):
        _solve_toy(x0, settings=dict(qp_solver="osqp"))


def test_bad_inputs_raise():
    with pytest.raises(ValueError, match="x0"):
        _solve_toy(np.zeros((1, 1, 2), np.float32))
    with pytest.raises(TypeError, match="dict"):
        sqp.solve(toy.torch_problem(2), uniform_grid(0.0, 1.0, 4), np.zeros(2, np.float32),
                  None, device="cpu")


def test_defects_match_jax():
    jgrid, tgrid = _legged_grids("trot")
    rng = np.random.default_rng(3)
    xs = (np.asarray(jmodel.default_state())[None]
          + 0.05 * rng.standard_normal((LEGGED_N + 1, 24))).astype(np.float32)
    _, us = _legged_inputs(1)
    ref = jsqp._defects(jinterface.make_problem(), jgrid, jnp.asarray(xs), jnp.asarray(us),
                        jinterface.make_params(jgrid), "rk2", 2)
    cand = torch.as_tensor(np.stack([xs, xs]))[None]  # [1, 2, N+1, nx]
    mine = sqp._defects(
        interface.make_problem(device="cpu"), tgrid, cand,
        torch.as_tensor(us).expand(1, 2, LEGGED_N, 24),
        interface.make_params(tgrid, device="cpu"), "rk2", 2)
    assert mine.shape == (1, 2, LEGGED_N, 24)
    np.testing.assert_allclose(mine[0, 1].numpy(), np.asarray(ref), rtol=2e-4, atol=1e-5)
    # Jump transitions (dt = 0) leave the state where it was.
    jumps = np.asarray(tgrid.is_jump) > 0
    np.testing.assert_allclose(
        mine[0, 0].numpy()[jumps], (xs[:-1] - xs[1:])[jumps], atol=1e-6)


def test_sqp_solution_from_numpy(case):
    _, batch, mine, ref = case
    rec = {k: (v._asdict() if hasattr(v, "_asdict") else v) for k, v in ref._asdict().items()}
    sol = convert.sqp_solution_from_numpy(rec, device="cpu")
    assert isinstance(sol, sqp.SqpSolution) and isinstance(sol.history, sqp.IterationLog)
    assert sol.iterations.dtype == torch.int32 and sol.converged.dtype == torch.bool
    assert sol.xs.dtype == torch.float32 and sol.xs.shape == mine.xs.shape
    np.testing.assert_array_equal(sol.history.step_size.numpy(), ref.history.step_size)


def test_entry_point_defaults_to_the_card():
    import inspect

    for fn in (sqp.solve, interface.make_problem, interface.make_params, interface.default_target,
               model.default_state, model.weight_compensating_input,
               convert.sqp_solution_from_numpy, convert.projection_from_numpy):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn
