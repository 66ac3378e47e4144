"""The port's segmented-planes perceptive stack vs the JAX package on the
CPU: the convex planar decomposition of the elevation map, the polygon
queries, the host foothold planner, the in-solver terms of the segmented
perceptive problem with its motion-tracking options, an SQP solve, and a
short closed loop through ``Mpc`` + ``PerceptiveReferenceManager``.

Maps, states and targets come from numpy seeds or from the perceptive lane's
settings (``bench.py:287``); the JAX side is jitted with the grid and params
as arguments.  Tolerances: the decomposition exactly equal; the foothold
plan's eight arrays within 1e-5; pure query values within rtol 1e-4 /
atol 1e-5; LQ coefficients and trajectory metrics rtol 1e-4 / atol 1e-5
times the leaf's largest entry (as in ``test_torch_legged_model.py``);
solves with equal iteration counts, ``xs`` / ``us`` within
1e-3 + 1e-4 |value|.

The JAX package's LQ approximation, trajectory metrics, solves and closed
loop (``JAX_RECORDS``; XLA takes minutes to compile them) are stored in
``tests/torch_data/test_torch_segmented_planes_jax.npz`` by
``tools/torch_test_records.py --record test_torch_segmented_planes``; the
port runs live on the same inputs.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ocs2_tpu.core.reference import TargetTrajectories as JTargetTrajectories
from ocs2_tpu.models.legged_robot import foothold_planner as jfp
from ocs2_tpu.models.legged_robot import model as jmodel
from ocs2_tpu.models.legged_robot import segmented_planes as jsp
from ocs2_tpu.models.legged_robot.gait import GaitSchedule as JGaitSchedule
from ocs2_tpu.models.legged_robot.gait import trot_gait as jtrot_gait
from ocs2_tpu.models.legged_robot.terrain import ElevationMap as JElevationMap
from ocs2_tpu.mpc import mpc as jmpc
from ocs2_tpu.mpc import mrt as jmrt
from ocs2_tpu.oc import approx as japprox
from ocs2_tpu.oc import metrics as jmetrics
from ocs2_tpu.oc.time_discretization import make_time_grid as jmake_time_grid
from ocs2_tpu.solvers import sqp as jsqp

from ocs2_tpu_torch import convert
from ocs2_tpu_torch.models.legged_robot import foothold_planner as fp
from ocs2_tpu_torch.models.legged_robot import model
from ocs2_tpu_torch.models.legged_robot import segmented_planes as sp
from ocs2_tpu_torch.models.legged_robot.gait import GaitSchedule, trot_gait
from ocs2_tpu_torch.models.legged_robot.terrain import ElevationMap
from ocs2_tpu_torch.mpc.mpc import Mpc, MpcSettings
from ocs2_tpu_torch.mpc.mrt import MpcMrtInterface, dummy_loop
from ocs2_tpu_torch.oc import approx, metrics
from ocs2_tpu_torch.oc.time_discretization import make_time_grid
from ocs2_tpu_torch.solvers import sqp
from tools._records import Records

torch.set_num_threads(1)  # one intra-op thread a test process: the suite runs in several
# processes at once (pytest-xdist), and these small tensors gain nothing from more.

RTOL, ATOL = 1e-4, 1e-5
PLAN_ATOL = 1e-5
SOLVE_ATOL, SOLVE_RTOL = 1e-3, 1e-4
N, HORIZON = 14, 0.7  # one trot cycle
SQP_SETTINGS = dict(max_iterations=3, integrator="rk2")
LOOP = dict(horizon=0.4, n=16, duration=0.4, mrt_frequency=60.0, mpc_frequency=15.0,
            max_iterations=6)


def close(mine, ref, rtol=RTOL, atol=ATOL):
    mine = mine.detach().cpu().numpy() if isinstance(mine, torch.Tensor) else np.asarray(mine)
    np.testing.assert_allclose(mine, np.asarray(ref), rtol=rtol, atol=atol)


def close_solve(mine, ref):
    close(mine, ref, SOLVE_RTOL, SOLVE_ATOL)


def T(a):
    return torch.as_tensor(np.array(a))


def np_tree(rec):
    return jax.tree.map(np.asarray, rec)._asdict()


# -- maps ----------------------------------------------------------------------


def stepped(step_x=0.45, high=0.12, extent=4.0, res=0.05):
    n = int(extent / res)
    h = np.zeros((n, n), np.float32)
    xs = -extent / 2 + (np.arange(n) + 0.5) * res
    h[xs > step_x, :] = high
    return h, (-extent / 2, -extent / 2), res


def sloped(grade=0.3, extent=2.0, res=0.05):
    n = int(extent / res)
    xs = (np.arange(n) + 0.5) * res
    return np.broadcast_to(grade * xs[:, None], (n, n)).astype(np.float32), (0.0, 0.0), res


def rough(extent=3.0, res=0.05):
    """Two levels, a ramp between them and 4 mm of seeded noise: many
    components, hulls to simplify."""
    n = int(extent / res)
    xs = -extent / 2 + (np.arange(n) + 0.5) * res
    h = np.where(xs[:, None] > 0.3, 0.1, 0.0) + np.where(
        np.abs(xs[None, :]) < 0.4, 0.15 * np.clip(xs[:, None] + 0.5, 0, 0.4), 0.0)
    h = h + 0.004 * np.random.default_rng(9).standard_normal((n, n))
    return h.astype(np.float32), (-extent / 2, -extent / 2), res


MAPS = {"step_012": stepped(), "step_008": stepped(high=0.08), "slope": sloped(),
        "rough": rough()}


@functools.lru_cache(maxsize=None)
def maps(name):
    h, origin, res = MAPS[name]
    return (JElevationMap.create(h, origin_xy=origin, resolution=res),
            ElevationMap.create(h, origin_xy=origin, resolution=res, device="cpu"))


@functools.lru_cache(maxsize=None)
def terrains(name, **kw):
    jem, em = maps(name)
    return jsp.decompose_planes(jem, **dict(kw)), sp.decompose_planes(em, device="cpu", **dict(kw))


# -- decomposition ---------------------------------------------------------------

DECOMPOSITIONS = [
    ("step_012", {}), ("step_008", {}), ("slope", {}), ("rough", {}),
    ("step_012", {"max_vertices": 6}), ("rough", {"max_segments": 8, "max_vertices": 5}),
    ("step_008", {"margin": 0.05}),
]


@pytest.mark.parametrize("name, kw", DECOMPOSITIONS,
                         ids=[f"{n}-{'-'.join(f'{k}{v}' for k, v in kw.items()) or 'default'}"
                              for n, kw in DECOMPOSITIONS])
def test_decompose_planes_is_exactly_equal(name, kw):
    ref, mine = terrains(name, **kw)
    for field, a, b in zip(ref._fields, mine, ref):
        b = np.asarray(b)
        assert a.dtype == torch.from_numpy(b.copy()).dtype, field
        np.testing.assert_array_equal(a.numpy(), b, err_msg=field)
    assert int(mine.valid.sum()) >= 1


def test_step_gives_two_level_segments():
    _, terr = terrains("step_008")
    assert int(terr.valid.sum()) == 2
    zs = sorted(float(terr.plane_point[k, 2]) for k in range(2))
    assert zs[0] == pytest.approx(0.0, abs=5e-3) and zs[1] == pytest.approx(0.08, abs=5e-3)


def test_terrain_from_numpy_and_host_mirror():
    ref, mine = terrains("rough")
    back = convert.segmented_planes_terrain_from_numpy(np_tree(ref), device="cpu")
    for a, b in zip(back, mine):
        assert a.dtype == b.dtype and torch.equal(a, b)
    host = mine.to_numpy()
    assert all(isinstance(v, np.ndarray) for v in host)
    for a, b in zip(host.to("cpu"), mine):
        assert torch.equal(a, b)


# -- polygon queries -------------------------------------------------------------


def square():
    b = np.array([[0, 0], [1, 0], [1, 1], [0, 1], [0, 1], [0, 1]], np.float32)
    return b, np.int32(4)


def test_project_to_polygon_2d_matches():
    b, nv = square()
    pts = np.concatenate([np.array([[0.5, 0.5], [1.5, 0.5], [-1.0, -1.0], [0.2, 0.9]],
                                   np.float32),
                          np.random.default_rng(1).uniform(-1, 2, (60, 2)).astype(np.float32)])
    sq_ref, img_ref = jax.jit(jax.vmap(jsp.project_to_polygon_2d, (None, None, 0)))(
        jnp.asarray(b), jnp.asarray(nv), jnp.asarray(pts))
    sq, img = sp.project_to_polygon_2d(T(b), T(nv), T(pts))
    close(sq, sq_ref)
    close(img, img_ref)
    assert float(sq[0]) == pytest.approx(-0.25, abs=1e-6)
    close(img[2], [0.0, 0.0])


def test_closest_segment_and_distances_match():
    ref, mine = terrains("rough")
    pts = np.random.default_rng(2).uniform([-1.4, -1.4, -0.05], [1.4, 1.4, 0.2], (80, 3)).astype(
        np.float32)
    pen = np.random.default_rng(3).uniform(0, 0.01, ref.valid.shape).astype(np.float32)
    k_ref, p_ref, d_ref = jax.jit(jax.vmap(lambda p: (
        *jsp.closest_segment(ref, p, jnp.asarray(pen)), jsp.segment_distances(ref, p))))(
        jnp.asarray(pts))
    k, proj = sp.closest_segment(mine, T(pts), T(pen))
    np.testing.assert_array_equal(k.numpy(), np.asarray(k_ref))
    close(proj, p_ref)
    close(sp.segment_distances(mine, T(pts)), d_ref)


def test_host_closest_segment_agrees_with_the_tensor_query():
    _, mine = terrains("step_012")
    rng = np.random.default_rng(0)
    for _ in range(10):
        p = np.array([rng.uniform(-1.5, 1.5), rng.uniform(-1.5, 1.5), 0.02])
        k_np, proj_np = fp._closest_segment_np(mine, p)
        k, proj = sp.closest_segment(mine, torch.as_tensor(p, dtype=torch.float32))
        assert int(k) == k_np
        close(proj, proj_np, 0, 1e-4)


@pytest.mark.parametrize("margin", [0.0, 0.07])
def test_tangential_constraint_matches(margin):
    ref, mine = terrains("rough")
    ks = np.flatnonzero(np.asarray(ref.valid))
    A_ref, b_ref = jax.jit(jax.vmap(lambda k: jsp.tangential_constraint(ref, k, margin)))(
        jnp.asarray(ks))
    A, b = sp.tangential_constraint(mine, T(ks), margin)
    close(A, A_ref)
    close(b, b_ref, atol=ATOL * 1e6)  # padded rows hold BIG = 1e6
    for k in ks:
        A_h, b_h = fp._tangential_rows_np(mine, int(k), margin)
        real = np.arange(A_h.shape[0]) < int(mine.num_vertices[k])
        close(A[list(ks).index(k)][real], A_h[real])
        close(b[list(ks).index(k)][real], b_h[real], 0, 1e-4)


def test_project_to_segment_lands_on_plane():
    ref, mine = terrains("slope")
    p = np.array([[1.0, 1.0, 0.9], [0.3, 1.7, 0.0]], np.float32)
    proj = sp.project_to_segment(mine, torch.tensor(0), T(p))
    proj_ref = jax.jit(jax.vmap(lambda q: jsp.project_to_segment(ref, jnp.asarray(0), q)))(
        jnp.asarray(p))
    close(proj, proj_ref)
    n, pt = mine.plane_normal[0].numpy(), mine.plane_point[0].numpy()
    assert np.abs((proj.numpy() - pt) @ n).max() < 1e-4


def test_kinematic_penalty_matches():
    st = fp.FootholdPlannerSettings()
    hip = np.array([0.3, 0.2, model.STAND_HEIGHT])
    rot = np.array([[0.8, -0.6, 0.0], [0.6, 0.8, 0.0], [0.0, 0.0, 1.0]])
    for leg in range(4):
        for foot in (hip - [0, 0, 0.45], hip - [0, 0, 0.8], hip + [0, -0.25, -0.45],
                     hip + [0.1, 0.25, -0.3]):
            assert fp.compute_kinematic_penalty_np(
                foot, hip, rot, leg, st.max_leg_extension, st.kinematic_penalty_weight
            ) == jfp.compute_kinematic_penalty_np(
                foot, hip, rot, leg, st.max_leg_extension, st.kinematic_penalty_weight)


# -- the foothold planner ----------------------------------------------------------


def trot_grids(t0, horizon, n):
    ms = JGaitSchedule(jtrot_gait(0.7)).mode_schedule(t0, t0 + horizon)
    kw = dict(event_times=np.asarray(ms.event_times), mode_sequence=np.asarray(ms.mode_sequence))
    return jmake_time_grid(t0, t0 + horizon, n, **kw), make_time_grid(t0, t0 + horizon, n, **kw)


def walk_target(horizon, high, goal_x=0.85):
    """The perceptive lane's target: 0.6 m/s forward, onto the step."""
    x0 = jmodel.default_state()
    u0 = jmodel.weight_compensating_input(jnp.ones(4))
    x_goal = x0.at[6].set(goal_x).at[8].set(jmodel.STAND_HEIGHT + high)
    ref = JTargetTrajectories.create(times=[0.0, horizon],
                                     states=jnp.stack([x0.at[0].set(0.6), x_goal.at[0].set(0.6)]),
                                     inputs=jnp.stack([u0, u0]))
    return ref, convert.target_trajectories_from_numpy(np_tree(ref), device="cpu")


def stand_target(horizon):
    x0 = jmodel.default_state()
    u0 = jmodel.weight_compensating_input(jnp.ones(4))
    ref = JTargetTrajectories.create(times=[0.0, horizon], states=jnp.stack([x0, x0]),
                                     inputs=jnp.stack([u0, u0]))
    return ref, convert.target_trajectories_from_numpy(np_tree(ref), device="cpu")


def start_state(seed):
    x = np.asarray(jmodel.default_state()).copy()
    if seed is not None:
        x = x + 0.01 * np.random.default_rng(seed).standard_normal(24).astype(np.float32)
        x[6] += 0.2
    return x.astype(np.float32)


# (map, t0, horizon, N, start-state seed, settings): the lane's plan, a plan
# mid-gait from a perturbed state, and one with a terrain margin.
PLANS = {
    "lane_n46": ("step_012", 0.0, 1.4, 46, None, {}),
    "loop_n32_midgait": ("step_008", 0.45, 1.0, 32, 4, {}),
    "rough_margin": ("rough", 0.2, 0.7, 14, 5, {"terrain_margin": 0.03, "swing_height": 0.1}),
}


@functools.lru_cache(maxsize=None)
def plans(case):
    name, t0, horizon, n, seed, kw = PLANS[case]
    jterr, terr = terrains(name)
    jem, em = maps(name)
    jg, tg = trot_grids(t0, horizon, n)
    jtarget, target = walk_target(t0 + horizon, 0.12)
    x0 = start_state(seed)
    ref = jfp.plan_footholds(jterr, jem, np.asarray(jg.times), np.asarray(jg.modes),
                             jnp.asarray(x0), jtarget, jfp.FootholdPlannerSettings(**kw))
    mine = fp.plan_footholds(terr, em, tg.times, tg.modes, torch.as_tensor(x0), target,
                             fp.FootholdPlannerSettings(**kw))
    return mine, ref, tg


@pytest.mark.parametrize("case", list(PLANS))
@pytest.mark.parametrize("field", fp.FootholdPlan._fields)
def test_plan_footholds_matches(case, field):
    mine, ref, tg = plans(case)
    a, b = getattr(mine, field), np.asarray(getattr(ref, field))
    assert isinstance(a, np.ndarray) and a.dtype == np.float32 and a.shape == b.shape
    assert a.shape[0] == len(tg.times)
    np.testing.assert_allclose(a, b, rtol=0, atol=PLAN_ATOL)


def test_plan_from_host_mirrors_equals_plan_from_device_arrays():
    """The reference manager plans from host mirrors made once; the result is
    the plan of the device arrays."""
    mine, _, tg = plans("lane_n46")
    _, terr = terrains("step_012")
    _, em = maps("step_012")
    _, target = walk_target(1.4, 0.12)
    host_target = target._replace(times=target.times.numpy(), states=target.states.numpy())
    again = fp.plan_footholds(terr.to_numpy(), ElevationMap(*(v.numpy() for v in em)), tg.times,
                              tg.modes, start_state(None), host_target)
    for a, b in zip(again, mine):
        np.testing.assert_array_equal(a, b)


def test_plan_to_params_is_one_copy():
    mine, ref, _ = plans("lane_n46")
    _, target = walk_target(1.4, 0.12)
    params = fp.plan_to_params(mine, {"target": target, "other": torch.zeros(2)})
    storage = {params[k].untyped_storage().data_ptr() for k in fp.PLAN_KEYS}
    assert len(storage) == 1
    for key, field in zip(fp.PLAN_KEYS, fp.FootholdPlan._fields):
        assert params[key].dtype == torch.float32
        np.testing.assert_array_equal(params[key].numpy(), getattr(mine, field))
    # The JAX package's plan, carried across, merges the same way.
    carried = fp.plan_to_params(convert.foothold_plan_from_numpy(np_tree(ref), device="cpu"),
                                {"target": target})
    for key in fp.PLAN_KEYS:
        close(carried[key], params[key], 0, PLAN_ATOL)


def test_make_perceptive_params_matches():
    jterr, terr = terrains("step_012")
    jem, em = maps("step_012")
    jg, tg = trot_grids(0.0, 1.4, 46)
    jtarget, target = walk_target(1.4, 0.12)
    x0 = start_state(None)
    ref = jfp.make_perceptive_params(jg, jterr, jem, jnp.asarray(x0), jtarget)
    mine = fp.make_perceptive_params(tg, terr, em, torch.as_tensor(x0), target, device="cpu")
    carried = convert.params_from_numpy(
        {k: (np_tree(v) if k == "target" else np.asarray(v)) for k, v in ref.items()},
        device="cpu")
    assert set(carried) == set(mine)
    for key in mine:
        if key == "target":
            continue
        close(mine[key], carried[key], 0, PLAN_ATOL)


def test_comkino_model_type_is_not_ported():
    """The segmented problem on the ComKino model carries the kinodynamic
    flow map; an unknown model type raises."""
    from ocs2_tpu_torch.models.legged_robot import comkino

    problem = fp.make_segmented_perceptive_problem(model_type="comkino", device="cpu")
    assert problem.dynamics is comkino.dynamics
    with pytest.raises(ValueError, match="model_type"):
        fp.make_segmented_perceptive_problem(model_type="kino", device="cpu")


# -- the in-solver terms through approximate_lq and evaluate_trajectory --------------

OPTIONS = dict(motion_tracking=True, torque_limits=True, collision_avoidance=True)


def lq_setup():
    jterr, terr = terrains("step_012")
    jem, em = maps("step_012")
    jg, tg = trot_grids(0.0, HORIZON, N)
    jtarget, target = walk_target(HORIZON, 0.12)
    x0 = start_state(None)
    jparams = jfp.make_perceptive_params(jg, jterr, jem, jnp.asarray(x0), jtarget)
    params = fp.make_perceptive_params(tg, terr, em, torch.as_tensor(x0), target, device="cpu")
    # The collision term's elevation grid and the motion-tracking foot
    # references, as params.
    rng = np.random.default_rng(10)
    extra = dict(em_heights=np.asarray(jem.heights), em_origin=np.asarray(jem.origin_xy),
                 em_res=np.asarray(jem.resolution),
                 mt_foot_pos_ref=(np.asarray(jmodel.foot_positions_world(jmodel.default_state()))
                                  + 0.01 * rng.standard_normal((4, 3))).astype(np.float32))
    jparams = dict(jparams, **{k: jnp.asarray(v) for k, v in extra.items()})
    params = dict(params, **{k: T(v) for k, v in extra.items()})
    rng = np.random.default_rng(11)
    xs = (x0[None] + 0.02 * rng.standard_normal((N + 1, 24))).astype(np.float32)
    xs[:, 6] += np.linspace(0.0, 0.4, N + 1)
    us = (np.asarray(jmodel.weight_compensating_input(jnp.ones(4)))[None]
          + 5.0 * rng.standard_normal((N, 24))).astype(np.float32)
    return jg, tg, jparams, params, xs, us


def _jax_segmented_lq():
    jg, _, jparams, _, xs, us = lq_setup()
    jprob = jfp.make_segmented_perceptive_problem(**OPTIONS)
    return jax.jit(lambda x, u, g, p: japprox.approximate_lq(jprob, g, x, u, p, method="rk2"))(
        jnp.asarray(xs), jnp.asarray(us), jg, jparams)


def _jax_segmented_metrics():
    jg, _, jparams, _, xs, us = lq_setup()
    jprob = jfp.make_segmented_perceptive_problem(**OPTIONS)
    return jax.jit(lambda x, u, g, p: jmetrics.evaluate_trajectory(jprob, g, x, u, p))(
        jnp.asarray(xs), jnp.asarray(us), jg, jparams)


@pytest.fixture(scope="module")
def segmented_lq():
    _, tg, _, params, xs, us = lq_setup()
    ref = RECORDS["segmented_lq"]
    prob = fp.make_segmented_perceptive_problem(device="cpu", **OPTIONS)
    mine = approx.approximate_lq(prob, tg, T(xs)[None], T(us)[None], params, method="rk2")
    return mine, ref


LQ_LEAVES = [("cost", f) for f in ("f", "dfdx", "dfdu", "dfdxx", "dfdux", "dfduu")] + [
    ("dynamics", f) for f in ("f", "dfdx", "dfdu")] + [("eq", f) for f in ("f", "dfdx", "dfdu")]


@pytest.mark.parametrize("leaf", LQ_LEAVES, ids=lambda lf: ".".join(lf))
def test_segmented_problem_lq_matches(segmented_lq, leaf):
    mine, ref = segmented_lq
    a = getattr(getattr(mine, leaf[0]), leaf[1])[0]
    b = np.asarray(getattr(getattr(ref, leaf[0]), leaf[1]))
    assert a.shape == b.shape and a.dtype == torch.float32
    close(a, b, atol=ATOL * max(1.0, float(np.abs(b).max())))


def test_segmented_problem_metrics_match():
    """The batch path of every term (scenarios and nodes as leading dims)."""
    _, tg, _, params, xs, us = lq_setup()
    ref = RECORDS["segmented_metrics"]
    mine = metrics.evaluate_trajectory(fp.make_segmented_perceptive_problem(device="cpu",
                                                                            **OPTIONS),
                                       tg, T(xs)[None].expand(2, -1, -1),
                                       T(us)[None].expand(2, -1, -1), params)
    assert mine.g_eq.shape == (2, N, 12) and torch.equal(mine.cost[0], mine.cost[1])
    mine = mine._replace(cost=mine.cost[0], g_eq=mine.g_eq[0])
    close(mine.cost, ref.cost)
    close(mine.g_eq, ref.g_eq, atol=ATOL * max(1.0, float(np.abs(np.asarray(ref.g_eq)).max())))


# -- an SQP solve ----------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _jax_segmented_solve():
    """One program for both targets: the grid and the params are arguments."""
    jprob = jfp.make_segmented_perceptive_problem()
    return jax.jit(lambda x, u, g, p: jsqp.solve(
        jprob, g, x, p, us_init=u, settings=jsqp.SqpSettings(**SQP_SETTINGS)))


def _solve_inputs(kind):
    """The segmented problem at N = 14 over one trot cycle on the lane's map,
    from the default state, a fixed budget of 3 iterations; the target
    stands (trot in place, the front feet 0.15 m from the step edge) or is
    the lane's walk onto the step."""
    jg, tg = trot_grids(0.0, HORIZON, N)
    jtarget, target = stand_target(HORIZON) if kind == "stand" else walk_target(HORIZON, 0.12)
    u0 = np.asarray(jmodel.weight_compensating_input(jnp.ones(4)))
    return jg, tg, jtarget, target, start_state(None), np.tile(u0[None], (N, 1)).astype(np.float32)


def _jax_segmented_solve_of(kind):
    jterr, _ = terrains("step_012")
    jem, _ = maps("step_012")
    jg, _, jtarget, _, x0, us = _solve_inputs(kind)
    return _jax_segmented_solve()(
        jnp.asarray(x0), jnp.asarray(us), jg,
        jfp.make_perceptive_params(jg, jterr, jem, jnp.asarray(x0), jtarget))


@functools.lru_cache(maxsize=None)
def segmented_solve(kind):
    _, terr = terrains("step_012")
    _, em = maps("step_012")
    _, tg, _, target, x0, us = _solve_inputs(kind)
    ref = RECORDS[f"segmented_solve_{kind}"]
    params = fp.make_perceptive_params(tg, terr, em, torch.as_tensor(x0), target, device="cpu")
    mine = sqp.solve(fp.make_segmented_perceptive_problem(device="cpu"), tg, torch.as_tensor(x0),
                     params, us_init=T(us), settings=sqp.SqpSettings(**SQP_SETTINGS),
                     device="cpu")
    return mine, ref


def test_segmented_solve_matches():
    mine, ref = segmented_solve("stand")
    assert int(mine.iterations[0]) == int(ref.iterations) == SQP_SETTINGS["max_iterations"]
    close_solve(mine.xs[0], ref.xs)
    close_solve(mine.us[0], ref.us)
    close(mine.history.step_size[0], ref.history.step_size, 0, 0)
    close(mine.performance.merit[0], ref.performance.merit, 1e-4, 1e-6)


def test_segmented_solve_holds_the_contact_constraint():
    mine, ref = segmented_solve("stand")
    assert bool(torch.isfinite(mine.xs).all()) and bool(torch.isfinite(mine.us).all())
    sse, ref_sse = float(mine.performance.equality_constraints_sse[0]), float(
        ref.performance.equality_constraints_sse)
    assert sse < 1e-4 and sse <= 2.0 * ref_sse + 1e-8, (sse, ref_sse)


# The walk onto the step from standing: the first iterations move the forces
# by hundreds of newtons, and the result is sensitive to float32 rounding in
# the JAX package itself: its one solve and the same solve inside jax.vmap
# differ by 0.11 N in us (tools/perceptive_reference.py --witness).  Held:
# equal iterations, step sizes and merits, xs within 1e-3 + 1e-4 |value|,
# us within twice the JAX package's own spread.
WALK_US_ATOL = 0.25


def test_walking_solve_matches_within_the_references_own_spread():
    mine, ref = segmented_solve("walk")
    assert int(mine.iterations[0]) == int(ref.iterations) == SQP_SETTINGS["max_iterations"]
    close(mine.history.step_size[0], ref.history.step_size, 0, 0)
    close(mine.performance.merit[0], ref.performance.merit, 1e-3, 1e-6)
    close_solve(mine.xs[0], ref.xs)
    close(mine.us[0], ref.us, 0, WALK_US_ATOL)


# -- the closed loop -----------------------------------------------------------------


def _loop_inputs():
    """``dummy_loop`` over the segmented perceptive MPC in both packages: the
    0.08 m step, a 0.4 m/s forward target, N = 16 over 0.4 s, 15 Hz MPC,
    60 Hz control, 0.4 s (6 ticks)."""
    x_t = jmodel.default_state().at[0].set(0.4)
    u0 = jmodel.weight_compensating_input(jnp.ones(4))
    jtgt = JTargetTrajectories.create(
        times=[0.0, 4.0], states=jnp.stack([x_t, x_t.at[6].set(1.6).at[8].set(
            jmodel.STAND_HEIGHT + 0.08)]), inputs=jnp.stack([u0, u0]))
    st = dict(max_iterations=LOOP["max_iterations"], integrator="rk2")
    loop = {k: LOOP[k] for k in ("duration", "mrt_frequency", "mpc_frequency")}
    return jtgt, start_state(None), st, loop


def _jax_closed_loop():
    jterr, _ = terrains("step_008")
    jem, _ = maps("step_008")
    h, n = LOOP["horizon"], LOOP["n"]
    jtgt, x0, st, loop = _loop_inputs()
    jg0, _ = trot_grids(0.0, h, n)
    ref_mpc = jmpc.Mpc(
        jfp.make_segmented_perceptive_problem(),
        jfp.make_perceptive_params(jg0, jterr, jem, jnp.asarray(x0), jtgt),
        settings=jmpc.MpcSettings(time_horizon=h, num_intervals=n, solver="sqp"),
        solver_settings=jsqp.SqpSettings(**st),
        reference_manager=jfp.PerceptiveReferenceManager(
            jterr, jem, JGaitSchedule(jtrot_gait(0.7)), target=jtgt))
    ref_its, solve = [], ref_mpc._jitted

    def counted(*a):
        sol, ctrl = solve(*a)
        ref_its.append(int(sol.iterations))
        return sol, ctrl

    ref_mpc._jitted = counted
    _, ref_xs, _ = jmrt.dummy_loop(jmrt.MpcMrtInterface(ref_mpc), jnp.asarray(x0), **loop)
    return dict(iterations=np.asarray(ref_its, np.int32), xs=ref_xs)


JAX_RECORDS = {
    "segmented_lq": _jax_segmented_lq,
    "segmented_metrics": _jax_segmented_metrics,
    "segmented_solve_stand": lambda: _jax_segmented_solve_of("stand"),
    "segmented_solve_walk": lambda: _jax_segmented_solve_of("walk"),
    "closed_loop": _jax_closed_loop,
}
RECORDS = Records(__file__)


@functools.lru_cache(maxsize=None)
def closed_loops():
    _, terr = terrains("step_008")
    _, em = maps("step_008")
    h, n = LOOP["horizon"], LOOP["n"]
    jtgt, x0, st, loop = _loop_inputs()
    tgt = convert.target_trajectories_from_numpy(np_tree(jtgt), device="cpu")
    _, tg0 = trot_grids(0.0, h, n)
    ref = RECORDS["closed_loop"]
    rm = fp.PerceptiveReferenceManager(terr, em, GaitSchedule(trot_gait(0.7)), target=tgt,
                                       device="cpu")
    mpc = Mpc(fp.make_segmented_perceptive_problem(device="cpu"),
              fp.make_perceptive_params(tg0, terr, em, torch.as_tensor(x0), tgt, device="cpu"),
              MpcSettings(time_horizon=h, num_intervals=n, solver="sqp"),
              solver_settings=sqp.SqpSettings(**st), reference_manager=rm, device="cpu")
    ticks = []

    def observe(t, x, u):
        if mpc.solve_timer.count > len(ticks):
            ticks.append(dict(iterations=int(mpc.last_solution.iterations[0]),
                              inputs=mpc.last_solve_inputs, sol=mpc.last_solution))

    _, xs, _ = dummy_loop(MpcMrtInterface(mpc), torch.as_tensor(x0), observers=[observe], **loop)
    return dict(mpc=mpc, ticks=ticks, xs=xs, ref_its=ref["iterations"].tolist(),
                ref_xs=ref["xs"])


def test_closed_loop_matches_jax():
    run = closed_loops()
    its = [k["iterations"] for k in run["ticks"]]
    assert len(its) == round(LOOP["duration"] * LOOP["mpc_frequency"])
    assert its == run["ref_its"]
    assert run["xs"].shape == run["ref_xs"].shape == (
        round(LOOP["duration"] * LOOP["mrt_frequency"]) + 1, 24)
    close_solve(run["xs"], run["ref_xs"])
    assert float(run["xs"][-1, 6]) > 0.05  # walked forward


def test_closed_loop_plans_once_a_tick_into_one_buffer():
    run = closed_loops()
    mpc, ticks = run["mpc"], run["ticks"]
    rm = mpc.reference_manager
    assert rm.plan_timer.count == len(ticks) == mpc.solve_timer.count
    for k in ticks:
        params = k["inputs"]["params"]
        assert len({params[key].untyped_storage().data_ptr() for key in fp.PLAN_KEYS}) == 1
        assert params["fh_normal"].shape == (LOOP["n"] + 1, 4, 3)
    # The terrain the planner reads is the host mirror made at construction.
    assert all(isinstance(v, np.ndarray) for v in rm._terrain_host)


def test_closed_loop_tick_resolves_through_the_single_sweep():
    """A tick re-solved from ``Mpc.last_solve_inputs`` through the
    single-scenario sweep is the tick (the chip script's check)."""
    run = closed_loops()
    mpc, tick = run["mpc"], run["ticks"][1]
    inp = tick["inputs"]
    again = sqp.solve(mpc.problem, inp["grid"], inp["x0"], inp["params"], xs_init=inp["xs_init"],
                      us_init=inp["us_init"], al_init=inp["al_init"],
                      settings=mpc.solver_settings, device="cpu", force_single_riccati=True)
    assert torch.equal(again.iterations, tick["sol"].iterations)
    close_solve(again.xs, tick["sol"].xs)
    close_solve(again.us, tick["sol"].us)
