"""The legged-robot model of the port vs the JAX package on the CPU:
kinematics, SRBD dynamics, constraints, gait and swing planning, the params
dict, and the LQ approximation of the assembled problem on a trot grid
(projected and unprojected).  Values rtol 2e-4 / atol 1e-5, float32.

The JAX package's LQ approximation and trajectory metrics (``JAX_RECORDS``)
are stored in ``tests/torch_data/test_torch_legged_model_jax.npz`` by
``tools/torch_test_records.py --record test_torch_legged_model``."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ocs2_tpu.models.legged_robot import constraints as jcon
from ocs2_tpu.models.legged_robot import gait as jgait
from ocs2_tpu.models.legged_robot import interface as jinterface
from ocs2_tpu.models.legged_robot import model as jmodel
from ocs2_tpu.models.legged_robot import swing as jswing
from ocs2_tpu.oc import approx as japprox
from ocs2_tpu.oc import metrics as jmetrics
from ocs2_tpu.oc.time_discretization import make_time_grid as jmake_time_grid
from ocs2_tpu.solvers import al as jal

from ocs2_tpu_torch import convert
from ocs2_tpu_torch.models.legged_robot import constraints as con
from ocs2_tpu_torch.models.legged_robot import gait, interface, model, swing
from ocs2_tpu_torch.oc import approx, metrics
from ocs2_tpu_torch.oc.time_discretization import make_time_grid
from ocs2_tpu_torch.solvers import al
from tools._records import Records

torch.set_num_threads(1)  # one intra-op thread a test process: the suite runs in several
# processes at once (pytest-xdist), and these small tensors gain nothing from more.

RTOL, ATOL = 2e-4, 1e-5
T = lambda v: torch.as_tensor(np.asarray(v, np.float32))  # noqa: E731
MODES = [15, 9, 6, 0, 1, 14]


def close(mine, ref, **kw):
    kw = {"rtol": RTOL, "atol": ATOL, **kw}
    np.testing.assert_allclose(np.asarray(mine), np.asarray(ref), **kw)


def samples(batch, seed):
    """States around the default stance and inputs around weight
    compensation, numpy float32 [batch, 24] each."""
    rng = np.random.default_rng(seed)
    x = np.asarray(jmodel.default_state())[None] + 0.2 * rng.standard_normal((batch, 24))
    u = np.asarray(jmodel.weight_compensating_input(jnp.ones(4)))[None] + np.concatenate(
        [10.0 * rng.standard_normal((batch, 12)), rng.standard_normal((batch, 12))], axis=1)
    return x.astype(np.float32), u.astype(np.float32)


# -- model ------------------------------------------------------------------


def test_constants_match():
    for name in ("NX", "NU", "NUM_LEGS", "NUM_JOINTS", "MASS", "GRAVITY", "THIGH_LENGTH",
                 "SHANK_LENGTH", "HIP_LATERAL", "STAND_HEIGHT"):
        assert getattr(model, name) == getattr(jmodel, name), name
    for name in ("INERTIA", "HIP_OFFSETS", "DEFAULT_JOINTS"):
        np.testing.assert_array_equal(getattr(model, name), getattr(jmodel, name))
    np.testing.assert_array_equal(interface.Q_DIAG, jinterface.Q_DIAG)
    np.testing.assert_array_equal(interface.R_MAT, jinterface.R_MAT)
    assert (con.FRICTION_MU, con.CONE_EPS) == (jcon.FRICTION_MU, jcon.CONE_EPS)


def test_default_state_and_weight_compensation():
    close(model.default_state("cpu"), jmodel.default_state())
    for flags in ([1, 1, 1, 1], [1, 0, 0, 1], [0, 0, 0, 0]):
        close(model.weight_compensating_input(flags, "cpu"),
              jmodel.weight_compensating_input(jnp.asarray(flags, jnp.float32)))


@pytest.mark.parametrize("leg", range(4))
def test_foot_position_base(leg):
    q = np.random.default_rng(leg).uniform(-1.0, 1.0, (5, 3)).astype(np.float32)
    ref = jax.vmap(lambda qq: jmodel.foot_position_base(leg, qq))(jnp.asarray(q))
    close(model.foot_position_base(leg, T(q)), ref)
    # One sample, as the LQ approximator calls it.
    close(model.foot_position_base(leg, T(q[0])), ref[0])


def test_leg_jacobian_is_the_derivative_of_the_leg_kinematics():
    """The closed-form J_leg dq equals jacfwd of foot_position_base times dq
    (what the reference computes), for every leg."""
    rng = np.random.default_rng(7)
    q = rng.uniform(-1.0, 1.0, (4, 3)).astype(np.float32)
    dq = rng.standard_normal((4, 3)).astype(np.float32)
    k = model._constants(torch.device("cpu"), torch.float32)
    mine = model._feet_velocity_base(T(q), T(dq), k.lateral)
    for leg in range(4):
        jac = torch.func.jacfwd(lambda qq: model.foot_position_base(leg, qq))(T(q[leg]))
        close(mine[leg], jac @ T(dq[leg]))
        close(jac, interface._foot_jacobian_np(leg, q[leg]))


def test_euler_matrices():
    e = np.random.default_rng(1).uniform(-1.2, 1.2, (6, 3)).astype(np.float32)
    close(model.euler_zyx_rotation(T(e)), jax.vmap(jmodel.euler_zyx_rotation)(jnp.asarray(e)))
    close(model.euler_zyx_rate_matrix(T(e)),
          jax.vmap(jmodel.euler_zyx_rate_matrix)(jnp.asarray(e)))
    # The pitch clamp near the gimbal singularity.
    s = np.float32([[0.3, np.pi / 2, 0.2]])
    close(model.euler_zyx_rate_matrix(T(s)),
          jax.vmap(jmodel.euler_zyx_rate_matrix)(jnp.asarray(s)), rtol=1e-3)


@pytest.fixture(scope="module")
def xu():
    return samples(7, seed=2)


def test_foot_positions_world(xu):
    x, _ = xu
    close(model.foot_positions_world(T(x)),
          jax.vmap(jmodel.foot_positions_world)(jnp.asarray(x)))


def test_foot_velocities_world(xu):
    x, u = xu
    close(model.foot_velocities_world(T(x), T(u)),
          jax.vmap(jmodel.foot_velocities_world)(jnp.asarray(x), jnp.asarray(u)))


def test_dynamics(xu):
    x, u = xu
    ref = jax.vmap(lambda a, b: jmodel.dynamics(0.0, a, b, None))(jnp.asarray(x), jnp.asarray(u))
    close(model.dynamics(None, T(x), T(u), None), ref)
    # Leading dims [B, A, N] as the line search gives them.
    x4 = T(x[:6]).reshape(1, 2, 3, 24)
    u4 = T(u[:6]).reshape(1, 2, 3, 24)
    close(model.dynamics(None, x4, u4, None).reshape(6, 24), ref[:6])


def test_dynamics_jacobians_stay_float32(xu):
    x, u = xu
    a = torch.func.jacfwd(lambda xx: model.dynamics(None, xx, T(u[0]), None))(T(x[0]))
    ref = jax.jacfwd(lambda xx: jmodel.dynamics(0.0, xx, jnp.asarray(u[0]), None))(
        jnp.asarray(x[0]))
    assert a.dtype == torch.float32
    close(a, ref)


# -- gait and swing ----------------------------------------------------------


def test_mode_encoding():
    assert gait.STANCE == jgait.STANCE
    for flags in ([1, 0, 0, 1], [0, 1, 1, 0], [1, 1, 1, 1], [0, 0, 0, 0]):
        assert gait.mode_number(flags) == jgait.mode_number(flags)
    for m in range(16):
        np.testing.assert_array_equal(gait.contact_flags_static(m), jgait.contact_flags_static(m))
    modes = np.arange(16)
    ref = jax.vmap(jgait.contact_flags)(jnp.asarray(modes, jnp.int32))
    mine = gait.contact_flags(torch.as_tensor(modes))
    assert mine.dtype == torch.float32 and mine.shape == (16, 4)
    np.testing.assert_array_equal(mine.numpy(), np.asarray(ref))
    # One node under vmap, as the LQ approximator decodes it.
    mapped = torch.func.vmap(gait.contact_flags)(torch.as_tensor(modes))
    np.testing.assert_array_equal(mapped.numpy(), np.asarray(ref))


@pytest.mark.parametrize("name", sorted(jgait.GAIT_MAP))
def test_gait_templates(name):
    assert sorted(gait.GAIT_MAP) == sorted(jgait.GAIT_MAP)
    mine, ref = gait.GAIT_MAP[name](), jgait.GAIT_MAP[name]()
    assert mine.switching_times == ref.switching_times
    assert mine.mode_sequence == ref.mode_sequence and mine.duration == ref.duration


@pytest.mark.parametrize("t0, tf, phase", [(0.0, 1.0, 0.0), (0.33, 1.9, 0.1), (2.0, 2.2, 0.0)])
def test_gait_schedule(t0, tf, phase):
    mine = gait.GaitSchedule(gait.trot_gait(0.7), phase=phase).mode_schedule(t0, tf)
    ref = jgait.GaitSchedule(jgait.trot_gait(0.7), phase=phase).mode_schedule(t0, tf)
    for a, b in zip(mine, ref):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_gait_schedule_template_swap():
    mine = gait.GaitSchedule(gait.trot_gait(0.7))
    ref = jgait.GaitSchedule(jgait.trot_gait(0.7))
    mine.set_template(gait.static_walk_gait())
    ref.set_template(jgait.static_walk_gait())
    for a, b in zip(mine.mode_schedule(0.5, 2.5), ref.mode_schedule(0.5, 2.5)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert mine.phase == ref.phase


def grids(n=20, mode_sequence=None):
    """The same event-aligned grid for both packages (host numpy)."""
    if mode_sequence is None:
        ms = jgait.GaitSchedule(jgait.trot_gait(0.7)).mode_schedule(0.0, 1.0)
        events, seq = np.asarray(ms.event_times), np.asarray(ms.mode_sequence)
    else:
        events, seq = (), np.asarray(mode_sequence)
    return (jmake_time_grid(0.0, 1.0, n, event_times=events, mode_sequence=seq),
            make_time_grid(0.0, 1.0, n, event_times=events, mode_sequence=seq))


def test_trot_grid_and_swing_references():
    jg, tg = grids()
    for a, b in zip(tg, jg):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert set(np.asarray(tg.modes).tolist()) == {9, 6} and tg.is_jump.sum() == 2
    ref = jswing.plan_swing_references(np.asarray(jg.times), np.asarray(jg.modes), 0.08)
    mine = swing.plan_swing_references(tg.times, tg.modes, 0.08)
    np.testing.assert_array_equal(mine.z, np.asarray(ref.z))
    np.testing.assert_array_equal(mine.vz, np.asarray(ref.vz))
    assert mine.z.max() > 0.05


def test_make_params_and_its_conversion():
    jg, tg = grids()
    jp = jinterface.make_params(jg)
    mine = interface.make_params(tg, device="cpu")
    carried = convert.params_from_numpy(
        {k: (jax.tree.map(np.asarray, v)._asdict() if k == "target" else np.asarray(v))
         for k, v in jp.items()}, device="cpu")
    assert set(mine) == set(carried) == set(jp)
    for key in ("swing_z", "swing_vz", "fz_max"):
        assert mine[key].dtype == carried[key].dtype == torch.float32
        assert mine[key].shape == carried[key].shape
        np.testing.assert_array_equal(mine[key].numpy(), carried[key].numpy())
        close(mine[key], jp[key])
    for a, b, c in zip(mine["target"], carried["target"], jp["target"]):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
        close(a, c)


# -- constraints -------------------------------------------------------------


def _swing_rows():
    """A swing reference row per mode of MODES, [len(MODES), 4]."""
    return np.random.default_rng(3).uniform(0.0, 0.1, (len(MODES), 4)).astype(np.float32)


@pytest.mark.parametrize("name, with_input", [
    ("friction_cone", True), ("fz_bounds", True), ("foot_constraint", True),
    ("swing_normal_velocity", True), ("_swing_height_error", False),
])
def test_constraint_terms(name, with_input):
    x, u = samples(len(MODES), seed=4)
    sw = _swing_rows()
    jfn, tfn = getattr(jcon, name), getattr(con, name)

    def jone(xx, uu, mode, node):
        p = {"mode": mode, "node": node, "swing_vz": jnp.asarray(sw), "swing_z": jnp.asarray(sw),
             "fz_max": jnp.float32(400.0)}
        return jfn(0.0, xx, uu, p) if with_input else jfn(0.0, xx, p)

    nodes = np.arange(len(MODES))
    ref = jax.vmap(jone)(jnp.asarray(x), jnp.asarray(u), jnp.asarray(MODES, jnp.int32),
                         jnp.asarray(nodes))
    # Batched over the nodes, as the trajectory evaluation calls the terms.
    p = {"mode": torch.as_tensor(MODES), "node": torch.as_tensor(nodes), "swing_vz": T(sw),
         "swing_z": T(sw), "fz_max": torch.tensor(400.0)}
    mine = tfn(None, T(x), T(u), p) if with_input else tfn(None, T(x), p)
    assert mine.dtype == torch.float32
    close(mine, ref)
    # With further leading dims [2, nodes].
    x2, u2 = T(np.stack([x, x])), T(np.stack([u, u]))
    mine2 = tfn(None, x2, u2, p) if with_input else tfn(None, x2, p)
    close(mine2[1], ref)


@pytest.mark.parametrize("name", ["swing_height_tracking", "friction_cone_soft"])
def test_soft_terms_value(name):
    x, u = samples(len(MODES), seed=5)
    sw = _swing_rows()
    if name == "swing_height_tracking":
        jterm, tterm = jcon.swing_height_tracking, con.swing_height_tracking
    else:
        jterm, tterm = jcon.make_friction_cone_soft(), con.make_friction_cone_soft()
    nodes = np.arange(len(MODES))

    def jone(xx, uu, mode, node):
        p = {"mode": mode, "node": node, "swing_z": jnp.asarray(sw)}
        return jterm(0.0, xx, uu, p) if jterm.with_input else jterm(0.0, xx, p)

    ref = jax.vmap(jone)(jnp.asarray(x), jnp.asarray(u), jnp.asarray(MODES, jnp.int32),
                         jnp.asarray(nodes))
    p = {"mode": torch.as_tensor(MODES), "node": torch.as_tensor(nodes), "swing_z": T(sw)}
    mine = tterm(None, T(x), T(u), p) if tterm.with_input else tterm(None, T(x), p)
    close(mine, ref)


# -- the assembled problem ----------------------------------------------------


def _flat(lq):
    out = {}
    for name, rec in lq._asdict().items():
        if rec is None:
            continue
        for f, v in rec._asdict().items():
            if v is not None:
                out[f"{name}.{f}"] = np.asarray(v)
    return out


def _trajectory(batch, n, seed):
    x, u = samples(batch * (n + 1), seed)
    return x.reshape(batch, n + 1, 24), u.reshape(batch, n + 1, 24)[:, :n]


def _jax_legged_lq():
    n = 20
    jg, _ = grids(n)
    xs, us = _trajectory(2, n, seed=6)
    jp = jinterface.make_problem()
    jaug = jal.augment_problem(jp, project_equalities=True)
    jparams = jinterface.make_params(jg)
    jdims = jp.constraint_dims(dict(jparams, mode=jnp.int32(0), node=jnp.int32(0)))
    jalst = jal.AlState.init(jdims, n, 10.0)
    ref = jax.jit(jax.vmap(lambda x, u: japprox.approximate_lq(
        jaug, jg, x, u, dict(jparams, al=jalst), method="rk2")))(jnp.asarray(xs), jnp.asarray(us))
    return dict(lq=ref, dims=jdims)


def _jax_trajectory_metrics(friction, project):
    n = 20
    jg, _ = grids(n)
    xs, us = _trajectory(2, n, seed=8)
    jp = jinterface.make_problem(friction_cone=friction, project_foot_constraint=project)
    return jax.jit(jax.vmap(lambda x, u: jmetrics.evaluate_trajectory(
        jp, jg, x, u, jinterface.make_params(jg))))(jnp.asarray(xs), jnp.asarray(us))


METRICS_CASES = [("hard", False), ("soft", False)]
JAX_RECORDS = dict(
    {f"metrics_{f}_{p}": functools.partial(_jax_trajectory_metrics, f, p)
     for f, p in METRICS_CASES},
    legged_lq=_jax_legged_lq)
RECORDS = Records(__file__)


@pytest.fixture(scope="module")
def legged_lq():
    """Projected flagship problem (soft cone, foot constraint kept as an
    equality for the projection) on the trot grid, rk2, B = 2."""
    n = 20
    _, tg = grids(n)
    xs, us = _trajectory(2, n, seed=6)
    rec = RECORDS["legged_lq"]
    ref, jdims = rec["lq"], {k: int(v) for k, v in rec["dims"].items()}
    tp = interface.make_problem(device="cpu")
    taug = al.augment_problem(tp, project_equalities=True)
    tparams = interface.make_params(tg, device="cpu")
    tdims = tp.constraint_dims(approx.example_params(tparams, "cpu"), device="cpu")
    assert tdims == jdims == {"ne": 12, "nse": 0, "ni": 0, "nsi": 0, "nfe": 0}
    talst = al.AlState.init(tdims, n, 10.0, batch=(2,), device="cpu")
    mine = approx.approximate_lq(taug, tg, T(xs), T(us), dict(tparams, al=talst), method="rk2")
    assert tp.cost_structure_psd and taug.cost_structure_psd
    return _flat(mine), _flat(ref)


LEGGED_LEAVES = [
    "cost.f", "cost.dfdx", "cost.dfdu", "cost.dfdxx", "cost.dfdux", "cost.dfduu",
    "dynamics.f", "dynamics.dfdx", "dynamics.dfdu", "eq.f", "eq.dfdx", "eq.dfdu",
]


@pytest.mark.parametrize("leaf", LEGGED_LEAVES)
def test_legged_lq_matches_jax(legged_lq, leaf):
    mine, ref = legged_lq
    assert set(mine) == set(ref) == set(LEGGED_LEAVES)
    assert mine[leaf].dtype == np.float32 and mine[leaf].shape == ref[leaf].shape
    # Hessian entries reach 1e4 (barrier curvature times force Jacobians).
    close(mine[leaf], ref[leaf], atol=ATOL * max(1.0, float(np.abs(ref[leaf]).max())))


def test_legged_eq_jacobian_has_full_row_rank(legged_lq):
    mine, _ = legged_lq
    s = np.linalg.svd(mine["eq.dfdu"], compute_uv=False)
    assert s.shape == (2, 20, 12) and s.min() > 1e-2


@pytest.mark.parametrize("friction, project", METRICS_CASES)
def test_legged_trajectory_metrics_match_jax(friction, project):
    """evaluate_trajectory on the unprojected / hard-cone assemblies: cost
    and the raw constraint values of every family."""
    n = 20
    _, tg = grids(n)
    xs, us = _trajectory(2, n, seed=8)
    tp = interface.make_problem(friction_cone=friction, project_foot_constraint=project,
                                device="cpu")
    ref = RECORDS[f"metrics_{friction}_{project}"]
    mine = metrics.evaluate_trajectory(tp, tg, T(xs), T(us), interface.make_params(tg, device="cpu"))
    close(mine.cost, ref.cost)
    close(mine.g_eq, ref.g_eq)
    assert mine.g_eq.shape == (2, n, 16)
    if friction == "hard":
        close(mine.h_ineq, ref.h_ineq)
    else:
        assert mine.h_ineq is None and ref.h_ineq is None


@pytest.mark.parametrize("model_type", ["full", "comkino"])
def test_unported_model_types_raise(model_type):
    """The full centroidal and the ComKino model build the flagship problem
    with their own flow map; a model type that names no model raises."""
    from ocs2_tpu_torch.models.legged_robot import centroidal, comkino

    problem = interface.make_problem(model_type=model_type, device="cpu")
    expected = {"full": centroidal.dynamics_full, "comkino": comkino.dynamics}[model_type]
    assert problem.dynamics is expected
    with pytest.raises(ValueError, match="model_type"):
        interface.make_problem(model_type=model_type + "_x", device="cpu")
