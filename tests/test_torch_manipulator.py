"""The self-collision model and the mobile manipulator of the port vs the JAX
package, on the CPU: sphere models, centers, pair distances and their
gradients; the built-in arm's EE pose, flow and constraints; the LQ data of
its soft problem with an orientation target, and the constraints of its hard
problem with the workspace SDF; SQP's Hessian correction (``convexify``) of
that data, which runs on every manipulator solve since the EE costs are
plain callables (``cost_structure_psd`` False); a short live SQP solve at
N = 10; and the card lane's two long solves (``chip_smoke.py`` phase
``manipulator_sqp_b1``), alone and as one batch with an EE target per
scenario (``params["scenario"]``, where the JAX package maps a whole solve
over its params), against the JAX package's record
(``tools/manipulator_reference.py``) and the JAX tests' own bounds
(``tests/test_robot_zoo.py``).

Tolerances: model functions and distances atol 2e-6; their gradients 1e-5;
LQ leaves and convexified Hessians atol 1e-5 times the leaf's largest entry
(at least 1), rtol 1e-4 (as ``tests/test_torch_legged_model.py``); solves
with the card lanes' rules (``chip_smoke.compare_with_ties`` against a live
JAX solve, ``chip_smoke.compare_with_record`` against a record): iterations
equal except ties at equal merit, xs and us within 1e-3 + 1e-4 |value|
(BASELINE.md's 1e-3), or, where the JAX package's own routes part by more,
within that spread.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke as cs
from ocs2_tpu.models import collision as jcol
from ocs2_tpu.models import mobile_manipulator as jmm
from ocs2_tpu.models.perceptive import signed_distance_field as jsdf
from ocs2_tpu.oc import approx as japprox
from ocs2_tpu.oc.time_discretization import uniform_grid as juniform_grid
from ocs2_tpu.ops import riccati as jriccati
from ocs2_tpu.solvers import sqp as jsqp

from ocs2_tpu_torch import convert
from ocs2_tpu_torch.models import collision
from ocs2_tpu_torch.models import mobile_manipulator as mm
from ocs2_tpu_torch.models.perceptive import signed_distance_field
from ocs2_tpu_torch.oc import approx
from ocs2_tpu_torch.oc.time_discretization import uniform_grid
from ocs2_tpu_torch.ops import riccati
from ocs2_tpu_torch.solvers import sqp
from tools._records import Records

torch.set_num_threads(1)  # one intra-op thread a test process: the suite runs in several
# processes at once (pytest-xdist), and these small tensors gain nothing from more.

ATOL, GRAD_ATOL = 2e-6, 1e-5
T = lambda v: torch.as_tensor(np.array(v, np.float32))  # noqa: E731
R_DOWN = np.float32([[1.0, 0, 0], [0, -1.0, 0], [0, 0, -1.0]])  # the tool pointing down


def _states(count, seed):
    return np.random.default_rng(seed).uniform(-1.2, 1.2, (count, mm.NX)).astype(np.float32)


# -- collision ------------------------------------------------------------------


def test_sphere_model_matches_jax_and_lives_on_its_device():
    mine = collision.SphereModel.create(mm.SPHERE_SPECS, mm.SPHERE_PAIR_FRAMES, device="cpu")
    ref = jmm.SPHERES
    for f in ref._fields:
        np.testing.assert_array_equal(getattr(mine, f).numpy(), np.asarray(getattr(ref, f)))
        assert isinstance(getattr(mine, f), torch.Tensor)
    assert mine.pairs.shape == (6, 2) and mm.spheres("cpu").pairs.device.type == "cpu"
    assert mm.SELF_COLLISION_MIN_DISTANCE == 0.02
    # Carried across from the JAX package's arrays: the same model.
    carried = convert.sphere_model_from_numpy(
        {f: np.asarray(v) for f, v in ref._asdict().items()}, device="cpu")
    for f in ref._fields:
        assert torch.equal(getattr(carried, f), getattr(mine, f)), f


def test_distances_of_random_frame_poses_match_jax():
    rng = np.random.default_rng(0)
    spec = [(0, (0.0, 0.1, 0.2), 0.1), (1, (0.3, 0.0, 0.0), 0.05), (1, (0.0, 0.0, 0.0), 0.2),
            (2, (0.0, -0.2, 0.1), 0.07)]
    mine = collision.SphereModel.create(spec, [(0, 1), (0, 2), (1, 2)], device="cpu")
    ref = jcol.SphereModel.create(spec, [(0, 1), (0, 2), (1, 2)])
    rots = np.stack([np.asarray(jax.scipy.linalg.expm(jnp.asarray(
        np.cross(np.eye(3), v)))) for v in rng.standard_normal((6 * 3, 3))]).reshape(6, 3, 3, 3)
    pos = rng.standard_normal((6, 3, 3)).astype(np.float32)
    want_c = jax.vmap(ref.centers)(jnp.asarray(rots, jnp.float32), jnp.asarray(pos))
    want_d = jax.vmap(ref.distances)(jnp.asarray(rots, jnp.float32), jnp.asarray(pos))
    np.testing.assert_allclose(mine.centers(T(rots), T(pos)).numpy(), np.asarray(want_c), atol=ATOL)
    np.testing.assert_allclose(mine.distances(T(rots), T(pos)).numpy(), np.asarray(want_d),
                               atol=ATOL)


def test_builtin_arm_functions_match_jax():
    x = _states(16, 1)
    u = np.random.default_rng(2).standard_normal((16, mm.NU)).astype(np.float32)
    pos_ref, rot_ref = jax.vmap(jmm.ee_pose)(jnp.asarray(x))
    pos, rot = mm.ee_pose(T(x))
    np.testing.assert_allclose(pos.numpy(), np.asarray(pos_ref), atol=ATOL)
    np.testing.assert_allclose(rot.numpy(), np.asarray(rot_ref), atol=ATOL)
    for mine, ref, args in (
        (mm.dynamics, jmm.dynamics, (x, u)), (mm.velocity_limits, jmm.velocity_limits, (x, u)),
        (mm.input_cost, jmm.input_cost, (x, u)),
    ):
        want = jax.vmap(lambda a, b: ref(0.0, a, b, None))(*map(jnp.asarray, args))
        np.testing.assert_allclose(mine(0.0, *map(T, args), None).numpy(), np.asarray(want),
                                   atol=ATOL, err_msg=mine.__name__)
    for mine, ref in ((mm.joint_limits, jmm.joint_limits), (mm.self_collision, jmm.self_collision)):
        want = jax.vmap(lambda a: ref(0.0, a, {}))(jnp.asarray(x))
        np.testing.assert_allclose(mine(0.0, T(x), {}).numpy(), np.asarray(want), atol=ATOL,
                                   err_msg=mine.__name__)


def test_self_collision_gradients_match_jax():
    """d distances / d x, the rows the soft self-collision term's
    Gauss-Newton quadratization is made of."""
    x = _states(4, 3)
    jac = torch.func.vmap(torch.func.jacrev(lambda v: mm.self_collision(0.0, v, {})))(T(x))
    ref = jax.jit(jax.vmap(jax.jacrev(lambda v: jmm.self_collision(0.0, v, {}))))(jnp.asarray(x))
    assert jac.dtype == torch.float32 and jac.shape == (4, 6, mm.NX)
    np.testing.assert_allclose(jac.numpy(), np.asarray(ref), atol=GRAD_ATOL)


# -- LQ data and the Hessian correction -------------------------------------------


def _sdf_pair():
    occ = np.zeros((40, 24, 24), bool)
    occ[24:28] = True  # a wall slab at x in [1.2, 1.4)
    return (signed_distance_field(torch.as_tensor(occ), [0.0, -0.6, 0.0], 0.05),
            jsdf(jnp.asarray(occ), [0.0, -0.6, 0.0], 0.05))


def _lq_inputs(nx, nu, seed, n=4, b=2):
    rng = np.random.default_rng(seed)
    xs = rng.uniform(-0.8, 0.8, (b, n + 1, nx)).astype(np.float32)
    us = rng.standard_normal((b, n, nu)).astype(np.float32)
    return n, xs, us


def _jax_lq(jp, r_target, seed):
    """The JAX package's LQ data (rk2, jitted) of one problem at B = 2,
    N = 4 from random trajectories."""
    n, xs, us = _lq_inputs(jp.nx, jp.nu, seed)
    jpar = jmm.make_params((0.8, 0.3, 0.7), r_target)
    return jax.jit(jax.vmap(lambda x, u: japprox.approximate_lq(
        jp, juniform_grid(0.0, 1.0, n), x, u, jpar, method="rk2")))(
            jnp.asarray(xs), jnp.asarray(us))


def _lq_pair(p, ref, r_target, seed):
    """The port's LQ data on the inputs of ``_jax_lq`` beside the stored
    JAX result."""
    n, xs, us = _lq_inputs(p.nx, p.nu, seed)
    par = mm.make_params((0.8, 0.3, 0.7), r_target, device="cpu")
    mine = approx.approximate_lq(p, uniform_grid(0.0, 1.0, n), T(xs), T(us), par, method="rk2")
    return _flat(mine), _flat(ref)


def _flat(lq):
    return {f"{name}.{f}": np.asarray(v) for name, rec in lq._asdict().items()
            if rec is not None for f, v in rec._asdict().items() if v is not None}


def assert_lq_close(mine, ref):
    assert set(mine) == set(ref)
    for k in ref:
        assert mine[k].shape == ref[k].shape, k
        scale = max(1.0, float(np.abs(ref[k]).max()))
        np.testing.assert_allclose(mine[k], ref[k], rtol=1e-4, atol=1e-5 * scale, err_msg=k)


@pytest.fixture(scope="module")
def lq_data():
    """The soft problem with self-collision and an orientation target: the
    EE pose cost's exact Hessian, the soft joint, velocity and sphere terms'
    Gauss-Newton blocks, and the flow's Jacobians."""
    p, jp = mm.make_problem("soft"), jmm.make_problem("soft")
    assert p.cost_structure_psd is jp.cost_structure_psd is False
    return _lq_pair(p, RECORDS["soft_lq"], R_DOWN, seed=4)


def test_lq_data_matches_jax(lq_data):
    assert_lq_close(*lq_data)


def test_hard_problem_constraints_match_jax():
    """The hard mode's constraint families at a node: velocity limits as the
    state-input inequality, joint limits and sphere distances as the state
    inequality, and the latter's Jacobian."""
    p, jp = mm.make_problem("hard"), jmm.make_problem("hard")
    x = _states(3, 10)
    u = np.random.default_rng(11).standard_normal((3, mm.NU)).astype(np.float32)
    want = jax.vmap(lambda a, b: jp.inequality(0.0, a, b, {}))(jnp.asarray(x), jnp.asarray(u))
    np.testing.assert_allclose(p.inequality(0.0, T(x), T(u), {}).numpy(), np.asarray(want),
                               atol=ATOL)
    want = jax.vmap(lambda a: jp.state_inequality(0.0, a, {}))(jnp.asarray(x))
    np.testing.assert_allclose(p.state_inequality(0.0, T(x), {}).numpy(), np.asarray(want),
                               atol=ATOL)
    jac = torch.func.vmap(torch.func.jacrev(lambda v: p.state_inequality(0.0, v, {})))(T(x))
    want = jax.jit(jax.vmap(jax.jacrev(lambda v: jp.state_inequality(0.0, v, {}))))(jnp.asarray(x))
    np.testing.assert_allclose(jac.numpy(), np.asarray(want), atol=GRAD_ATOL)


@pytest.mark.parametrize("method", ["eigh", "gershgorin"])
def test_convexify_matches_jax(lq_data, method):
    """The Hessian correction SQP applies to the manipulator's LQ data (stage
    Hessians at (9, 8), indefinite from the EE cost's exact second
    derivatives), against the JAX package's on the same data."""
    mine, _ = lq_data
    leaves = dict(Qxx=mine["cost.dfdxx"][:, :-1], Qux=mine["cost.dfdux"][:, :-1],
                  Quu=mine["cost.dfduu"][:, :-1], Qf=mine["cost.dfdxx"][:, -1])
    nu, nx = leaves["Qux"].shape[-2:]
    assert (nx, nu) == (mm.NX, mm.NU)
    z = np.block([[leaves["Qxx"], np.swapaxes(leaves["Qux"], -1, -2)],
                  [leaves["Qux"], leaves["Quu"]]])
    assert np.linalg.eigvalsh(0.5 * (z + np.swapaxes(z, -1, -2))).min() < -1e-3  # a real correction
    b, n = leaves["Quu"].shape[:2]
    zeros = dict(A=np.zeros((b, n, nx, nx)), B=np.zeros((b, n, nx, nu)), b=np.zeros((b, n, nx)),
                 qx=np.zeros((b, n, nx)), qu=np.zeros((b, n, nu)), qf=np.zeros((b, nx)))
    data = {k: np.asarray(v, np.float32) for k, v in dict(leaves, **zeros).items()}
    got = riccati.convexify(convert.lqr_coeffs_from_numpy(data, device="cpu"), method=method)
    want = jax.vmap(lambda c: jriccati.convexify(c, method=method))(
        jriccati.LqrCoeffs(**{k: jnp.asarray(v) for k, v in data.items()}))
    for f in ("Qxx", "Qux", "Quu", "Qf"):
        a, w = getattr(got, f).numpy(), np.asarray(getattr(want, f))
        scale = max(1.0, float(np.abs(w).max()))
        np.testing.assert_allclose(a, w, rtol=1e-4, atol=1e-5 * scale, err_msg=f)


# -- solves -----------------------------------------------------------------------

SHORT = dict(n=10, horizon=1.5, settings=dict(max_iterations=10, integrator="rk2"))


def _short_grid(mod):
    return mod(0.0, SHORT["horizon"], SHORT["n"])


def _jax_short_solve():
    return jax.jit(lambda x: jsqp.solve(
        jmm.make_problem("soft"), _short_grid(juniform_grid), x,
        jmm.make_params(cs.MANIP_TARGETS["reach"]),
        settings=jsqp.SqpSettings(**SHORT["settings"])))(jmm.home_state())


JAX_RECORDS = {
    "soft_lq": lambda: _jax_lq(jmm.make_problem("soft"), R_DOWN, seed=4),
    "short_solve": _jax_short_solve,
}
RECORDS = Records(__file__)


def test_short_solve_matches_jax():
    """The soft problem with self-collision from home to the reach target,
    N = 10, 10 iterations: the port live, the JAX package's solve stored."""
    target = cs.MANIP_TARGETS["reach"]
    ref = RECORDS["short_solve"]
    mine = sqp.solve(mm.make_problem("soft"), _short_grid(uniform_grid), mm.home_state("cpu"),
                     mm.make_params(target, device="cpu"),
                     settings=sqp.SqpSettings(**SHORT["settings"]), device="cpu")
    want = cs.record_solution(torch, {"iterations": ref.iterations, "merit": ref.performance.merit,
                                      "xs": ref.xs, "us": ref.us}, rows=None, device="cpu")
    cs.compare_with_ties(torch, mine, want, "manipulator N = 10 port vs JAX")


@pytest.fixture(scope="module")
def record():
    with np.load(cs.MANIP_RECORD) as f:
        return {k: f[k] for k in f.files}


def _check_bounds(xs, name):
    """The JAX tests' bounds (tests/test_robot_zoo.py:98-130): joints inside
    their box, every monitored sphere pair apart next to the base body, and
    the EE within 0.05 m of a reachable target."""
    qs = xs[:, 3:9].numpy()
    assert np.all(qs > mm.JOINT_LOWER[None] - cs.MANIP_JOINT_TOL)
    assert np.all(qs < mm.JOINT_UPPER[None] + cs.MANIP_JOINT_TOL)
    assert float(mm.self_collision(0.0, xs, {}).min()) > cs.MANIP_SPHERE_TOL
    if name == "reach":
        pos, _ = mm.ee_pose(xs[-1])
        assert float((pos - T(cs.MANIP_TARGETS[name])).norm()) < cs.MANIP_EE_TOL


def _long_solve(x0, params):
    return sqp.solve(mm.make_problem("soft"), uniform_grid(0.0, cs.MANIP_HORIZON, cs.MANIP_N),
                     x0, params, settings=sqp.SqpSettings(
                         max_iterations=cs.MANIP_MAX_ITERATIONS, integrator="rk2"), device="cpu")


@pytest.mark.parametrize("name", list(cs.MANIP_TARGETS))
def test_long_solve_matches_the_record(record, name):
    """The card lane's solve (N = 40 over 3 s, rk2, 40 iterations, B = 1) on
    the CPU, against the JAX package's record and the JAX tests' bounds."""
    sol = _long_solve(mm.home_state("cpu"), mm.make_params(cs.MANIP_TARGETS[name], device="cpu"))
    cs.compare_with_record(torch, sol, record, f"builtin_{name}_", f"{name} vs the record",
                           rows=None)
    _check_bounds(sol.xs[0], name)


def test_per_scenario_targets_match_the_records(record):
    """Both targets in one batched solve, one EE target per scenario
    (params["scenario"], where the JAX package maps a whole solve over its
    params), each scenario against its record.  At the self-collision target
    the JAX package's own solve and its vmapped solve part by 8.9e-3 in xs
    and 0.12 in us (the record's spread): the rule of
    ``chip_smoke.compare_with_record`` holds that scenario to the spread
    where it leaves the tolerance."""
    targets = np.float32(list(cs.MANIP_TARGETS.values()))
    params = mm.make_params(targets, device="cpu")
    assert set(params) == {"scenario"} and params["scenario"]["ee_target"].shape == (2, 3)
    sol = _long_solve(mm.home_state("cpu")[None].expand(2, mm.NX), params)
    for i, name in enumerate(cs.MANIP_TARGETS):
        cs.compare_with_record(torch, cs.take_rows(sol, slice(i, i + 1)), record,
                               f"builtin_{name}_", f"{name} in a batch vs the record", rows=None)
        _check_bounds(sol.xs[i], name)


def test_workspace_sdf_clearance_constraint_matches_jax():
    """The EE workspace clearance against an SDF wall slab (the perceptive
    EndEffectorDistanceConstraint, tests/test_robot_zoo.py's SDF case) as the
    soft problem's state inequality and hard problem's: values and
    Jacobians at states on both sides of the wall, against the JAX package's
    on the same occupancy grid."""
    sdf, jsdf_ = _sdf_pair()
    x = _states(6, 13)
    x[:3, 3:9] = np.float32([0.0, -0.5, 1.0, 0.0, 0.5, 0.0])  # home arm, EE at x ~ 0.5
    x[3:, 0] = np.float32([0.9, 1.0, 1.1])  # the base driven toward the wall
    p = mm.make_problem("hard", workspace_sdf=sdf, sdf_clearance=0.05)
    jp = jmm.make_problem("hard", workspace_sdf=jsdf_, sdf_clearance=0.05)
    got = p.state_inequality(0.0, T(x), {})
    want = jax.vmap(lambda a: jp.state_inequality(0.0, a, {}))(jnp.asarray(x))
    assert got.shape == (6, 12 + 6 + 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    assert float(got[:, -1].min()) < 0.0 < float(got[:, -1].max())  # both sides of the wall
    jac = torch.func.vmap(torch.func.jacrev(lambda v: p.state_inequality(0.0, v, {})))(T(x))
    jac_want = jax.jit(jax.vmap(jax.jacrev(lambda v: jp.state_inequality(0.0, v, {}))))(
        jnp.asarray(x))
    np.testing.assert_allclose(jac.numpy(), np.asarray(jac_want), atol=1e-4)
