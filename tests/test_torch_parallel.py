"""Meshes, scenario sharding and the horizon-sharded PIPG (K9) of the port,
on the CPU.

* ``parallel/horizon.pipg_solve_horizon_sharded`` on a mesh of 4 and of 8
  CPU shards, and on one of four entries that name the CPU differently (so
  that the halos cross "devices"), against the port's single-device
  ``pipg_solve`` (the same iteration: 1e-6), and against the JAX package's
  ``pipg_solve_horizon_sharded`` run live on its 8-device CPU mesh at
  ``tests/test_sharding.py:40``'s case (N = 32, nx = 6, nu = 3, 3,000
  iterations) to that test's 2e-3;
* ``parallel/mesh.sharded`` against the unsharded batched solve (per-scenario
  results: iterations equal, 1e-5);
* SQP and SLP with ``qp_solver="pipg_sharded"`` on the ballbot (N = 16, 4
  shards) against ``"pipg"`` in the port (1e-6) and against the JAX
  package's sharded solves on a 4-device time mesh (``JAX_RECORDS``, stored
  by ``tools/torch_test_records.py --record test_torch_parallel``):
  iterations equal, ``xs`` / ``us`` within 1e-3 + 1e-4 |value|.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

from lq_fixtures import random_lq_coeffs
from ocs2_tpu.models import ballbot as jballbot
from ocs2_tpu.oc.time_discretization import uniform_grid as juniform_grid
from ocs2_tpu.ops.pipg import PipgSettings as JPipgSettings
from ocs2_tpu.parallel.horizon import pipg_solve_horizon_sharded as jsharded_pipg
from ocs2_tpu.solvers import slp as jslp
from ocs2_tpu.solvers import sqp as jsqp

from ocs2_tpu_torch import convert
from ocs2_tpu_torch.models import ballbot
from ocs2_tpu_torch.oc.time_discretization import uniform_grid
from ocs2_tpu_torch.ops.pipg import PipgSettings, pipg_solve, ruiz_equilibrate
from ocs2_tpu_torch.parallel import horizon, mesh
from ocs2_tpu_torch.solvers import ddp, slp, sqp
from tools._records import Records

torch.set_num_threads(1)  # one intra-op thread a test process: the suite runs in several
# processes at once (pytest-xdist), and these small tensors gain nothing from more.

SAME_ATOL = 1e-6  # the sharded and single-device iterations: the same arithmetic
JAX_TOL = 2e-3  # tests/test_sharding.py:45-51
SOLVE_ATOL, SOLVE_RTOL = 1e-3, 1e-4


def _coeffs(seed, n, nx, nu):
    jc = jax.jit(random_lq_coeffs, static_argnums=(1, 2, 3))(jax.random.PRNGKey(seed), n, nx, nu)
    leaves = {k: np.asarray(v)[None] for k, v in jc._asdict().items()}
    return jc, convert.lqr_coeffs_from_numpy(leaves, device="cpu")


def test_mesh_record():
    m = mesh.make_mesh(["cpu"] * 4, "time")
    assert m.shape == {"time": 4} and len(m) == 4 and m.axis_names == ("time",)
    assert mesh.device_groups(m) == [(torch.device("cpu"), 0, 4)]
    split = mesh.Mesh(("cpu:0", "cpu:1", "cpu:1", "cpu:2"), "time")
    assert [(g[1], g[2]) for g in mesh.device_groups(split)] == [(0, 1), (1, 2), (3, 1)]
    if torch.cuda.device_count() == 0:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mesh.make_mesh()
    else:
        assert len(mesh.make_mesh()) == torch.cuda.device_count()


MESHES = {"cpu_x4": ["cpu"] * 4, "cpu_x8": ["cpu"] * 8,
          "four_devices": ["cpu:0", "cpu:1", "cpu:1", "cpu:2"]}


@pytest.mark.parametrize("devices", list(MESHES))
def test_horizon_sharded_pipg_equals_the_single_device_iteration(devices):
    _, coeffs = _coeffs(3, 32, 6, 3)
    st = PipgSettings(num_iterations=300)
    ref = pipg_solve(coeffs, st)
    shd = horizon.pipg_solve_horizon_sharded(coeffs, mesh.make_mesh(MESHES[devices], "time"), st)
    assert shd.dxs.shape == (1, 33, 6) and shd.dus.shape == (1, 32, 3)
    np.testing.assert_allclose(shd.dxs.numpy(), ref.dxs.numpy(), rtol=0.0, atol=SAME_ATOL)
    np.testing.assert_allclose(shd.dus.numpy(), ref.dus.numpy(), rtol=0.0, atol=SAME_ATOL)
    np.testing.assert_allclose(shd.primal_residual.numpy(), ref.primal_residual.numpy(),
                               rtol=1e-5, atol=SAME_ATOL)


def test_horizon_sharded_pipg_matches_the_jax_package():
    """tests/test_sharding.py::test_matches_single_device_pipg's case on both
    packages' 8-shard CPU meshes."""
    jc, coeffs = _coeffs(3, 32, 6, 3)
    jmesh = JaxMesh(np.asarray(jax.devices()), ("time",))
    ref = jax.jit(lambda c: jsharded_pipg(c, jmesh, JPipgSettings(num_iterations=3000)))(jc)
    mine = horizon.pipg_solve_horizon_sharded(
        coeffs, mesh.make_mesh(["cpu"] * 8, "time"), PipgSettings(num_iterations=3000))
    for f in ("dxs", "dus"):
        np.testing.assert_allclose(getattr(mine, f)[0].numpy(), np.asarray(getattr(ref, f)),
                                   rtol=JAX_TOL, atol=JAX_TOL, err_msg=f)


def test_horizon_sharded_residual_falls_and_a_ragged_horizon_is_refused():
    _, coeffs = _coeffs(5, 16, 4, 2)
    scaled, _ = ruiz_equilibrate(coeffs, 5)
    tmesh = mesh.make_mesh(["cpu"] * 8, "time")
    short = horizon.pipg_solve_horizon_sharded(scaled, tmesh, PipgSettings(num_iterations=50))
    long = horizon.pipg_solve_horizon_sharded(scaled, tmesh, PipgSettings(num_iterations=1000))
    assert float(long.primal_residual) < float(short.primal_residual)
    with pytest.raises(ValueError, match="divisible"):
        horizon.pipg_solve_horizon_sharded(scaled, mesh.make_mesh(["cpu"] * 3, "time"))


@pytest.mark.parametrize("devices", [["cpu"] * 2, ["cpu:0", "cpu:1"]], ids=["one", "two"])
def test_sharded_batch_equals_the_unsharded_solve(devices):
    """Four ballbot scenarios split over two shards, each solved on its own,
    equal the batch solved at once."""
    problem, params = ballbot.make_problem(device="cpu"), ballbot.make_params(device="cpu")
    grid = uniform_grid(0.0, 1.0, 8)
    x0s = torch.as_tensor(
        (0.1 * np.random.default_rng(2).standard_normal((4, ballbot.NX))).astype(np.float32))

    def solve(x):
        return ddp.solve(problem, grid, x, params, settings=ddp.DdpSettings(max_iterations=4),
                         device="cpu")

    assert mesh.batched(solve) is solve
    m = mesh.make_mesh(devices)
    whole, split = solve(x0s), mesh.sharded(solve, m)(x0s)
    assert type(split) is type(whole) and split.xs.device == torch.device("cpu")
    np.testing.assert_array_equal(split.iterations.numpy(), whole.iterations.numpy())
    for f in ("xs", "us", "gains"):
        np.testing.assert_allclose(getattr(split, f).numpy(), getattr(whole, f).numpy(),
                                   rtol=1e-5, atol=1e-5, err_msg=f)
    stats = mesh.scenario_rollout_stats(split.performance)
    assert stats["num"] == 4 and np.isfinite(stats["cost_mean"])
    with pytest.raises(ValueError, match="divide"):
        mesh.sharded(solve, m)(x0s[:3])


# -- SQP and SLP with qp_solver="pipg_sharded" ----------------------------------

SHARDS, BALLBOT_N = 4, 16
QP_CASES = {
    "sqp": dict(max_iterations=3, integrator="rk4", pipg_iterations=1000,
                use_feedback_policy=False),
    "slp": dict(max_iterations=3, pipg_iterations=1000),
}
X0 = {"sqp": (3, 0.1), "slp": (4, -0.08)}  # tests/test_sharding.py's leans


def _x0(kind):
    x0 = np.zeros(ballbot.NX, np.float32)
    x0[X0[kind][0]] = X0[kind][1]
    return x0


def _jax_qp_case(kind):
    jmesh = JaxMesh(np.asarray(jax.devices()[:SHARDS]), ("time",))
    mod, cls = (jsqp, jsqp.SqpSettings) if kind == "sqp" else (jslp, jslp.SlpSettings)
    st = cls(qp_solver="pipg_sharded", time_mesh=jmesh, **QP_CASES[kind])
    sol = jax.jit(lambda x: mod.solve(jballbot.make_problem(), juniform_grid(0.0, 1.0, BALLBOT_N),
                                      x, jballbot.make_params(), settings=st))(
        jnp.asarray(_x0(kind)))
    return dict(x0=_x0(kind), sol=sol)


JAX_RECORDS = {f"{kind}_pipg_sharded": (lambda kind=kind: _jax_qp_case(kind)) for kind in QP_CASES}
RECORDS = Records(__file__)


@pytest.mark.parametrize("kind", list(QP_CASES))
def test_pipg_sharded_solve_matches_pipg_and_the_reference(kind):
    solve = sqp.solve if kind == "sqp" else slp.solve
    cls = sqp.SqpSettings if kind == "sqp" else slp.SlpSettings
    run = lambda **kw: solve(  # noqa: E731
        ballbot.make_problem(device="cpu"), uniform_grid(0.0, 1.0, BALLBOT_N), _x0(kind),
        ballbot.make_params(device="cpu"), settings=cls(**QP_CASES[kind], **kw), device="cpu")
    mine = run(qp_solver="pipg_sharded", time_mesh=mesh.make_mesh(["cpu"] * SHARDS, "time"))
    plain = run(qp_solver="pipg")
    np.testing.assert_array_equal(mine.iterations.numpy(), plain.iterations.numpy())
    np.testing.assert_allclose(mine.xs.numpy(), plain.xs.numpy(), rtol=0.0, atol=SAME_ATOL)
    rec = RECORDS[f"{kind}_pipg_sharded"]
    np.testing.assert_array_equal(rec["x0"], _x0(kind))  # the record solved this start
    ref = rec["sol"]
    np.testing.assert_array_equal(mine.iterations.numpy(), np.atleast_1d(ref.iterations))
    for field in ("xs", "us"):
        np.testing.assert_allclose(getattr(mine, field)[0].numpy(), getattr(ref, field),
                                   atol=SOLVE_ATOL, rtol=SOLVE_RTOL, err_msg=field)


def test_pipg_sharded_needs_a_time_mesh():
    with pytest.raises(ValueError, match="time_mesh"):
        sqp.solve(ballbot.make_problem(device="cpu"), uniform_grid(0.0, 1.0, 4), _x0("sqp"),
                  ballbot.make_params(device="cpu"),
                  settings=sqp.SqpSettings(qp_solver="pipg_sharded"), device="cpu")
