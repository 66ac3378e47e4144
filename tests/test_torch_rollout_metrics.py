"""Rollout, trajectory metrics and augmented-Lagrangian bookkeeping of the
port vs the JAX package on the CPU (ballbot and the constrained toy problem),
atol 1e-5 in float32 unless a case says otherwise.  The JAX package's AL-DDP
solve of the toy (``JAX_RECORDS``) is stored in
``tests/torch_data/test_torch_rollout_metrics_jax.npz`` by
``tools/torch_test_records.py --record test_torch_rollout_metrics``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_toy_problem as toy
from ocs2_tpu.models import ballbot as jballbot
from ocs2_tpu.oc import metrics as jmetrics
from ocs2_tpu.oc import rollout as jrollout
from ocs2_tpu.oc.time_discretization import uniform_grid as juniform_grid
from ocs2_tpu.solvers import al as jal
from ocs2_tpu.solvers import ddp as jddp

from ocs2_tpu_torch import convert
from ocs2_tpu_torch.models import ballbot
from ocs2_tpu_torch.oc import approx, metrics, rollout
from ocs2_tpu_torch.oc.time_discretization import uniform_grid
from ocs2_tpu_torch.solvers import al, ddp
from tools._records import Records

torch.set_num_threads(1)  # one intra-op thread a test process: the suite runs in several
# processes at once (pytest-xdist), and these small tensors gain nothing from more.

ATOL = 1e-5
T = lambda v: torch.as_tensor(np.asarray(v, np.float32))  # noqa: E731
B, N, A = 3, 8, 4


@pytest.fixture(scope="module")
def search_data():
    rng = np.random.default_rng(0)
    return dict(
        x0=(0.1 * rng.standard_normal((B, 10))).astype(np.float32),
        us=(0.5 * rng.standard_normal((B, N, 3))).astype(np.float32),
        duff=(0.3 * rng.standard_normal((B, N, 3))).astype(np.float32),
        gains=(0.2 * rng.standard_normal((B, N, 3, 10))).astype(np.float32),
        xs=(0.1 * rng.standard_normal((B, N + 1, 10))).astype(np.float32),
        alphas=(0.5 ** np.arange(A)).astype(np.float32),
    )


@pytest.fixture(scope="module")
def jax_search(search_data):
    d = {k: jnp.asarray(v) for k, v in search_data.items()}
    problem, grid, params = jballbot.make_problem(), juniform_grid(0.0, 1.0, N), jballbot.make_params()

    def one(x0, us, duff, gains, xs):
        def try_alpha(alpha):
            pol = jrollout.ddp_search_policy(us, duff, gains, xs, alpha)
            xs_a, us_a = jrollout.rollout(problem, grid, x0, pol, params)
            return xs_a, us_a, jmetrics.evaluate_trajectory(problem, grid, xs_a, us_a, params).cost
        return jax.vmap(try_alpha)(d["alphas"])

    return jax.tree.map(np.asarray, jax.jit(jax.vmap(one))(
        d["x0"], d["us"], d["duff"], d["gains"], d["xs"]))


def test_line_search_rollout_matches_jax(search_data, jax_search):
    d = {k: T(v) for k, v in search_data.items()}
    problem, grid = ballbot.make_problem(device="cpu"), uniform_grid(0.0, 1.0, N)
    params = ballbot.make_params(device="cpu")
    pol = rollout.ddp_search_policy(d["us"], d["duff"], d["gains"], d["xs"], d["alphas"])
    xs, us = rollout.rollout(problem, grid, d["x0"][:, None, :].expand(B, A, 10), pol, params)
    assert xs.shape == (B, A, N + 1, 10) and us.shape == (B, A, N, 3)
    np.testing.assert_allclose(xs.numpy(), jax_search[0], atol=ATOL, rtol=1e-5)
    np.testing.assert_allclose(us.numpy(), jax_search[1], atol=ATOL, rtol=1e-5)
    cost = metrics.evaluate_trajectory(problem, grid, xs, us, params).cost
    assert cost.shape == (B, A)
    np.testing.assert_allclose(cost.numpy(), jax_search[2], rtol=1e-5)
    # A scalar step size gives the corresponding candidate.
    pol1 = rollout.ddp_search_policy(d["us"], d["duff"], d["gains"], d["xs"], 0.25)
    xs1, _ = rollout.rollout(problem, grid, d["x0"], pol1, params)
    np.testing.assert_allclose(xs1.numpy(), xs[:, 2].numpy(), atol=1e-6)


def test_open_loop_and_linear_policy_match_jax(search_data):
    d = search_data
    jp, jg, jpar = jballbot.make_problem(), juniform_grid(0.0, 1.0, N), jballbot.make_params()
    tp, tg = ballbot.make_problem(device="cpu"), uniform_grid(0.0, 1.0, N)
    tpar = ballbot.make_params(device="cpu")
    ref = jax.vmap(lambda x0, us: jrollout.rollout(
        jp, jg, x0, jrollout.open_loop_policy(us), jpar, method="rk2", substeps=2))(
            jnp.asarray(d["x0"]), jnp.asarray(d["us"]))
    mine = rollout.rollout(tp, tg, T(d["x0"]), rollout.open_loop_policy(T(d["us"])), tpar,
                           method="rk2", substeps=2)
    np.testing.assert_allclose(mine[0].numpy(), np.asarray(ref[0]), atol=ATOL)
    # Shared inputs [N, nu] broadcast over the batch.
    shared = rollout.rollout(tp, tg, T(d["x0"]), rollout.open_loop_policy(T(d["us"][0])), tpar)
    assert shared[1].shape == (B, N, 3)
    ref = jax.vmap(lambda x0, us, k, xs: jrollout.rollout(
        jp, jg, x0, jrollout.linear_policy(us, k, xs), jpar))(
            *(jnp.asarray(d[k]) for k in ("x0", "us", "gains", "xs")))
    mine = rollout.rollout(
        tp, tg, T(d["x0"]), rollout.linear_policy(T(d["us"]), T(d["gains"]), T(d["xs"])), tpar)
    np.testing.assert_allclose(mine[0].numpy(), np.asarray(ref[0]), atol=ATOL)
    np.testing.assert_allclose(mine[1].numpy(), np.asarray(ref[1]), atol=ATOL)


@pytest.fixture(scope="module")
def toy_metrics():
    b, n = 3, 6
    rng = np.random.default_rng(1)
    xs = (0.6 * rng.standard_normal((b, n + 1, 2))).astype(np.float32)
    us = rng.standard_normal((b, n, 1)).astype(np.float32)
    al_np = toy.random_al_numpy(b, n, rng)
    j_al = jal.AlState(**{k: jnp.asarray(v) for k, v in al_np.items()})
    t_al = convert.al_state_from_numpy(al_np, device="cpu")
    jm = jax.vmap(lambda x, u: jmetrics.evaluate_trajectory(
        toy.jax_problem(), juniform_grid(0.0, 1.2, n), x, u, toy.jax_params()))(
            jnp.asarray(xs), jnp.asarray(us))
    tm = metrics.evaluate_trajectory(
        toy.torch_problem(), uniform_grid(0.0, 1.2, n), T(xs), T(us), toy.torch_params())
    return jm, j_al, tm, t_al


@pytest.mark.parametrize("field", ["cost", "g_eq", "h_ineq", "h_state_ineq", "g_final_eq"])
def test_trajectory_metrics_match_jax(toy_metrics, field):
    jm, _, tm, _ = toy_metrics
    assert tm.g_state_eq is None and jm.g_state_eq is None
    np.testing.assert_allclose(
        getattr(tm, field).numpy(), np.asarray(getattr(jm, field)), atol=ATOL, rtol=1e-5)


def test_sse_merit_and_dual_ascent_match_jax(toy_metrics):
    jm, j_al, tm, t_al = toy_metrics
    np.testing.assert_allclose(
        tm.eq_sse.numpy(), np.asarray(jax.vmap(lambda m: m.eq_sse)(jm)), rtol=1e-5)
    np.testing.assert_allclose(
        tm.ineq_sse.numpy(), np.asarray(jax.vmap(lambda m: m.ineq_sse)(jm)), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(
        metrics.al_merit(tm, t_al).numpy(), np.asarray(jax.vmap(jmetrics.al_merit)(jm, j_al)),
        rtol=1e-5)
    dual = metrics.al_dual_ascent(tm, t_al)
    ref = jax.vmap(jmetrics.al_dual_ascent)(jm, j_al)
    for f in al.AlState._fields:
        np.testing.assert_allclose(
            getattr(dual, f).numpy(), np.asarray(getattr(ref, f)), atol=ATOL, err_msg=f)
    assert (dual.lmbd_ineq >= 0).all()


def test_merit_broadcasts_multipliers_over_candidates(toy_metrics):
    _, _, tm, t_al = toy_metrics
    cand = metrics.TrajectoryMetrics(*(None if a is None else torch.stack([a, 2 * a], 1) for a in tm))
    al_c = al.AlState(*(a.unsqueeze(1) for a in t_al))
    merit = metrics.al_merit(cand, al_c)
    assert merit.shape == (3, 2)
    np.testing.assert_allclose(merit[:, 0].numpy(), metrics.al_merit(tm, t_al).numpy(), rtol=1e-6)


def test_ballbot_has_no_constraints_and_al_state_is_empty():
    tp, tpar = ballbot.make_problem(device="cpu"), ballbot.make_params(device="cpu")
    dims = tp.constraint_dims(approx.example_params(tpar, "cpu"), device="cpu")
    jdims = jballbot.make_problem().constraint_dims(jddp._example_params(jballbot.make_params()))
    assert dims == jdims == {"ne": 0, "nse": 0, "ni": 0, "nsi": 0, "nfe": 0}
    state = al.AlState.init(dims, 5, rho=3.0, batch=(2,), device="cpu")
    assert state.lmbd_eq.shape == (2, 5, 0) and state.rho.tolist() == [3.0, 3.0]
    assert al.augment_problem(tp).cost_terms == tp.cost_terms and tp.cost_structure_psd
    toy_dims = toy.torch_problem().constraint_dims(
        approx.example_params(toy.torch_params(), "cpu"), device="cpu")
    assert toy_dims == toy.jax_problem().constraint_dims(
        jddp._example_params(toy.jax_params())) == {"ne": 1, "nse": 0, "ni": 1, "nsi": 1, "nfe": 1}
    assert not toy.torch_problem().cost_structure_psd
    grown = tp.add(inequality_terms=(lambda t, x, u, p: u,), nu=3)
    assert len(grown.inequality_terms) == 1 and grown.nu == 3


def test_augmented_cost_value_matches_jax():
    """The AL terms as plain cost callables (value, not quadratization)."""
    n = 6
    rng = np.random.default_rng(2)
    x = (0.5 * rng.standard_normal((n, 2))).astype(np.float32)
    u = rng.standard_normal((n, 1)).astype(np.float32)
    al_np = {k: v[0] for k, v in toy.random_al_numpy(1, n, rng).items()}
    j_al = jal.AlState(**{k: jnp.asarray(v) for k, v in al_np.items()})
    t_al = convert.al_state_from_numpy(al_np, device="cpu")
    jaug, taug = jal.augment_problem(toy.jax_problem()), al.augment_problem(toy.torch_problem())
    ts = np.linspace(0.0, 1.0, n).astype(np.float32)
    ref = jax.vmap(lambda k, t, xx, uu: jaug.cost(
        t, xx, uu, dict(toy.jax_params(), al=j_al, node=k, mode=0)))(
            jnp.arange(n), jnp.asarray(ts), jnp.asarray(x), jnp.asarray(u))
    mine = taug.cost(T(ts), T(x), T(u), dict(toy.torch_params(), al=t_al, node=torch.arange(n), mode=0))
    np.testing.assert_allclose(mine.numpy(), np.asarray(ref), rtol=1e-5, atol=ATOL)


TOY_DDP = dict(n=10, x0=np.float32([[0.4, 0.0], [-0.3, 0.2]]),
               settings=dict(algorithm="ilqr", max_iterations=6, convexify=False))


def _jax_toy_ddp():
    return jax.jit(jax.vmap(lambda x: jddp.solve(
        toy.jax_problem(), juniform_grid(0.0, 1.0, TOY_DDP["n"]), x, toy.jax_params(),
        settings=jddp.DdpSettings(**TOY_DDP["settings"]))))(jnp.asarray(TOY_DDP["x0"]))


JAX_RECORDS = {"toy_ddp": _jax_toy_ddp}
RECORDS = Records(__file__)


def test_constrained_toy_ddp_matches_jax():
    """A short AL-DDP solve of the constrained toy problem: the generic
    augmented-Lagrangian path of the solver (dual ascent, penalty growth,
    Gauss-Newton terms) follows the JAX solve."""
    n, x0, st = TOY_DDP["n"], TOY_DDP["x0"], TOY_DDP["settings"]
    ref = RECORDS["toy_ddp"]
    mine = ddp.solve(
        toy.torch_problem(), uniform_grid(0.0, 1.0, n), x0, toy.torch_params(),
        settings=ddp.DdpSettings(**st), device="cpu")
    np.testing.assert_array_equal(mine.iterations.numpy(), np.asarray(ref.iterations))
    np.testing.assert_allclose(mine.xs.numpy(), np.asarray(ref.xs), atol=1e-3)
    np.testing.assert_allclose(mine.us.numpy(), np.asarray(ref.us), atol=1e-3)
    np.testing.assert_allclose(mine.al.rho.numpy(), np.asarray(ref.al.rho), rtol=1e-6)
    np.testing.assert_allclose(
        mine.al.lmbd_eq.numpy(), np.asarray(ref.al.lmbd_eq), atol=1e-3, rtol=1e-3)
    np.testing.assert_allclose(
        mine.performance.equality_constraints_sse.numpy(),
        np.asarray(ref.performance.equality_constraints_sse), atol=1e-4, rtol=1e-3)
