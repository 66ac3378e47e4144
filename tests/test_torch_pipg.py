"""PIPG, SQP with ``qp_solver="pipg"``, SLP and the small leftovers of the
port vs the JAX package on the CPU.

* ``ops/pipg``: ``ruiz_equilibrate``, ``estimate_sigma``,
  ``estimate_cost_eigs`` and ``pipg_solve`` after 200 iterations (with and
  without an input box) on a batch of random LQ problems made from a numpy
  seed, against ``jax.vmap`` of the JAX functions, at rtol 2e-4 / atol 1e-5
  (the iterate after 200 iterations at 1e-4 / 1e-5, stated below); at its
  full iteration count against the port's dense-KKT truth
  (``solvers/qp.solve_lq_dense``, float64), at ``tests/test_pipg.py``'s 5e-3.
* ``sqp.solve(qp_solver="pipg")`` and ``slp.solve`` on the double integrator
  (``tests/test_pipg.py``'s SLP case), a batch of one and of three: iterations
  equal, ``xs`` / ``us`` within 1e-3 + 1e-4 |value|, NaN wherever the JAX
  package puts NaN (all of ``value_S`` / ``value_s``), zero gains.
* ``al.update_multipliers`` and ``rollout.evaluate_rollout`` on the
  constrained toy problem (every constraint family).
"""
import functools
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_toy_problem as toy
from ocs2_tpu.models import double_integrator as jdi
from ocs2_tpu.oc import rollout as jrollout
from ocs2_tpu.oc.time_discretization import uniform_grid as juniform_grid
from ocs2_tpu.ops import pipg as jpipg
from ocs2_tpu.ops.riccati import LqrCoeffs as JLqrCoeffs
from ocs2_tpu.solvers import al as jal
from ocs2_tpu.solvers import qp as jqp
from ocs2_tpu.solvers import slp as jslp
from ocs2_tpu.solvers import sqp as jsqp

from ocs2_tpu_torch import convert
from ocs2_tpu_torch.models import double_integrator as di
from ocs2_tpu_torch.oc import rollout
from ocs2_tpu_torch.oc.time_discretization import uniform_grid
from ocs2_tpu_torch.ops import pipg
from ocs2_tpu_torch.ops.riccati import LqrCoeffs, lqr_backward, lqr_forward
from ocs2_tpu_torch.solvers import al, qp, slp, sqp
from tools._records import Records

torch.set_num_threads(1)  # one intra-op thread a test process: the suite runs in several
# processes at once (pytest-xdist), and these small tensors gain nothing from more.

RTOL, ATOL = 2e-4, 1e-5
SOLVE_ATOL, SOLVE_RTOL = 1e-3, 1e-4
BATCH, N, NX, NU = 3, 12, 4, 2


def random_lq(seed, batch=BATCH, n=N, nx=NX, nu=NU):
    """A batch of positive-definite LQ problems as numpy leaves [B, N, ...]
    (the shape of ``tests/lq_fixtures.random_lq_coeffs``)."""
    rng = np.random.default_rng(seed)
    def r(scale, *s):
        return (scale * rng.standard_normal((batch,) + s)).astype(np.float32)

    def psd(dim, count, eps):
        m = r(1.0, *count, dim, dim)
        return (m @ np.swapaxes(m, -1, -2) / dim + eps * np.eye(dim, dtype=np.float32)).astype(
            np.float32)

    return dict(
        A=r(1.0 / np.sqrt(nx), n, nx, nx) + 0.5 * np.eye(nx, dtype=np.float32),
        B=r(0.5, n, nx, nu), b=r(0.1, n, nx),
        Qxx=psd(nx, (n,), 0.2), qx=r(1.0, n, nx),
        Quu=psd(nu, (n,), 0.5), qu=r(1.0, n, nu), Qux=r(0.05, n, nu, nx),
        Qf=psd(nx, (), 0.3), qf=r(1.0, nx),
    )


def pair(leaves):
    return (LqrCoeffs(**{k: torch.as_tensor(v) for k, v in leaves.items()}),
            JLqrCoeffs(**{k: jnp.asarray(v) for k, v in leaves.items()}))


def close(mine, ref, rtol=RTOL, atol=ATOL, err_msg=""):
    np.testing.assert_allclose(np.asarray(mine), np.asarray(ref), rtol=rtol, atol=atol,
                               err_msg=err_msg)


# -- ops/pipg ------------------------------------------------------------------


def test_ruiz_equilibrate_matches_jax():
    mine_c, ref_c = pair(random_lq(0))
    scaled, scal = pipg.ruiz_equilibrate(mine_c, 5)
    ref_scaled, ref_scal = jax.jit(jax.vmap(lambda c: jpipg.ruiz_equilibrate(c, 5)))(ref_c)
    for name in LqrCoeffs._fields:
        close(getattr(scaled, name), getattr(ref_scaled, name), err_msg=name)
    for name in pipg.RuizScaling._fields:
        close(getattr(scal, name), getattr(ref_scal, name), err_msg=name)
    assert scal.c.shape == (BATCH,)


def test_ruiz_keeps_the_riccati_solution():
    """Solving the scaled QP and unscaling gives the unscaled Riccati
    solution (the stage form's -I block is kept exactly)."""
    coeffs, _ = pair(random_lq(4))
    dx0 = torch.zeros((BATCH, NX))
    ref = lqr_forward(coeffs, lqr_backward(coeffs, 0.0), dx0)
    scaled, scal = pipg.ruiz_equilibrate(coeffs, 5)
    dxs, dus = lqr_forward(scaled, lqr_backward(scaled, 0.0), dx0)
    close(scal.d_x * dxs, ref[0], atol=1e-4)
    close(scal.d_u * dus, ref[1], atol=1e-4)


def test_estimate_sigma_matches_jax():
    mine_c, ref_c = pair(random_lq(2))
    mine = pipg.estimate_sigma(mine_c, 60)
    ref = jax.jit(jax.vmap(lambda c: jpipg.estimate_sigma(c, 60)))(ref_c)
    assert mine.shape == (BATCH,)
    close(mine, ref)


def test_estimate_cost_eigs_match_jax():
    mine_c, ref_c = pair(random_lq(3))
    mu, lam = pipg.estimate_cost_eigs(mine_c, 80)
    mu_r, lam_r = jax.jit(jax.vmap(lambda c: jpipg.estimate_cost_eigs(c, 80)))(ref_c)
    close(lam, lam_r)
    # mu = lam - (Rayleigh quotient of lam I - Q): cancellation of two
    # numbers near lam, so its error is lam's rounding.
    close(mu, mu_r, atol=RTOL * float(lam_r.max()))
    assert bool((mu >= 0).all()) and bool((lam > mu).all())


@pytest.mark.parametrize("box", [False, True])
def test_pipg_iterate_matches_jax(box):
    """200 iterations, with and without a box on the inputs (half the
    Riccati step's largest input, so that it binds): every field of the
    iterate within rtol 1e-4 / atol 1e-5 of the JAX package's.  (200 steps of
    a contraction keep float32 reassociation at the step's own rounding.)
    The iterate is the over-relaxed one, which may leave the box before
    convergence, so the box shows in the unboxed iterate's difference."""
    mine_c, ref_c = pair(random_lq(1))
    scaled, scal = pipg.ruiz_equilibrate(mine_c, 5)
    kw, kw_r = {}, {}
    if box:
        _, dus = lqr_forward(mine_c, lqr_backward(mine_c, 0.0), torch.zeros((BATCH, NX)))
        cap = 0.5 * dus.abs().amax(dim=(1, 2))[:, None, None]
        kw = dict(u_lower=-cap / scal.d_u, u_upper=cap / scal.d_u)
        kw_r = {k: jnp.asarray(v.numpy()) for k, v in kw.items()}
    st = pipg.PipgSettings(num_iterations=200)
    mine = pipg.pipg_solve(scaled, st, **kw)
    ref_scaled = jax.vmap(lambda c: jpipg.ruiz_equilibrate(c, 5)[0])(ref_c)
    ref = jax.jit(jax.vmap(lambda c, *b: jpipg.pipg_solve(
        c, jpipg.PipgSettings(num_iterations=200), *b)))(
        ref_scaled, *(kw_r[k] for k in ("u_lower", "u_upper") if k in kw_r))
    for f in pipg.PipgSolution._fields:
        close(getattr(mine, f), getattr(ref, f), rtol=1e-4, atol=1e-5, err_msg=f)
    if box:
        free = pipg.pipg_solve(scaled, st)
        assert float((free.dus - mine.dus).abs().max()) > 0.1


def test_pipg_converges_to_the_dense_kkt_solution():
    """At full iterations PIPG lands on the float64 dense-KKT solution of
    every scenario (tests/test_pipg.py's bound against the Riccati sweep)."""
    coeffs, _ = pair(random_lq(0, n=20))
    scaled, scal = pipg.ruiz_equilibrate(coeffs, 5)
    sol = pipg.pipg_solve(scaled, pipg.PipgSettings(num_iterations=6000))
    assert bool((sol.primal_residual < 1e-3).all())
    for b in range(BATCH):
        truth = qp.solve_lq_dense(LqrCoeffs(*(leaf[b] for leaf in coeffs)), np.zeros(NX))
        close((scal.d_x * sol.dxs)[b], truth.dxs, rtol=0.0, atol=5e-3)
        close((scal.d_u * sol.dus)[b], truth.dus, rtol=0.0, atol=5e-3)


def test_solve_lq_dense_matches_jax_and_the_riccati_sweep():
    coeffs, ref_c = pair(random_lq(5))
    one = LqrCoeffs(*(leaf[0] for leaf in coeffs))
    mine = qp.solve_lq_dense(one, np.full(NX, 0.1))
    ref = jqp.solve_lq_dense(JLqrCoeffs(*(leaf[0] for leaf in ref_c)), np.full(NX, 0.1))
    np.testing.assert_array_equal(mine.dxs, ref.dxs)
    np.testing.assert_array_equal(mine.dus, ref.dus)
    assert mine.cost == ref.cost and mine.dxs.dtype == np.float64
    dxs, dus = lqr_forward(coeffs, lqr_backward(coeffs, 0.0), torch.full((BATCH, NX), 0.1))
    close(dxs[0], mine.dxs, atol=1e-4)
    close(dus[0], mine.dus, atol=1e-4)


# -- SQP with qp_solver="pipg", and SLP ------------------------------------------

DI_N = 20
PIPG_SETTINGS = dict(max_iterations=10, pipg_iterations=2000)
DI_X0 = np.array([[1.0, 0.0], [0.5, -0.5], [-0.8, 0.3]], np.float32)


def _jax_di_solve(solver, batch):
    jsettings, jsolve = {
        "sqp_pipg": (jsqp.SqpSettings(qp_solver="pipg", **PIPG_SETTINGS), jsqp.solve),
        "slp": (jslp.SlpSettings(**PIPG_SETTINGS), jslp.solve),
    }[solver]
    one = lambda x: jsolve(  # noqa: E731
        jdi.make_problem(), juniform_grid(0.0, 2.0, DI_N), x, jdi.make_params(),
        settings=jsettings)
    x0 = DI_X0[:batch]
    return jax.jit(one if batch == 1 else jax.vmap(one))(jnp.asarray(x0[0] if batch == 1 else x0))


@functools.lru_cache(maxsize=None)
def _di_solves(solver, batch):
    settings, solve = {
        "sqp_pipg": (sqp.SqpSettings(qp_solver="pipg", **PIPG_SETTINGS), sqp.solve),
        "slp": (slp.SlpSettings(**PIPG_SETTINGS), slp.solve),
    }[solver]
    ref = RECORDS[f"di_{solver}_b{batch}"]
    if batch == 1:
        ref = jax.tree.map(lambda a: a[None], ref)
    x0 = DI_X0[:batch]
    mine = solve(di.make_problem(device="cpu"), uniform_grid(0.0, 2.0, DI_N),
                 x0[0] if batch == 1 else x0, di.make_params(device="cpu"), settings=settings,
                 device="cpu")
    return mine, ref


PIPG_CASES = [(s, b) for s in ("sqp_pipg", "slp") for b in (1, 3)]
PROJECTED_TOY = dict(settings=dict(max_iterations=2, qp_solver="pipg", pipg_iterations=500),
                     x0=(0.3, -0.2))


def _jax_projected_toy():
    return jax.jit(lambda x: jsqp.solve(
        toy.jax_problem(2), juniform_grid(0.0, 1.0, 8), x, toy.jax_params(2),
        settings=jsqp.SqpSettings(**PROJECTED_TOY["settings"])))(
            jnp.asarray(PROJECTED_TOY["x0"], jnp.float32))


JAX_RECORDS = dict(
    {f"di_{s}_b{b}": functools.partial(_jax_di_solve, s, b) for s, b in PIPG_CASES},
    projected_toy=_jax_projected_toy)
RECORDS = Records(__file__)


@pytest.mark.parametrize("solver,batch", PIPG_CASES)
def test_pipg_solves_match_jax(solver, batch):
    mine, ref = _di_solves(solver, batch)
    np.testing.assert_array_equal(mine.iterations.numpy(), ref.iterations)
    np.testing.assert_array_equal(mine.converged.numpy(), ref.converged)
    for f in ("xs", "us"):
        close(getattr(mine, f), getattr(ref, f), rtol=SOLVE_RTOL, atol=SOLVE_ATOL, err_msg=f)
    # The first step is a full one in both; from the second on the iterate is
    # stationary up to PIPG's residual, where the filter's "merit fell" test
    # is decided by float32 rounding (tests/test_torch_sqp.py), so only the
    # NaN padding of the later rows is held.
    step, ref_step = mine.history.step_size.numpy(), ref.history.step_size
    np.testing.assert_array_equal(step[:, 0], ref_step[:, 0])
    np.testing.assert_array_equal(np.isnan(step), np.isnan(ref_step))
    assert float(mine.performance.dynamics_violation_sse.max()) < 1e-4


@pytest.mark.parametrize("solver,batch", PIPG_CASES)
def test_pipg_solves_leave_no_value_function_and_no_gains(solver, batch):
    """PIPG computes no value function: NaN in value_S / value_s where the
    JAX package has it (everywhere), and zero gains."""
    mine, ref = _di_solves(solver, batch)
    for f in ("value_S", "value_s"):
        a, b = getattr(mine, f).numpy(), getattr(ref, f)
        assert a.shape == b.shape
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
        assert np.isnan(a).all()
    assert mine.gains.shape == ref.gains.shape and not bool(mine.gains.any())
    assert not np.asarray(ref.gains).any()


def test_slp_is_within_the_reference_bound_of_the_riccati_sqp():
    """tests/test_pipg.py's bound: SLP's inputs within 5e-2 of SQP's."""
    mine, _ = _di_solves("slp", 3)
    ref = sqp.solve(di.make_problem(device="cpu"), uniform_grid(0.0, 2.0, DI_N), DI_X0,
                    di.make_params(device="cpu"), device="cpu")
    close(mine.us, ref.us, rtol=0.0, atol=5e-2)


SLP_RECORD = pathlib.Path(__file__).parent / "torch_data" / "slp_ballbot_reference.npz"
SLP_RECORD_SCENARIOS = 8


def test_slp_on_the_ballbot_matches_the_reference_record():
    """chip_smoke.py's SLP phase on the CPU for the first 8 of its 256
    scenarios (ballbot, N = 32, rk4, SlpSettings' defaults) against the JAX
    package's record (tools/slp_reference.py): inputs within 1e-3 + 1e-4
    |value|, merits within 1e-5.  Iterations are not held: SLP ends at a
    stall where whether a step of 1e-6 is accepted is float32 rounding.  The
    record's own SLP lies 0.026-2.2 from its SQP, so SQP is no reference
    here."""
    from ocs2_tpu_torch.models import ballbot

    with np.load(SLP_RECORD) as f:
        rec = {k: f[k][:SLP_RECORD_SCENARIOS] for k in f.files}
    sol = slp.solve(ballbot.make_problem(device="cpu"), uniform_grid(0.0, 1.0, 32), rec["x0s"],
                    ballbot.make_params(device="cpu"), settings=slp.SlpSettings(integrator="rk4"),
                    device="cpu")
    close(sol.us, rec["us"], rtol=SOLVE_RTOL, atol=SOLVE_ATOL)
    close(sol.performance.merit, rec["merit"], rtol=1e-5, atol=0.0)
    assert float(rec["us_max_abs_diff_vs_sqp"].min()) > 5e-2 / 2


def test_slp_settings_are_the_reference_s():
    st, ref = slp.SlpSettings(), jslp.SlpSettings()
    for f in ("qp_solver", "pipg_iterations", "ruiz_iterations", "use_feedback_policy"):
        assert getattr(st, f) == getattr(ref, f), f
    assert isinstance(st, sqp.SqpSettings)
    assert sqp.SqpSettings().pipg_iterations == jsqp.SqpSettings().pipg_iterations
    assert sqp.SqpSettings().ruiz_iterations == jsqp.SqpSettings().ruiz_iterations


def test_sqp_pipg_on_the_projected_toy_remaps_zero_gains():
    """With a projected equality the returned gains are the projection's
    state feedback (Px + Pu 0), as in the JAX package."""
    st = PROJECTED_TOY["settings"]
    x0 = np.array(PROJECTED_TOY["x0"], np.float32)
    ref = RECORDS["projected_toy"]
    mine = sqp.solve(toy.torch_problem(2), uniform_grid(0.0, 1.0, 8), x0, toy.torch_params(2),
                     settings=sqp.SqpSettings(**st), device="cpu")
    assert int(mine.iterations[0]) == int(ref.iterations)
    close(mine.gains[0], ref.gains, rtol=1e-3, atol=1e-4)
    assert bool(mine.gains.any())
    close(mine.us[0], ref.us, rtol=SOLVE_RTOL, atol=SOLVE_ATOL)


# -- the leftovers ------------------------------------------------------------


def _toy_trajectory(batch, seed):
    rng = np.random.default_rng(seed)
    xs = (0.5 * rng.standard_normal((batch, 9, 2))).astype(np.float32)
    us = (0.5 * rng.standard_normal((batch, 8, 1))).astype(np.float32)
    return xs, us


def test_update_multipliers_matches_jax():
    xs, us = _toy_trajectory(2, 7)
    al_np = toy.random_al_numpy(2, 8, np.random.default_rng(8))
    jgrid, tgrid = juniform_grid(0.0, 1.0, 8), uniform_grid(0.0, 1.0, 8)
    ref = jax.jit(jax.vmap(lambda x, u, a: jal.update_multipliers(
        toy.jax_problem(), jgrid, x, u, toy.jax_params(), a, rho_growth=3.0, rho_max=40.0)))(
        jnp.asarray(xs), jnp.asarray(us),
        jal.AlState(**{k: jnp.asarray(v) for k, v in al_np.items()}))
    mine = al.update_multipliers(
        toy.torch_problem(), tgrid, torch.as_tensor(xs), torch.as_tensor(us), toy.torch_params(),
        convert.al_state_from_numpy(al_np, device="cpu"), rho_growth=3.0, rho_max=40.0)
    for f in al.AlState._fields:
        close(getattr(mine, f), getattr(ref, f), err_msg=f)
    assert float(mine.rho.max()) <= 40.0


def test_evaluate_rollout_matches_jax():
    xs, us = _toy_trajectory(3, 9)
    jgrid, tgrid = juniform_grid(0.0, 1.0, 8), uniform_grid(0.0, 1.0, 8)
    ref = jax.jit(jax.vmap(lambda x, u: jrollout.evaluate_rollout(
        toy.jax_problem(), jgrid.device(), x, u, toy.jax_params())))(
        jnp.asarray(xs), jnp.asarray(us))
    mine = rollout.evaluate_rollout(toy.torch_problem(), tgrid, torch.as_tensor(xs),
                                    torch.as_tensor(us), toy.torch_params())
    for f in rollout.RolloutMetrics._fields:
        assert getattr(mine, f).shape == (3,)
        close(getattr(mine, f), getattr(ref, f), err_msg=f)
    assert float(mine.ineq_sse.min()) > 0.0 and float(mine.eq_sse.min()) > 0.0
