"""The associative-scan Riccati (K7) of the port vs the JAX package, on the CPU.

``ops/riccati.lqr_backward_parallel`` against the JAX package's
``lqr_backward_parallel`` run live (jitted, small pieces): on
``tests/lq_fixtures.random_lq_coeffs`` at ``tests/test_riccati.py``'s three
cases and at the legged robot's projected (24, 12) over 100 nodes, a batch of three with a nonzero
``reg`` per scenario against ``jax.vmap``, and a ``Quu`` that is not
positive definite, where the NaN entries must be the same ones.  Tolerance:
rtol 2e-4 / atol 1e-4, float32 rounding of the batched LU solves and
products (the largest differences are 1e-5-1e-4 on entries of order 10-100).
K7 is also held against the port's sequential sweep at
``tests/test_riccati.py``'s 5e-3, and at one to three nodes (the scan's
shortest recursions) at 1e-4.

Whole solves with ``parallel_riccati=True`` against the JAX package's
(``JAX_RECORDS``, stored by ``tools/torch_test_records.py --record
test_torch_riccati_parallel``): SQP on the legged trot at N = 20
(``tests/test_torch_sqp.py``'s fixture), iLQR on ``tests/test_ddp.py``'s
double integrator and the interior-point solver on ``tests/test_ipm.py``'s;
iterations equal, ``xs`` / ``us`` within 1e-3 + 1e-4 |value|.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lq_fixtures import random_lq_coeffs
from ocs2_tpu.models import double_integrator as jdi
from ocs2_tpu.models.legged_robot import gait as jgait
from ocs2_tpu.models.legged_robot import interface as jinterface
from ocs2_tpu.models.legged_robot import model as jmodel
from ocs2_tpu.oc.time_discretization import make_time_grid as jmake_time_grid
from ocs2_tpu.oc.time_discretization import uniform_grid as juniform_grid
from ocs2_tpu.ops import riccati as jriccati
from ocs2_tpu.solvers import ddp as jddp
from ocs2_tpu.solvers import ipm as jipm
from ocs2_tpu.solvers import sqp as jsqp

from ocs2_tpu_torch import convert
from ocs2_tpu_torch.models import double_integrator as di
from ocs2_tpu_torch.models.legged_robot import interface, model
from ocs2_tpu_torch.models.legged_robot.gait import GaitSchedule, trot_gait
from ocs2_tpu_torch.oc.time_discretization import make_time_grid, uniform_grid
from ocs2_tpu_torch.ops import riccati
from ocs2_tpu_torch.solvers import ddp, ipm, sqp
from tools._records import Records

torch.set_num_threads(1)  # one intra-op thread a test process: the suite runs in several
# processes at once (pytest-xdist), and these small tensors gain nothing from more.

RTOL, ATOL = 2e-4, 1e-4
SEQ_ATOL = 5e-3  # tests/test_riccati.py::test_parallel_matches_sequential
SOLVE_ATOL, SOLVE_RTOL = 1e-3, 1e-4
FIELDS = riccati.LqrSolution._fields

_jax_data = jax.jit(random_lq_coeffs, static_argnums=(1, 2, 3))
_jax_batch_data = jax.jit(
    lambda keys, n, nx, nu: jax.vmap(lambda k: random_lq_coeffs(k, n, nx, nu))(keys),
    static_argnums=(1, 2, 3))
_jax_parallel = jax.jit(jriccati.lqr_backward_parallel)
_jax_parallel_batch = jax.jit(jax.vmap(jriccati.lqr_backward_parallel))


def _to_port(jcoeffs, batched=False):
    leaves = {k: np.asarray(v) if batched else np.asarray(v)[None]
              for k, v in jcoeffs._asdict().items()}
    return convert.lqr_coeffs_from_numpy(leaves, device="cpu")


def _close(mine, ref, fields=FIELDS, rtol=RTOL, atol=ATOL):
    for f in fields:
        a, b = getattr(mine, f).numpy(), np.asarray(getattr(ref, f))
        assert a.shape == b.shape, (f, a.shape, b.shape)
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b), err_msg=f)
        keep = ~np.isnan(b)
        np.testing.assert_allclose(a[keep], b[keep], rtol=rtol, atol=atol, err_msg=f)


# (seed, N, nx, nu): tests/test_riccati.py:35's three and the legged robot's
# projected sweep.
CASES = [(0, 16, 3, 2), (3, 64, 6, 4), (4, 33, 2, 2), (5, 100, 24, 12)]
# The batch: three scenarios, each with its own reg.
BATCH_SHAPE, BATCH_REG = (3, 20, 5, 3), np.float32([0.0, 0.1, 2.0])


@functools.lru_cache(maxsize=None)
def _case(seed, n, nx, nu):
    jc = _jax_data(jax.random.PRNGKey(seed), n, nx, nu)
    ref = jax.tree.map(lambda a: np.asarray(a)[None], _jax_parallel(jc))
    coeffs = _to_port(jc)
    return coeffs, ref, riccati.lqr_backward_parallel(coeffs)


@pytest.mark.parametrize("case", CASES, ids=lambda c: "seed{}_n{}_nx{}_nu{}".format(*c))
def test_matches_the_jax_parallel_sweep(case):
    _, ref, mine = _case(*case)
    _close(mine, ref)


@pytest.mark.parametrize("case", CASES, ids=lambda c: "seed{}_n{}_nx{}_nu{}".format(*c))
def test_matches_the_sequential_sweep(case):
    """The same value function and gains as the port's sequential sweep (the
    single-scenario sweep at B = 1), within tests/test_riccati.py's 5e-3."""
    coeffs, _, mine = _case(*case)
    seq = riccati.lqr_backward(coeffs, 0.0)
    _close(mine, seq, ("value_S", "value_s", "gains", "kff"), rtol=0.0, atol=SEQ_ATOL)


def _batch_data(seed):
    batch, n, nx, nu = BATCH_SHAPE
    return _jax_batch_data(jax.random.split(jax.random.PRNGKey(seed), batch), n, nx, nu)


def test_batch_with_reg_matches_jax_vmap():
    """A batch of three, each with its own ``reg`` (0, 0.1, 2.0), against
    ``jax.vmap``: dv1 and dv2 summed per scenario."""
    jc = _batch_data(9)
    ref = _jax_parallel_batch(jc, jnp.asarray(BATCH_REG))
    coeffs = _to_port(jc, batched=True)
    mine = riccati.lqr_backward_parallel(coeffs, torch.as_tensor(BATCH_REG))
    assert mine.dv1.shape == (3,) and mine.gains.shape == (3, 20, 3, 5)
    _close(mine, ref)
    # reg is added to Quu: the same as a solve of the shifted data.
    shifted = coeffs._replace(Quu=coeffs.Quu + torch.as_tensor(BATCH_REG)[:, None, None, None]
                              * torch.eye(3))
    _close(mine, riccati.lqr_backward_parallel(shifted), rtol=1e-5, atol=1e-5)


def test_nan_placement_on_a_quu_that_is_not_positive_definite():
    """``Quu = -100 I`` at node 7 of scenario 1 (reg 0.1 does not make it
    positive definite): NaN in the same entries as the JAX package's (that
    node's gains and every earlier node's, the value function up to it, dv1,
    dv2), the rest equal within the tolerance; the other scenarios stay
    finite."""
    jc = _batch_data(11)
    quu = np.array(jc.Quu)
    quu[1, 7] = -100.0 * np.eye(3)
    jc = jc._replace(Quu=jnp.asarray(quu))
    ref = _jax_parallel_batch(jc, jnp.asarray(BATCH_REG))
    mine = riccati.lqr_backward_parallel(_to_port(jc, batched=True), torch.as_tensor(BATCH_REG))
    _close(mine, ref)
    assert bool(torch.isnan(mine.gains[1, :8]).all()) and bool(torch.isnan(mine.dv1[1]))
    assert bool(torch.isfinite(mine.gains[1, 8:]).all())
    assert all(bool(torch.isfinite(getattr(mine, f)[[0, 2]]).all()) for f in FIELDS)


@pytest.mark.parametrize("n", [1, 2, 3])
def test_shortest_scans_match_the_sequential_sweep(n):
    """One, two and three nodes (two to four elements: the recursion's base
    case, an even and an odd fix-up), at B = 2, against the port's clamped
    batched sweep at 1e-4."""
    rng = np.random.default_rng(n)
    nx, nu = 3, 2
    m = rng.standard_normal((2, n, nu, nu))
    leaves = dict(
        A=np.eye(nx) + 0.3 * rng.standard_normal((2, n, nx, nx)),
        B=rng.standard_normal((2, n, nx, nu)), b=0.1 * rng.standard_normal((2, n, nx)),
        Qxx=np.broadcast_to(np.eye(nx), (2, n, nx, nx)), qx=rng.standard_normal((2, n, nx)),
        Quu=m @ np.swapaxes(m, -1, -2) + np.eye(nu), qu=rng.standard_normal((2, n, nu)),
        Qux=0.1 * rng.standard_normal((2, n, nu, nx)),
        Qf=np.broadcast_to(2.0 * np.eye(nx), (2, nx, nx)), qf=rng.standard_normal((2, nx)))
    coeffs = convert.lqr_coeffs_from_numpy(
        {k: np.ascontiguousarray(v, np.float32) for k, v in leaves.items()}, device="cpu")
    _close(riccati.lqr_backward_parallel(coeffs, 0.1), riccati.lqr_backward(coeffs, 0.1),
           rtol=1e-4, atol=1e-4)


# -- whole solves with parallel_riccati=True ------------------------------------

LEGGED_N = 20
LEGGED_SETTINGS = dict(max_iterations=4, integrator="rk2", parallel_riccati=True)
DI_N, DI_X0 = 40, (1.0, 0.0)


def _trot_events():
    ms = jgait.GaitSchedule(jgait.trot_gait(0.7)).mode_schedule(0.0, 1.0)
    return dict(event_times=np.asarray(ms.event_times), mode_sequence=np.asarray(ms.mode_sequence))


def _legged_inputs():
    x0 = np.array(jmodel.default_state(), np.float32)
    u0 = np.asarray(jmodel.weight_compensating_input(jnp.ones(4)), np.float32)
    return x0, np.tile(u0[None], (LEGGED_N, 1))


def _jax_sqp_trot():
    grid = jmake_time_grid(0.0, 1.0, LEGGED_N, **_trot_events())
    x0, us = _legged_inputs()
    sol = jax.jit(lambda x, u: jsqp.solve(
        jinterface.make_problem(), grid, x, jinterface.make_params(grid), us_init=u,
        settings=jsqp.SqpSettings(**LEGGED_SETTINGS)))(jnp.asarray(x0), jnp.asarray(us))
    return dict(x0=x0, sol=sol)


def _jax_ddp_di():
    sol = jax.jit(lambda x: jddp.solve(
        jdi.make_problem(), juniform_grid(0.0, 2.0, DI_N), x, jdi.make_params(),
        settings=jddp.DdpSettings(parallel_riccati=True)))(jnp.asarray(DI_X0, jnp.float32))
    return dict(sol=sol)


def _jax_ipm_di():
    sol = jax.jit(lambda x: jipm.solve(
        jdi.make_problem(), juniform_grid(0.0, 2.0, DI_N), x, jdi.make_params(),
        settings=jipm.IpmSettings(parallel_riccati=True)))(jnp.asarray(DI_X0, jnp.float32))
    return dict(sol=sol)


JAX_RECORDS = {"sqp_legged_trot": _jax_sqp_trot, "ddp_double_integrator": _jax_ddp_di,
               "ipm_double_integrator": _jax_ipm_di}
RECORDS = Records(__file__)


def _sqp_trot():
    ms = GaitSchedule(trot_gait(0.7)).mode_schedule(0.0, 1.0)
    grid = make_time_grid(0.0, 1.0, LEGGED_N, event_times=ms.event_times,
                          mode_sequence=ms.mode_sequence)
    x0, us = _legged_inputs()
    np.testing.assert_array_equal(RECORDS["sqp_legged_trot"]["x0"], x0)
    np.testing.assert_array_equal(x0, model.default_state("cpu").numpy())
    return sqp.solve(interface.make_problem(device="cpu"), grid, x0,
                     interface.make_params(grid, device="cpu"), us_init=torch.as_tensor(us),
                     settings=sqp.SqpSettings(**LEGGED_SETTINGS), device="cpu")


def _ddp_di():
    return ddp.solve(di.make_problem(device="cpu"), uniform_grid(0.0, 2.0, DI_N),
                     np.float32([DI_X0]), di.make_params(device="cpu"),
                     settings=ddp.DdpSettings(parallel_riccati=True), device="cpu")


def _ipm_di():
    return ipm.solve(di.make_problem(device="cpu"), uniform_grid(0.0, 2.0, DI_N),
                     np.float32(DI_X0), di.make_params(device="cpu"),
                     settings=ipm.IpmSettings(parallel_riccati=True), device="cpu")


SOLVES = {"sqp_legged_trot": _sqp_trot, "ddp_double_integrator": _ddp_di,
          "ipm_double_integrator": _ipm_di}


@pytest.mark.parametrize("name", list(SOLVES))
def test_parallel_riccati_solve_matches_the_reference(name, monkeypatch):
    """The solve never reaches the sequential sweep, and lands where the JAX
    package's solve with the associative scan lands."""
    from ocs2_tpu_torch.solvers import ddp as ddp_mod, ipm as ipm_mod, sqp as sqp_mod

    def refuse(*args, **kwargs):
        raise AssertionError("the sequential sweep ran with parallel_riccati=True")

    for mod in (ddp_mod, ipm_mod, sqp_mod):
        monkeypatch.setattr(mod, "lqr_backward", refuse)
    mine = SOLVES[name]()
    ref = RECORDS[name]["sol"]
    np.testing.assert_array_equal(mine.iterations.numpy(), np.atleast_1d(ref.iterations))
    for field in ("xs", "us"):
        np.testing.assert_allclose(getattr(mine, field)[0].numpy(), getattr(ref, field),
                                   atol=SOLVE_ATOL, rtol=SOLVE_RTOL, err_msg=field)
