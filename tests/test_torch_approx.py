"""LQ approximation of the port vs the JAX package on the CPU: ballbot (the
slice's problem: closed-form cost blocks, jacfwd dynamics) and a toy
constrained problem under the augmented Lagrangian (Gauss-Newton terms, AD
fallbacks, constraint linearizations).  atol 1e-5, float32.

The JAX package's LQ approximations of the ballbot and toy fixtures
(``JAX_RECORDS``) are stored in ``tests/torch_data/test_torch_approx_jax.npz``
by ``tools/torch_test_records.py --record test_torch_approx``; the port runs
live on the same seeded inputs."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_toy_problem as toy
from ocs2_tpu.models import ballbot as jballbot
from ocs2_tpu.oc import approx as japprox
from ocs2_tpu.oc.time_discretization import uniform_grid as juniform_grid
from ocs2_tpu.solvers import al as jal

from ocs2_tpu_torch import convert
from ocs2_tpu_torch.models import ballbot
from ocs2_tpu_torch.oc import approx
from ocs2_tpu_torch.oc.time_discretization import uniform_grid
from ocs2_tpu_torch.solvers import al
from tools._records import Records

torch.set_num_threads(1)  # one intra-op thread a test process: the suite runs in several
# processes at once (pytest-xdist), and these small tensors gain nothing from more.

ATOL = 1e-5
T = lambda v: torch.as_tensor(np.asarray(v, np.float32))  # noqa: E731


def _flat(lq, prefix=""):
    """{name: array} of every non-None leaf of an LQData."""
    out = {}
    for name, rec in lq._asdict().items():
        if rec is None:
            continue
        for f, v in rec._asdict().items():
            if v is not None:
                out[f"{name}.{f}"] = np.asarray(v)
    return out


def _ballbot_inputs():
    b, n = 3, 8
    rng = np.random.default_rng(0)
    xs = (0.2 * rng.standard_normal((b, n + 1, 10))).astype(np.float32)
    us = rng.standard_normal((b, n, 3)).astype(np.float32)
    return n, xs, us


def _jax_ballbot_lq():
    n, xs, us = _ballbot_inputs()
    jp, jg = jballbot.make_problem(), juniform_grid(0.0, 1.0, n)
    return jax.jit(jax.vmap(
        lambda x, u: japprox.approximate_lq(jp, jg, x, u, jballbot.make_params())
    ))(jnp.asarray(xs), jnp.asarray(us))


@pytest.fixture(scope="module")
def ballbot_lq():
    n, xs, us = _ballbot_inputs()
    mine = approx.approximate_lq(
        ballbot.make_problem(device="cpu"), uniform_grid(0.0, 1.0, n), T(xs), T(us),
        ballbot.make_params(device="cpu"))
    return _flat(mine), _flat(RECORDS["ballbot_lq"])


BALLBOT_LEAVES = [
    "cost.f", "cost.dfdx", "cost.dfdu", "cost.dfdxx", "cost.dfdux", "cost.dfduu",
    "dynamics.f", "dynamics.dfdx", "dynamics.dfdu",
]


@pytest.mark.parametrize("leaf", BALLBOT_LEAVES)
def test_ballbot_lq_matches_jax(ballbot_lq, leaf):
    mine, ref = ballbot_lq
    assert set(mine) == set(ref) == set(BALLBOT_LEAVES)
    assert mine[leaf].dtype == np.float32 and mine[leaf].shape == ref[leaf].shape
    np.testing.assert_allclose(mine[leaf], ref[leaf], atol=ATOL, rtol=1e-5)


INTEGRATORS = [("euler", 1), ("rk2", 2)]


def _other_integrator_inputs():
    rng = np.random.default_rng(1)
    xs = (0.2 * rng.standard_normal((2, 5, 10))).astype(np.float32)
    us = rng.standard_normal((2, 4, 3)).astype(np.float32)
    return xs, us


def _jax_ballbot_other_integrator(method, substeps):
    xs, us = _other_integrator_inputs()
    return jax.vmap(lambda x, u: japprox.approximate_lq(
        jballbot.make_problem(), juniform_grid(0.0, 0.4, 4), x, u,
        jballbot.make_params(), method=method, substeps=substeps))(jnp.asarray(xs), jnp.asarray(us))


@pytest.mark.parametrize("method, substeps", INTEGRATORS)
def test_ballbot_dynamics_jacobians_other_integrators(method, substeps):
    xs, us = _other_integrator_inputs()
    ref = RECORDS[f"ballbot_{method}_{substeps}"]
    mine = approx.approximate_lq(
        ballbot.make_problem(device="cpu"), uniform_grid(0.0, 0.4, 4), T(xs), T(us),
        ballbot.make_params(device="cpu"), method=method, substeps=substeps)
    for f in ("f", "dfdx", "dfdu"):
        np.testing.assert_allclose(
            getattr(mine.dynamics, f).numpy(), np.asarray(getattr(ref.dynamics, f)), atol=ATOL)


def _toy_inputs():
    b, n = 3, 6
    rng = np.random.default_rng(2)
    xs = (0.5 * rng.standard_normal((b, n + 1, 2))).astype(np.float32)
    us = rng.standard_normal((b, n, 1)).astype(np.float32)
    return n, xs, us, toy.random_al_numpy(b, n, rng)


def _jax_toy_lq():
    n, xs, us, al_np = _toy_inputs()
    jp, jg, jpar = toy.jax_problem(), juniform_grid(0.0, 1.2, n), toy.jax_params()
    j_al = jal.AlState(**{k: jnp.asarray(v) for k, v in al_np.items()})
    ref_plain = jax.vmap(lambda x, u: japprox.approximate_lq(jp, jg, x, u, jpar))(
        jnp.asarray(xs), jnp.asarray(us))
    ref_aug = jax.vmap(lambda x, u, a: japprox.approximate_lq(
        jal.augment_problem(jp), jg, x, u, dict(jpar, al=a)))(
            jnp.asarray(xs), jnp.asarray(us), j_al)
    return dict(plain=ref_plain, augmented=ref_aug)


JAX_RECORDS = dict(
    {f"ballbot_{m}_{k}": functools.partial(_jax_ballbot_other_integrator, m, k)
     for m, k in INTEGRATORS},
    ballbot_lq=_jax_ballbot_lq, toy_lq=_jax_toy_lq)
RECORDS = Records(__file__)


@pytest.fixture(scope="module")
def toy_lq():
    """The constrained toy problem, plain and AL-augmented, B = 3."""
    n, xs, us, al_np = _toy_inputs()
    tp, tg, tpar = toy.torch_problem(), uniform_grid(0.0, 1.2, n), toy.torch_params()
    t_al = convert.al_state_from_numpy(al_np, device="cpu")
    mine_plain = approx.approximate_lq(tp, tg, T(xs), T(us), tpar)
    mine_aug = approx.approximate_lq(
        al.augment_problem(tp), tg, T(xs), T(us), dict(tpar, al=t_al))
    ref = RECORDS["toy_lq"]
    return ((_flat(mine_plain), _flat(ref["plain"])),
            (_flat(mine_aug), _flat(ref["augmented"])))


@pytest.mark.parametrize("which", ["plain", "augmented"])
def test_toy_lq_matches_jax(toy_lq, which):
    mine, ref = toy_lq[0] if which == "plain" else toy_lq[1]
    assert set(mine) == set(ref)
    if which == "plain":
        assert {"eq.dfdu", "ineq.f", "state_ineq.dfdx", "final_eq.f"} <= set(mine)
    else:  # the constraints went into the cost
        assert not any(k.split(".")[0] in ("eq", "ineq", "state_ineq", "final_eq") for k in mine)
    for k in ref:
        assert mine[k].shape == ref[k].shape, k
        np.testing.assert_allclose(mine[k], ref[k], atol=ATOL, rtol=1e-5, err_msg=k)


def _fn(lib):
    return lambda x, u: lib.sin(x[0]) * u[0] ** 2 + lib.exp(0.3 * x[1]) * u[1] + x[0] * x[1] * x[2]


def test_quadratize_scalar_matches_jax():
    rng = np.random.default_rng(3)
    x, u = rng.standard_normal(3).astype(np.float32), rng.standard_normal(2).astype(np.float32)
    ref = japprox.quadratize_scalar(_fn(jnp), jnp.asarray(x), jnp.asarray(u))
    mine = approx.quadratize_scalar(_fn(torch), T(x), T(u))
    for a, b in zip(mine, ref):
        assert a.dtype == torch.float32
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL)


def test_quadratize_state_scalar_matches_jax():
    x = np.random.default_rng(4).standard_normal(3).astype(np.float32)
    fn = lambda lib: (lambda xx: lib.cos(xx[0]) * xx[1] ** 2 + lib.tanh(xx[2]))  # noqa: E731
    ref = japprox.quadratize_state_scalar(fn(jnp), jnp.asarray(x), 2)
    mine = approx.quadratize_state_scalar(fn(torch), T(x), 2)
    for a, b in zip(mine, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL)
    assert mine.dfdux.shape == (2, 3) and not mine.dfduu.any()


@pytest.mark.parametrize("with_u", [True, False])
def test_linearize_vector_matches_jax(with_u):
    rng = np.random.default_rng(5)
    x, u = rng.standard_normal(3).astype(np.float32), rng.standard_normal(2).astype(np.float32)
    if with_u:
        fn = lambda lib: (lambda xx, uu: lib.stack(  # noqa: E731
            [lib.sin(xx[0]) * uu[1], xx[1] * xx[2] + uu[0] ** 2]))
        ref = japprox.linearize_vector(fn(jnp), jnp.asarray(x), jnp.asarray(u))
        mine = approx.linearize_vector(fn(torch), T(x), T(u))
    else:
        fn = lambda lib: (lambda xx: lib.stack([lib.sin(xx[0]) * xx[1], xx[2] ** 3]))  # noqa: E731
        ref = japprox.linearize_vector(fn(jnp), jnp.asarray(x), None)
        mine = approx.linearize_vector(fn(torch), T(x), None)
        assert mine.dfdu is None
    for a, b in zip(mine, ref):
        if b is not None:
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL)


def test_node_params_injects_mode_and_node():
    grid = uniform_grid(0.0, 1.0, 4).device("cpu")
    p = approx.node_params({"a": 1}, grid, torch.arange(3))
    assert p["a"] == 1 and p["mode"].shape == (3,) and p["node"].tolist() == [0, 1, 2]
    assert approx.node_params("opaque", grid, 0) == "opaque"
