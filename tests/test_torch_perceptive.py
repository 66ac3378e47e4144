"""The port's small-matrix solves and perceptive grids vs the JAX package on
the CPU: ``ops/smallmat`` (unrolled Cholesky and solves, the eps pivot clamp
on a matrix that is not positive definite), bilinear and trilinear
interpolation (values and ``jacfwd`` derivatives), the exact Euclidean
distance transform and the signed-distance field on a 12 x 12 x 8 grid, SDF
queries and gradients, and the end-effector distance constraint.

Inputs come from numpy seeds; the JAX side is jitted.  Values and
derivatives within rtol 1e-4 / atol 1e-5 (float32), distance transforms
exactly equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ocs2_tpu.models import perceptive as jperceptive
from ocs2_tpu.ops import smallmat as jsmallmat

from ocs2_tpu_torch import convert
from ocs2_tpu_torch.models import perceptive
from ocs2_tpu_torch.ops import smallmat

torch.set_num_threads(1)  # one intra-op thread a test process: the suite runs in several
# processes at once (pytest-xdist), and these small tensors gain nothing from more.

RTOL, ATOL = 1e-4, 1e-5
GRID_SHAPE = (12, 12, 8)


def close(mine, ref, rtol=RTOL, atol=ATOL):
    mine = mine.detach().cpu().numpy() if isinstance(mine, torch.Tensor) else np.asarray(mine)
    np.testing.assert_allclose(mine, np.asarray(ref), rtol=rtol, atol=atol)


def T(a):
    return torch.as_tensor(np.asarray(a))


def spd(batch, n, seed):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((batch, n, n)).astype(np.float32)
    return (a @ a.transpose(0, 2, 1) + n * np.eye(n, dtype=np.float32)).astype(np.float32)


# -- ops/smallmat --------------------------------------------------------------


@pytest.mark.parametrize("n", [1, 3, 6])
def test_cholesky_small_matches(n):
    m = spd(5, n, seed=n)
    ref = jsmallmat.cholesky_small(jnp.asarray(m))
    mine = smallmat.cholesky_small(T(m))
    for i in range(n):
        for j in range(i + 1):
            close(mine[i][j], ref[i][j])
    dense = np.zeros_like(m)
    for i in range(n):
        for j in range(i + 1):
            dense[:, i, j] = mine[i][j].numpy()
    close(dense @ dense.transpose(0, 2, 1), m, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("vec", [True, False], ids=["vector_rhs", "matrix_rhs"])
def test_solve_psd_small_matches(vec):
    m = spd(7, 3, seed=11)
    rhs = np.random.default_rng(12).standard_normal((7, 3) if vec else (7, 3, 2)).astype(
        np.float32)
    ref = jax.jit(jsmallmat.solve_psd_small)(jnp.asarray(m), jnp.asarray(rhs))
    mine = smallmat.solve_psd_small(T(m), T(rhs))
    assert mine.shape == rhs.shape and mine.dtype == torch.float32
    close(mine, ref)


@pytest.mark.parametrize("n", [3, 20], ids=["unrolled", "library"])
def test_solve_psd_dispatch_matches(n):
    m = spd(4, n, seed=20 + n)
    rhs = np.random.default_rng(n).standard_normal((4, n, 2)).astype(np.float32)
    ref = jax.jit(jsmallmat.solve_psd)(jnp.asarray(m), jnp.asarray(rhs))
    close(smallmat.solve_psd(T(m), T(rhs)), ref, rtol=1e-4, atol=1e-5)


def test_non_pd_matrix_is_clamped_not_raised():
    """A patch whose normal equations are singular gives the JAX package's
    finite answer where torch.linalg.cholesky would raise."""
    m = np.array([[[1.0, 1.0, 0.0], [1.0, 1.0, 0.0], [0.0, 0.0, -2.0]]], np.float32)
    rhs = np.array([[1.0, 2.0, 3.0]], np.float32)
    ref = jsmallmat.solve_psd_small(jnp.asarray(m), jnp.asarray(rhs))
    mine = smallmat.solve_psd_small(T(m), T(rhs))
    with pytest.raises(torch.linalg.LinAlgError):
        torch.linalg.cholesky(T(m))
    np.testing.assert_array_equal(np.isfinite(mine.numpy()), np.isfinite(np.asarray(ref)))
    close(mine, ref)


def test_solve_psd_small_under_jacfwd_and_vmap():
    m = spd(6, 3, seed=31)
    rhs = np.random.default_rng(32).standard_normal((6, 3)).astype(np.float32)
    ref = jax.jit(jax.vmap(jax.jacfwd(jsmallmat.solve_psd_small, argnums=1)))(
        jnp.asarray(m), jnp.asarray(rhs))
    mine = torch.func.vmap(torch.func.jacfwd(smallmat.solve_psd_small, argnums=1))(T(m), T(rhs))
    assert mine.dtype == torch.float32
    close(mine, ref)


# -- interpolation -------------------------------------------------------------


def grid3(seed=0):
    return np.random.default_rng(seed).standard_normal(GRID_SHAPE).astype(np.float32)


def fractional_indices(dims, count, seed):
    """Inside the grid, on its faces and beyond them (the clamp)."""
    hi = np.asarray(GRID_SHAPE[:dims], np.float32)
    idx = np.random.default_rng(seed).uniform(-1.5, 1.0, (count, dims)) * 1.0
    idx = idx + np.random.default_rng(seed + 1).uniform(0, 1, (count, dims)) * (hi + 1.0)
    return idx.astype(np.float32)


@pytest.fixture(scope="module")
def interp_ref():
    g3 = grid3()
    g2 = g3[:, :, 0].copy()
    i3, i2 = fractional_indices(3, 300, 1), fractional_indices(2, 300, 2)
    tri = lambda g, i: jperceptive.trilinear_interpolate(g, i)  # noqa: E731
    bil = lambda g, i: jperceptive.bilinear_interpolate(g, i)  # noqa: E731
    out = jax.jit(lambda g3_, g2_, i3_, i2_: (
        jax.vmap(tri, (None, 0))(g3_, i3_), jax.vmap(bil, (None, 0))(g2_, i2_),
        jax.vmap(jax.jacfwd(tri, argnums=1), (None, 0))(g3_, i3_),
        jax.vmap(jax.jacfwd(bil, argnums=1), (None, 0))(g2_, i2_)))(g3, g2, i3, i2)
    return dict(g3=g3, g2=g2, i3=i3, i2=i2, tri=out[0], bil=out[1], dtri=out[2], dbil=out[3])


def test_trilinear_values_match(interp_ref):
    r = interp_ref
    mine = perceptive.trilinear_interpolate(T(r["g3"]), T(r["i3"]))
    assert mine.shape == (300,) and mine.dtype == torch.float32
    close(mine, r["tri"])


def test_bilinear_values_match(interp_ref):
    r = interp_ref
    close(perceptive.bilinear_interpolate(T(r["g2"]), T(r["i2"])), r["bil"])


@pytest.mark.parametrize("kind", ["trilinear", "bilinear"])
def test_interpolation_jacfwd_matches(interp_ref, kind):
    """Derivatives flow through the fraction only (the integer cell carries
    no tangent); clamped queries have zero derivative along the clamp."""
    r = interp_ref
    fn, g, i, ref = (
        (perceptive.trilinear_interpolate, r["g3"], r["i3"], r["dtri"]) if kind == "trilinear"
        else (perceptive.bilinear_interpolate, r["g2"], r["i2"], r["dbil"]))
    mine = torch.func.vmap(torch.func.jacfwd(lambda ii: fn(T(g), ii)))(T(i))
    assert mine.dtype == torch.float32 and mine.shape == ref.shape
    close(mine, ref)


def test_interpolation_is_batch_polymorphic(interp_ref):
    r = interp_ref
    idx = T(r["i3"]).reshape(10, 30, 3)
    flat = perceptive.trilinear_interpolate(T(r["g3"]), T(r["i3"]))
    assert torch.equal(perceptive.trilinear_interpolate(T(r["g3"]), idx), flat.reshape(10, 30))


# -- distance transform and SDF ------------------------------------------------


def occupancy(seed=3):
    occ = np.random.default_rng(seed).uniform(size=GRID_SHAPE) > 0.85
    occ[2:5, 3:7, 1:4] = True  # one solid block
    return occ


@pytest.fixture(scope="module")
def sdf_pair():
    occ = occupancy()
    origin, res = (-0.3, -0.2, 0.05), 0.1
    ref = jax.jit(lambda o: jperceptive.signed_distance_field(o, origin, res))(jnp.asarray(occ))
    mine = perceptive.signed_distance_field(T(occ), origin, res)
    return occ, ref, mine


def test_edt_1d_matches():
    f = np.random.default_rng(4).uniform(0, 30, (12, 5, 3)).astype(np.float32)
    f[f > 25] = 1e12
    ref = jax.jit(jperceptive._edt_1d_sq)(jnp.asarray(f))
    np.testing.assert_array_equal(perceptive._edt_1d_sq(T(f)).numpy(), np.asarray(ref))


def test_distance_transform_matches_and_is_euclidean():
    occ = occupancy()
    ref = jax.jit(lambda o: jperceptive.distance_transform(o, 0.1))(jnp.asarray(occ))
    mine = perceptive.distance_transform(T(occ), 0.1)
    assert mine.dtype == torch.float32
    np.testing.assert_array_equal(mine.numpy(), np.asarray(ref))
    # Brute force on the grid: the nearest occupied cell.
    cells = np.argwhere(occ)
    probe = np.array([[0, 0, 0], [11, 11, 7], [6, 2, 5]])
    for p in probe:
        d = np.sqrt(((cells - p) ** 2).sum(1)).min() * 0.1
        assert float(mine[tuple(p)]) == pytest.approx(d, rel=1e-6)


def test_signed_distance_field_matches(sdf_pair):
    occ, ref, mine = sdf_pair
    np.testing.assert_array_equal(mine.values.numpy(), np.asarray(ref.values))
    close(mine.origin, ref.origin, 0, 0)
    assert mine.resolution.dtype == torch.float32 and mine.resolution.ndim == 0
    assert bool((mine.values[T(occ)] < 0).all()) and bool((mine.values[~T(occ)] > 0).all())


def test_sdf_query_and_gradient_match(sdf_pair):
    _, ref, mine = sdf_pair
    pts = np.random.default_rng(5).uniform([-0.4, -0.3, 0.0], [1.0, 1.0, 0.8], (200, 3)).astype(
        np.float32)
    q_ref, g_ref = jax.jit(lambda s, p: (jax.vmap(s.query)(p), jax.vmap(s.gradient)(p)))(
        ref, jnp.asarray(pts))
    close(mine.query(T(pts)), q_ref)
    close(mine.gradient(T(pts)), g_ref)
    assert mine.gradient(T(pts[0])).shape == (3,)


def test_ee_distance_constraint_matches(sdf_pair):
    _, ref, mine = sdf_pair
    ee_j = lambda x: jnp.reshape(x[:6], (2, 3))  # noqa: E731
    ee_t = lambda x: x[..., :6].reshape(x.shape[:-1] + (2, 3))  # noqa: E731
    xs = np.random.default_rng(6).uniform(0.0, 0.7, (20, 8)).astype(np.float32)
    h_ref = jax.jit(jax.vmap(lambda x: jperceptive.ee_distance_constraint(ref, ee_j, 0.05)(
        0.0, x, {})))(jnp.asarray(xs))
    h = perceptive.ee_distance_constraint(mine, ee_t, 0.05)
    close(h(0.0, T(xs), {}), h_ref)
    # A field in params takes the place of the captured one.
    shifted = mine._replace(values=mine.values + 1.0)
    close(h(0.0, T(xs), {"sdf": shifted}), np.asarray(h_ref) + 1.0)


def test_sdf_from_numpy_round_trip(sdf_pair):
    _, ref, mine = sdf_pair
    back = convert.signed_distance_field_from_numpy(
        jax.tree.map(np.asarray, ref)._asdict(), device="cpu")
    for a, b in zip(back, mine):
        assert torch.equal(a, b)
