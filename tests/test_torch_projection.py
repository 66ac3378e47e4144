"""Null-space projection of the port vs the JAX package on the CPU.

``Pu`` is not unique (column signs, any rotation of the null space), so what
is held against JAX is p0, Px, Pu Pu', and everything remapped to the full
input; the reduced coefficients are held through quantities a change of the
null-space basis leaves alone.  Invariants at 1e-4, float32."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ocs2_tpu.ops import projection as jprojection
from ocs2_tpu.ops import riccati as jriccati

from ocs2_tpu_torch import convert
from ocs2_tpu_torch.ops import projection, riccati
from test_torch_riccati import both, lq_numpy

torch.set_num_threads(1)  # one intra-op thread a test process: the suite runs in several
# processes at once (pytest-xdist), and these small tensors gain nothing from more.

TOL = 1e-4
B, N, NX, NU, NE = 3, 6, 8, 6, 3
# The flagship's sizes: 12 rows on 24 inputs.
SHAPES = {"small": (B, N, NX, NU, NE), "legged": (2, 4, 24, 24, 12)}


def constraint_numpy(batch, n, nx, nu, ne, seed):
    rng = np.random.default_rng(seed)
    return (
        rng.standard_normal((batch, n, ne)).astype(np.float32),
        rng.standard_normal((batch, n, ne, nx)).astype(np.float32),
        rng.standard_normal((batch, n, ne, nu)).astype(np.float32),
    )


@pytest.fixture(scope="module", params=list(SHAPES))
def case(request):
    batch, n, nx, nu, ne = SHAPES[request.param]
    leaves = lq_numpy(batch, n, nx, nu, seed=21)
    g, c, d = constraint_numpy(batch, n, nx, nu, ne, seed=22)
    jc, tc = both(leaves)
    jred, jproj = jax.jit(jax.vmap(jprojection.project_lqr_coeffs))(
        jc, jnp.asarray(g), jnp.asarray(c), jnp.asarray(d))
    tred, tproj = projection.project_lqr_coeffs(tc, *(torch.as_tensor(v) for v in (g, c, d)))
    return dict(jc=jc, tc=tc, g=g, c=c, d=d, jred=jred, jproj=jproj, tred=tred, tproj=tproj,
                dims=(batch, n, nx, nu, ne))


def test_shapes(case):
    batch, n, nx, nu, ne = case["dims"]
    p, r = case["tproj"], case["tred"]
    assert p.p0.shape == (batch, n, nu) and p.Px.shape == (batch, n, nu, nx)
    assert p.Pu.shape == (batch, n, nu, nu - ne)
    assert r.B.shape == (batch, n, nx, nu - ne) and r.Quu.shape == (batch, n, nu - ne, nu - ne)
    assert r.Qux.shape == (batch, n, nu - ne, nx) and r.qu.shape == (batch, n, nu - ne)
    assert all(leaf.dtype == torch.float32 for leaf in tuple(p) + tuple(r))


@pytest.mark.parametrize("field", ["p0", "Px"])
def test_determined_parts_match_jax(case, field):
    np.testing.assert_allclose(
        getattr(case["tproj"], field).numpy(), np.asarray(getattr(case["jproj"], field)),
        atol=TOL, rtol=TOL)


def test_null_space_projector_matches_jax(case):
    pu, jpu = case["tproj"].Pu.numpy(), np.asarray(case["jproj"].Pu)
    np.testing.assert_allclose(
        pu @ np.swapaxes(pu, -1, -2), jpu @ np.swapaxes(jpu, -1, -2), atol=TOL)


def test_null_space_basis_is_orthonormal_and_annihilated(case):
    pu = case["tproj"].Pu.numpy()
    nv = pu.shape[-1]
    np.testing.assert_allclose(
        np.swapaxes(pu, -1, -2) @ pu, np.broadcast_to(np.eye(nv), pu.shape[:2] + (nv, nv)),
        atol=TOL)
    np.testing.assert_allclose(case["d"] @ pu, 0.0, atol=TOL)


def test_feasibility_of_the_offset_and_feedback(case):
    """D p0 = -g and D Px = -C: any v gives a feasible du."""
    p = case["tproj"]
    np.testing.assert_allclose(
        (case["d"] @ p.p0.numpy()[..., None])[..., 0], -case["g"], atol=TOL)
    np.testing.assert_allclose(case["d"] @ p.Px.numpy(), -case["c"], atol=5 * TOL)


@pytest.mark.parametrize("field", ["A", "b", "Qxx", "qx", "Qf", "qf"])
def test_basis_independent_reduced_coeffs_match_jax(case, field):
    np.testing.assert_allclose(
        getattr(case["tred"], field).numpy(), np.asarray(getattr(case["jred"], field)),
        atol=TOL, rtol=TOL)


@pytest.mark.parametrize("name", ["B Pu'", "Pu Quu Pu'", "Pu qu", "Pu Qux"])
def test_basis_dependent_reduced_coeffs_match_jax_after_lifting(case, name):
    """B~ = B Pu, Quu~ = Pu' Quu Pu, qu~, Qux~ change with the basis; lifted
    back to the full input by Pu they do not."""
    def lift(red, pu):
        t = lambda m: np.swapaxes(m, -1, -2)  # noqa: E731
        return {
            "B Pu'": red.B @ t(pu), "Pu Quu Pu'": pu @ red.Quu @ t(pu),
            "Pu qu": (pu @ red.qu[..., None])[..., 0], "Pu Qux": pu @ red.Qux,
        }[name]

    mine = lift(type(case["tred"])(*(v.numpy() for v in case["tred"])), case["tproj"].Pu.numpy())
    ref = lift(type(case["jred"])(*(np.asarray(v) for v in case["jred"])),
               np.asarray(case["jproj"].Pu))
    np.testing.assert_allclose(mine, ref, atol=TOL, rtol=TOL)


@pytest.fixture(scope="module")
def remapped(case):
    """The projected QP solved on both sides and remapped to the full input."""
    batch, n, nx, nu, ne = case["dims"]

    def jsolve(red, proj):
        sol = jriccati._lqr_backward_single(red, jnp.asarray(1e-6))
        dxs, dvs = jriccati.lqr_forward(red, sol, jnp.zeros((nx,)))
        return (dxs, jprojection.remap_projected_input(proj, dxs[:-1], dvs),
                jprojection.remap_projected_gain(proj, sol.gains))

    ref = jax.jit(jax.vmap(jsolve))(case["jred"], case["jproj"])
    red = type(case["tred"])(*(v.contiguous() for v in case["tred"]))
    sol = riccati._lqr_backward_batched(red, 1e-6)
    dxs, dvs = riccati.lqr_forward(red, sol, torch.zeros((batch, nx)))
    mine = (dxs, projection.remap_projected_input(case["tproj"], dxs[:, :-1], dvs),
            projection.remap_projected_gain(case["tproj"], sol.gains))
    return mine, ref


@pytest.mark.parametrize("i, name", [(0, "dxs"), (1, "dus"), (2, "gains")])
def test_remapped_step_and_gains_match_jax(remapped, i, name):
    mine, ref = remapped
    a, b = mine[i].numpy(), np.asarray(ref[i])
    np.testing.assert_allclose(a, b, atol=TOL * max(1.0, np.abs(b).max()), rtol=TOL, err_msg=name)


def test_remapped_step_satisfies_the_linearized_constraint(case, remapped):
    (dxs, dus, _), _ = remapped
    res = (case["g"] + (case["c"] @ dxs[:, :-1].numpy()[..., None])[..., 0]
           + (case["d"] @ dus.numpy()[..., None])[..., 0])
    np.testing.assert_allclose(res, 0.0, atol=TOL * max(1.0, np.abs(dus.numpy()).max()))


def test_projection_from_numpy_roundtrip(case):
    rec = jax.tree.map(np.asarray, case["jproj"])._asdict()
    p = convert.projection_from_numpy(rec, device="cpu")
    assert isinstance(p, projection.Projection) and p.Pu.dtype == torch.float32
    np.testing.assert_array_equal(p.Px.numpy(), rec["Px"])


def test_one_node_without_leading_dims():
    g, c, d = constraint_numpy(1, 1, 5, 4, 2, seed=23)
    p = projection.constraint_projection(*(torch.as_tensor(v[0, 0]) for v in (g, c, d)))
    ref = jprojection.constraint_projection(*(jnp.asarray(v[0, 0]) for v in (g, c, d)))
    assert p.p0.shape == (4,) and p.Px.shape == (4, 5) and p.Pu.shape == (4, 2)
    np.testing.assert_allclose(p.p0.numpy(), np.asarray(ref.p0), atol=TOL)
    np.testing.assert_allclose(p.Px.numpy(), np.asarray(ref.Px), atol=TOL)


@pytest.mark.parametrize("shape", [(3, 5, 24, 12), (7, 6, 6), (4, 4)])
def test_householder_qr_is_a_complete_qr(shape):
    """The tensor-op QR factorizes as torch.linalg.qr(mode="complete") does:
    Q orthogonal, R upper triangular, Q R = A, and the same range / null
    space split (signs of the columns aside)."""
    rng = np.random.default_rng(41)
    a = torch.as_tensor(rng.standard_normal(shape).astype(np.float32))
    if len(shape) == 4:
        a[0, 0, :, 3] = 0.0  # a zero column: its reflection is the identity
    q, r = projection.householder_qr(a)
    m, n = shape[-2:]
    assert q.shape == shape[:-2] + (m, m) and r.shape == a.shape
    np.testing.assert_allclose((q @ r).numpy(), a.numpy(), atol=1e-5)
    np.testing.assert_allclose(
        (q.transpose(-1, -2) @ q).numpy(), np.broadcast_to(np.eye(m), q.shape), atol=1e-5)
    np.testing.assert_allclose(torch.tril(r, -1).numpy(), 0.0, atol=1e-5)
    q_ref, r_ref = torch.linalg.qr(a, mode="complete")
    np.testing.assert_allclose(r.abs().numpy(), r_ref.abs().numpy(), atol=1e-4)
    if m > n and len(shape) == 3:
        q2, q2_ref = q[..., n:], q_ref[..., n:]
        np.testing.assert_allclose(
            (q2 @ q2.transpose(-1, -2)).numpy(), (q2_ref @ q2_ref.transpose(-1, -2)).numpy(),
            atol=1e-5)


def test_householder_qr_keeps_untouched_coordinates_exact():
    """LAPACK's conventions: a reflector is the identity where its column is
    already zero below the diagonal, and Q is accumulated from the last
    reflector, so the null-space basis has an exact zero wherever the JAX
    package's QR has one (on the legged robot's foot-constraint structure:
    swing legs' force rows, stance rows on 1-3 joint velocities).  Rounding
    therefore couples no unconstrained input with the others: at a jump node
    under IPM's condensation (49 on a stance force, 1e-6 elsewhere) that
    coupling decided whether the float32 Cholesky of the reduced Hessian
    succeeded (PERF.md §6, PR 7)."""
    rng = np.random.default_rng(43)
    d = np.zeros((12, 24), np.float32)
    for row in range(12):  # each constraint row on 1-3 joint-velocity coordinates
        cols = 12 + rng.choice(12, size=1 + row % 3, replace=False)
        d[row, cols] = rng.standard_normal(cols.size)
    d[3:9] = 0.0
    d[3:9, 3:9] = np.eye(6, dtype=np.float32)  # two swing legs: zero force rows
    q, _ = projection.householder_qr(torch.as_tensor(d.T))
    q_ref, _ = jnp.linalg.qr(jnp.asarray(d.T), mode="complete")
    pu, pu_ref = q[:, 12:].numpy(), np.asarray(q_ref)[:, 12:]
    assert (pu == 0.0).sum() > 200
    np.testing.assert_array_equal(pu == 0.0, pu_ref == 0.0)
    np.testing.assert_allclose(np.abs(pu), np.abs(pu_ref), atol=1e-6)
