"""The port's elevation-map terrain model vs the JAX package on the CPU:
``ElevationMap`` queries (``height_at``, ``plane_at`` with its 5 x 5 fit,
``sdf``), the three terrain constraints (stance on terrain, swing clearance,
terrain friction cone) with their Jacobians, and the elevation-map
perceptive problem (``make_perceptive_problem``) through
``approximate_lq`` and ``evaluate_trajectory`` on a trot grid of 14 nodes
over 0.7 s.

Maps and states come from numpy seeds; the JAX side is jitted with the grid
and params as arguments.  Tolerances: heights and SDF values exact to
float32 rounding (atol 1e-6); plane normals and points no farther from a
float64 fit of the same cells than the JAX package's, and within twice that
distance of the JAX package's (the 3x3 normal equations are ill-conditioned
in float32); constraint values and
Jacobians rtol 1e-4 / atol 1e-5 times the largest entry (1e-4 for the
friction cone, which reads the fit's normal); LQ coefficients rtol 1e-4 /
atol 1e-5 times the leaf's largest entry, as in
``test_torch_legged_model.py`` (Hessians reach 1e4).  The JAX package's LQ
approximation and trajectory metrics of the perceptive problem
(``JAX_RECORDS``) are stored in ``tests/torch_data/test_torch_terrain_jax.npz``
by ``tools/torch_test_records.py --record test_torch_terrain``.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ocs2_tpu.models.legged_robot import gait as jgait
from ocs2_tpu.models.legged_robot import interface as jinterface
from ocs2_tpu.models.legged_robot import model as jmodel
from ocs2_tpu.models.legged_robot import terrain as jterrain
from ocs2_tpu.oc import approx as japprox
from ocs2_tpu.oc import metrics as jmetrics
from ocs2_tpu.oc.time_discretization import make_time_grid as jmake_time_grid

from ocs2_tpu_torch import convert
from ocs2_tpu_torch.models.legged_robot import interface, terrain
from ocs2_tpu_torch.oc import approx, metrics
from ocs2_tpu_torch.oc.time_discretization import make_time_grid
from tools._records import Records

torch.set_num_threads(1)  # one intra-op thread a test process: the suite runs in several
# processes at once (pytest-xdist), and these small tensors gain nothing from more.

RTOL, ATOL = 1e-4, 1e-5
N, HORIZON = 14, 0.7
TROT_MODE = 9  # LF + RH in stance


def close(mine, ref, rtol=RTOL, atol=ATOL):
    mine = mine.detach().cpu().numpy() if isinstance(mine, torch.Tensor) else np.asarray(mine)
    np.testing.assert_allclose(mine, np.asarray(ref), rtol=rtol, atol=atol)


def T(a):
    return torch.as_tensor(np.asarray(a))


def heights(kind):
    """The perceptive lane's stepped map (0.12 m at x = 0.45, 4 m at 0.05 m),
    or the same with a 0.3 grade and 1 cm of seeded roughness."""
    res, extent = 0.05, 4.0
    n = int(extent / res)
    xs = -extent / 2 + (np.arange(n) + 0.5) * res
    h = np.zeros((n, n), np.float32)
    h[xs > 0.45, :] = 0.12
    if kind == "rough_slope":
        h = h + 0.3 * np.clip(xs, 0.0, None)[:, None] + 0.01 * np.random.default_rng(7).standard_normal(
            (n, n))
    return h.astype(np.float32)


@functools.lru_cache(maxsize=None)
def maps(kind="step"):
    h = heights(kind)
    kw = dict(origin_xy=(-2.0, -2.0), resolution=0.05)
    return jterrain.ElevationMap.create(h, **kw), terrain.ElevationMap.create(h, device="cpu", **kw)


def queries(count, seed):
    return np.random.default_rng(seed).uniform(-2.2, 2.2, (count, 2)).astype(np.float32)


def states(count, seed):
    """States near the stand, the base spread over x in [-0.3, 0.9] so feet
    straddle the step."""
    rng = np.random.default_rng(seed)
    x = np.asarray(jmodel.default_state())[None] + 0.02 * rng.standard_normal((count, 24))
    x[:, 6] = rng.uniform(-0.3, 0.9, count)
    u = np.asarray(jmodel.weight_compensating_input(jnp.ones(4)))[None] + 5.0 * rng.standard_normal(
        (count, 24))
    return x.astype(np.float32), u.astype(np.float32)


# -- the map -----------------------------------------------------------------


@pytest.mark.parametrize("kind", ["step", "rough_slope"])
def test_height_at_matches(kind):
    jem, em = maps(kind)
    xy = queries(500, 1)
    ref = jax.jit(jax.vmap(jem.height_at))(jnp.asarray(xy))
    mine = em.height_at(T(xy))
    assert mine.shape == (500,) and mine.dtype == torch.float32
    close(mine, ref, 0, 1e-6)


def plane_fit_float64(kind, xy, window=5):
    """The plane fit of ``plane_at`` in float64 (numpy), the same window and
    cell coordinates: (normals, points) [M, 3]."""
    h = heights(kind).astype(np.float64)
    res, origin = float(np.float32(0.05)), -2.0
    c = np.floor((xy.astype(np.float64) - origin) / res).astype(int) - window // 2
    c = np.clip(c, 0, np.asarray(h.shape) - window)
    ar = np.arange(window)
    xs = np.broadcast_to(((c[:, 0:1] + ar) * res + origin)[:, :, None], (len(xy), window, window))
    ys = np.broadcast_to(((c[:, 1:2] + ar) * res + origin)[:, None, :], (len(xy), window, window))
    zs = h[(c[:, 0:1] + ar)[:, :, None], (c[:, 1:2] + ar)[:, None, :]]
    basis = np.stack([xs.reshape(len(xy), -1), ys.reshape(len(xy), -1),
                      np.ones((len(xy), window * window))], axis=1)
    ata = basis @ basis.transpose(0, 2, 1) + 1e-6 * np.eye(3)
    coef = np.linalg.solve(ata, (basis @ zs.reshape(len(xy), -1, 1)))[..., 0]
    n = np.stack([-coef[:, 0], -coef[:, 1], np.ones(len(xy))], axis=1)
    z = coef[:, 0] * xy[:, 0] + coef[:, 1] * xy[:, 1] + coef[:, 2]
    return n / np.linalg.norm(n, axis=1, keepdims=True), np.stack([xy[:, 0], xy[:, 1], z], 1)


@pytest.mark.parametrize("kind", ["step", "rough_slope"])
def test_plane_at_matches(kind):
    """The fit's normal equations are ill-conditioned in float32 (world
    coordinates up to 2 m, a 0.2 m window): the JAX package's normals sit up
    to 8e-5 from a float64 fit of the same cells.  The port must land no
    farther from that float64 fit than the JAX package does, and within
    twice that distance of the JAX package."""
    jem, em = maps(kind)
    xy = queries(500, 2)
    ref = jax.jit(jax.vmap(jem.plane_at))(jnp.asarray(xy))
    mine = em.plane_at(T(xy))
    assert mine.normal.dtype == torch.float32 and mine.point.dtype == torch.float32
    truth = plane_fit_float64(kind, xy)
    for leaf, true in zip(("normal", "point"), truth):
        a, b = getattr(mine, leaf).numpy(), np.asarray(getattr(ref, leaf))
        ref_err = np.abs(b - true).max()
        assert np.abs(a - true).max() <= ref_err, (leaf, np.abs(a - true).max(), ref_err)
        assert np.abs(a - b).max() <= 2.0 * ref_err, (leaf, np.abs(a - b).max(), ref_err)
        assert ref_err < 1e-4, ref_err
    close(torch.linalg.norm(mine.normal, dim=-1), np.ones(500), 0, 1e-6)


def test_plane_at_under_vmap_matches_batch():
    _, em = maps("rough_slope")
    xy = T(queries(50, 3))
    batch = em.plane_at(xy)
    mapped = torch.func.vmap(em.plane_at)(xy)
    close(mapped.normal, batch.normal.numpy(), 1e-6, 1e-7)


def test_plane_fit_on_flat_and_sloped_regions():
    _, em = maps("step")
    for xy, z in (((-0.5, 0.3), 0.0), ((1.5, -0.4), 0.12)):
        plane = em.plane_at(torch.tensor(xy))
        close(plane.normal, [0.0, 0.0, 1.0], 0, 1e-4)
        assert float(plane.point[2]) == pytest.approx(z, abs=1e-3)


@pytest.mark.parametrize("z_resolution", [None, 0.04])
def test_elevation_sdf_matches(z_resolution):
    jem, em = maps("step")
    ref = jem.sdf(-0.1, 0.5, z_resolution)
    mine = em.sdf(-0.1, 0.5, z_resolution)
    assert mine.values.shape == ref.values.shape
    close(mine.values, ref.values, 0, 1e-6)
    close(mine.origin, ref.origin, 0, 0)
    pts = np.random.default_rng(4).uniform([-1.0, -1.0, -0.05], [1.0, 1.0, 0.45], (100, 3)).astype(
        np.float32)
    close(mine.query(T(pts)), jax.vmap(ref.query)(jnp.asarray(pts)))


def test_elevation_map_from_numpy_round_trip():
    jem, em = maps("rough_slope")
    back = convert.elevation_map_from_numpy(jax.tree.map(np.asarray, jem)._asdict(), device="cpu")
    for a, b in zip(back, em):
        assert torch.equal(a, b)


# -- the terrain constraints --------------------------------------------------


def constraint_pair(name, kind="rough_slope"):
    jem, em = maps(kind)
    if name == "stance_on_terrain":
        return jterrain.stance_on_terrain(jem), terrain.stance_on_terrain(em), False
    if name == "swing_clearance_over_terrain":
        return (jterrain.swing_clearance_over_terrain(jem),
                terrain.swing_clearance_over_terrain(em), False)
    return jterrain.terrain_friction_cone(jem), terrain.terrain_friction_cone(em), True


CONSTRAINTS = ["stance_on_terrain", "swing_clearance_over_terrain", "terrain_friction_cone"]


def node_params(mode, node=3):
    swing_z = 0.05 * np.sin(np.arange((N + 1) * 4, dtype=np.float32)).reshape(N + 1, 4)
    jp = dict(mode=jnp.int32(mode), node=jnp.int32(node), swing_z=jnp.asarray(swing_z))
    tp = dict(mode=torch.tensor(mode), node=torch.tensor(node), swing_z=T(swing_z))
    return jp, tp


@functools.lru_cache(maxsize=None)
def jax_constraint(name):
    """The JAX constraint's values and Jacobians over a batch of states, one
    program per constraint (the params are arguments)."""
    jfn, _, with_input = constraint_pair(name)
    if with_input:
        def one(x, u, p):
            f = lambda xx, uu: jfn(0.0, xx, uu, p)  # noqa: E731
            return (f(x, u), *jax.jacrev(f, argnums=(0, 1))(x, u))
        return jax.jit(jax.vmap(one, in_axes=(0, 0, None)))
    def one(x, u, p):
        f = lambda xx: jfn(0.0, xx, p)  # noqa: E731
        return f(x), jax.jacrev(f)(x)
    return jax.jit(jax.vmap(one, in_axes=(0, 0, None)))


@pytest.mark.parametrize("name", CONSTRAINTS)
@pytest.mark.parametrize("mode", [TROT_MODE, 15])
def test_terrain_constraint_values_and_jacobians_match(name, mode):
    _, tfn, with_input = constraint_pair(name)
    x, u = states(40, 5)
    jp, tp = node_params(mode)
    ref = jax_constraint(name)(jnp.asarray(x), jnp.asarray(u), jp)
    if with_input:
        tf = lambda xx, uu: tfn(0.0, xx, uu, tp)  # noqa: E731
        mine = (tf(T(x), T(u)), *torch.func.vmap(torch.func.jacrev(tf, argnums=(0, 1)))(T(x), T(u)))
    else:
        tf = lambda xx: tfn(0.0, xx, tp)  # noqa: E731
        mine = (tf(T(x)), torch.func.vmap(torch.func.jacrev(tf))(T(x)))
    # The cone reads the plane fit's normal, whose own float32 error is up
    # to 1e-4 (test_plane_at_matches): atol 1e-4 for it, 1e-5 otherwise,
    # times the largest entry.
    atol = 1e-4 if name == "terrain_friction_cone" else ATOL
    for a, b in zip(mine, ref):
        assert a.shape == b.shape and a.dtype == torch.float32
        close(a, b, atol=atol * max(1.0, float(np.abs(np.asarray(b)).max())))


# -- the elevation-map perceptive problem ---------------------------------------


def grids():
    ms = jgait.GaitSchedule(jgait.trot_gait(0.7)).mode_schedule(0.0, HORIZON)
    kw = dict(event_times=np.asarray(ms.event_times), mode_sequence=np.asarray(ms.mode_sequence))
    return jmake_time_grid(0.0, HORIZON, N, **kw), make_time_grid(0.0, HORIZON, N, **kw)


def trajectory(batch, seed):
    x, u = states(batch * (N + 1), seed)
    return x.reshape(batch, N + 1, 24), u.reshape(batch, N + 1, 24)[:, :N]


def _jax_elevation_problem_lq():
    jem, _ = maps("rough_slope")
    jg, _ = grids()
    xs, us = trajectory(1, seed=8)
    jp = jterrain.make_perceptive_problem(jem)
    return jax.jit(lambda x, u, g, p: japprox.approximate_lq(jp, g, x, u, p, method="rk2"))(
        jnp.asarray(xs[0]), jnp.asarray(us[0]), jg, jinterface.make_params(jg))


def _jax_elevation_problem_metrics():
    jem, _ = maps("step")
    jg, _ = grids()
    xs, us = trajectory(2, seed=9)
    jp = jterrain.make_perceptive_problem(jem)
    return jax.jit(jax.vmap(lambda x, u: jmetrics.evaluate_trajectory(
        jp, jg, x, u, jinterface.make_params(jg))))(jnp.asarray(xs), jnp.asarray(us))


JAX_RECORDS = {"elevation_problem_lq": _jax_elevation_problem_lq,
               "elevation_problem_metrics": _jax_elevation_problem_metrics}
RECORDS = Records(__file__)


@pytest.fixture(scope="module")
def elevation_problem_lq():
    _, em = maps("rough_slope")
    _, tg = grids()
    xs, us = trajectory(1, seed=8)
    ref = RECORDS["elevation_problem_lq"]
    tp = terrain.make_perceptive_problem(em, device="cpu")
    mine = approx.approximate_lq(tp, tg, T(xs), T(us), interface.make_params(tg, device="cpu"),
                                 method="rk2")
    return mine, ref


LQ_LEAVES = [("cost", f) for f in ("f", "dfdx", "dfdu", "dfdxx", "dfdux", "dfduu")] + [
    ("dynamics", f) for f in ("f", "dfdx", "dfdu")] + [("eq", f) for f in ("f", "dfdx", "dfdu")]


@pytest.mark.parametrize("leaf", LQ_LEAVES, ids=lambda lf: ".".join(lf))
def test_elevation_problem_lq_matches(elevation_problem_lq, leaf):
    mine, ref = elevation_problem_lq
    a = getattr(getattr(mine, leaf[0]), leaf[1])[0]
    b = np.asarray(getattr(getattr(ref, leaf[0]), leaf[1]))
    assert a.shape == b.shape and a.dtype == torch.float32
    close(a, b, atol=ATOL * max(1.0, float(np.abs(b).max())))


def test_elevation_problem_metrics_match():
    _, em = maps("step")
    _, tg = grids()
    xs, us = trajectory(2, seed=9)
    ref = RECORDS["elevation_problem_metrics"]
    mine = metrics.evaluate_trajectory(terrain.make_perceptive_problem(em, device="cpu"), tg,
                                       T(xs), T(us), interface.make_params(tg, device="cpu"))
    close(mine.cost, ref.cost)
    close(mine.g_eq, ref.g_eq)
