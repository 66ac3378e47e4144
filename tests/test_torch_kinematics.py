"""Kinematics of the port vs the JAX package, on the CPU: principal-axis and
Rodrigues rotations, a chain's forward kinematics, frame poses and position
Jacobian (the built-in manipulator arm, and a chain with free axes, origin
rotations, a prismatic and a fixed joint), the quaternion of a rotation
matrix at each of Shepperd's four pivots and at a tie, the quaternion
distance and the rotation error, values and forward-mode derivatives.

Tolerance: atol 2e-6 on rotations, positions and quaternions (float32
evaluation order over a chain of six joints), 1e-5 on Jacobians; a tie of
pivots is exact in float32 (the matrix below), so the branch the port picks
must be the JAX package's (the first maximum).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ocs2_tpu.models import kinematics as jk
from ocs2_tpu.models import mobile_manipulator as jmm

from ocs2_tpu_torch import convert
from ocs2_tpu_torch.models import kinematics as kin
from ocs2_tpu_torch.models import mobile_manipulator as mm

torch.set_num_threads(1)  # one intra-op thread a test process: the suite runs in several
# processes at once (pytest-xdist), and these small tensors gain nothing from more.

ATOL, JAC_ATOL = 2e-6, 1e-5
T = lambda v: torch.as_tensor(np.asarray(v, np.float32))  # noqa: E731


def _joints(mod):
    """The same chain in either package: a free axis with an origin rotation,
    a negated principal axis, a prismatic joint and a fixed joint."""
    rz = tuple(np.asarray(jk.rpy_matrix((0.3, -0.2, 0.5))).ravel().tolist())
    return mod.Chain(
        joints=(
            mod.Joint(offset=(0.1, 0.0, 0.3), axis="z"),
            mod.Joint(offset=(0.0, 0.05, 0.2), axis=(0.0, -1.0, 0.0), origin_rot=rz),
            mod.Joint(offset=(0.0, 0.0, 0.25), axis=(0.6, 0.0, 0.8)),
            mod.Joint(offset=(0.02, 0.0, 0.1), axis="x", kind="fixed"),
            mod.Joint(offset=(0.0, 0.0, 0.1), axis=(0.0, 0.0, 1.0), kind="prismatic"),
            mod.Joint(offset=(0.0, 0.1, 0.0), axis=(1.0, 1.0, 0.0)),
        ),
        ee_offset=(0.0, 0.0, 0.12),
        ee_rot=rz,
    )


CHAINS = {"arm": (mm.ARM, jmm.ARM), "mixed": (_joints(kin), _joints(jk))}


@pytest.mark.parametrize("axis", [0, 1, 2])
def test_rot_axis_matches_jax(axis):
    a = np.random.default_rng(axis).uniform(-4, 4, 16).astype(np.float32)
    ref = jax.vmap(lambda v: jk.rot_axis(axis, v))(jnp.asarray(a))
    mine = kin.rot_axis(axis, T(a)[:, None])
    assert mine.shape == (16, 3, 3)
    np.testing.assert_allclose(mine.numpy(), np.asarray(ref), atol=ATOL)


def test_rot_any_axis_matches_jax():
    a = np.random.default_rng(3).uniform(-4, 4, 16).astype(np.float32)
    axis = (0.36, 0.48, 0.8)
    ref = jax.vmap(lambda v: jk.rot_any_axis(axis, v))(jnp.asarray(a))
    np.testing.assert_allclose(kin.rot_any_axis(axis, T(a)[:, None]).numpy(), np.asarray(ref),
                               atol=ATOL)


def test_rpy_matrix_and_axis_spec_are_the_jax_packages():
    np.testing.assert_array_equal(kin.rpy_matrix((0.1, -0.7, 2.0)), jk.rpy_matrix((0.1, -0.7, 2.0)))
    for axis in ("x", (0.0, 0.0, -2.0), (1.0, 1.0, 0.0)):
        assert kin._axis_spec(axis) == jk._axis_spec(axis)


def _qs(chain, count, seed):
    return np.random.default_rng(seed).uniform(-1.5, 1.5, (count, chain.num_dof)).astype(np.float32)


@pytest.mark.parametrize("name", CHAINS)
def test_forward_kinematics_matches_jax(name):
    mine_c, ref_c = CHAINS[name]
    q = _qs(mine_c, 8, 4)
    base_rot = np.asarray(jk.rot_axis(2, 0.4), np.float32)
    base_pos = np.float32([0.2, -0.1, 0.05])
    with_base = (dict(base_rot=jnp.asarray(base_rot), base_pos=jnp.asarray(base_pos)),
                 dict(base_rot=T(base_rot).expand(8, 3, 3), base_pos=T(base_pos).expand(8, 3)))
    for kw_ref, kw in (({}, {}), with_base):
        pos_ref, rot_ref = jax.vmap(lambda v: ref_c.forward(v, **kw_ref))(jnp.asarray(q))
        pos, rot = mine_c.forward(T(q), **kw)
        np.testing.assert_allclose(pos.numpy(), np.asarray(pos_ref), atol=ATOL)
        np.testing.assert_allclose(rot.numpy(), np.asarray(rot_ref), atol=ATOL)
    np.testing.assert_allclose(mine_c.ee_position(T(q)).numpy(),
                               np.asarray(jax.vmap(ref_c.ee_position)(jnp.asarray(q))), atol=ATOL)


@pytest.mark.parametrize("name", CHAINS)
def test_frame_poses_match_jax(name):
    mine_c, ref_c = CHAINS[name]
    q = _qs(mine_c, 5, 5)
    rots_ref, pos_ref = jax.vmap(ref_c.frame_poses)(jnp.asarray(q))
    rots, pos = mine_c.frame_poses(T(q))
    assert rots.shape == (5, len(mine_c.joints) + 2, 3, 3)
    np.testing.assert_allclose(rots.numpy(), np.asarray(rots_ref), atol=ATOL)
    np.testing.assert_allclose(pos.numpy(), np.asarray(pos_ref), atol=ATOL)


@pytest.mark.parametrize("name", CHAINS)
def test_position_jacobian_matches_jax(name):
    mine_c, ref_c = CHAINS[name]
    qs = _qs(mine_c, 3, 6)
    want = jax.jit(jax.vmap(ref_c.position_jacobian))(jnp.asarray(qs))
    for q, w in zip(qs, np.asarray(want)):
        jac = mine_c.position_jacobian(T(q))
        assert jac.shape == (3, mine_c.num_dof) and jac.dtype == torch.float32
        np.testing.assert_allclose(jac.numpy(), w, atol=JAC_ATOL)


def _chain_numpy(chain):
    """A JAX chain's joints as arrays (``convert.chain_from_numpy``'s form)."""
    eye = np.eye(3)
    return {
        "offsets": np.asarray([j.offset for j in chain.joints]),
        "axes": np.asarray([eye[jk._AXES[j.axis]] if isinstance(j.axis, str) else j.axis
                            for j in chain.joints]),
        "kinds": np.asarray([j.kind for j in chain.joints]),
        "origin_rots": np.asarray([np.reshape(j.origin_rot if j.origin_rot else eye, (3, 3))
                                   for j in chain.joints]),
        "has_origin_rot": np.asarray([j.origin_rot is not None for j in chain.joints]),
        "names": np.asarray([j.name for j in chain.joints]),
        "ee_offset": np.asarray(chain.ee_offset),
        "ee_rot": np.reshape(chain.ee_rot if chain.ee_rot else eye, (3, 3)),
        "has_ee_rot": chain.ee_rot is not None,
    }


@pytest.mark.parametrize("name", CHAINS)
def test_chain_carried_across_as_numpy(name):
    """``convert.chain_from_numpy`` rebuilds the JAX package's chain from its
    numbers: joint for joint the port's own twin, and the same poses."""
    mine_c, ref_c = CHAINS[name]
    carried = convert.chain_from_numpy(_chain_numpy(ref_c))
    assert carried.num_dof == ref_c.num_dof
    assert [(j.kind, j.origin_rot, j.name) for j in carried.joints] == [
        (j.kind, j.origin_rot, j.name) for j in ref_c.joints]
    q = _qs(mine_c, 4, 10)
    pos, rot = carried.forward(T(q))
    pos_ref, rot_ref = jax.vmap(ref_c.forward)(jnp.asarray(q))
    np.testing.assert_allclose(pos.numpy(), np.asarray(pos_ref), atol=ATOL)
    np.testing.assert_allclose(rot.numpy(), np.asarray(rot_ref), atol=ATOL)
    np.testing.assert_array_equal(pos.numpy(), mine_c.forward(T(q))[0].numpy())


def test_position_jacobian_under_vmap():
    q = _qs(mm.ARM, 6, 7)
    jac = torch.func.vmap(mm.ARM.position_jacobian)(T(q))
    ref = jax.jit(jax.vmap(jmm.ARM.position_jacobian))(jnp.asarray(q))
    assert jac.dtype == torch.float32
    np.testing.assert_allclose(jac.numpy(), np.asarray(ref), atol=JAC_ATOL)


def _rotation(axis, angle):
    return np.asarray(jk.rot_any_axis(np.asarray(axis) / np.linalg.norm(axis), angle), np.float32)


# Rotations whose largest Shepperd pivot is w, x, y, z in turn, and one with
# an exact tie of x and y (a half turn about (1, 1, 0) / sqrt(2)).
PIVOTS = {
    "w": _rotation((0.2, 0.5, 0.3), 0.7),
    "x": _rotation((1.0, 0.2, 0.1), 2.9),
    "y": _rotation((0.1, 1.0, 0.3), 3.0),
    "z": _rotation((0.2, -0.1, 1.0), -2.8),
    "tie_xy": np.float32([[0.0, 1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, -1.0]]),
}


_JAX_QUATERNION_JACOBIAN = jax.jit(jax.jacfwd(jk.matrix_to_quaternion))


@pytest.mark.parametrize("case", PIVOTS)
def test_matrix_to_quaternion_matches_jax(case):
    r = PIVOTS[case]
    m = r.astype(np.float64)
    ts = [1 + m[0, 0] + m[1, 1] + m[2, 2], 1 + m[0, 0] - m[1, 1] - m[2, 2],
          1 - m[0, 0] + m[1, 1] - m[2, 2], 1 - m[0, 0] - m[1, 1] + m[2, 2]]
    want = "tie_xy" if ts[1] == ts[2] == max(ts) else "wxyz"[int(np.argmax(ts))]
    assert want == case
    q = kin.matrix_to_quaternion(T(r))
    ref = jk.matrix_to_quaternion(jnp.asarray(r))
    np.testing.assert_allclose(q.numpy(), np.asarray(ref), atol=ATOL)
    # The derivatives flow through the picked branch only, as in JAX.
    jac = torch.func.jacfwd(kin.matrix_to_quaternion)(T(r))
    jac_ref = _JAX_QUATERNION_JACOBIAN(jnp.asarray(r))
    assert jac.dtype == torch.float32
    np.testing.assert_allclose(jac.numpy(), np.asarray(jac_ref), atol=JAC_ATOL)


def test_matrix_to_quaternion_batched_over_every_pivot():
    rs = np.stack(list(PIVOTS.values()))
    q = torch.func.vmap(kin.matrix_to_quaternion)(T(rs))
    np.testing.assert_allclose(q.numpy(), np.asarray(jax.vmap(jk.matrix_to_quaternion)(
        jnp.asarray(rs))), atol=ATOL)
    np.testing.assert_allclose(kin.matrix_to_quaternion(T(rs)).numpy(), q.numpy(), atol=0)


def test_quaternion_distance_and_rotation_error_match_jax():
    rng = np.random.default_rng(8)
    rs = np.stack([_rotation(rng.standard_normal(3), a) for a in rng.uniform(-3, 3, 6)])
    rd = np.stack([_rotation(rng.standard_normal(3), a) for a in rng.uniform(-3, 3, 6)])
    ref = jax.vmap(jk.rotation_error)(jnp.asarray(rs), jnp.asarray(rd))
    np.testing.assert_allclose(kin.rotation_error(T(rs), T(rd)).numpy(), np.asarray(ref), atol=ATOL)
    qa = jax.vmap(jk.matrix_to_quaternion)(jnp.asarray(rs))
    qb = jax.vmap(jk.matrix_to_quaternion)(jnp.asarray(rd))
    np.testing.assert_allclose(
        kin.quaternion_distance(T(qa), T(qb)).numpy(),
        np.asarray(jax.vmap(jk.quaternion_distance)(qa, qb)), atol=ATOL)


def test_orientation_error_jacobian_through_the_arm_matches_jax():
    """d rotation_error(R_ee(q), R_des) / d q: the derivative the EE
    orientation cost's Hessian is made of, float32 under jacfwd."""
    r_des = np.float32([[1.0, 0, 0], [0, -1.0, 0], [0, 0, -1.0]])
    qs = _qs(mm.ARM, 3, 9)
    ref = jax.jit(jax.vmap(jax.jacfwd(
        lambda v: jk.rotation_error(jmm.ARM.forward(v)[1], jnp.asarray(r_des)))))(jnp.asarray(qs))
    for q, want in zip(qs, np.asarray(ref)):
        jac = torch.func.jacfwd(lambda v: kin.rotation_error(mm.ARM.forward(v)[1], T(r_des)))(T(q))
        assert jac.dtype == torch.float32
        np.testing.assert_allclose(jac.numpy(), want, atol=JAC_ATOL)
