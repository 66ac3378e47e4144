"""The URDF front end of the port vs the JAX package, on the CPU, per bundled
arm (franka, UR5): the assets are byte copies of the JAX package's, parsing
gives the same joints, the extracted chains (folded fixed joints, removed
joints frozen) are the JAX package's joint for joint, and their forward
kinematics agrees with the JAX package's and with an independent
homogeneous-transform walk of the raw URDF; a fixed-base arm MPC on each
(``make_urdf_arm_problem``) reaches its target within the JAX test's
bounds (``tests/test_urdf.py``).  The arms on the reference's four base
types (``chip_smoke.py`` phase ``urdf_variants_b1``): the LQ data of one
against the JAX package's, and each variant's solve against the JAX
package's record (``tools/manipulator_reference.py``) and the JAX tests'
bounds (``tests/test_manipulator_variants.py``).

Tolerance: forward kinematics atol 2e-5 against the homogeneous walk in
float64 (the JAX test's), 2e-6 against the JAX chain in float32; chain data
exactly equal (the same host arithmetic); LQ leaves atol 1e-5 times the
leaf's largest entry, rtol 1e-4; solves by ``chip_smoke.compare_with_record``
(1e-3 + 1e-4 |value|, the JAX package's own spread where it is wider).
"""
import filecmp
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke as cs
from ocs2_tpu.models import mobile_manipulator as jmm
from test_urdf import ANYMAL_URDF
from ocs2_tpu.models import urdf as jurdf
from ocs2_tpu.oc import approx as japprox
from ocs2_tpu.oc.time_discretization import uniform_grid as juniform_grid

from ocs2_tpu_torch.models import mobile_manipulator as mm
from ocs2_tpu_torch.models import urdf
from ocs2_tpu_torch.models.kinematics import rpy_matrix
from ocs2_tpu_torch.models.urdf import asset_path, chain_from_urdf, parse_urdf
from ocs2_tpu_torch.oc import approx
from ocs2_tpu_torch.oc.time_discretization import uniform_grid
from ocs2_tpu_torch.solvers import sqp
from tools._records import Records

torch.set_num_threads(1)  # one intra-op thread a test process: the suite runs in several
# processes at once (pytest-xdist), and these small tensors gain nothing from more.

ARMS = {
    "franka": dict(file="franka_panda.urdf", base="root", ee="panda_hand_tcp",
                   remove=("panda_finger_joint1", "panda_finger_joint2"), dof=7,
                   home=np.array([0.0, -0.785, 0.0, -2.356, 0.0, 1.571, 0.785]),
                   target=(0.4, 0.2, 0.5)),
    "ur5": dict(file="ur5.urdf", base="base_link", ee="ee_link", remove=(), dof=6,
                home=np.array([0.0, -1.2, 1.6, -0.4, 1.5708, 0.0]), target=(0.35, 0.25, 0.45)),
}


def _load(arm, mod=urdf, ee=None):
    """An arm's chain through the port's URDF module, or the JAX package's."""
    cfg = ARMS[arm]
    return mod.chain_from_urdf(mod.asset_path(cfg["file"]), cfg["base"], ee or cfg["ee"],
                               remove_joints=cfg["remove"])


@pytest.mark.parametrize("arm", ARMS)
def test_asset_is_a_byte_copy_of_the_jax_packages(arm):
    mine, ref = asset_path(ARMS[arm]["file"]), jurdf.asset_path(ARMS[arm]["file"])
    assert os.path.dirname(mine) != os.path.dirname(ref)
    assert filecmp.cmp(mine, ref, shallow=False)


def test_missing_asset_raises():
    with pytest.raises(FileNotFoundError):
        asset_path("no_such_robot.urdf")


@pytest.mark.parametrize("arm", ARMS)
def test_parsing_matches_jax(arm):
    path = asset_path(ARMS[arm]["file"])
    mine, ref = parse_urdf(path), jurdf.parse_urdf(path)
    assert (mine.name, mine.root_link, mine.links) == (ref.name, ref.root_link, ref.links)
    assert len(mine.joints) == len(ref.joints)
    for a, b in zip(mine.joints, ref.joints):
        assert a.__dict__ == b.__dict__
    # A raw XML string parses the same as the file.
    with open(path) as f:
        assert parse_urdf(f.read()) == mine


def test_parse_refuses_a_non_urdf():
    with pytest.raises(ValueError):
        parse_urdf("<sdf></sdf>")


@pytest.mark.parametrize("arm", ARMS)
def test_chain_extraction_matches_jax(arm):
    cfg = ARMS[arm]
    mine, ref = _load(arm), _load(arm, jurdf)
    assert mine.chain.num_dof == ref.chain.num_dof == cfg["dof"]
    assert mine.joint_names == ref.joint_names
    for f in ("lower", "upper", "velocity"):
        np.testing.assert_array_equal(getattr(mine, f), getattr(ref, f))
    assert np.all(mine.lower < mine.upper) and np.all(mine.velocity > 0)
    for a, b in zip(mine.chain.joints, ref.chain.joints):
        assert (a.offset, a.axis, a.kind, a.origin_rot, a.name) == (
            b.offset, b.axis, b.kind, b.origin_rot, b.name)
    assert (mine.chain.ee_offset, mine.chain.ee_rot) == (ref.chain.ee_offset, ref.chain.ee_rot)


def test_franka_limits():
    loaded = _load("franka")
    assert loaded.lower[0] == pytest.approx(-2.8973)
    assert loaded.upper[0] == pytest.approx(2.8973)
    assert loaded.upper[3] == pytest.approx(-0.0698)  # the elbow's asymmetric range


def _fk_reference(model, base, ee, remove, q):
    """Independent forward kinematics: the raw URDF joints as homogeneous
    transforms (no folding, no Chain), in float64."""
    by_child = model.joint_by_child()
    tf = np.eye(4)
    qi = 0
    for child in model.chain_links(base, ee)[1:]:
        j = by_child[child]
        origin = np.eye(4)
        origin[:3, :3] = rpy_matrix(j.rpy)
        origin[:3, 3] = j.xyz
        tf = tf @ origin
        if j.kind != "fixed" and j.name not in remove:
            a = np.asarray(j.axis, np.float64) / np.linalg.norm(j.axis)
            th = q[qi]
            qi += 1
            k = np.array([[0, -a[2], a[1]], [a[2], 0, -a[0]], [-a[1], a[0], 0]])
            motion = np.eye(4)
            if j.kind == "prismatic":
                motion[:3, 3] = a * th
            else:
                motion[:3, :3] = np.eye(3) + np.sin(th) * k + (1 - np.cos(th)) * (k @ k)
            tf = tf @ motion
    return tf[:3, 3], tf[:3, :3]


@pytest.mark.parametrize("arm", ARMS)
def test_fk_matches_jax_and_the_homogeneous_walk(arm):
    cfg = ARMS[arm]
    model = parse_urdf(asset_path(cfg["file"]))
    mine, ref = _load(arm), _load(arm, jurdf)
    q = np.random.default_rng(0).uniform(-1.5, 1.5, (5, cfg["dof"]))
    pos, rot = mine.chain.forward(torch.as_tensor(q, dtype=torch.float32))
    pos_j, rot_j = jax.vmap(ref.chain.forward)(jnp.asarray(q, jnp.float32))
    np.testing.assert_allclose(pos.numpy(), np.asarray(pos_j), atol=2e-6)
    np.testing.assert_allclose(rot.numpy(), np.asarray(rot_j), atol=2e-6)
    for i in range(len(q)):
        pos_ref, rot_ref = _fk_reference(model, cfg["base"], cfg["ee"], set(cfg["remove"]), q[i])
        np.testing.assert_allclose(pos[i].numpy(), pos_ref, atol=2e-5)
        np.testing.assert_allclose(rot[i].numpy(), rot_ref, atol=2e-5)


def test_removed_joints_are_frozen():
    """The chain to a finger keeps the 7 arm joints once the finger joints
    are removed, as in the JAX package, and its pose does not depend on a
    finger opening."""
    mine = _load("franka", ee="panda_leftfinger")
    ref = _load("franka", jurdf, ee="panda_leftfinger")
    assert mine.chain.num_dof == ref.chain.num_dof == 7
    q = np.random.default_rng(1).uniform(-1.0, 1.0, (3, 7)).astype(np.float32)
    np.testing.assert_allclose(
        mine.chain.ee_position(torch.as_tensor(q)).numpy(),
        np.asarray(jax.vmap(ref.chain.ee_position)(jnp.asarray(q))), atol=2e-6)
    free = chain_from_urdf(asset_path("franka_panda.urdf"), "root", "panda_leftfinger")
    assert free.chain.num_dof == 8


def test_no_path_between_links_raises():
    with pytest.raises(ValueError):
        chain_from_urdf(asset_path("ur5.urdf"), "ee_link", "base_link")


@pytest.mark.skipif(not os.path.exists(ANYMAL_URDF), reason="no reference urdf")
def test_anymal_leg_chains():
    """A branching quadruped URDF yields one 3-DOF chain per foot (the twin of
    tests/test_urdf.py's TestAnymalTree, which skips the same way)."""
    model = parse_urdf(ANYMAL_URDF)
    feet = [ln for ln in model.links if ln.endswith("FOOT")]
    assert len(feet) >= 4
    for foot in feet[:4]:
        assert chain_from_urdf(model, "base", foot).chain.num_dof == 3


@pytest.mark.parametrize("arm", ARMS)
def test_fixed_base_arm_reaches_its_target(arm):
    """``make_urdf_arm_problem`` (x = q, u = dq): the EE reaches a workspace
    target with the joint limits respected (tests/test_urdf.py's
    TestUrdfArmMpc: N = 30 over 2 s, rk2, 30 iterations; its bounds)."""
    cfg = ARMS[arm]
    loaded = _load(arm)
    target = np.float32(cfg["target"])
    sol = sqp.solve(mm.make_urdf_arm_problem(loaded), uniform_grid(0.0, 2.0, 30),
                    torch.as_tensor(cfg["home"], dtype=torch.float32),
                    mm.make_params(target, device="cpu"),
                    settings=sqp.SqpSettings(max_iterations=30, integrator="rk2"), device="cpu")
    pos, _ = loaded.chain.forward(sol.xs[0, -1])
    assert float(np.linalg.norm(pos.numpy() - target)) < 0.05
    qs = sol.xs[0].numpy()
    lo, hi = loaded.lower.astype(np.float32), loaded.upper.astype(np.float32)
    assert np.all(qs > lo[None] - 1e-2) and np.all(qs < hi[None] + 1e-2)


# -- the arms on the reference's base types (chip_smoke.py's urdf_variants_b1) ----


VARIANT_LQ = dict(n=3, b=2, seed=12, r_down=np.float32([[1.0, 0, 0], [0, -1.0, 0],
                                                          [0, 0, -1.0]]))


def _variant_lq_inputs(nx, nu):
    n, b = VARIANT_LQ["n"], VARIANT_LQ["b"]
    rng = np.random.default_rng(VARIANT_LQ["seed"])
    xs = rng.uniform(-0.8, 0.8, (b, n + 1, nx)).astype(np.float32)
    us = rng.standard_normal((b, n, nu)).astype(np.float32)
    return n, xs, us


def _jax_variant_lq():
    jp = jmm.make_urdf_manipulator_problem(_load("franka", jurdf), base_type="wheel_based")
    n, xs, us = _variant_lq_inputs(jp.nx, jp.nu)
    return jax.jit(jax.vmap(lambda x, u: japprox.approximate_lq(
        jp, juniform_grid(0.0, 0.6, n), x, u,
        jmm.make_params((0.6, 0.2, 0.4), VARIANT_LQ["r_down"]))))(
            jnp.asarray(xs), jnp.asarray(us))


JAX_RECORDS = {"franka_wheel_based_lq": _jax_variant_lq}
RECORDS = Records(__file__)


def test_variant_lq_data_matches_jax():
    """The franka on a wheeled base with an orientation target: its LQ data
    (rk4) against the JAX package's at B = 2, N = 3 (atol 1e-5 times the
    leaf's largest entry, rtol 1e-4; the JAX side stored by
    ``tools/torch_test_records.py --record test_torch_urdf``)."""
    loaded, jloaded = _load("franka"), _load("franka", jurdf)
    p = mm.make_urdf_manipulator_problem(loaded, base_type="wheel_based")
    jp = jmm.make_urdf_manipulator_problem(jloaded, base_type="wheel_based")
    assert p.cost_structure_psd is jp.cost_structure_psd is False
    n, xs, us = _variant_lq_inputs(p.nx, p.nu)
    r_down = VARIANT_LQ["r_down"]
    ref = RECORDS["franka_wheel_based_lq"]
    mine = approx.approximate_lq(p, uniform_grid(0.0, 0.6, n), torch.as_tensor(xs),
                                 torch.as_tensor(us),
                                 mm.make_params((0.6, 0.2, 0.4), r_down, device="cpu"))
    for name, rec in ref._asdict().items():
        if rec is None:
            continue
        for f, want in rec._asdict().items():
            if want is None:
                continue
            got = getattr(getattr(mine, name), f).numpy()
            want = np.asarray(want)
            scale = max(1.0, float(np.abs(want).max()))
            np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5 * scale,
                                       err_msg=f"{name}.{f}")


@pytest.fixture(scope="module")
def record():
    with np.load(cs.MANIP_RECORD) as f:
        return {k: f[k] for k in f.files}


@pytest.mark.parametrize("arm, base_type", cs.URDF_VARIANTS,
                         ids=[cs.urdf_variant_key(a, b) for a, b in cs.URDF_VARIANTS])
def test_variant_matches_the_record(record, arm, base_type):
    """The card lane's solve of each variant (SQP, rk4, N = 40 over 2 s, 25
    iterations, the target 0.15, 0.1, -0.1 m from the home EE position) on
    the CPU, against the JAX package's record (``chip_smoke.compare_with_record``)
    and the JAX test's bound: the EE within 0.03 m of the target; a floating
    arm's unactuated base stays where it is."""
    key = cs.urdf_variant_key(arm, base_type)
    cfg = cs.URDF_ARMS[arm]
    loaded = chain_from_urdf(asset_path(cfg["urdf"]), cfg["base"], cfg["ee"],
                             remove_joints=cfg["remove"])
    x0 = mm.variant_home_state(loaded, base_type, q_home=cfg["q_home"], device="cpu")
    np.testing.assert_array_equal(x0.numpy(), record[f"{key}_x0"])
    nb, _, nx, nu = mm._base_dims(base_type, loaded.chain.num_dof)
    target = (loaded.chain.forward(x0[nb:])[0].numpy()
              + np.float32(cs.URDF_TARGET_OFFSET))
    np.testing.assert_allclose(target, record[f"{key}_target"], atol=1e-6)
    sol = sqp.solve(mm.make_urdf_manipulator_problem(loaded, base_type=base_type),
                    uniform_grid(0.0, cs.URDF_HORIZON, cs.URDF_N), x0,
                    mm.make_params(target, device="cpu"),
                    settings=sqp.SqpSettings(max_iterations=cs.URDF_MAX_ITERATIONS,
                                             integrator="rk4"), device="cpu")
    assert sol.xs.shape == (1, cs.URDF_N + 1, nx) and sol.us.shape == (1, cs.URDF_N, nu)
    cs.compare_with_record(torch, sol, record, f"{key}_", f"{key} vs the record", rows=None)
    err = mm.variant_ee_pose(loaded.chain, base_type, sol.xs[0, -1])[0].numpy() - target
    assert np.linalg.norm(err) < cs.URDF_EE_TOL, err
    if base_type == "floating_arm":
        np.testing.assert_allclose(sol.xs[0, :, :6].numpy(),
                                   np.broadcast_to(x0[:6], (cs.URDF_N + 1, 6)), atol=1e-5)
