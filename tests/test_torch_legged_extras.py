"""The legged robot's analytic IK, operator motions and soft-contact plant of
the port vs the JAX package on the CPU.

* ``ik``: per leg and for the four legs at once, base and world frame, against
  ``ocs2_tpu``'s closed form at 1e-5 (float32 rounding of the angles), and the
  JAX package's own IK checks run on the port;
* ``motions`` (host numpy): the built-in squat and walk motions, the CSV
  writer and reader, publishing into a reference manager and the extrapolated
  base reference, equal to the JAX package's at 1e-6 (finite-differenced
  joint velocities at 1e-6 over the sample spacing);
* ``contact_plant``: ``plant_forces``, the plant's flow map and one rollout
  period against the JAX package's at rtol 1e-5, with an absolute floor of
  what 2e-7 m of foot height is worth through the ground stiffness (kp 2e-7:
  8e-3 N at 4e4 N/m).  A foot's world height is the base height (about
  0.52 m) plus the rotated leg (about -0.52 m), each rounded to a float32 ulp
  of 6e-8 m in its own order by either package: the two packages' heights
  differ by 1.2e-7 m on these samples.  The floor is carried to the servo
  velocities by the leg Jacobian (|J| < 0.6 m) and to the flow map by the
  mass; the JAX package's contact-model checks on the port; a short standing
  loop on the plant.

States, inputs and targets come from numpy seeds.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ocs2_tpu.models.legged_robot import contact_plant as jcp
from ocs2_tpu.models.legged_robot import ik as jik
from ocs2_tpu.models.legged_robot import model as jmodel
from ocs2_tpu.models.legged_robot import motions as jmotions
from ocs2_tpu.models.legged_robot.terrain import ElevationMap as JElevationMap
from ocs2_tpu.mpc.mpc import ReferenceManager as JReferenceManager

from ocs2_tpu_torch import convert
from ocs2_tpu_torch.models.legged_robot import contact_plant as cp
from ocs2_tpu_torch.models.legged_robot import ik, model, motions
from ocs2_tpu_torch.models.legged_robot.terrain import ElevationMap
from ocs2_tpu_torch.mpc.mpc import ReferenceManager

torch.set_num_threads(1)  # one intra-op thread a test process: the suite runs in several
# processes at once (pytest-xdist), and these small tensors gain nothing from more.

IK_TOL = 1e-5
MOTION_TOL = 1e-6
PLANT_RTOL = 1e-5
FOOT_HEIGHT_ROUNDING = 2e-7  # m: the absolute floor of the plant's comparisons


def T(a):
    return torch.as_tensor(np.array(a, dtype=np.float32))


def close(mine, ref, tol):
    mine = mine.detach().numpy() if isinstance(mine, torch.Tensor) else np.asarray(mine)
    np.testing.assert_allclose(mine, np.asarray(ref), rtol=tol, atol=tol)


def close_plant(mine, ref, atol):
    np.testing.assert_allclose(mine.detach().numpy(), np.asarray(ref), rtol=PLANT_RTOL, atol=atol)


def plant_atol(c):
    """(forces, servo joint velocities, flow map): the floors of the plant's
    comparisons for contact parameters c."""
    force = c.kp * FOOT_HEIGHT_ROUNDING
    return force, 0.6 * force / c.b_servo, 4.0 * force / model.MASS


def np_tree(rec):
    return jax.tree.map(np.asarray, rec)._asdict()


# -- ik ----------------------------------------------------------------------------


def joint_samples(batch, seed, scale=0.3):
    """Joint angles [batch, 4, 3] around the stance."""
    rng = np.random.default_rng(seed)
    q0 = np.asarray(jmodel.DEFAULT_JOINTS).reshape(4, 3)
    return (q0[None] + scale * rng.standard_normal((batch, 4, 3))).astype(np.float32)


def feet_base_of(q):
    """Base-frame feet [batch, 4, 3] of joint angles, by the JAX package's FK."""
    return np.stack([np.asarray(jax.vmap(lambda qq: jmodel.foot_position_base(leg, qq))(
        jnp.asarray(q[:, leg]))) for leg in range(4)], axis=1)


@pytest.mark.parametrize("leg", range(4))
def test_leg_ik_matches(leg):
    feet = feet_base_of(joint_samples(16, seed=leg))[:, leg]
    ref = jax.vmap(lambda p: jik.leg_ik(leg, p))(jnp.asarray(feet))
    close(ik.leg_ik(leg, T(feet)), ref, IK_TOL)
    close(ik.leg_ik(leg, T(feet[0])), ref[0], IK_TOL)  # one target


def test_joints_from_foot_positions_matches():
    feet = feet_base_of(joint_samples(16, seed=7))
    ref = jax.vmap(jik.joints_from_foot_positions)(jnp.asarray(feet))
    close(ik.joints_from_foot_positions(T(feet)), ref, IK_TOL)


def test_joints_from_foot_positions_world_matches():
    rng = np.random.default_rng(8)
    x = np.asarray(jmodel.default_state())[None] + 0.1 * rng.standard_normal((12, 24))
    x = x.astype(np.float32)
    feet_w = np.asarray(jax.vmap(jmodel.foot_positions_world)(jnp.asarray(x)))
    feet_w = feet_w + 0.02 * rng.standard_normal(feet_w.shape).astype(np.float32)
    pose = x[:, 6:12]
    ref = jax.vmap(jik.joints_from_foot_positions_world)(jnp.asarray(pose), jnp.asarray(feet_w))
    close(ik.joints_from_foot_positions_world(T(pose), T(feet_w)), ref, IK_TOL)


def test_ik_unreachable_targets_match():
    """Targets past full extension and inside the shortest reach are clamped to
    the workspace as the reference clamps them."""
    p = np.array([[2.0, 0.3, -2.0], [0.3, 0.2, -0.02], [0.31, 0.28, 0.0]], np.float32)
    for leg in range(4):
        ref = jax.vmap(lambda pp: jik.leg_ik(leg, pp))(jnp.asarray(p))
        mine = ik.leg_ik(leg, T(p))
        assert bool(torch.isfinite(mine).all())
        close(mine, ref, IK_TOL)


def test_ik_roundtrip_default_stance():
    q = model.DEFAULT_JOINTS.reshape(4, 3)
    for leg in range(4):
        p = model.foot_position_base(leg, T(q[leg]))
        close(ik.leg_ik(leg, p), q[leg], IK_TOL)


def test_ik_fk_roundtrip_random_targets():
    q = joint_samples(5, seed=3)
    for leg in range(4):
        p_target = model.foot_position_base(leg, T(q[:, leg]))
        p_reached = model.foot_position_base(leg, ik.leg_ik(leg, p_target))
        close(p_reached, p_target.numpy(), IK_TOL)


def test_ik_world_frame():
    x = model.default_state("cpu")
    q = ik.joints_from_foot_positions_world(x[6:12], model.foot_positions_world(x))
    close(q, model.DEFAULT_JOINTS, IK_TOL)


# -- motions --------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def libraries():
    return jmotions.MotionLibrary(), motions.MotionLibrary(device="cpu")


def assert_motions_equal(mine, ref):
    """Times, states and schedule at MOTION_TOL; inputs at MOTION_TOL over the
    sample spacing: the squat's joint velocities are differences of IK angles
    (rounded to 1.2e-7 in either package) over 0.05 s."""
    for f in ("times", "states"):
        close(getattr(mine.target, f), getattr(ref.target, f), MOTION_TOL)
    spacing = float(np.diff(np.asarray(ref.target.times)).min())
    close(mine.target.inputs, ref.target.inputs, MOTION_TOL / spacing)
    for f in ("event_times", "mode_sequence", "num_events"):
        np.testing.assert_array_equal(getattr(mine.mode_schedule, f),
                                      np.asarray(getattr(ref.mode_schedule, f)))
    assert mine.duration == pytest.approx(ref.duration, abs=1e-12)


@pytest.mark.parametrize("name", ["squat", "walk_forward"])
def test_builtin_motions_match(name):
    ref_lib, lib = libraries()
    assert lib.list_motions() == ref_lib.list_motions()
    assert_motions_equal(lib.motions[name], ref_lib.motions[name])
    # The JAX record carried across.
    back = convert.motion_from_numpy(dict(
        target=np_tree(ref_lib.motions[name].target),
        mode_schedule=ref_lib.motions[name].mode_schedule,
        duration=ref_lib.motions[name].duration), device="cpu")
    assert_motions_equal(back, ref_lib.motions[name])


def csv_rows(text):
    lines = text.split("\n")
    return lines[0], np.array([[float(v) for v in line.split(",")] for line in lines[1:]])


@pytest.mark.parametrize("name", ["squat", "walk_forward"])
def test_motion_to_csv_matches(name):
    ref_lib, lib = libraries()
    times = np.linspace(0.0, ref_lib.motions[name].duration, 33)
    head_a, rows_a = csv_rows(motions.motion_to_csv(lib.motions[name], times))
    head_b, rows_b = csv_rows(jmotions.motion_to_csv(ref_lib.motions[name], times))
    assert head_a == head_b
    # Columns from 30 on are the inputs (joint velocities, forces): see
    # assert_motions_equal.
    spacing = float(np.diff(np.asarray(ref_lib.motions[name].target.times)).min())
    close(rows_a[:, :30], rows_b[:, :30], MOTION_TOL)
    close(rows_a[:, 30:], rows_b[:, 30:], MOTION_TOL / spacing)


@pytest.mark.parametrize("dt", [-1.0, 0.1])
def test_read_motion_csv_matches(dt):
    ref_lib, _ = libraries()
    m = ref_lib.motions["walk_forward"]
    text = jmotions.motion_to_csv(m, np.linspace(0.0, m.duration, 81))
    assert_motions_equal(motions.read_motion_csv(text, dt, device="cpu"),
                         jmotions.read_motion_csv(text, dt))


def test_read_motion_csv_rejects_a_wrong_header():
    with pytest.raises(ValueError, match="columns"):
        motions.read_motion_csv("time,a,b\n0.0,1.0,2.0\n1.0,1.0,2.0", device="cpu")


def test_csv_roundtrip():
    _, lib = libraries()
    m = lib.motions["squat"]
    m2 = motions.read_motion_csv(motions.motion_to_csv(m, m.target.times.numpy()), device="cpu")
    for tt in (0.0, 0.7, 1.4):
        close(m2.target.state_at(np.float32(tt)), m.target.state_at(np.float32(tt)).numpy(), 2e-3)
        close(m2.target.input_at(np.float32(tt)), m.target.input_at(np.float32(tt)).numpy(), 2e-3)


def test_library_publish_matches_and_buffers():
    ref_lib, lib = libraries()
    ref_rm = JReferenceManager(ref_lib.motions["squat"].target)
    rm = ReferenceManager(lib.motions["squat"].target)
    ref = ref_lib.publish("squat", ref_rm, t0=5.0)
    mine = lib.publish("squat", rm, t0=5.0)
    assert_motions_equal(mine, ref)
    # Buffered: the target changes at the next pre_solver_run only.
    assert float(rm.target.times[0]) == 0.0
    rm.pre_solver_run(5.0, 6.0, model.default_state("cpu"))
    assert float(rm.target.times[0]) == pytest.approx(5.0)
    close(rm.target.state_at(np.float32(5.0))[8], model.STAND_HEIGHT, 1e-5)
    assert float(rm.target.state_at(np.float32(6.0))[8]) < model.STAND_HEIGHT - 0.05


COMMANDS = {
    "straight": (dict(heading_velocity=0.5), 0.1, 10, None),
    "turning": (dict(heading_velocity=0.5, yaw_rate=1.0), 0.05, 40, None),
    "lateral_ramp": (dict(heading_velocity=1.0, lateral_velocity=-0.3, base_height=0.5), 0.1, 10,
                     lambda xy: 0.5 * xy[0]),
}


@pytest.mark.parametrize("case", sorted(COMMANDS))
def test_extrapolated_base_reference_matches(case):
    kw, dt, n, ground = COMMANDS[case]
    x0 = np.asarray(jmodel.default_state()).copy()
    x0[[6, 7, 9]] = (0.2, -0.1, 0.3)
    ref = jmotions.generate_extrapolated_base_reference(
        dt, n, 1.0, jnp.asarray(x0), jmotions.BaseReferenceCommand(**kw), terrain_height_fn=ground)
    mine = motions.generate_extrapolated_base_reference(
        dt, n, 1.0, torch.as_tensor(x0), motions.BaseReferenceCommand(**kw),
        terrain_height_fn=ground, device="cpu")
    for f in ("times", "states", "inputs"):
        close(getattr(mine, f), getattr(ref, f), MOTION_TOL)


# -- contact plant --------------------------------------------------------------------


def plant_samples(batch, seed):
    """States a few millimetres into the ground with small velocities, inputs
    around weight compensation; numpy float32."""
    rng = np.random.default_rng(seed)
    x = np.asarray(jmodel.default_state())[None] + 0.01 * rng.standard_normal((batch, 24))
    x[:, 8] -= 0.004
    x[:, 0:3] += 0.2 * rng.standard_normal((batch, 3))
    u = np.asarray(jmodel.weight_compensating_input(jnp.ones(4)))[None] + np.concatenate(
        [10.0 * rng.standard_normal((batch, 12)), rng.standard_normal((batch, 12))], axis=1)
    return x.astype(np.float32), u.astype(np.float32)


def bumpy_maps():
    """A bumpy elevation map in both packages."""
    rng = np.random.default_rng(4)
    h = (0.01 * rng.standard_normal((60, 60))).astype(np.float32)
    return (JElevationMap.create(h, origin_xy=(-1.5, -1.5), resolution=0.05),
            ElevationMap.create(h, origin_xy=(-1.5, -1.5), resolution=0.05, device="cpu"))


CONTACT = {"default": cp.ContactParams(), "stiff_servo": cp.ContactParams(b_servo=1e12),
           "soft": cp.ContactParams(kp=1e4, kd=5e2, kt=8e2, mu=0.4)}


@pytest.mark.parametrize("ground", ["flat", "bumpy"])
@pytest.mark.parametrize("params", sorted(CONTACT))
def test_plant_forces_match(ground, params):
    x, u = plant_samples(16, seed=11)
    c = CONTACT[params]
    jc = jcp.ContactParams(*c)
    if ground == "flat":
        j_h, h = (lambda xy: jnp.zeros(())), (lambda xy: torch.zeros_like(xy[..., 0]))
    else:
        jem, em = bumpy_maps()
        j_h, h = jem.height_at, em.height_at
    ref_f, ref_dq = jax.jit(jax.vmap(lambda a, b: jcp.plant_forces(a, b, j_h, jc)))(x, u)
    forces, dq = cp.plant_forces(T(x), T(u), h, c)
    assert forces.shape == (16, 4, 3) and dq.shape == (16, 12)
    atol_f, atol_dq, _ = plant_atol(c)
    close_plant(forces, ref_f, atol_f)
    close_plant(dq, ref_dq, atol_dq)
    # One state, as the rollout calls it.
    close_plant(cp.contact_forces_from_state(T(x[0]), T(u[0]), h, c), ref_f[0], atol_f)


def test_leg_jacobians_match():
    x, _ = plant_samples(8, seed=12)
    close(cp._leg_jacobians(T(x)), jax.vmap(jcp._leg_jacobians)(jnp.asarray(x)), 1e-5)


def test_soft_contact_dynamics_match():
    x, u = plant_samples(8, seed=13)
    ref = jax.jit(jax.vmap(lambda a, b: jcp.make_soft_contact_dynamics()(0.0, a, b, None)))(x, u)
    close_plant(cp.make_soft_contact_dynamics()(0.0, T(x), T(u), None), ref,
                plant_atol(cp.ContactParams())[2])


def test_contact_rollout_step_matches():
    """One control period of the plant's RK4 rollout (8 substeps of 1.25 ms)."""
    from ocs2_tpu_torch.mpc.mrt import ExternalSimRollout

    x, u = plant_samples(4, seed=14)
    backend = cp.make_contact_rollout()
    assert isinstance(backend, ExternalSimRollout) and backend.substeps == 8
    jb = jcp.make_contact_rollout()
    ref = jax.jit(jax.vmap(lambda a, b: jb.step(0.0, a, b, 0.01, None)))(x, u)
    mine = backend.step(torch.tensor(0.0), T(x), T(u), torch.tensor(0.01), None)
    close_plant(mine, ref, 0.01 * plant_atol(cp.ContactParams())[2])


def test_static_equilibrium_force():
    c = cp.ContactParams()
    pen = model.MASS * model.GRAVITY / (4 * c.kp)
    x = model.default_state("cpu")
    x[8] = model.STAND_HEIGHT - pen
    u = model.weight_compensating_input(np.ones(4), "cpu")
    f = cp.contact_forces_from_state(x, u, cp._flat_ground, c)
    np.testing.assert_allclose(f[:, 2].numpy(), model.MASS * model.GRAVITY / 4, rtol=1e-3)
    assert float(f[:, :2].abs().max()) < 1e-4


def test_zero_command_yields():
    c = cp.ContactParams()
    pen = model.MASS * model.GRAVITY / (4 * c.kp)
    x = model.default_state("cpu")
    x[8] = model.STAND_HEIGHT - pen
    f = cp.contact_forces_from_state(x, torch.zeros(model.NU), cp._flat_ground, c)
    assert float(f[:, 2].max()) < 0.8 * c.kp * pen


def test_no_force_above_ground():
    x = model.default_state("cpu")
    x[8] = model.STAND_HEIGHT + 0.05
    f = cp.contact_forces_from_state(x, torch.zeros(model.NU), cp._flat_ground)
    assert float(f.abs().max()) == 0.0


@pytest.mark.parametrize("b_servo", [1e12, 25.0])
def test_friction_cone_respected(b_servo):
    c = cp.ContactParams(b_servo=b_servo)
    x = model.default_state("cpu")
    x[8] = model.STAND_HEIGHT - 0.005
    x[0] = 2.0  # 2 m/s of slip
    u = torch.zeros(model.NU) if b_servo > 1e6 else model.weight_compensating_input(np.ones(4),
                                                                                   "cpu")
    f = cp.contact_forces_from_state(x, u, cp._flat_ground, c).numpy()
    ft, fn = np.linalg.norm(f[:, :2], axis=1), f[:, 2]
    assert (ft <= c.mu * fn + 1e-4).all()
    if b_servo > 1e6:  # the rigid servo isolates the Coulomb logic: fast slip is on the cone
        assert (fn > 0).all() and (ft > 0.9 * c.mu * fn).all()


def test_plant_freefall_without_contact():
    x = model.default_state("cpu")
    x[8] = 1.0
    dx = cp.make_soft_contact_dynamics()(0.0, x, torch.zeros(model.NU), None)
    close(dx[0:3], [0.0, 0.0, -model.GRAVITY], 1e-6)


def test_stand_on_contact_plant():
    """The JAX package's standing loop on the spring-damper ground, cut to
    0.5 s and N = 20 (it runs 1.5 s at N = 32): SRBD MPC (stance, 6
    iterations) at 20 Hz, the plant at 100 Hz; the robot settles at a
    millimetric penetration, level."""
    from ocs2_tpu_torch.models.legged_robot import interface
    from ocs2_tpu_torch.models.legged_robot.gait import GaitSchedule, stance_gait
    from ocs2_tpu_torch.mpc.mpc import Mpc, MpcSettings
    from ocs2_tpu_torch.mpc.mrt import MpcMrtInterface, Mrt, dummy_loop
    from ocs2_tpu_torch.oc.time_discretization import make_time_grid
    from ocs2_tpu_torch.solvers import sqp

    gs = GaitSchedule(stance_gait())
    ms = gs.mode_schedule(0.0, 1.0)
    grid = make_time_grid(0.0, 1.0, 20, event_times=ms.event_times,
                          mode_sequence=ms.mode_sequence)
    problem = interface.make_problem(device="cpu")
    mpc = Mpc(problem, interface.make_params(grid, device="cpu"),
              MpcSettings(time_horizon=1.0, num_intervals=20, solver="sqp"),
              solver_settings=sqp.SqpSettings(max_iterations=6, integrator="rk2"),
              reference_manager=interface.SwitchedModelReferenceManager(gs, device="cpu"),
              device="cpu")
    iface = MpcMrtInterface(mpc, Mrt(problem, rollout_backend=cp.make_contact_rollout()))
    _, xs, _ = dummy_loop(iface, model.default_state("cpu"), duration=0.5, mrt_frequency=100.0,
                          mpc_frequency=20.0)
    assert bool(torch.isfinite(xs).all())
    z = xs[:, 8].numpy()
    assert z.min() > model.STAND_HEIGHT - 0.03, z.min()
    assert abs(z[-1] - model.STAND_HEIGHT) < 0.02, z[-1]
    assert float(xs[:, 9:12].abs().max()) < 0.1
