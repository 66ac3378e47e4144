"""The full-order legged models of the port vs the JAX package on the CPU: the
full centroidal model (``centroidal``) and the ComKino kinodynamic model
(``comkino``), and the entry points they unlock.

* Live, the JAX side jitted once and mapped over a batch: 16 numpy-seeded
  (x, u) around the stance, with and without the external wrench, through
  ``comkino.dynamics``, ``mass_matrix``, ``base_acceleration``, the contact
  generalized force, ``centroidal_momentum_matrix``, ``dynamics_full`` and the
  RBD conversions, at rtol 1e-4 / atol 1e-5.
* The JAX package's own ComKino and centroidal checks
  (``tests/test_comkino.py``, ``tests/test_centroidal.py``) run on the port.
* Against the record of ``tools/comkino_reference.py``
  (``tests/torch_data/comkino_reference.npz``; a live JAX ComKino solve
  compiles for minutes): ComKino's rk2 LQ Jacobians at 8 nodes (rtol 1e-3 /
  atol 1e-4); the trot solve at N = 12 (3 iterations); the first 3 ticks of
  the ComKino perceptive closed loop, each re-solved from the JAX tick's exact
  inputs, and the port's own loop over those ticks; the full model's standing
  solve (N = 20, 12 iterations).  Solves: iterations equal, xs / us within
  1e-3 + 1e-4 |value|.
"""
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke as cs
from ocs2_tpu.models.legged_robot import centroidal as jcentroidal
from ocs2_tpu.models.legged_robot import comkino as jcomkino
from ocs2_tpu.models.legged_robot import model as jmodel
from ocs2_tpu.ops import smallmat as jsmallmat

from ocs2_tpu_torch import convert
from ocs2_tpu_torch.models.legged_robot import centroidal, comkino, interface, model
from ocs2_tpu_torch.models.legged_robot.centroidal import DEFAULT_MASSES, SRBD_MASSES
from ocs2_tpu_torch.ops import smallmat
from ocs2_tpu_torch.solvers import sqp
from tools._records import Records

torch.set_num_threads(1)  # one intra-op thread a test process: the suite runs in several
# processes at once (pytest-xdist), and these small tensors gain nothing from more.

RTOL, ATOL = 1e-4, 1e-5
LQ_RTOL, LQ_ATOL = 1e-3, 1e-4
SOLVE_ATOL, SOLVE_RTOL = 1e-3, 1e-4
TROT_ITERATIONS, RECORDED_TICKS = 3, 3  # as tools/comkino_reference.py records them
RECORD = os.path.join(os.path.dirname(__file__), "torch_data", "comkino_reference.npz")
WRENCHES = {
    "none": None,
    "force": (np.float32([30.0, -12.0, 5.0]), None),
    "torque": (None, np.float32([1.5, -0.5, 2.0])),
    "both": (np.float32([-8.0, 20.0, 0.0]), np.float32([0.0, 0.7, -1.2])),
}


def T(a):
    return torch.as_tensor(np.array(a, dtype=np.float32))


def close(mine, ref, rtol=RTOL, atol=ATOL):
    mine = mine.detach().numpy() if isinstance(mine, torch.Tensor) else np.asarray(mine)
    np.testing.assert_allclose(mine, np.asarray(ref), rtol=rtol, atol=atol)


def close_solve(mine, ref):
    close(mine, ref, SOLVE_RTOL, SOLVE_ATOL)


@functools.lru_cache(maxsize=None)
def samples():
    """16 states around the stance (attitude and joints moved, base and
    momentum velocities) and inputs around weight compensation."""
    rng = np.random.default_rng(6)
    x = np.asarray(jmodel.default_state())[None] + 0.2 * rng.standard_normal((16, 24))
    u = np.asarray(jmodel.weight_compensating_input(jnp.ones(4)))[None] + np.concatenate(
        [10.0 * rng.standard_normal((16, 12)), rng.standard_normal((16, 12))], axis=1)
    return x.astype(np.float32), u.astype(np.float32)


def z_of(x):
    """Generalized coordinates and velocities of states x (numpy), as the JAX
    package's ``_state_to_z`` makes them, plus joint velocities from u."""
    z, _, deuler = jax.vmap(jcomkino._state_to_z)(jnp.asarray(x))
    return np.asarray(z), np.asarray(deuler)


def _jax_side():
    """One jitted, vmapped JAX program over the samples: ComKino's flow map
    with a wrench argument (zeros for none), mass matrix, base acceleration and
    contact force, and the full centroidal model's terms (stored in
    ``tests/torch_data/test_torch_comkino_jax.npz`` by
    ``tools/torch_test_records.py --record test_torch_comkino``: XLA takes
    most of a minute to compile it)."""

    def one(x, u, f_ext, tau_ext):
        z, _, deuler = jcomkino._state_to_z(x)
        zdot = jnp.concatenate([x[0:3], deuler, u[12:24]])
        forces = u[:12].reshape(4, 3)
        q_rbd, v_rbd = jcentroidal.rbd_state_from_centroidal(x, u)
        return {
            "dynamics": jcomkino.dynamics(0.0, x, u, {"external_force_world": f_ext,
                                                      "external_torque_base": tau_ext}),
            "mass_matrix": jcomkino.mass_matrix(x),
            "base_acceleration": jcomkino.base_acceleration(z, zdot, forces),
            "contact_force": jcomkino._contact_generalized_force(z, forces),
            "momentum_matrix": jcentroidal.centroidal_momentum_matrix(x[12:24], x[9:12]),
            "com_offset": jcentroidal.com_offset_base(x[12:24]),
            "dynamics_full": jcentroidal.dynamics_full(0.0, x, u, {}),
            "q_rbd": q_rbd, "v_rbd": v_rbd,
            "x_from_rbd": jcentroidal.centroidal_state_from_rbd(q_rbd, v_rbd),
        }

    fn = jax.jit(jax.vmap(one, in_axes=(0, 0, None, None)))
    x, u = samples()
    out = {}
    for name, wrench in WRENCHES.items():
        f, tau = wrench or (None, None)
        f = np.zeros(3, np.float32) if f is None else f
        tau = np.zeros(3, np.float32) if tau is None else tau
        out[name] = jax.tree.map(np.asarray, fn(x, u, f, tau))
    return dict(samples=dict(x=x, u=u), out=out)


JAX_RECORDS = {"jax_side": _jax_side}
RECORDS = Records(__file__)


@functools.lru_cache(maxsize=None)
def jax_side():
    rec = RECORDS["jax_side"]
    x, u = samples()
    np.testing.assert_array_equal(rec["samples"]["x"], x)  # the record's inputs
    np.testing.assert_array_equal(rec["samples"]["u"], u)
    return rec["out"]


# -- constants and mass model ---------------------------------------------------------


def test_mass_model_matches():
    for name in ("HIP_MASS", "THIGH_MASS", "SHANK_MASS", "LEG_MASS", "BASE_MASS"):
        assert getattr(centroidal, name) == getattr(jcentroidal, name), name
    for masses in ("DEFAULT_MASSES", "SRBD_MASSES"):
        a, b = getattr(centroidal, masses), getattr(jcentroidal, masses)
        assert tuple(a) == tuple(b) and (a.leg, a.base) == (b.leg, b.base)
        assert convert.mass_model_from_numpy(b._asdict()) == a
        np.testing.assert_array_equal(comkino._base_inertia(a), jcomkino._base_inertia(b))
    np.testing.assert_array_equal(centroidal.BASE_INERTIA, jcentroidal.BASE_INERTIA)
    assert comkino.NZ == jcomkino.NZ == 18


# -- ComKino, live against the JAX package ---------------------------------------------


@pytest.mark.parametrize("wrench", sorted(WRENCHES))
def test_comkino_dynamics_matches(wrench):
    x, u = samples()
    ref = jax_side()[wrench]["dynamics"]
    p = {} if WRENCHES[wrench] is None else {
        k: T(v) for k, v in zip(("external_force_world", "external_torque_base"),
                                WRENCHES[wrench]) if v is not None}
    mine = comkino.dynamics(0.0, T(x), T(u), p)
    assert mine.shape == (16, 24) and mine.dtype == torch.float32
    close(mine, ref)
    close(comkino.dynamics(0.0, T(x[3]), T(u[3]), p), ref[3])  # one sample


def test_comkino_mass_matrix_matches():
    x, _ = samples()
    close(comkino.mass_matrix(T(x)), jax_side()["none"]["mass_matrix"])


def test_comkino_base_acceleration_and_contact_force_match():
    x, u = samples()
    z, deuler = z_of(x)
    zdot = np.concatenate([x[:, 0:3], deuler, u[:, 12:24]], axis=1)
    forces = T(u[:, :12].reshape(16, 4, 3))
    ref = jax_side()["none"]
    close(comkino.base_acceleration(T(z), T(zdot), forces), ref["base_acceleration"])
    close(comkino._contact_generalized_force(T(z), forces), ref["contact_force"])


def test_comkino_energy_terms_match():
    x, u = samples()
    z, deuler = z_of(x)
    zdot = np.concatenate([x[:, 0:3], deuler, u[:, 12:24]], axis=1)
    ib = jcomkino._base_inertia(DEFAULT_MASSES)
    ref_ke = jax.vmap(lambda a, b: jcomkino._kinetic_energy(a, b, DEFAULT_MASSES, ib))(z, zdot)
    ref_pe = jax.vmap(lambda a: jcomkino._potential_energy(a, DEFAULT_MASSES))(z)
    close(comkino._kinetic_energy(T(z), T(zdot), DEFAULT_MASSES, ib), ref_ke)
    close(comkino._potential_energy(T(z), DEFAULT_MASSES), ref_pe)
    ps, m = comkino._link_points(T(z), DEFAULT_MASSES)
    ref_ps, ref_m = jax.vmap(lambda a: jcomkino._link_points(a, DEFAULT_MASSES))(z)
    close(ps, ref_ps)
    close(m, ref_m[0])
    close(comkino._omega_body(T(z[:, 3:6]), T(deuler)),
          jax.vmap(jcomkino._omega_body)(z[:, 3:6], deuler))


def test_rate_inverse_is_the_inverse_of_the_rate_matrix():
    """W (closed form) inverts the rate matrix, and its time derivative is the
    forward derivative of W along the euler rates."""
    e = np.random.default_rng(2).uniform(-1.2, 1.2, (8, 3)).astype(np.float32)
    de = np.random.default_rng(3).standard_normal((8, 3)).astype(np.float32)
    w = comkino._rate_inverse(T(e))
    close(w @ model.euler_zyx_rate_matrix(T(e)), np.broadcast_to(np.eye(3), (8, 3, 3)))
    _, w_dot = torch.func.jvp(lambda ee: comkino._rate_inverse(ee) @ T(de)[..., None],
                              (T(e),), (T(de),))
    close(comkino._rate_inverse_dot(T(e), T(de)), w_dot[..., 0])


def test_comkino_dynamics_under_jacfwd_and_vmap_stays_float32():
    x, u = samples()
    jac = torch.func.vmap(torch.func.jacfwd(lambda xx, uu: comkino.dynamics(0.0, xx, uu, {}),
                                            argnums=(0, 1)))(T(x[:4]), T(u[:4]))
    assert all(j.dtype == torch.float32 for j in jac)
    assert jac[0].shape == (4, 24, 24) and jac[1].shape == (4, 24, 24)


def test_solve_psd_small_under_jacfwd_in_the_matrix():
    """jacfwd with respect to the matrix (ComKino's 6x6 solve inside the LQ
    approximation) keeps float32: the pivots' reciprocal is a tensor op, not
    1.0 / d, which promotes a 0-dim dual to float64."""
    rng = np.random.default_rng(9)
    a = rng.standard_normal((3, 6, 6)).astype(np.float32)
    m = a @ a.transpose(0, 2, 1) + 6.0 * np.eye(6, dtype=np.float32)
    rhs = rng.standard_normal((3, 6)).astype(np.float32)
    mine = torch.func.vmap(torch.func.jacfwd(smallmat.solve_psd_small))(T(m), T(rhs))
    assert mine.dtype == torch.float32
    ref = jax.jit(jax.vmap(jax.jacfwd(jsmallmat.solve_psd_small)))(m, rhs)
    close(mine, ref)


# -- the JAX package's own ComKino checks, on the port -----------------------------------


def test_comkino_reduces_to_srbd():
    x = model.default_state("cpu")
    u = model.weight_compensating_input(np.ones(4), "cpu")
    close(comkino.dynamics(0.0, x, u, {}, masses=SRBD_MASSES), model.dynamics(0.0, x, u, {}),
          atol=1e-4)


def test_comkino_mass_matrix_spd_and_total_mass():
    x = model.default_state("cpu") + 0.1 * T(np.random.default_rng(0).standard_normal(24))
    m = comkino.mass_matrix(x).numpy()
    assert np.max(np.abs(m - m.T)) < 1e-5
    assert np.linalg.eigvalsh(m).min() > 0
    close(m[:3, :3], model.MASS * np.eye(3), atol=1e-4)


def test_comkino_energy_conservation_free_fall():
    """No contact forces, frozen joints: total energy is conserved under RK4."""
    x = model.default_state("cpu")
    x[0:3] = T([0.3, -0.2, 0.5])
    x[3:6] = T([0.02, -0.03, 0.04])
    u = torch.zeros(model.NU)
    ib = comkino._base_inertia(DEFAULT_MASSES)

    def energy(xx):
        z, _, deuler = comkino._state_to_z(xx)
        zdot = torch.cat([xx[0:3], deuler, torch.zeros(12)])
        return float(comkino._kinetic_energy(z, zdot, DEFAULT_MASSES, ib)
                     + comkino._potential_energy(z, DEFAULT_MASSES))

    f = lambda xx: comkino.dynamics(0.0, xx, u, {})  # noqa: E731
    dt, e0 = 2e-3, energy(x)
    for _ in range(50):
        k1 = f(x)
        k2 = f(x + 0.5 * dt * k1)
        k3 = f(x + 0.5 * dt * k2)
        k4 = f(x + dt * k3)
        x = x + dt / 6.0 * (k1 + 2 * k2 + 2 * k3 + k4)
    assert abs(energy(x) - e0) < 5e-3 * max(abs(e0), 1.0)


def test_comkino_coriolis_affects_base():
    x = model.default_state("cpu")
    u0 = torch.zeros(model.NU)
    u1 = u0.clone()
    u1[12:24] = 3.0
    d0, d1 = comkino.dynamics(0.0, x, u0, {}), comkino.dynamics(0.0, x, u1, {})
    assert float((d0[0:6] - d1[0:6]).abs().max()) > 1e-4


def test_comkino_external_disturbance():
    x = model.default_state("cpu")
    u = model.weight_compensating_input(np.ones(4), "cpu")
    d0 = comkino.dynamics(0.0, x, u, {})
    d_f = comkino.dynamics(0.0, x, u, {"external_force_world": T([30.0, 0.0, 0.0])})
    np.testing.assert_allclose(float(d_f[0] - d0[0]), 30.0 / model.MASS, rtol=5e-2)
    d_t = comkino.dynamics(0.0, x, u, {"external_torque_base": T([0.0, 0.0, 2.0])})
    assert float((d_t[5] - d0[5]).abs()) > 1e-4


# -- the full centroidal model ------------------------------------------------------


def test_momentum_matrix_and_com_offset_match():
    x, _ = samples()
    ref = jax_side()["none"]
    close(centroidal.centroidal_momentum_matrix(T(x[:, 12:24]), T(x[:, 9:12])),
          ref["momentum_matrix"])
    close(centroidal.com_offset_base(T(x[:, 12:24])), ref["com_offset"])


def test_dynamics_full_matches():
    x, u = samples()
    mine = centroidal.dynamics_full(0.0, T(x), T(u), {})
    close(mine, jax_side()["none"]["dynamics_full"])
    close(centroidal.dynamics_full(0.0, T(x[5]), T(u[5]), None), mine[5])


def test_rbd_conversions_match_and_round_trip():
    x, u = samples()
    ref = jax_side()["none"]
    q_rbd, v_rbd = centroidal.rbd_state_from_centroidal(T(x), T(u))
    close(q_rbd, ref["q_rbd"])
    close(v_rbd, ref["v_rbd"])
    back = centroidal.centroidal_state_from_rbd(q_rbd, v_rbd)
    close(back, ref["x_from_rbd"])
    close(back, x, rtol=1e-3, atol=1e-4)


def test_momentum_is_linear_in_velocities():
    rng = np.random.default_rng(0)
    q_j = T(model.DEFAULT_JOINTS + 0.2 * rng.standard_normal(12))
    euler = T([0.3, -0.1, 0.2])
    a = centroidal.centroidal_momentum_matrix(q_j, euler)
    for _ in range(3):
        v = T(rng.standard_normal(18))
        h = centroidal._momentum_world(q_j, euler, v[0:3], v[3:6], v[6:18], DEFAULT_MASSES)
        close(a @ v, h)


def test_momentum_matrix_blocks():
    a = centroidal.centroidal_momentum_matrix(T(model.DEFAULT_JOINTS), T([0.1, 0.2, -0.1]))
    close(a[3:6, 0:3], np.zeros((3, 3)), atol=1e-4)  # sum m_i (p_i - r_com) = 0
    a0 = centroidal.centroidal_momentum_matrix(T(model.DEFAULT_JOINTS), torch.zeros(3))
    close(a0[0:3, 0:3], model.MASS * np.eye(3), rtol=1e-5)


def test_base_velocity_consistency():
    rng = np.random.default_rng(7)
    x = model.default_state("cpu") + 0.3 * T(rng.standard_normal(24))
    dq = 0.5 * T(rng.standard_normal(12))
    v_base, omega = centroidal.base_velocity_from_momentum(x, dq)
    h = centroidal._momentum_world(model.joint_angles(x), model.base_euler(x), v_base, omega, dq,
                                   DEFAULT_MASSES)
    close(h / model.MASS, x[0:6], rtol=1e-3, atol=1e-4)


def test_full_reduces_to_srbd_with_massless_legs():
    rng = np.random.default_rng(11)
    x = model.default_state("cpu") + 0.2 * T(rng.standard_normal(24))
    u = model.weight_compensating_input(np.ones(4), "cpu") + 0.2 * T(rng.standard_normal(24))
    dx_full = centroidal.make_dynamics(SRBD_MASSES)(0.0, x, u, {})
    dx_srbd = model.dynamics(0.0, x, u, {})
    close(dx_full[0:3], dx_srbd[0:3])
    close(dx_full[6:9], dx_srbd[6:9], rtol=1e-3, atol=1e-4)
    close(dx_full[12:], dx_srbd[12:], atol=1e-6)


def test_com_offset_massless_and_moving_legs():
    q0 = T(model.DEFAULT_JOINTS)
    close(centroidal.com_offset_base(q0, SRBD_MASSES), np.zeros(3), atol=1e-7)
    q1 = q0.reshape(4, 3).clone()
    q1[:, 1] -= 0.6
    assert float(centroidal.com_offset_base(q1.reshape(-1))[0]) > float(
        centroidal.com_offset_base(q0)[0]) + 1e-3


# -- against the JAX package's record (tools/comkino_reference.py) -------------------------


@functools.lru_cache(maxsize=None)
def record():
    with np.load(RECORD) as f:
        return {k: f[k] for k in f.files}


def entry(prefix):
    """Record entries directly under ``prefix/`` (arrays) and below (dicts)."""
    out = {}
    for key, val in record().items():
        if key.startswith(prefix + "/"):
            parts = key[len(prefix) + 1:].split("/")
            d = out
            for part in parts[:-1]:
                d = d.setdefault(part, {})
            d[parts[-1]] = val
    return out


def assert_solve_matches(sol, ref):
    assert int(sol.iterations[0]) == int(ref["iterations"])
    close_solve(sol.xs[0], ref["xs"])
    close_solve(sol.us[0], ref["us"])


def test_comkino_lq_jacobians_match_the_record():
    from ocs2_tpu_torch.oc.approx import approximate_lq

    rec = entry("lq")
    grid = convert.time_grid_from_numpy(rec["grid"], device="cpu")
    problem = interface.make_problem(model_type="comkino", device="cpu")
    lq = approximate_lq(problem, grid, T(rec["xs"])[None], T(rec["us"])[None],
                        interface.make_params(grid, device="cpu"), method="rk2")
    for f in ("f", "dfdx", "dfdu"):
        close(getattr(lq.dynamics, f)[0], rec["dynamics"][f], LQ_RTOL, LQ_ATOL)


def test_comkino_trot_solve_matches_the_record():
    rec = entry("trot")
    grid = convert.time_grid_from_numpy(rec["grid"], device="cpu")
    problem = interface.make_problem(model_type="comkino", device="cpu")
    sol = sqp.solve(problem, grid, T(rec["x0"]), interface.make_params(grid, device="cpu"),
                    us_init=T(rec["us_init"]), device="cpu",
                    settings=sqp.SqpSettings(max_iterations=TROT_ITERATIONS))
    assert_solve_matches(sol, rec)
    assert bool(torch.isfinite(sol.xs).all())
    close(sol.performance.merit[0], rec["merit"], rtol=1e-4, atol=0.0)


@functools.lru_cache(maxsize=None)
def loop_problem():
    from ocs2_tpu_torch.models.legged_robot import foothold_planner as fp

    return fp.make_segmented_perceptive_problem(model_type="comkino", device="cpu")


# Near the horizon's end a stance force's x/y split is held by the 1e-3 input
# weight alone, and ComKino's mass matrix carries it into the joint
# velocities: on the loop's third tick the JAX package's one solve and its
# solve inside jax.vmap differ by 0.094 N in the forces and 0.011 rad/s in the
# joint velocities (the record's loop/tick2/vmapped).  The inputs are held
# within 1e-3 + 1e-4 |value|, or within twice the reference's own spread where
# that is larger.


@pytest.mark.parametrize("tick", range(RECORDED_TICKS))
def test_comkino_closed_loop_tick_matches_the_record(tick):
    """Each of the first 3 ticks of the ComKino perceptive closed loop, solved
    from the JAX tick's own grid, state, warm start, multipliers and params
    (the foothold plan included)."""
    rec = entry(f"loop/tick{tick}")
    al = convert.al_state_from_numpy(rec["al"], device="cpu")
    sol = sqp.solve(loop_problem(), convert.time_grid_from_numpy(rec["grid"], device="cpu"),
                    T(rec["x0"]), convert.params_from_numpy(rec["params"], device="cpu"),
                    xs_init=T(rec["xs_init"]), us_init=T(rec["us_init"]),
                    al_init=type(al)(*(a[None] for a in al)), device="cpu",
                    settings=sqp.SqpSettings(max_iterations=5, integrator="rk2"))
    assert int(sol.iterations[0]) == int(rec["iterations"]) == int(rec["vmapped"]["iterations"])
    close_solve(sol.xs[0], rec["xs"])
    spread = np.abs(rec["us"] - rec["vmapped"]["us"])
    for cols in (slice(0, 12), slice(12, 24)):  # contact forces, joint velocities
        atol = max(SOLVE_ATOL, 2.0 * float(spread[:, cols].max()))
        close(sol.us[0, :, cols], rec["us"][:, cols], SOLVE_RTOL, atol)


def test_comkino_closed_loop_states_match_the_record():
    """The port's own loop (``Mpc`` with the ``PerceptiveReferenceManager``,
    ComKino, N = 32) over the recorded 3 ticks: iterations and its 13 states
    against the JAX loop's."""
    from ocs2_tpu_torch.core.reference import TargetTrajectories
    from ocs2_tpu_torch.models.legged_robot import foothold_planner as fp
    from ocs2_tpu_torch.models.legged_robot.gait import GaitSchedule, trot_gait
    from ocs2_tpu_torch.models.legged_robot.segmented_planes import decompose_planes
    from ocs2_tpu_torch.mpc.mpc import Mpc, MpcSettings
    from ocs2_tpu_torch.mpc.mrt import MpcMrtInterface, dummy_loop

    em = cs.stepped_map(cs.PERC_STEP_X, cs.LOOP_STEP_H, device="cpu")
    terr = decompose_planes(em, device="cpu")
    x0 = model.default_state("cpu")
    u0 = model.weight_compensating_input(np.ones(4), "cpu")
    x_t = x0.clone()
    x_t[0] = 0.4
    x_goal = x_t.clone()
    x_goal[6], x_goal[8] = 1.6, model.STAND_HEIGHT + cs.LOOP_STEP_H
    tgt = TargetTrajectories.create([0.0, 4.0], torch.stack([x_t, x_goal]),
                                    torch.stack([u0, u0]), device="cpu")
    rm = fp.PerceptiveReferenceManager(terr, em, GaitSchedule(trot_gait(0.7)), target=tgt,
                                       device="cpu")
    mpc = Mpc(loop_problem(),
              fp.make_perceptive_params(cs.trot_grid(cs.CK_HORIZON, cs.CK_N), terr, em, x0, tgt,
                                        device="cpu"),
              MpcSettings(time_horizon=cs.CK_HORIZON, num_intervals=cs.CK_N, solver="sqp"),
              solver_settings=sqp.SqpSettings(max_iterations=cs.CK_MAX_ITERATIONS,
                                              integrator="rk2"),
              reference_manager=rm, device="cpu")
    its = []

    def observe(t, x, u):
        if mpc.solve_timer.count > len(its):
            its.append(int(mpc.last_solution.iterations[0]))

    _, xs, _ = dummy_loop(MpcMrtInterface(mpc), x0, duration=RECORDED_TICKS / cs.CK_MPC_HZ,
                          mrt_frequency=cs.CK_MRT_HZ, mpc_frequency=cs.CK_MPC_HZ,
                          observers=[observe])
    assert its == [int(record()[f"loop/tick{i}/iterations"]) for i in range(RECORDED_TICKS)]
    close_solve(xs, record()["loop/states"])


def test_full_model_standing_solve_matches_the_record():
    """tests/test_centroidal.py:136 on the port: the full centroidal model in
    stance holds the base within 0.08 m of stand height."""
    from ocs2_tpu_torch.models.legged_robot.gait import GaitSchedule, stance_gait
    from ocs2_tpu_torch.oc.time_discretization import make_time_grid

    rec = entry("stand")
    ms = GaitSchedule(stance_gait()).mode_schedule(0.0, 1.0)
    grid = make_time_grid(0.0, 1.0, 20, event_times=ms.event_times,
                          mode_sequence=ms.mode_sequence)
    np.testing.assert_array_equal(grid.times, rec["grid"]["times"])
    sol = sqp.solve(interface.make_problem(model_type="full", device="cpu"), grid,
                    T(rec["x0"]), interface.make_params(grid, device="cpu"),
                    us_init=T(rec["us_init"]), device="cpu",
                    settings=sqp.SqpSettings(max_iterations=12, integrator="rk2"))
    assert_solve_matches(sol, rec)
    heights = sol.xs[0, :, 8].numpy()
    assert np.all(np.abs(heights - model.STAND_HEIGHT) < 0.08), heights
