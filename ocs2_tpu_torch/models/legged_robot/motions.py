"""Operator motion library and base-reference extrapolation for the quadruped.

Counterpart of ``ocs2_tpu/models/legged_robot/motions.py`` (the reference's
ocs2_anymal_commands): CSV motion files (one header line, rows of [time,
contact flags (4), base position (3), base quaternion wxyz (4), base-frame
linear and angular velocity (6), joint angles (12), joint velocities (12),
world contact forces (12)]) read into a (TargetTrajectories, ModeSchedule)
pair in the 24/24 centroidal layout and written back; a named motion library
that publishes a motion into a reference manager; and a base reference rolled
forward from (heading velocity, lateral velocity, yaw rate, height) commands.

Everything is host numpy, as in the JAX package; a motion's target goes to
``device`` (the card by default) as one TargetTrajectories, its mode
schedule stays on the host.
"""
from __future__ import annotations

import dataclasses
import io
from typing import Dict, Optional

import numpy as np
import torch

from ...core.reference import ModeSchedule, TargetTrajectories
from . import model
from .gait import contact_flags_static, mode_number

CSV_HEADER = (
    ["time"]
    + [f"contactflag_{leg}" for leg in ("LF", "RF", "LH", "RH")]
    + [f"base_positionInWorld_{a}" for a in "xyz"]
    + [f"base_quaternion_{a}" for a in "wxyz"]
    + [f"base_linearvelocityInBase_{a}" for a in "xyz"]
    + [f"base_angularvelocityInBase_{a}" for a in "xyz"]
    + [f"jointAngle_{leg}_{j}" for leg in ("LF", "RF", "LH", "RH") for j in ("HAA", "HFE", "KFE")]
    + [f"jointVelocity_{leg}_{j}" for leg in ("LF", "RF", "LH", "RH")
       for j in ("HAA", "HFE", "KFE")]
    + [f"contactForcesInWorld_{leg}_{a}" for leg in ("LF", "RF", "LH", "RH") for a in "xyz"]
)


def _host(v) -> np.ndarray:
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _default_state() -> np.ndarray:
    return model.default_state("cpu").numpy()


def _weight_compensating() -> np.ndarray:
    return model.weight_compensating_input(np.ones(4, np.float32), "cpu").numpy()


def _quat_wxyz_to_euler_zyx(q: np.ndarray) -> np.ndarray:
    """[N, 4] (w, x, y, z) -> [N, 3] (yaw, pitch, roll) ZYX."""
    w, x, y, z = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    yaw = np.arctan2(2 * (w * z + x * y), 1 - 2 * (y * y + z * z))
    pitch = np.arcsin(np.clip(2 * (w * y - z * x), -1.0, 1.0))
    roll = np.arctan2(2 * (w * x + y * z), 1 - 2 * (x * x + y * y))
    return np.stack([yaw, pitch, roll], axis=1)


def _quat_rotate(q: np.ndarray, v: np.ndarray) -> np.ndarray:
    """Rotate body vectors v [N, 3] to world by quaternions q [N, 4] wxyz."""
    w, xyz = q[:, :1], q[:, 1:]
    t = 2.0 * np.cross(xyz, v)
    return v + w * t + np.cross(xyz, t)


def _target(times, states, inputs, device) -> TargetTrajectories:
    return TargetTrajectories.create(np.asarray(times, np.float32), np.asarray(states, np.float32),
                                     np.asarray(inputs, np.float32), device=device)


@dataclasses.dataclass
class Motion:
    """A loaded motion: reference trajectories and its contact sequence."""

    target: TargetTrajectories
    mode_schedule: ModeSchedule
    duration: float


def read_motion_csv(source: str, dt: float = -1.0, device="cuda") -> Motion:
    """Parse a reference-format motion CSV.  ``source`` is the CSV text or a
    path; rows closer than ``dt`` to the last kept one are dropped (dt < 0
    keeps all).  States and inputs go to the centroidal layout (world-frame
    base velocity, normalized angular momentum through the SRBD inertia,
    euler ZYX)."""
    text = source
    if "\n" not in source:
        with open(source) as f:
            text = f.read()
    rows = np.genfromtxt(io.StringIO(text), delimiter=",", names=True)
    names = list(rows.dtype.names)
    if len(names) != len(CSV_HEADER):
        raise ValueError(f"motion csv has {len(names)} columns, expected {len(CSV_HEADER)}")
    data = np.stack([rows[n] for n in names], axis=1)
    if data.ndim == 1:
        data = data[None]
    if dt > 0:
        keep = [0]
        for i in range(1, data.shape[0]):
            if data[i, 0] - data[keep[-1], 0] >= dt - 1e-9:
                keep.append(i)
        data = data[keep]

    t = data[:, 0]
    flags = data[:, 1:5]
    quat = data[:, 8:12]
    euler = _quat_wxyz_to_euler_zyx(quat)
    v_world = _quat_rotate(quat, data[:, 12:15])
    # x[3:6] stores INERTIA * w_body / MASS (see model.py).
    h_n = np.asarray(model.INERTIA)[None] * data[:, 15:18] / model.MASS
    xs = np.concatenate([v_world, h_n, data[:, 5:8], euler, data[:, 18:30]], axis=1)
    us = np.concatenate([data[:, 42:54], data[:, 30:42]], axis=1)

    # Contact flags -> mode segments.
    modes = [mode_number(flags[0] > 0.5)]
    events = []
    for i in range(1, flags.shape[0]):
        m = mode_number(flags[i] > 0.5)
        if m != modes[-1]:
            events.append(float(t[i]))
            modes.append(m)
    ms = ModeSchedule.create(np.asarray(events), np.asarray(modes), capacity=max(len(events), 1))
    return Motion(target=_target(t, xs, us, device), mode_schedule=ms,
                  duration=float(t[-1] - t[0]))


def motion_to_csv(motion: Motion, times: np.ndarray) -> str:
    """Serialize a Motion back to the reference CSV format (the inverse of
    ``read_motion_csv``)."""
    lines = [",".join(CSV_HEADER)]
    for tt in times:
        x = _host(motion.target.state_at(np.float32(tt)))
        u = _host(motion.target.input_at(np.float32(tt)))
        fl = contact_flags_static(int(motion.mode_schedule.mode_at_time(np.float32(tt))))
        yaw, pitch, roll = x[9], x[10], x[11]
        cy, sy = np.cos(yaw / 2), np.sin(yaw / 2)
        cp, sp = np.cos(pitch / 2), np.sin(pitch / 2)
        cr, sr = np.cos(roll / 2), np.sin(roll / 2)
        quat = np.array([
            cy * cp * cr + sy * sp * sr,
            cy * cp * sr - sy * sp * cr,
            cy * sp * cr + sy * cp * sr,
            sy * cp * cr - cy * sp * sr,
        ])
        # World -> base-frame velocities.
        r = model.euler_zyx_rotation(torch.as_tensor(x[9:12])).numpy()
        v_b = r.T @ x[0:3]
        w_b = model.MASS * x[3:6] / np.asarray(model.INERTIA)
        row = np.concatenate([[tt], fl, x[6:9], quat, v_b, w_b, x[12:24], u[12:24], u[0:12]])
        lines.append(",".join(repr(float(v)) for v in row))
    return "\n".join(lines)


# -- built-in demo motions -------------------------------------------------------------


def _squat_motion(depth: float = 0.12, period: float = 2.0, device="cuda") -> Motion:
    """Full-stance squat: the base height oscillates with the feet pinned, the
    joint trajectories made consistent with the base motion by the analytic
    leg IK."""
    from . import ik

    t = np.linspace(0.0, period, 41)
    z = model.STAND_HEIGHT - depth * 0.5 * (1 - np.cos(2 * np.pi * t / period))
    dz = -depth * np.pi / period * np.sin(2 * np.pi * t / period)
    xs = np.tile(_default_state()[None], (t.size, 1))
    xs[:, 8] = z
    xs[:, 2] = dz
    feet0 = model.foot_positions_world(model.default_state("cpu"))
    for i in range(t.size):
        pose = torch.as_tensor(np.concatenate([xs[i, 6:9], xs[i, 9:12]]))
        xs[i, 12:24] = ik.joints_from_foot_positions_world(pose, feet0).numpy()
    us = np.tile(_weight_compensating()[None], (t.size, 1))
    dt = np.diff(t)
    us[:-1, 12:24] = (xs[1:, 12:24] - xs[:-1, 12:24]) / dt[:, None]
    us[-1, 12:24] = us[-2, 12:24]
    return Motion(target=_target(t, xs, us, device), mode_schedule=ModeSchedule.single_mode(15),
                  duration=float(period))


def _walk_forward_motion(distance: float = 0.4, duration: float = 2.0, device="cuda") -> Motion:
    """Straight static-walk translation of the base."""
    from .gait import GaitSchedule, static_walk_gait

    t = np.linspace(0.0, duration, 41)
    xs = np.tile(_default_state()[None], (t.size, 1))
    xs[:, 6] = distance * t / duration
    xs[:, 0] = distance / duration
    us = np.tile(_weight_compensating()[None], (t.size, 1))
    gs = GaitSchedule(static_walk_gait(1.0))
    return Motion(target=_target(t, xs, us, device),
                  mode_schedule=gs.mode_schedule(0.0, duration), duration=float(duration))


class MotionLibrary:
    """Named motion collection with a command surface."""

    def __init__(self, motions: Optional[Dict[str, Motion]] = None, device="cuda"):
        self.device = device
        self.motions: Dict[str, Motion] = motions or {
            "squat": _squat_motion(device=device),
            "walk_forward": _walk_forward_motion(device=device),
        }

    def list_motions(self):
        return sorted(self.motions)

    def add(self, name: str, motion: Motion) -> None:
        self.motions[name] = motion

    def load_csv(self, name: str, source: str, dt: float = -1.0) -> Motion:
        m = read_motion_csv(source, dt, device=self.device)
        self.add(name, m)
        return m

    def publish(self, name: str, reference_manager, t0: float = 0.0) -> Motion:
        """Retime a motion to start at t0 and push its target and mode schedule
        into the reference manager (applied at its next ``pre_solver_run``)."""
        m = self.motions[name]
        tgt = m.target
        shifted = TargetTrajectories(times=tgt.times - tgt.times[0] + t0, states=tgt.states,
                                     inputs=tgt.inputs)
        ms = m.mode_schedule
        n = int(ms.num_events)
        shifted_ms = ModeSchedule.create(np.asarray(ms.event_times[:n]) + t0,
                                         np.asarray(ms.mode_sequence[: n + 1]),
                                         capacity=max(n, 1))
        reference_manager.set_target(shifted)
        if hasattr(reference_manager, "set_mode_schedule"):
            reference_manager.set_mode_schedule(shifted_ms)
        return Motion(shifted, shifted_ms, m.duration)


# -- base-reference extrapolation -----------------------------------------------------


@dataclasses.dataclass(frozen=True)
class BaseReferenceCommand:
    """Operator velocity command."""

    heading_velocity: float = 0.0
    lateral_velocity: float = 0.0
    yaw_rate: float = 0.0
    base_height: float = model.STAND_HEIGHT


def generate_extrapolated_base_reference(
    horizon_dt: float,
    horizon_n: int,
    t0: float,
    x0,
    command: BaseReferenceCommand,
    terrain_height_fn=None,
    device="cuda",
) -> TargetTrajectories:
    """Roll the base pose forward under a constant (heading, lateral, yaw-rate)
    command: 2D unicycle integration, the height pinned to
    ``command.base_height`` above the terrain (``terrain_height_fn(xy) -> z``
    on host arrays, default flat 0)."""
    x0 = _host(x0)
    t = t0 + horizon_dt * np.arange(horizon_n + 1)
    yaw = x0[9] + command.yaw_rate * (t - t0)
    vx = command.heading_velocity * np.cos(yaw) - command.lateral_velocity * np.sin(yaw)
    vy = command.heading_velocity * np.sin(yaw) + command.lateral_velocity * np.cos(yaw)
    px = x0[6] + np.concatenate([[0.0], np.cumsum(vx[:-1]) * horizon_dt])
    py = x0[7] + np.concatenate([[0.0], np.cumsum(vy[:-1]) * horizon_dt])
    if terrain_height_fn is None:
        ground = np.zeros_like(px)
    else:
        ground = np.asarray([terrain_height_fn(np.array([xx, yy])) for xx, yy in zip(px, py)])

    xs = np.tile(_default_state()[None], (t.size, 1))
    xs[:, 0] = vx
    xs[:, 1] = vy
    xs[:, 5] = np.asarray(model.INERTIA)[2] * command.yaw_rate / model.MASS  # h_n yaw ~ I_z wz / m
    xs[:, 6] = px
    xs[:, 7] = py
    xs[:, 8] = ground + command.base_height
    xs[:, 9] = yaw
    us = np.tile(_weight_compensating()[None], (t.size, 1))
    return _target(t, xs, us, device)
