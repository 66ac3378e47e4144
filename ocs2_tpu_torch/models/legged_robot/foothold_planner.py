"""Foothold planning on segmented-planes terrain, terrain-adaptive swing, the
in-solver foot constraints that consume the plan, and the perceptive
reference manager of the MPC runtime.

Counterpart of ``ocs2_tpu/models/legged_robot/foothold_planner.py``.
Planning runs on the host once per MPC tick on small numpy arrays (this
package's own copy of the JAX package's planner): contact phases off the
node modes, heuristic footholds from the base target, projection onto the
segmented planes, quintic swing profiles over the terrain along the swing
line.  The product is a ``FootholdPlan`` of fixed-shape per-node arrays;
``plan_to_params`` sends its eight arrays to the device in one copy, and the
constraints below gather their node's row by the injected ``p["node"]``
(the flow of ``swing.py``).  The terrain and the rest of the params stay on
the device; the planner reads host mirrors of the terrain made once.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ...core import penalties as pen
from ...oc.problem import (
    OptimalControlProblem,
    quadratic_cost,
    quadratic_final_cost,
    soft_constraint,
)
from ...utils.timers import RepeatedTimer
from . import model
from .gait import contact_flags, contact_flags_static
from .model import (
    HIP_OFFSETS,
    NUM_LEGS,
    STAND_HEIGHT,
    contact_forces,
    foot_positions_world,
    foot_velocities_world,
)
from .segmented_planes import SegmentedPlanesTerrain
from .terrain import ElevationMap

Tensor = torch.Tensor
_BIG = 1e6


def _host(v) -> np.ndarray:
    """A tensor or an array as a numpy array (one copy for a device tensor)."""
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _foot_positions_world_np(x: np.ndarray) -> np.ndarray:
    """Numpy mirror of model.foot_positions_world for one state (host
    planner)."""
    yaw, pitch, roll = x[9], x[10], x[11]
    cy, sy = np.cos(yaw), np.sin(yaw)
    cp, sp = np.cos(pitch), np.sin(pitch)
    cr, sr = np.cos(roll), np.sin(roll)
    rz = np.array([[cy, -sy, 0.0], [sy, cy, 0.0], [0.0, 0.0, 1.0]])
    ry = np.array([[cp, 0.0, sp], [0.0, 1.0, 0.0], [-sp, 0.0, cp]])
    rx = np.array([[1.0, 0.0, 0.0], [0.0, cr, -sr], [0.0, sr, cr]])
    r_wb = rz @ ry @ rx
    q = np.asarray(x[12:24], np.float64).reshape(NUM_LEGS, 3)
    out = np.zeros((NUM_LEGS, 3))
    for leg in range(NUM_LEGS):
        haa, hfe, kfe = q[leg]
        side = model.leg_side_sign(leg)
        x_p = -model.THIGH_LENGTH * np.sin(hfe) - model.SHANK_LENGTH * np.sin(hfe + kfe)
        z_p = -model.THIGH_LENGTH * np.cos(hfe) - model.SHANK_LENGTH * np.cos(hfe + kfe)
        p_leg = np.array([x_p, side * model.HIP_LATERAL, z_p])
        c, s = np.cos(haa), np.sin(haa)
        rxx = np.array([[1.0, 0, 0], [0, c, -s], [0, s, c]])
        out[leg] = x[6:9] + r_wb @ (np.asarray(HIP_OFFSETS[leg]) + rxx @ p_leg)
    return out


class FootholdPlan(NamedTuple):
    """Per-node foot references (all [N+1, ...], world frame); numpy on the
    host, tensors once in the params.

    normal:    [N+1, 4, 3] surface normal (stance: segment plane normal;
               swing: liftoff -> touchdown blended normal).
    pos_ref_n: [N+1, 4]  reference of n . p_foot.
    vel_ref_n: [N+1, 4]  reference of n . v_foot.
    foothold:  [N+1, 4, 3] active / upcoming foothold location.
    pos_ref:   [N+1, 4, 3] 3D foot position reference (stance: the foothold;
               swing: the swing spline point).
    vel_ref:   [N+1, 4, 3] 3D foot velocity reference.
    tang_A:    [N+1, 4, V, 3], tang_b: [N+1, 4, V]  stance tangential
               polygon rows A p + b >= 0; inert rows (0, BIG) for swing.
    """

    normal: np.ndarray
    pos_ref_n: np.ndarray
    vel_ref_n: np.ndarray
    foothold: np.ndarray
    pos_ref: np.ndarray
    vel_ref: np.ndarray
    tang_A: np.ndarray
    tang_b: np.ndarray


# The params keys of the plan's fields, in FootholdPlan's order.
PLAN_KEYS = ("fh_normal", "fh_pos_n", "fh_vel_n", "fh_foothold", "fh_pos_ref",
             "fh_vel_ref", "fh_tang_A", "fh_tang_b")


class FootholdPlannerSettings(NamedTuple):
    """The subset of the swing-trajectory planner's settings that shapes
    footholds and swing."""

    swing_height: float = 0.08
    position_gain: float = 20.0  # foot-normal constraint position gain
    sdf_clearance: float = 0.03  # obstacle clearance at mid-swing
    inverted_pendulum_height: float = STAND_HEIGHT
    terrain_margin: float = 0.0
    # Approximate-kinematics foothold scoring: candidates are scored
    # distance^2 + this penalty, so a nearby segment that over-extends the
    # leg or forces an inward step loses to a reachable one.
    max_leg_extension: float = 0.55
    kinematic_penalty_weight: float = 5.0


# -- host-side numpy polygon queries ------------------------------------------


def _project_polygon_np(boundary: np.ndarray, nv: int, p: np.ndarray):
    """Numpy mirror of segmented_planes.project_to_polygon_2d."""
    v = boundary[:nv]
    p2 = np.roll(v, -1, axis=0)
    e = p2 - v
    len2 = np.maximum((e * e).sum(1), 1e-12)
    r = np.clip(((p[None] - v) * e).sum(1) / len2, 0.0, 1.0)
    q = v + r[:, None] * e
    d2 = ((p[None] - q) ** 2).sum(1)
    best = int(np.argmin(d2))
    cross = e[:, 0] * (p[1] - v[:, 1]) - e[:, 1] * (p[0] - v[:, 0])
    inside = bool(np.all(cross >= 0.0))
    return (-d2[best] if inside else d2[best]), q[best]


def compute_kinematic_penalty_np(
    foot_world: np.ndarray,
    hip_world: np.ndarray,
    rot_hip_to_world: np.ndarray,
    leg: int,
    max_leg_extension: float,
    weight: float,
) -> float:
    """Approximate-kinematics foothold penalty: weight * (inward-step^2 +
    over-extension^2).  The inward direction is gravity x hip-x in the hip
    frame, signed so that stepping under the body is penalized."""
    p_hip = rot_hip_to_world.T @ (foot_world - hip_world)
    g_hip = rot_hip_to_world.T @ np.array([0.0, 0.0, -1.0])
    # Rotation about +x of the hip frame turns the left leg outwards; for
    # right legs the axis is mirrored so "inward" keeps its meaning.
    x_axis = np.array([model.leg_side_sign(leg), 0.0, 0.0])
    inward = np.cross(g_hip, x_axis)
    nrm = np.linalg.norm(inward)
    instep = max(0.0, float(inward @ p_hip) / nrm) if nrm > 1e-9 else 0.0
    extension = max(0.0, float(np.linalg.norm(p_hip)) - max_leg_extension)
    return weight * (instep * instep + extension * extension)


def _closest_segment_np(terr: SegmentedPlanesTerrain, p_world: np.ndarray, kin=None):
    """(segment id, projected 3D point) on the host.  With ``kin`` =
    (hip_world, rot_hip_to_world, leg, settings), candidates are scored
    distance^2 + the kinematic penalty."""
    pp = _host(terr.plane_point)
    t1 = _host(terr.tangent1)
    t2 = _host(terr.tangent2)
    bd = _host(terr.boundary)
    nv = _host(terr.num_vertices)
    valid = _host(terr.valid)
    best, best_score, best_proj = 0, np.inf, p_world
    for k in range(pp.shape[0]):
        if not valid[k]:
            continue
        rel = p_world - pp[k]
        uv = np.array([rel @ t1[k], rel @ t2[k]])
        sq, img = _project_polygon_np(bd[k], int(nv[k]), uv)
        uv_in = uv if sq <= 0 else img
        proj = pp[k] + uv_in[0] * t1[k] + uv_in[1] * t2[k]
        score = ((p_world - proj) ** 2).sum()
        if kin is not None:
            hip_world, rot, leg, st = kin
            score += compute_kinematic_penalty_np(
                proj, hip_world, rot, leg, st.max_leg_extension, st.kinematic_penalty_weight)
        if score < best_score:
            best, best_score, best_proj = k, score, proj
    return best, best_proj


def _tangential_rows_np(terr: SegmentedPlanesTerrain, k: int, margin: float):
    """Numpy mirror of segmented_planes.tangential_constraint."""
    pp = _host(terr.plane_point)[k]
    t1 = _host(terr.tangent1)[k]
    t2 = _host(terr.tangent2)[k]
    bd = _host(terr.boundary)[k]
    nv = int(_host(terr.num_vertices)[k])
    V = bd.shape[0]
    A = np.zeros((V, 3), np.float32)
    b = np.full((V,), _BIG, np.float32)
    v = bd[:nv]
    p2 = np.roll(v, -1, axis=0)
    e = p2 - v
    en = np.stack([-e[:, 1], e[:, 0]], axis=1)
    en /= np.maximum(np.linalg.norm(en, axis=1, keepdims=True), 1e-9)
    rows = en[:, 0:1] * t1[None] + en[:, 1:2] * t2[None]
    verts_w = pp[None] + v[:, 0:1] * t1[None] + v[:, 1:2] * t2[None]
    A[:nv] = rows
    b[:nv] = -(rows * verts_w).sum(1) - margin
    return A, b


def _quintic_1d(s: np.ndarray, p0, v0, p1, v1):
    """Quintic with zero acceleration at both ends on s in [0, 1]: returns
    (p(s), dp/ds)."""
    h00 = 1 - 10 * s**3 + 15 * s**4 - 6 * s**5
    h10 = s - 6 * s**3 + 8 * s**4 - 3 * s**5
    h01 = 10 * s**3 - 15 * s**4 + 6 * s**5
    h11 = -4 * s**3 + 7 * s**4 - 3 * s**5
    p = h00 * p0 + h10 * v0 + h01 * p1 + h11 * v1
    d00 = -30 * s**2 + 60 * s**3 - 30 * s**4
    d10 = 1 - 18 * s**2 + 32 * s**3 - 15 * s**4
    d01 = 30 * s**2 - 60 * s**3 + 30 * s**4
    d11 = -12 * s**2 + 28 * s**3 - 15 * s**4
    dp = d00 * p0 + d10 * v0 + d01 * p1 + d11 * v1
    return p, dp


def plan_footholds(
    terr: SegmentedPlanesTerrain,
    em: ElevationMap,
    node_times: np.ndarray,
    node_modes: np.ndarray,
    x0,
    target,
    settings: FootholdPlannerSettings = FootholdPlannerSettings(),
) -> FootholdPlan:
    """The FootholdPlan of one horizon (host, once per MPC tick).

    Per leg: contact phases off the node modes -> heuristic foothold at each
    phase's middle from the base target (hip projection and an
    inverted-pendulum shift) -> projection onto the best segment -> stance
    rows and terrain-adaptive swing splines between consecutive footholds.

    ``terr``, ``em``, ``x0`` and ``target``'s times and states may be
    tensors or numpy; a device tensor is copied to the host once here (the
    reference manager passes host mirrors, so a tick reads only ``x0``)."""
    node_times = np.asarray(node_times, np.float64)
    node_modes = np.asarray(node_modes)
    n1 = node_times.shape[0]
    V = terr.boundary.shape[1]
    heights_np = _host(em.heights)
    res = float(em.resolution)
    origin = np.asarray(_host(em.origin_xy), np.float64)

    normal = np.tile(np.array([0, 0, 1.0], np.float32), (n1, NUM_LEGS, 1))
    pos_ref_n = np.zeros((n1, NUM_LEGS), np.float32)
    vel_ref_n = np.zeros((n1, NUM_LEGS), np.float32)
    foothold = np.zeros((n1, NUM_LEGS, 3), np.float32)
    pos_ref = np.zeros((n1, NUM_LEGS, 3), np.float32)
    vel_ref = np.zeros((n1, NUM_LEGS, 3), np.float32)
    tang_A = np.zeros((n1, NUM_LEGS, V, 3), np.float32)
    tang_b = np.full((n1, NUM_LEGS, V), _BIG, np.float32)

    x0 = _host(x0)
    feet0 = _foot_positions_world_np(x0)
    tgt_times = np.asarray(_host(target.times), np.float64)
    tgt_states = np.asarray(_host(target.states), np.float64)

    def target_state_np(t):
        k = np.clip(np.searchsorted(tgt_times, t) - 1, 0, len(tgt_times) - 2)
        t0_, t1_ = tgt_times[k], tgt_times[k + 1]
        a = 0.0 if t1_ <= t0_ else np.clip((t - t0_) / (t1_ - t0_), 0.0, 1.0)
        return (1 - a) * tgt_states[k] + a * tgt_states[k + 1]

    base_v0 = x0[0:3]
    flags = np.stack([contact_flags_static(int(m)) for m in node_modes])

    def height_line_max(p0, p1, samples=12):
        """Max terrain height along the xy segment."""
        ss = np.linspace(0.0, 1.0, samples)
        xy = p0[None, :2] * (1 - ss)[:, None] + p1[None, :2] * ss[:, None]
        ij = (xy - origin[None]) / res
        i = np.clip(ij[:, 0].round().astype(int), 0, heights_np.shape[0] - 1)
        j = np.clip(ij[:, 1].round().astype(int), 0, heights_np.shape[1] - 1)
        return float(heights_np[i, j].max())

    nn_np = _host(terr.plane_normal)
    for leg in range(NUM_LEGS):
        in_contact = flags[:, leg] > 0.5
        # Phase boundaries: runs of equal contact flag over nodes.
        bounds = [0] + [k for k in range(1, n1) if in_contact[k] != in_contact[k - 1]] + [n1]
        phases = [
            (bounds[i], bounds[i + 1], bool(in_contact[bounds[i]]))
            for i in range(len(bounds) - 1)
        ]

        # 1) Foothold per contact phase.
        phase_foothold: list = []
        phase_seg: list = []
        for (s, e, contact) in phases:
            if not contact:
                phase_foothold.append(None)
                phase_seg.append(None)
                continue
            kin = None
            if s == 0:
                # Ongoing stance: keep the current foot position.
                heur = feet0[leg]
            else:
                t_mid = 0.5 * (node_times[s] + node_times[min(e, n1 - 1)])
                xb = target_state_np(float(t_mid))
                yaw = xb[9]
                cz, sz = np.cos(yaw), np.sin(yaw)
                rot = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1.0]])
                heur = xb[6:9] + rot @ np.asarray(HIP_OFFSETS[leg], np.float64)
                # Inverted-pendulum shift toward the base velocity.
                t_swing = max(node_times[s] - node_times[0], 0.0)
                ip = np.sqrt(settings.inverted_pendulum_height / 9.81)
                heur = heur + ip * np.concatenate([base_v0[:2], [0.0]]) * min(t_swing, 0.5)
                # Seed the heuristic height from the terrain under its xy, so
                # the lower of two stacked segments is not picked whenever the
                # height difference exceeds the xy overshoot.
                ij = (heur[:2] - origin) / res
                hi = int(np.clip(round(ij[0]), 0, heights_np.shape[0] - 1))
                hj = int(np.clip(round(ij[1]), 0, heights_np.shape[1] - 1))
                heur[2] = float(heights_np[hi, hj])
                # Score candidate segments with the approximate-kinematics
                # penalty from the hip at the phase midpoint.
                hip_world = xb[6:9] + rot @ np.asarray(HIP_OFFSETS[leg], np.float64)
                kin = (hip_world, rot, leg, settings)
            k, proj = _closest_segment_np(terr, np.asarray(heur, np.float64), kin=kin)
            phase_foothold.append(proj.astype(np.float32))
            phase_seg.append(k)

        # 2) Per-node stance rows and swing splines.
        for pi, (s, e, contact) in enumerate(phases):
            if contact:
                k = phase_seg[pi]
                fh = phase_foothold[pi]
                n_k = nn_np[k]
                A, b = _tangential_rows_np(terr, k, settings.terrain_margin)
                normal[s:e, leg] = n_k
                pos_ref_n[s:e, leg] = float(n_k @ fh)
                vel_ref_n[s:e, leg] = 0.0
                foothold[s:e, leg] = fh
                pos_ref[s:e, leg] = fh
                vel_ref[s:e, leg] = 0.0
                tang_A[s:e, leg] = A
                tang_b[s:e, leg] = b
            else:
                # Swing: previous foothold -> next foothold.
                prev_fh = None
                for pj in range(pi - 1, -1, -1):
                    if phase_foothold[pj] is not None:
                        prev_fh = phase_foothold[pj]
                        break
                next_fh, next_seg = None, None
                for pj in range(pi + 1, len(phases)):
                    if phase_foothold[pj] is not None:
                        next_fh, next_seg = phase_foothold[pj], phase_seg[pj]
                        break
                if prev_fh is None:
                    prev_fh = feet0[leg].astype(np.float32)
                if next_fh is None:
                    next_fh, next_seg = prev_fh, None
                t_lo = node_times[max(s - 1, 0)]
                t_td = node_times[min(e, n1 - 1)]
                dur = max(t_td - t_lo, 1e-3)
                # Terrain-adaptive apex: clear the highest terrain on the line.
                obst = height_line_max(prev_fh, next_fh)
                apex = max(float(prev_fh[2]), float(next_fh[2])) + settings.swing_height
                apex = max(apex, obst + settings.sdf_clearance + settings.swing_height)
                # Normal blended from the liftoff to the touchdown plane.
                n_lo = normal[max(s - 1, 0), leg].astype(np.float64)
                n_td = np.asarray(nn_np[next_seg] if next_seg is not None else n_lo, np.float64)
                ph = ((node_times[s:e] - t_lo) / dur)[:, None]  # [m, 1]
                nb = (1 - ph) * n_lo[None] + ph * n_td[None]
                nb /= np.maximum(np.linalg.norm(nb, axis=1, keepdims=True), 1e-9)
                # Two-piece quintic through the apex at ph = 0.5.
                z_up, dz_up = _quintic_1d(2 * ph[:, 0], float(prev_fh[2]), 0.0, apex, 0.0)
                z_dn, dz_dn = _quintic_1d(2 * ph[:, 0] - 1, apex, 0.0, float(next_fh[2]), 0.0)
                up = ph[:, 0] < 0.5
                z = np.where(up, z_up, z_dn)
                dz = np.where(up, dz_up, dz_dn) * (2.0 / dur)
                xy = prev_fh[None, :2] * (1 - ph) + next_fh[None, :2] * ph
                vxy = np.broadcast_to((next_fh[:2] - prev_fh[:2]) / dur, xy.shape)
                p_ref = np.concatenate([xy, z[:, None]], axis=1)
                v_ref = np.concatenate([vxy, dz[:, None]], axis=1)
                normal[s:e, leg] = nb
                pos_ref_n[s:e, leg] = np.einsum("ij,ij->i", nb, p_ref)
                vel_ref_n[s:e, leg] = np.einsum("ij,ij->i", nb, v_ref)
                foothold[s:e, leg] = next_fh
                pos_ref[s:e, leg] = p_ref
                vel_ref[s:e, leg] = v_ref

    return FootholdPlan(normal, pos_ref_n, vel_ref_n, foothold, pos_ref, vel_ref, tang_A,
                        tang_b)


# -- in-solver terms consuming the plan (batch-polymorphic) -------------------


def _plan_rows(p, key):
    return p[key][p["node"]]


def _normal_errors(x, u, p, position_gain):
    """n.v_foot - v_ref + gain * (n.p_foot - p_ref), [..., 4]."""
    n = _plan_rows(p, "fh_normal")  # [..., 4, 3]
    perr = torch.sum(n * foot_positions_world(x), dim=-1) - _plan_rows(p, "fh_pos_n")
    verr = torch.sum(n * foot_velocities_world(x, u), dim=-1) - _plan_rows(p, "fh_vel_n")
    return verr + position_gain * perr


def foot_normal_constraint(position_gain: float = 20.0):
    """[..., 4] state-input equality n.v_foot - v_ref + gain*(n.p_foot -
    p_ref) = 0, active in stance and in swing."""

    def g(t, x, u, p):
        del t
        return _normal_errors(x, u, p, position_gain)

    return g


def _tangent_basis(n: Tensor):
    """Tangents of unit normals [..., 3] by Gram-Schmidt on world x (world y
    where |n_x| >= 0.9)."""
    ex = torch.tensor([1.0, 0.0, 0.0], dtype=n.dtype, device=n.device)
    ey = torch.tensor([0.0, 1.0, 0.0], dtype=n.dtype, device=n.device)
    ref = torch.where(torch.abs(n[..., 0:1]) < 0.9, ex, ey)
    t1 = model._cross(n, ref)
    t1 = t1 / torch.clamp(torch.linalg.norm(t1, dim=-1, keepdim=True), min=1e-9)
    return t1, model._cross(n, t1)


def foot_contact_constraint(position_gain: float = 20.0):
    """[..., 12] equality, the merged per-leg contact constraint (three rows
    a leg, in blocks of four legs):

    stance: (t1.v, t2.v, n.v + gain*(n.p - n.foothold)) = 0 (no slip in the
            tangent plane, attachment to the segment plane along its normal);
    swing:  (t1.f, t2.f, n.f) = 0 (zero contact force).

    The mode-paired rows keep it full-rank in u for the QR projection.  The
    swing half of the normal tracking is the soft ``swing_normal_motion_error``.
    """

    def g(t, x, u, p):
        del t
        c = contact_flags(p["mode"])
        n = _plan_rows(p, "fh_normal")  # [..., 4, 3]
        t1, t2 = _tangent_basis(n)
        vels = foot_velocities_world(x, u)
        feet = foot_positions_world(x)
        f = contact_forces(u)
        rows1 = c * torch.sum(t1 * vels, -1) + (1 - c) * torch.sum(t1 * f, -1)
        rows2 = c * torch.sum(t2 * vels, -1) + (1 - c) * torch.sum(t2 * f, -1)
        normal_eq = (
            torch.sum(n * vels, dim=-1)
            - _plan_rows(p, "fh_vel_n")
            + position_gain * (torch.sum(n * feet, dim=-1) - _plan_rows(p, "fh_pos_n"))
        )
        rows3 = c * normal_eq + (1 - c) * torch.sum(n * f, -1)
        return torch.cat([rows1, rows2, rows3], dim=-1)

    return g


def swing_normal_motion_error(position_gain: float = 20.0):
    """[..., 4] soft swing-foot normal tracking residual, gated to swing legs
    (stance legs carry the hard row of ``foot_contact_constraint``)."""

    def g(t, x, u, p):
        del t
        c = contact_flags(p["mode"])
        return (1.0 - c) * _normal_errors(x, u, p, position_gain)

    return g


def foothold_polygon_penalty(t, x, p):
    """[..., 4 * V] state inequality: stance feet inside the chosen segment's
    convex polygon, A p + b >= 0 per edge; swing and padded rows inert."""
    del t
    c = contact_flags(p["mode"])[..., None]  # [..., 4, 1]
    A = _plan_rows(p, "fh_tang_A")  # [..., 4, V, 3]
    b = _plan_rows(p, "fh_tang_b")  # [..., 4, V]
    feet = foot_positions_world(x)  # [..., 4, 3]
    vals = torch.sum(A * feet[..., None, :], dim=-1) + b
    vals = c * vals + (1 - c) * 1.0
    return vals.reshape(vals.shape[:-2] + (-1,))


def swing_motion_error(t, x, p):
    """[..., 8] swing-foot xy tracking error toward the planned swing line
    (the z axis belongs to the normal rows)."""
    del t
    c = contact_flags(p["mode"])
    feet = foot_positions_world(x)
    err = (feet[..., :2] - _plan_rows(p, "fh_pos_ref")[..., :2]) * (1.0 - c)[..., None]
    return err.reshape(err.shape[:-2] + (-1,))


def plan_friction_cone(mu: float = 0.7, cone_eps: float = 5.0):
    """[..., 4] inequality: friction cone about the planned per-node surface
    normal (no plane fit inside the solver)."""

    def h(t, x, u, p):
        del t, x
        c = contact_flags(p["mode"])
        n = _plan_rows(p, "fh_normal")  # [..., 4, 3]
        f = contact_forces(u)
        fn = torch.sum(n * f, dim=-1, keepdim=True)
        ft = f - fn * n
        cone = mu * fn[..., 0] - torch.sqrt(torch.sum(ft * ft, dim=-1) + cone_eps)
        return c * cone + (1.0 - c) * 1.0

    return h


# -- problem assembly and the reference manager --------------------------------


def make_segmented_perceptive_problem(
    settings: FootholdPlannerSettings = FootholdPlannerSettings(),
    polygon_weight: float = 2000.0,
    swing_tracking_weight: float = 200.0,
    model_type: str = "srbd",  # "srbd" | "comkino"
    motion_tracking: bool = False,  # add the motion-tracking cost
    torque_limits: bool = False,  # add the soft torque limits
    collision_avoidance: bool = False,  # add the knee collision-avoidance cost
    device="cuda",
) -> OptimalControlProblem:
    """The segmented-planes perceptive OCP: base tracking, the merged foot
    contact constraint, the plan's friction cone, soft swing tracking and
    the foothold polygon penalty."""
    from .interface import Q_DIAG, R_MAT, select_dynamics

    problem = OptimalControlProblem(
        dynamics=select_dynamics(model_type),
        cost_terms=(
            quadratic_cost(np.diag(Q_DIAG), R_MAT, device=device),
            soft_constraint(plan_friction_cone(), pen.relaxed_barrier(mu=0.1, delta=5.0)),
            soft_constraint(swing_normal_motion_error(settings.position_gain),
                            pen.quadratic(scale=2.0 * swing_tracking_weight)),
        ),
        final_cost_terms=(quadratic_final_cost(10.0 * np.diag(Q_DIAG[:24]), device=device),),
        equality_terms=(foot_contact_constraint(settings.position_gain),),
        state_cost_terms=(
            soft_constraint(foothold_polygon_penalty,
                            pen.squared_hinge(mu=2.0 * polygon_weight), with_input=False),
            soft_constraint(swing_motion_error,
                            pen.quadratic(scale=2.0 * swing_tracking_weight), with_input=False),
        ),
        nx=model.NX,
        nu=model.NU,
    )
    from .motion_tracking import (
        make_collision_avoidance_cost,
        make_torque_limits_soft,
        motion_tracking_cost,
    )

    if motion_tracking:
        problem = problem.add(cost_terms=(motion_tracking_cost(device=device),))
    if torque_limits:
        problem = problem.add(cost_terms=(make_torque_limits_soft(device=device),))
    if collision_avoidance:
        problem = problem.add(state_cost_terms=(make_collision_avoidance_cost(),))
    return problem


def plan_to_params(plan: FootholdPlan, params: dict, device=None) -> dict:
    """Merge a FootholdPlan into a params dict under the fh_* keys.  A host
    plan goes to ``device`` (default: the device of the params' target) in
    one copy: its eight arrays packed into one float32 buffer, the params
    entries views of it."""
    dev = params["target"].times.device if device is None else torch.device(device)
    host = [np.asarray(_host(a), np.float32) for a in plan]
    buf = torch.from_numpy(np.concatenate([a.reshape(-1) for a in host])).to(dev)
    views = torch.split(buf, [a.size for a in host])
    return dict(params, **{key: v.view(a.shape) for key, v, a in zip(PLAN_KEYS, views, host)})


def make_perceptive_params(
    grid,
    terrain: SegmentedPlanesTerrain,
    em: ElevationMap,
    x0,
    target,
    settings: FootholdPlannerSettings = FootholdPlannerSettings(),
    device="cuda",
) -> dict:
    """Base params of the segmented-planes perceptive problem: the legged
    params and a first FootholdPlan on this grid (the reference manager
    re-plans every tick)."""
    from .interface import make_params

    params = make_params(grid, target=target, device=device)
    plan = plan_footholds(terrain, em, np.asarray(grid.times), np.asarray(grid.modes), x0,
                          target, settings)
    return plan_to_params(plan, params, device)


class PerceptiveReferenceManager:
    """The gait-synchronized reference manager plus segmented-planes foothold
    planning: re-plans footholds and swing references on the tick's grid
    before every solve.  Duck-typed against ``mpc.Mpc``.

    The planner reads host mirrors of the terrain, the map and the target
    made once (the target's again only when a new one is set), and the
    current state, read from the device once a tick.  ``plan_timer`` times
    the plan and its copy to the device."""

    def __init__(
        self,
        terrain: SegmentedPlanesTerrain,
        em: ElevationMap,
        gait_schedule,
        target=None,
        settings: FootholdPlannerSettings = FootholdPlannerSettings(),
        device="cuda",
    ):
        from .interface import SwitchedModelReferenceManager

        self._inner = SwitchedModelReferenceManager(gait_schedule, target, device=device)
        self.terrain = terrain
        self.em = em
        self.settings = settings
        self._terrain_host = terrain.to_numpy()
        self._em_host = ElevationMap(*(_host(v) for v in em))
        self._target_host = (None, None)
        self._x0 = None
        self.plan_timer = RepeatedTimer()

    def set_target(self, target):
        self._inner.set_target(target)

    def set_mode_schedule(self, ms):
        self._inner.set_mode_schedule(ms)

    def set_gait(self, g):
        self._inner.set_gait(g)

    def pre_solver_run(self, t0, tf, x0):
        self._x0 = x0
        self._inner.pre_solver_run(t0, tf, x0)

    @property
    def target(self):
        return self._inner.target

    @property
    def mode_schedule(self):
        return self._inner.mode_schedule

    def _host_target(self):
        target = self.target
        if self._target_host[0] is not target:
            self._target_host = (target, type(target)(
                times=_host(target.times), states=_host(target.states),
                inputs=_host(target.inputs)))
        return self._target_host[1]

    def augment_params(self, grid, params: dict) -> dict:
        params = self._inner.augment_params(grid, params)
        self.plan_timer.start()
        plan = plan_footholds(
            self._terrain_host, self._em_host, np.asarray(grid.times), np.asarray(grid.modes),
            self._x0, self._host_target(), self.settings)
        params = plan_to_params(plan, params)
        self.plan_timer.stop()
        return params
