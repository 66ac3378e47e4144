"""Differentiable rigid-body kinematics of serial chains in PyTorch.

Counterpart of ``ocs2_tpu/models/kinematics.py`` (the reference's Pinocchio
layer for the queries the MPC stack needs: forward kinematics of
end-effector frames and their Jacobians).  A chain is a static description
(tuples of Python numbers); forward kinematics is batch-polymorphic,
``q [..., dof]`` -> ``[..., 3]`` / ``[..., 3, 3]``, and runs under
``torch.func`` transforms.  Joint angles are taken as width-1 slices, never
0-dim selects (see ``oc/problem.py``); the chain's constant vectors and
rotations are made once per device and dtype.

Revolute and prismatic joints about any axis with URDF-style origins (xyz
translation + rpy rotation); principal-axis joints take the closed-form
rotation.  ``models/urdf.py`` extracts chains from URDF trees.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional, Tuple

import numpy as np
import torch

Tensor = torch.Tensor

_AXES = {"x": 0, "y": 1, "z": 2}


@functools.lru_cache(maxsize=None)
def _const(values: tuple, shape: tuple, device: torch.device, dtype: torch.dtype) -> Tensor:
    """A constant of the chain on ``device``, made once."""
    return torch.tensor(values, dtype=dtype, device=device).reshape(shape)


def _like(values, shape, like: Tensor) -> Tensor:
    return _const(tuple(float(v) for v in values), shape, like.device, like.dtype)


def rot_axis(axis: int, angle: Tensor) -> Tensor:
    """Rotation about a principal axis (0 = x, 1 = y, 2 = z) by ``angle``
    [..., 1] -> [..., 3, 3]."""
    c, s = torch.cos(angle), torch.sin(angle)
    one, zero = torch.ones_like(c), torch.zeros_like(c)
    if axis == 0:
        rows = ([one, zero, zero], [zero, c, -s], [zero, s, c])
    elif axis == 1:
        rows = ([c, zero, s], [zero, one, zero], [-s, zero, c])
    else:
        rows = ([c, -s, zero], [s, c, zero], [zero, zero, one])
    return torch.stack([torch.cat(r, dim=-1) for r in rows], dim=-2)


def rot_any_axis(axis_vec, angle: Tensor) -> Tensor:
    """Rodrigues rotation about a constant unit axis (URDF <axis xyz>) by
    ``angle`` [..., 1] -> [..., 3, 3]."""
    kx, ky, kz = (float(v) for v in axis_vec)
    k = _like((0.0, -kz, ky, kz, 0.0, -kx, -ky, kx, 0.0), (3, 3), angle)
    eye = _like(np.eye(3).ravel(), (3, 3), angle)
    c, s = torch.cos(angle)[..., None], torch.sin(angle)[..., None]
    return eye + s * k + (1.0 - c) * (k @ k)


def rpy_matrix(rpy) -> np.ndarray:
    """URDF origin rpy (fixed-axis XYZ: R = Rz(y) Ry(p) Rx(r)), on the host."""
    r, p, y = float(rpy[0]), float(rpy[1]), float(rpy[2])
    cr, sr = math.cos(r), math.sin(r)
    cp, sp = math.cos(p), math.sin(p)
    cy, sy = math.cos(y), math.sin(y)
    rz = np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1.0]])
    ry = np.array([[cp, 0, sp], [0, 1.0, 0], [-sp, 0, cp]])
    rx = np.array([[1.0, 0, 0], [0, cr, -sr], [0, sr, cr]])
    return rz @ ry @ rx


def _axis_spec(axis) -> tuple:
    """Normalize an axis spec: 'x'|'y'|'z' or a 3-vector (possibly a negated
    principal axis).  Returns ("principal", idx, sign) or ("free", unit_vec)."""
    if isinstance(axis, str):
        return ("principal", _AXES[axis], 1.0)
    v = np.asarray(axis, np.float64)
    n = np.linalg.norm(v)
    v = v / (n if n > 0 else 1.0)
    for i in range(3):
        e = np.zeros(3)
        e[i] = 1.0
        if np.allclose(v, e, atol=1e-9):
            return ("principal", i, 1.0)
        if np.allclose(v, -e, atol=1e-9):
            return ("principal", i, -1.0)
    return ("free", tuple(v.tolist()))


def _rotate(rot: Tensor, vec: Tensor) -> Tensor:
    """rot [..., 3, 3] times vec [3] or [..., 3] -> [..., 3]."""
    return (rot @ vec.unsqueeze(-1)).squeeze(-1)


@dataclasses.dataclass(frozen=True)
class Joint:
    """One joint: a fixed origin (translation, then rotation), then motion
    about an axis (URDF joint semantics)."""

    offset: Tuple[float, float, float]  # parent->joint translation (parent frame)
    axis: object = "z"  # "x"|"y"|"z" or a 3-tuple axis vector
    kind: str = "revolute"  # revolute | prismatic | fixed
    # Fixed origin rotation (URDF rpy), row-major 9-tuple; None = identity.
    origin_rot: Optional[Tuple[float, ...]] = None
    name: str = ""

    def _motion_rot(self, angle: Tensor) -> Tensor:
        mode = _axis_spec(self.axis)
        if mode[0] == "principal":
            return rot_axis(mode[1], angle if mode[2] > 0 else -angle)
        return rot_any_axis(mode[1], angle)

    def _motion_step(self, disp: Tensor) -> Tensor:
        mode = _axis_spec(self.axis)
        if mode[0] == "principal":
            e = [0.0, 0.0, 0.0]
            e[mode[1]] = mode[2]
            return disp * _like(e, (3,), disp)
        return disp * _like(mode[1], (3,), disp)


@dataclasses.dataclass(frozen=True)
class Chain:
    """Serial kinematic chain ending at an end-effector frame."""

    joints: Tuple[Joint, ...]
    ee_offset: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    ee_rot: Optional[Tuple[float, ...]] = None  # row-major 9-tuple or None

    @property
    def num_dof(self) -> int:
        return sum(1 for j in self.joints if j.kind != "fixed")

    @staticmethod
    def _base(q: Tensor, base_rot, base_pos):
        lead = q.shape[:-1]
        rot = (_like(np.eye(3).ravel(), (3, 3), q).expand(lead + (3, 3))
               if base_rot is None else base_rot)
        pos = q.new_zeros(lead + (3,)) if base_pos is None else base_pos
        return rot, pos

    def _advance(self, joint: Joint, rot, pos, q, qi):
        pos = pos + _rotate(rot, _like(joint.offset, (3,), q))
        if joint.origin_rot is not None:
            rot = rot @ _like(joint.origin_rot, (3, 3), q)
        if joint.kind == "revolute":
            rot = rot @ joint._motion_rot(q[..., qi:qi + 1])
            qi += 1
        elif joint.kind == "prismatic":
            pos = pos + _rotate(rot, joint._motion_step(q[..., qi:qi + 1]))
            qi += 1
        return rot, pos, qi

    def _ee(self, rot, pos, q):
        pos = pos + _rotate(rot, _like(self.ee_offset, (3,), q))
        if self.ee_rot is not None:
            rot = rot @ _like(self.ee_rot, (3, 3), q)
        return rot, pos

    def forward(self, q: Tensor, base_rot=None, base_pos=None):
        """Forward kinematics of q [..., dof]: (ee position [..., 3], ee
        rotation [..., 3, 3]) in the base frame."""
        rot, pos = self._base(q, base_rot, base_pos)
        qi = 0
        for joint in self.joints:
            rot, pos, qi = self._advance(joint, rot, pos, q, qi)
        rot, pos = self._ee(rot, pos, q)
        return pos, rot

    def ee_position(self, q: Tensor, base_rot=None, base_pos=None) -> Tensor:
        return self.forward(q, base_rot, base_pos)[0]

    def frame_poses(self, q: Tensor, base_rot=None, base_pos=None):
        """Poses of every frame along the chain: ([..., F, 3, 3], [..., F, 3])
        with F = number of joints + 2 (the base frame first, the EE frame
        last), the query sphere-approximation collision models read."""
        rot, pos = self._base(q, base_rot, base_pos)
        rots, poss = [rot], [pos]
        qi = 0
        for joint in self.joints:
            rot, pos, qi = self._advance(joint, rot, pos, q, qi)
            rots.append(rot)
            poss.append(pos)
        rot, pos = self._ee(rot, pos, q)
        rots.append(rot)
        poss.append(pos)
        return torch.stack(rots, dim=-3), torch.stack(poss, dim=-2)

    def position_jacobian(self, q: Tensor) -> Tensor:
        """d ee_position / d q of one configuration q [dof] -> [3, dof], by
        forward-mode AD (``torch.func.jacfwd``)."""
        return torch.func.jacfwd(self.ee_position)(q)


def matrix_to_quaternion(r: Tensor) -> Tensor:
    """Rotation matrix [..., 3, 3] -> unit quaternion [..., 4] as [x, y, z, w].

    Shepperd's method evaluated on all four branches; the branch of the
    largest pivot (the first one on a tie, as ``jnp.argmax`` picks) is taken
    by a one-hot mask, which ``torch.func.vmap`` and ``jacfwd`` map.  Every
    square root's argument is clamped, so the unselected branches never give
    NaN derivatives."""
    m = lambda i, j: r[..., i, j:j + 1]  # noqa: E731  width-1 entries
    m00, m01, m02 = m(0, 0), m(0, 1), m(0, 2)
    m10, m11, m12 = m(1, 0), m(1, 1), m(1, 2)
    m20, m21, m22 = m(2, 0), m(2, 1), m(2, 2)
    tw = 1.0 + m00 + m11 + m22  # 4 w^2
    tx = 1.0 + m00 - m11 - m22  # 4 x^2
    ty = 1.0 - m00 + m11 - m22  # 4 y^2
    tz = 1.0 - m00 - m11 + m22  # 4 z^2

    def safe_sqrt(v):
        return torch.sqrt(torch.clamp(v, min=1e-12))

    sw, sx, sy, sz = safe_sqrt(tw), safe_sqrt(tx), safe_sqrt(ty), safe_sqrt(tz)
    # Candidate quaternions (x, y, z, w), one per pivot.
    q_w = torch.cat([(m21 - m12) / (2 * sw), (m02 - m20) / (2 * sw),
                     (m10 - m01) / (2 * sw), 0.5 * sw], dim=-1)
    q_x = torch.cat([0.5 * sx, (m01 + m10) / (2 * sx),
                     (m02 + m20) / (2 * sx), (m21 - m12) / (2 * sx)], dim=-1)
    q_y = torch.cat([(m01 + m10) / (2 * sy), 0.5 * sy,
                     (m12 + m21) / (2 * sy), (m02 - m20) / (2 * sy)], dim=-1)
    q_z = torch.cat([(m02 + m20) / (2 * sz), (m12 + m21) / (2 * sz),
                     0.5 * sz, (m10 - m01) / (2 * sz)], dim=-1)
    ts = torch.cat([tw, tx, ty, tz], dim=-1)
    qs = torch.stack([q_w, q_x, q_y, q_z], dim=-2)  # [..., 4 pivots, 4]
    pick = torch.argmax(ts, dim=-1, keepdim=True)  # the first maximum
    one_hot = (torch.arange(4, device=r.device) == pick).to(r.dtype)
    q = torch.sum(one_hot.unsqueeze(-1) * qs, dim=-2)
    return q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)


def quaternion_distance(q: Tensor, q_ref: Tensor) -> Tensor:
    """The reference's quaternionDistance (RotationTransforms.h:51):
    e = q.w * qRef.vec - qRef.w * q.vec + q.vec x qRef.vec, [..., 3]; zero
    iff the frames align, magnitude sin(theta / 2)."""
    q, q_ref = torch.broadcast_tensors(q, q_ref)
    qv, qw = q[..., :3], q[..., 3:4]
    rv, rw = q_ref[..., :3], q_ref[..., 3:4]
    return qw * rv - rw * qv + torch.linalg.cross(qv, rv, dim=-1)


def rotation_error(r: Tensor, r_des: Tensor) -> Tensor:
    """Orientation error between rotation matrices through the reference's
    quaternion distance, sign-fixed to the hemisphere nearest the target so
    the error is continuous around the identity."""
    q = matrix_to_quaternion(r)
    q_ref = matrix_to_quaternion(r_des)
    q = torch.where(torch.sum(q * q_ref, dim=-1, keepdim=True) < 0.0, -q, q)
    return quaternion_distance(q, q_ref)
