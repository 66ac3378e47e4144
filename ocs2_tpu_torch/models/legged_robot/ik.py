"""Analytic per-leg inverse kinematics for the quadruped.

Counterpart of ``ocs2_tpu/models/legged_robot/ik.py``: the leg chain of
``model.foot_position_base`` (hip offset -> HAA roll about x -> lateral
offset -> HFE/KFE pitch about y) solved in closed form, a roll solve in the
hip's y-z plane followed by a planar 2R solve in the sagittal plane.  The
knee convention (front knees backward, hind knees forward) matches
``model.DEFAULT_JOINTS``.  Batch-polymorphic: foot positions ``[..., 3]``
per leg, ``[..., 4, 3]`` for the four legs at once.
"""
from __future__ import annotations

import functools

import torch

from . import model
from .model import HIP_LATERAL, SHANK_LENGTH, THIGH_LENGTH

Tensor = torch.Tensor

# Knee bend sign per leg (LF RF LH RH): KFE < 0 in front, > 0 behind.
KNEE_SIGN = (-1.0, -1.0, 1.0, 1.0)


def _wrap(a: Tensor) -> Tensor:
    return torch.atan2(torch.sin(a), torch.cos(a))


def _ik(rel: Tensor, lateral: Tensor, knee: Tensor) -> Tensor:
    """(HAA, HFE, KFE) [..., 3] reaching rel (foot minus hip mount, base frame)
    for a leg with signed lateral offset and knee sign (width-1 tensors)."""
    x, y, z = rel[..., 0:1], rel[..., 1:2], rel[..., 2:3]
    # HAA roll: rotate (y, z) so that the lateral offset is side * HIP_LATERAL.
    zp_sq = torch.clamp(y * y + z * z - HIP_LATERAL ** 2, min=1e-10)
    z_p = -torch.sqrt(zp_sq)  # the leg extends downward
    haa = _wrap(torch.atan2(z, y) - torch.atan2(z_p, lateral))
    # Planar 2R in the sagittal plane: reach (x, z_p), clamped to the workspace.
    reach_max = (THIGH_LENGTH + SHANK_LENGTH) ** 2
    reach_min = (THIGH_LENGTH - SHANK_LENGTH) ** 2
    d_sq = torch.clamp(x * x + zp_sq, min=reach_min + 1e-9, max=reach_max - 1e-9)
    cos_kfe = (d_sq - THIGH_LENGTH ** 2 - SHANK_LENGTH ** 2) / (2.0 * THIGH_LENGTH * SHANK_LENGTH)
    kfe = knee * torch.arccos(torch.clamp(cos_kfe, -1.0, 1.0))
    a = THIGH_LENGTH + SHANK_LENGTH * torch.cos(kfe)
    b = SHANK_LENGTH * torch.sin(kfe)
    hfe = _wrap(torch.atan2(-x, -z_p) - torch.atan2(b, a))
    return torch.cat([haa, hfe, kfe], dim=-1)


def _leg_constants(like: Tensor):
    """Hip mounts [4, 3], signed lateral offsets [4, 1] and knee signs [4, 1]."""
    k = model._constants(like.device, like.dtype)
    return k.hip_offsets, k.lateral, _knee_signs(like.device, like.dtype)


@functools.lru_cache(maxsize=None)
def _knee_signs(device: torch.device, dtype: torch.dtype) -> Tensor:
    return torch.tensor(KNEE_SIGN, dtype=dtype, device=device)[:, None]


def leg_ik(leg: int, p_foot_base: Tensor) -> Tensor:
    """(HAA, HFE, KFE) [..., 3] reaching p_foot_base [..., 3] (the foot in the
    base frame).  Targets outside the workspace are clamped to the reachable
    shell (the limb saturates at full extension)."""
    hip, lateral, knee = _leg_constants(p_foot_base)
    return _ik(p_foot_base - hip[leg], lateral[leg], knee[leg])


def joints_from_foot_positions(feet_base: Tensor) -> Tensor:
    """[..., 12] joint vector from [..., 4, 3] base-frame foot targets."""
    hip, lateral, knee = _leg_constants(feet_base)
    return _ik(feet_base - hip, lateral, knee).flatten(-2, -1)


def joints_from_foot_positions_world(x_base_pose: Tensor, feet_world: Tensor) -> Tensor:
    """IK from world-frame foot targets [..., 4, 3] given the base pose
    [..., 6] = [p_base (3), euler zyx (3)]."""
    p_base, euler = x_base_pose[..., 0:3], x_base_pose[..., 3:6]
    r_wb = model.euler_zyx_rotation(euler)
    feet_base = (feet_world - p_base[..., None, :]) @ r_wb  # R' (p_f - p_base)
    return joints_from_foot_positions(feet_base)

