"""Legged-robot constraint terms: friction cone, contact-complementarity
foot constraint, swing vertical-velocity tracking.

Counterpart of ``ocs2_tpu/models/legged_robot/constraints.py``.  Stance/swing
selection is done by blending with the contact flag inside a fixed-size
constraint vector, so every node has the same constraint shape:

    foot_constraint (3/leg):  c * v_foot + (1-c) * f_foot = 0
        == zero-velocity when in contact, zero-force in swing — and its input
        Jacobian stays full-row-rank either way, so the QR projection path
        (ops/projection.py) handles it exactly.
    swing normal velocity (1/leg): (1-c) * (v_z - vz_ref) = 0, handled by AL
        (its row vanishes for stance legs — rank-safe only outside the
        projection path).
    friction cone (1/leg): c * (mu*fz - |f_t|) >= 0, inactive rows are
        lifted to a satisfied constant.

All terms are batch-polymorphic: ``p["mode"]`` and ``p["node"]`` are one
node's values or tensors over the nodes of the trajectory's last batch dim.
"""
from __future__ import annotations

import torch

from ...core import penalties as pen
from ...oc.problem import soft_constraint
from .gait import contact_flags
from .model import contact_forces, foot_positions_world, foot_velocities_world

FRICTION_MU = 0.7  # friction coefficient
CONE_EPS = 5.0  # regularization inside the norm


def friction_cone(t, x, u, p):
    """[..., 4] inequality: stance feet inside the cone (>= 0)."""
    del t, x
    c = contact_flags(p["mode"])
    f = contact_forces(u)
    ft = torch.sqrt(f[..., 0] ** 2 + f[..., 1] ** 2 + CONE_EPS)
    cone = FRICTION_MU * f[..., 2] - ft
    # Swing rows: constant satisfied value (keeps shape static, zero grad).
    return c * cone + (1.0 - c) * 1.0


def fz_bounds(t, x, u, p):
    """[..., 8] inequality: 0 <= fz <= fz_max for stance feet."""
    del t, x
    c = contact_flags(p["mode"])
    fz = contact_forces(u)[..., 2]
    fz_max = p.get("fz_max", 500.0)
    lower = c * fz + (1.0 - c) * 1.0
    upper = c * (fz_max - fz) + (1.0 - c) * 1.0
    return torch.cat([lower, upper], dim=-1)


def foot_constraint(t, x, u, p):
    """[..., 12] equality: c*v_foot + (1-c)*f_foot = 0 (zero velocity in
    stance / zero force in swing, merged for rank-safe projection)."""
    del t
    c = contact_flags(p["mode"]).unsqueeze(-1)
    v = foot_velocities_world(x, u)
    f = contact_forces(u)
    out = c * v + (1.0 - c) * f
    return out.reshape(out.shape[:-2] + (12,))


def swing_normal_velocity(t, x, u, p):
    """[..., 4] equality: swing feet track the planned vertical velocity
    (gathers the per-node reference planned on the host)."""
    del t
    c = contact_flags(p["mode"])
    v = foot_velocities_world(x, u)
    vz_ref = p["swing_vz"][p["node"]]
    return (1.0 - c) * (v[..., 2] - vz_ref)


def _swing_height_error(t, x, p):
    del t
    c = contact_flags(p["mode"])
    feet = foot_positions_world(x)
    z_ref = p["swing_z"][p["node"]]
    return (1.0 - c) * (feet[..., 2] - z_ref)


# Soft cost pulling swing feet toward the planned height profile, as a
# structured Gauss-Newton term: 20*sum(err^2) == 0.5*40*err^2 penalty
# (stabilizes the swing shape).
swing_height_tracking = soft_constraint(
    _swing_height_error, pen.quadratic(scale=40.0), with_input=False
)


def make_friction_cone_soft(mu_barrier: float = 0.1, delta: float = 5.0):
    """Relaxed-barrier soft friction cone."""
    return soft_constraint(
        friction_cone, pen.relaxed_barrier(mu=mu_barrier, delta=delta)
    )
