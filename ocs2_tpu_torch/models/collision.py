"""Self-collision avoidance by sphere approximation.

Counterpart of ``ocs2_tpu/models/collision.py`` (the reference's sphere
decomposition of link geometry, PinocchioSphereInterface /
SphereApproximation, and the distance-based SelfCollisionConstraint.h:44).
A ``SphereModel`` attaches spheres to kinematic frames; given frame poses the
pairwise signed distances are

    d_ij = ||c_i - c_j|| - (r_i + r_j)   >= min_distance.

The model's index and geometry tensors live on the solver's device, and the
queries are batch-polymorphic over the poses' leading dims.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Sequence, Tuple

import numpy as np
import torch

Tensor = torch.Tensor


class SphereModel(NamedTuple):
    """Sphere decomposition attached to frames.

    frame_idx: [S] int64 - owning frame of each sphere.
    offsets:   [S, 3]    - sphere center in the frame.
    radii:     [S]
    pairs:     [P, 2] int64 - sphere index pairs to check (pairs between
               different links; same-link pairs are excluded, like the
               reference's geometry collision-pair list).
    """

    frame_idx: Tensor
    offsets: Tensor
    radii: Tensor
    pairs: Tensor

    @staticmethod
    def create(spheres: Sequence[Tuple[int, Sequence[float], float]],
               pair_frames: Sequence[Tuple[int, int]], device="cuda") -> "SphereModel":
        """spheres: (frame, offset, radius) each; pair_frames: frame pairs to
        monitor (expanded to all sphere pairs across those frames)."""
        frame_idx = np.asarray([s[0] for s in spheres], np.int64)
        pairs = [
            (a, b)
            for fa, fb in pair_frames
            for a in np.nonzero(frame_idx == fa)[0]
            for b in np.nonzero(frame_idx == fb)[0]
        ]
        return SphereModel(
            frame_idx=torch.as_tensor(frame_idx, device=device),
            offsets=torch.as_tensor(
                np.asarray([s[1] for s in spheres], np.float32), device=device),
            radii=torch.as_tensor(np.asarray([s[2] for s in spheres], np.float32), device=device),
            pairs=torch.as_tensor(np.asarray(pairs, np.int64).reshape(-1, 2), device=device),
        )

    def centers(self, frame_rots: Tensor, frame_pos: Tensor) -> Tensor:
        """World sphere centers from frame poses ([..., F, 3, 3], [..., F, 3])
        -> [..., S, 3]."""
        rot = frame_rots.index_select(-3, self.frame_idx)
        pos = frame_pos.index_select(-2, self.frame_idx)
        return pos + (rot @ self.offsets.unsqueeze(-1)).squeeze(-1)

    def distances(self, frame_rots: Tensor, frame_pos: Tensor) -> Tensor:
        """Pairwise signed distances [..., P] (SelfCollision::getValue)."""
        c = self.centers(frame_rots, frame_pos)
        first, second = self.pairs[:, 0], self.pairs[:, 1]
        gap = c.index_select(-2, first) - c.index_select(-2, second)
        # Smooth-safe norm: keeps gradients finite at coincident centers.
        dist = torch.sqrt(torch.sum(gap * gap, dim=-1) + 1e-12)
        return dist - (self.radii.index_select(0, first) + self.radii.index_select(0, second))


def self_collision_constraint(
    model: SphereModel,
    forward_kinematics: Callable[[Tensor], Tuple[Tensor, Tensor]],
    min_distance: float = 0.0,
):
    """State inequality term h(t, x, p) = d(x) - min_distance >= 0, [..., P]
    (the reference's SelfCollisionConstraint.h:44).  ``forward_kinematics(x)``
    returns frame poses ([..., F, 3, 3], [..., F, 3]), e.g. a
    ``kinematics.Chain``'s ``frame_poses``."""

    def constraint(t, x, p):
        rots, pos = forward_kinematics(x)
        return model.distances(rots, pos) - min_distance

    return constraint
