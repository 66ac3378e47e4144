"""Perceptive locomotion: the elevation-map terrain model and terrain-aware
foot constraints.

Counterpart of ``ocs2_tpu/models/legged_robot/terrain.py``.  The terrain is a
dense elevation grid on the device; local planes come from a least-squares
fit over a window around the query (a closed-form 3x3 solve per query,
``ops/smallmat``).  Every query is batch-polymorphic (xy ``[..., 2]``) and
works under ``torch.func`` transforms: the fit's window is gathered from the
flattened grid at the linear indices of ``c + arange(window)``, which maps
where a slice with a tensor start would not.

The constraint closures capture the map's tensors; nothing of the map is
copied per call.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ...core import penalties as pen
from ...oc.problem import (
    OptimalControlProblem,
    quadratic_cost,
    quadratic_final_cost,
    soft_constraint,
)
from ...ops.smallmat import solve_psd_small
from ..perceptive import SignedDistanceField, bilinear_interpolate, signed_distance_field
from . import constraints as con
from . import model
from .gait import contact_flags
from .model import contact_forces, foot_positions_world

Tensor = torch.Tensor


class TerrainPlane(NamedTuple):
    """Local terrain plane: a point on it and its unit upward normal, world
    frame ([..., 3] each)."""

    point: Tensor
    normal: Tensor


class ElevationMap(NamedTuple):
    """Dense elevation grid: heights [H, W], the world xy of cell (0, 0) and
    a square cell resolution (0-dim), all on one device."""

    heights: Tensor
    origin_xy: Tensor  # [2]
    resolution: Tensor  # []

    @staticmethod
    def create(heights, origin_xy=(0.0, 0.0), resolution=0.05, device="cuda"):
        f32 = lambda v: torch.as_tensor(np.asarray(v, np.float32), device=device)  # noqa: E731
        return ElevationMap(heights=f32(heights), origin_xy=f32(origin_xy),
                            resolution=f32(resolution))

    @staticmethod
    def flat(height=0.0, extent=4.0, resolution=0.05, device="cuda"):
        n = int(extent / resolution)
        return ElevationMap.create(
            np.full((n, n), height, np.float32), origin_xy=(-extent / 2, -extent / 2),
            resolution=resolution, device=device,
        )

    def height_at(self, xy: Tensor) -> Tensor:
        """Bilinear terrain height at world xy [..., 2] -> [...]."""
        return bilinear_interpolate(self.heights, (xy - self.origin_xy) / self.resolution)

    def plane_at(self, xy: Tensor, window: int = 5) -> TerrainPlane:
        """Local plane by a least-squares fit of z = a x + b y + c over the
        window x window patch of cells around xy [..., 2]."""
        res = self.resolution
        h, w = self.heights.shape
        dev = xy.device
        idx = (xy - self.origin_xy) / res
        c = torch.floor(idx).to(torch.int64) - window // 2
        c = torch.minimum(torch.clamp(c, min=0),
                          torch.tensor([h - window, w - window], device=dev))
        ar = torch.arange(window, device=dev)
        patch = self.heights.reshape(-1)[
            (c[..., 0:1, None] + ar[:, None]) * w + c[..., 1:2, None] + ar[None, :]]
        # Cell-center world coordinates of the patch.
        arf = torch.arange(window, dtype=torch.float32, device=dev)
        ii = (c[..., 0:1].to(torch.float32) + arf) * res + self.origin_xy[0:1]
        jj = (c[..., 1:2].to(torch.float32) + arf) * res + self.origin_xy[1:2]
        shape = patch.shape[:-2] + (window, window)
        xs = ii[..., :, None].expand(shape).reshape(shape[:-2] + (-1,))
        ys = jj[..., None, :].expand(shape).reshape(shape[:-2] + (-1,))
        zs = patch.reshape(shape[:-2] + (-1,))
        # 3x3 SPD normal equations, closed form.  Their sums over the window
        # are taken in float64 and rounded to float32: in world coordinates
        # (x, y up to metres, a window of 0.2 m) they are ill-conditioned, and
        # a float32 sum in the order torch takes lands farther from the exact
        # fit than the JAX package's float32 does; rounded float64 sums land
        # nearer (tests/test_torch_terrain.py).
        basis = torch.stack([xs, ys, torch.ones_like(xs)], dim=-2).double()  # [..., 3, M]
        ata = (basis @ basis.transpose(-1, -2)).float() + 1e-6 * torch.eye(3, device=dev)
        atz = (basis @ zs.double()[..., None]).float()  # [..., 3, 1]
        coef = solve_psd_small(ata, atz)[..., 0]
        a, b, cc = coef[..., 0:1], coef[..., 1:2], coef[..., 2:3]
        normal = torch.cat([-a, -b, torch.ones_like(a)], dim=-1)
        normal = normal / torch.linalg.norm(normal, dim=-1, keepdim=True)
        z_fit = a * xy[..., 0:1] + b * xy[..., 1:2] + cc
        return TerrainPlane(point=torch.cat([xy[..., 0:1], xy[..., 1:2], z_fit], dim=-1),
                            normal=normal)

    def sdf(self, z_min: float, z_max: float,
            z_resolution: Optional[float] = None) -> SignedDistanceField:
        """3-D SDF of the solid below the surface: occupancy = cells under
        the elevation, then an exact Euclidean distance transform."""
        dev = self.heights.device
        zres = self.resolution if z_resolution is None else torch.tensor(
            z_resolution, dtype=torch.float32, device=dev)
        nz = int(np.ceil((z_max - z_min) / float(zres)))
        z_centers = z_min + (torch.arange(nz, device=dev) + 0.5) * zres
        occ = self.heights[:, :, None] > z_centers[None, None, :]
        origin = torch.cat([self.origin_xy, torch.tensor(
            [z_min + 0.5 * float(zres)], dtype=torch.float32, device=dev)])
        return signed_distance_field(occ, origin, float(self.resolution))


# -- terrain-aware legged constraints ----------------------------------------


def stance_on_terrain(terrain: ElevationMap):
    """[..., 4] state equality: stance feet lie on the terrain surface,
    c * (z_foot - h(xy_foot)) = 0."""

    def g(t, x, p):
        del t
        c = contact_flags(p["mode"])
        feet = foot_positions_world(x)
        return c * (feet[..., 2] - terrain.height_at(feet[..., :2]))

    return g


def swing_clearance_over_terrain(terrain: ElevationMap, swing_tracking: bool = True):
    """[..., 4] state term: swing feet track the planned height profile
    relative to the terrain under the foot, (1-c) * ((z - h(xy)) - z_ref)."""

    def g(t, x, p):
        del t
        c = contact_flags(p["mode"])
        feet = foot_positions_world(x)
        h = terrain.height_at(feet[..., :2])
        z_ref = p["swing_z"][p["node"]] if swing_tracking else 0.0
        return (1.0 - c) * (feet[..., 2] - h - z_ref)

    return g


def terrain_friction_cone(terrain: ElevationMap, mu: float = 0.7, cone_eps: float = 5.0):
    """[..., 4] inequality: friction cone about the local terrain normal of
    the plane fit under each foot."""

    def h(t, x, u, p):
        del t
        c = contact_flags(p["mode"])
        feet = foot_positions_world(x)
        f = contact_forces(u)
        n = terrain.plane_at(feet[..., :2]).normal  # [..., 4, 3]
        fn = torch.sum(n * f, dim=-1, keepdim=True)
        ft = f - fn * n
        cone = mu * fn[..., 0] - torch.sqrt(torch.sum(ft * ft, dim=-1) + cone_eps)
        return c * cone + (1.0 - c) * 1.0

    return h


def make_perceptive_problem(
    terrain: ElevationMap,
    friction_mu: float = 0.7,
    stance_weight: float = 4000.0,
    swing_weight: float = 100.0,
    device="cuda",
) -> OptimalControlProblem:
    """The elevation-map perceptive legged OCP: the flagship problem's base
    tracking and merged foot constraint, with the terrain-aware stance,
    swing and friction-cone terms (the map is queried inside the solver)."""
    from .interface import Q_DIAG, R_MAT

    return OptimalControlProblem(
        dynamics=model.dynamics,
        cost_terms=(
            quadratic_cost(np.diag(Q_DIAG), R_MAT, device=device),
            con.make_friction_cone_soft(),  # flat-cone fallback kept active
            soft_constraint(
                terrain_friction_cone(terrain, friction_mu),
                pen.relaxed_barrier(mu=1e-2, delta=1.0),
            ),
        ),
        final_cost_terms=(quadratic_final_cost(10.0 * np.diag(Q_DIAG[:24]), device=device),),
        equality_terms=(con.foot_constraint,),
        state_cost_terms=(
            soft_constraint(stance_on_terrain(terrain),
                            pen.quadratic(scale=2.0 * stance_weight), with_input=False),
            soft_constraint(swing_clearance_over_terrain(terrain),
                            pen.quadratic(scale=2.0 * swing_weight), with_input=False),
        ),
        nx=24,
        nu=24,
    )
