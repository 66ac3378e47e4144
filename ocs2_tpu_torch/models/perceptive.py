"""Perceptive constraints: signed-distance fields and terrain grids.

Counterpart of ``ocs2_tpu/models/perceptive.py``: bilinear / trilinear grid
interpolation, the exact Euclidean distance transform, the signed-distance
field built from an occupancy grid, and the end-effector distance
constraint.

Queries are batch-polymorphic (a fractional index ``[..., 3]`` or a point
``[..., 3]``) and work under ``torch.func`` transforms: the integer cell
index is taken from ``floor`` and carries no tangent, so derivatives flow
through the fractional part only.  Arithmetic uses width-1 columns, not
0-dim selects (see the note on Python scalars in ``oc/problem.py``).
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

Tensor = torch.Tensor


class SignedDistanceField(NamedTuple):
    """Dense SDF grid.

    values: [NX, NY, NZ] signed distances (positive = free space).
    origin: [3] world position of the center of cell (0, 0, 0).
    resolution: [] cell size (cubic cells).
    """

    values: Tensor
    origin: Tensor
    resolution: Tensor

    def query(self, point: Tensor) -> Tensor:
        """Trilinearly interpolated distance at world points [..., 3] ->
        [...] (clamped to the grid's boundary)."""
        return trilinear_interpolate(self.values, (point - self.origin) / self.resolution)

    def gradient(self, point: Tensor) -> Tensor:
        """d query / d point at world points [..., 3] -> [..., 3]."""
        g = torch.func.grad(self.query)
        return torch.func.vmap(g)(point.reshape(-1, 3)).reshape(point.shape)


def _cell_index(shape, idx: Tensor):
    """Clamp a fractional index [..., d] into the grid as the JAX package
    does (float32 bound ``shape - 1 - 1e-6``), and split it into the lower
    corner i0, the upper corner i1 (int64, no tangent) and the fraction.
    Cells are gathered from the flattened grid by one linear index, the form
    of gather that ``torch.func.vmap`` maps."""
    shape_f = torch.tensor(shape, dtype=idx.dtype, device=idx.device)
    idx = torch.minimum(torch.maximum(idx, torch.zeros_like(shape_f)), shape_f - 1.0 - 1e-6)
    i0 = torch.floor(idx).to(torch.int64)
    frac = idx - i0.to(idx.dtype)
    i1 = torch.minimum(i0 + 1, torch.tensor(shape, device=idx.device) - 1)
    return i0, i1, frac


def trilinear_interpolate(grid: Tensor, idx: Tensor) -> Tensor:
    """Trilinear interpolation of a [NX, NY, NZ] grid at fractional indices
    [..., 3] -> [...]."""
    i0, i1, frac = _cell_index(grid.shape, idx)
    _, ny, nz = grid.shape
    flat = grid.reshape(-1)

    def at(a, b, c):
        return flat[(a[..., 0:1] * ny + b[..., 1:2]) * nz + c[..., 2:3]]

    fx, fy, fz = frac[..., 0:1], frac[..., 1:2], frac[..., 2:3]
    c00 = at(i0, i0, i0) * (1 - fx) + at(i1, i0, i0) * fx
    c10 = at(i0, i1, i0) * (1 - fx) + at(i1, i1, i0) * fx
    c01 = at(i0, i0, i1) * (1 - fx) + at(i1, i0, i1) * fx
    c11 = at(i0, i1, i1) * (1 - fx) + at(i1, i1, i1) * fx
    c0 = c00 * (1 - fy) + c10 * fy
    c1 = c01 * (1 - fy) + c11 * fy
    return (c0 * (1 - fz) + c1 * fz).squeeze(-1)


def bilinear_interpolate(grid: Tensor, idx: Tensor) -> Tensor:
    """Bilinear interpolation of a [NX, NY] grid at fractional indices
    [..., 2] -> [...] (elevation maps)."""
    i0, i1, frac = _cell_index(grid.shape, idx)
    ny = grid.shape[1]
    flat = grid.reshape(-1)

    def at(a, b):
        return flat[a[..., 0:1] * ny + b[..., 1:2]]

    fx, fy = frac[..., 0:1], frac[..., 1:2]
    out = (
        at(i0, i0) * (1 - fx) * (1 - fy)
        + at(i1, i0) * fx * (1 - fy)
        + at(i0, i1) * (1 - fx) * fy
        + at(i1, i1) * fx * fy
    )
    return out.squeeze(-1)


def _edt_1d_sq(f_sq: Tensor) -> Tensor:
    """Exact 1-D squared Euclidean distance transform along axis 0,
    out[p] = min_q ((p - q)^2 + f_sq[q]) (Felzenszwalb & Huttenlocher's
    separable form), as one dense [L, L, M] broadcast and min."""
    length = f_sq.shape[0]
    i = torch.arange(length, dtype=f_sq.dtype, device=f_sq.device)
    d2 = torch.square(i[:, None] - i[None, :])  # [L, L]
    flat = f_sq.reshape(length, -1)  # [L, M]
    out = torch.amin(d2[:, :, None] + flat[None, :, :], dim=1)
    return out.reshape(f_sq.shape)


def distance_transform(occupancy: Tensor, resolution: float) -> Tensor:
    """Exact Euclidean distance from every cell of a boolean occupancy grid
    to the nearest occupied cell, in world units (separable per-axis
    squared transforms)."""
    big = torch.tensor(1e12, dtype=torch.float32, device=occupancy.device)
    d_sq = torch.where(occupancy, torch.zeros_like(big), big)
    for axis in range(d_sq.ndim):
        d_sq = torch.movedim(_edt_1d_sq(torch.movedim(d_sq, axis, 0)), 0, axis)
    return torch.sqrt(d_sq) * resolution


def signed_distance_field(occupancy: Tensor, origin, resolution: float) -> SignedDistanceField:
    """SDF of an occupancy grid: positive outside obstacles, negative inside."""
    outside = distance_transform(occupancy, resolution)
    inside = distance_transform(~occupancy, resolution)
    dev = occupancy.device
    return SignedDistanceField(
        values=torch.where(occupancy, -inside, outside),
        origin=torch.as_tensor(origin, dtype=torch.float32, device=dev),
        resolution=torch.tensor(resolution, dtype=torch.float32, device=dev),
    )


def ee_distance_constraint(
    sdf: SignedDistanceField,
    ee_positions: Callable[[Tensor], Tensor],  # x [..., nx] -> [..., E, 3] world points
    clearance: float = 0.0,
):
    """State inequality h(t, x, p) = sdf(ee_i(x)) - clearance >= 0 per end
    effector, [..., E].  The SDF is read from ``p["sdf"]`` when present, so a
    perception update changes a parameter, not the problem."""

    def constraint(t, x, p):
        field = p.get("sdf", sdf) if isinstance(p, dict) else sdf
        return field.query(ee_positions(x)) - clearance

    return constraint
