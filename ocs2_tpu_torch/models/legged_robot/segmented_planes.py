"""Segmented-planes terrain model: convex planar decomposition of the
elevation map, foothold-to-segment projection, and the tangential foothold
constraint.

Counterpart of ``ocs2_tpu/models/legged_robot/segmented_planes.py``.  The
decomposition runs on the host (numpy and scipy, this package's own copy of
the JAX package's code) once per elevation-map update and yields fixed-shape
arrays: K segments with padded V-vertex convex boundaries.  The queries
(polygon projection, closest segment, tangential rows) are tensor ops over
those arrays, batch-polymorphic in the query point.  Padding is inert:
invalid segments score +BIG, padded vertices repeat the last real one.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from .terrain import ElevationMap, TerrainPlane

Tensor = torch.Tensor

_BIG = 1e6


class SegmentedPlanesTerrain(NamedTuple):
    """K fitted planes with convex boundary polygons (fixed shapes).

    plane_point:  [K, 3] a point on each plane (world).
    plane_normal: [K, 3] unit upward normal (world).
    tangent1/2:   [K, 3] plane-frame tangent basis (world).
    boundary:     [K, V, 2] convex polygon vertices CCW in the plane's
                  tangent frame, padded by repeating the last vertex.
    num_vertices: [K] int32 true vertex counts.
    valid:        [K] bool, segment slot in use.

    Leaves are tensors on a device, or numpy arrays for the host mirror the
    foothold planner reads (``to_numpy``).
    """

    plane_point: Tensor
    plane_normal: Tensor
    tangent1: Tensor
    tangent2: Tensor
    boundary: Tensor
    num_vertices: Tensor
    valid: Tensor

    @property
    def num_segments(self) -> int:
        return self.plane_point.shape[0]

    def plane(self, k) -> TerrainPlane:
        return TerrainPlane(point=self.plane_point[k], normal=self.plane_normal[k])

    def to(self, device) -> "SegmentedPlanesTerrain":
        """The same arrays as tensors on ``device``."""
        return SegmentedPlanesTerrain(*(torch.as_tensor(v).to(device) for v in self))

    def to_numpy(self) -> "SegmentedPlanesTerrain":
        """Host mirror (numpy leaves); one copy per leaf."""
        return SegmentedPlanesTerrain(*(
            v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
            for v in self))


# ---------------------------------------------------------------------------
# Host-side decomposition (per elevation-map update).
# ---------------------------------------------------------------------------


def _plane_basis_np(normal: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Orthonormal tangents for a unit normal (world frame)."""
    ref = np.array([1.0, 0.0, 0.0]) if abs(normal[0]) < 0.9 else np.array([0.0, 1.0, 0.0])
    t1 = np.cross(normal, ref)
    t1 /= np.linalg.norm(t1)
    t2 = np.cross(normal, t1)
    return t1, t2


def _fit_plane_np(pts: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """LS plane through [M, 3] points -> (point, unit upward normal)."""
    c = pts.mean(axis=0)
    q = pts - c
    # Smallest singular vector of the centered cloud = normal.
    _, _, vt = np.linalg.svd(q, full_matrices=False)
    n = vt[-1]
    if n[2] < 0:
        n = -n
    return c, n / np.linalg.norm(n)


def _cross2(a: np.ndarray, b: np.ndarray) -> float:
    """2D scalar cross product."""
    return a[0] * b[1] - a[1] * b[0]


def _convex_hull_2d(pts: np.ndarray) -> np.ndarray:
    """Andrew monotone chain, CCW [M, 2] -> hull [H, 2]."""
    pts = np.unique(np.round(pts, 9), axis=0)
    if len(pts) <= 2:
        return pts
    pts = pts[np.lexsort((pts[:, 1], pts[:, 0]))]

    def half(points):
        out = []
        for p in points:
            while len(out) >= 2 and _cross2(out[-1] - out[-2], p - out[-2]) <= 0:
                out.pop()
            out.append(p)
        return out

    lower = half(pts)
    upper = half(pts[::-1])
    return np.asarray(lower[:-1] + upper[:-1])


def _simplify_hull(hull: np.ndarray, max_vertices: int) -> np.ndarray:
    """Reduce a CCW hull to <= max_vertices by dropping, one at a time, the
    vertex whose removal loses the least area (stays convex and inscribed)."""
    hull = hull.copy()
    while len(hull) > max_vertices:
        n = len(hull)
        losses = np.empty(n)
        for i in range(n):
            a, b, c = hull[i - 1], hull[i], hull[(i + 1) % n]
            losses[i] = abs(_cross2(b - a, c - a)) * 0.5
        hull = np.delete(hull, int(np.argmin(losses)), axis=0)
    return hull


def _shrink_polygon(hull: np.ndarray, margin: float) -> np.ndarray:
    """Pull each vertex toward the centroid by ``margin``."""
    if margin <= 0.0 or len(hull) < 3:
        return hull
    c = hull.mean(axis=0)
    d = hull - c
    norms = np.maximum(np.linalg.norm(d, axis=1, keepdims=True), 1e-9)
    return c + d * np.maximum(1.0 - margin / norms, 0.1)


def decompose_planes(
    em: ElevationMap,
    max_segments: int = 16,
    max_vertices: int = 12,
    max_slope_deg: float = 35.0,
    inlier_tol: float = 0.02,
    min_cells: int = 9,
    margin: float = 0.0,
    device="cuda",
) -> SegmentedPlanesTerrain:
    """Convex planar decomposition of the elevation map (host, numpy; run
    once per map update).

    Cell normals by central differences -> slope and roughness gate ->
    connected components (4-neighbourhood) -> per-component LS plane fit
    with one inlier re-fit -> convex hull of the inlier cells in the plane's
    tangent frame, simplified to <= max_vertices.  Components are ranked by
    area; the largest max_segments fill the fixed slots.  The result's
    tensors go to ``device``."""
    from scipy import ndimage

    h = np.asarray(em.heights.detach().cpu().numpy() if isinstance(em.heights, torch.Tensor)
                   else em.heights, np.float64)
    res = float(em.resolution)
    origin = np.asarray([float(v) for v in em.origin_xy], np.float64)
    H, W = h.shape

    # Cell-centered gradients -> normals; edge cells use one-sided diffs.
    gx, gy = np.gradient(h, res)
    slope_ok = np.hypot(gx, gy) < np.tan(np.deg2rad(max_slope_deg))
    # Roughness gate: local curvature (Laplacian) must be small.
    lap = np.abs(ndimage.laplace(h)) / res
    rough_ok = lap < 4.0 * inlier_tol / res
    mask = slope_ok & rough_ok

    labels, n_comp = ndimage.label(mask, structure=np.array([[0, 1, 0], [1, 1, 1], [0, 1, 0]]))
    # World xy of cell centers: heights[i, j] lives at origin + (i, j)*res.
    ii, jj = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    xs = origin[0] + ii * res
    ys = origin[1] + jj * res

    comps = []
    for c in range(1, n_comp + 1):
        sel = labels == c
        if sel.sum() < min_cells:
            continue
        pts = np.stack([xs[sel], ys[sel], h[sel]], axis=1)
        point, normal = _fit_plane_np(pts)
        # One inlier re-fit.
        d = np.abs((pts - point) @ normal)
        inl = d < max(inlier_tol, 1.5 * np.median(d) + 1e-9)
        if inl.sum() >= min_cells:
            point, normal = _fit_plane_np(pts[inl])
            pts = pts[inl]
        t1, t2 = _plane_basis_np(normal)
        uv = np.stack([(pts - point) @ t1, (pts - point) @ t2], axis=1)
        hull = _convex_hull_2d(uv)
        if len(hull) < 3:
            continue
        hull = _shrink_polygon(_simplify_hull(hull, max_vertices), margin)
        comps.append((sel.sum(), point, normal, t1, t2, hull))

    comps.sort(key=lambda t: -t[0])
    comps = comps[:max_segments]

    K, V = max_segments, max_vertices
    plane_point = np.zeros((K, 3), np.float32)
    plane_normal = np.tile(np.array([0, 0, 1.0], np.float32), (K, 1))
    tangent1 = np.tile(np.array([1.0, 0, 0], np.float32), (K, 1))
    tangent2 = np.tile(np.array([0, 1.0, 0], np.float32), (K, 1))
    boundary = np.zeros((K, V, 2), np.float32)
    num_vertices = np.zeros((K,), np.int32)
    valid = np.zeros((K,), bool)
    for k, (_, point, normal, t1, t2, hull) in enumerate(comps):
        nv = len(hull)
        plane_point[k] = point
        plane_normal[k] = normal
        tangent1[k] = t1
        tangent2[k] = t2
        boundary[k, :nv] = hull
        boundary[k, nv:] = hull[-1]  # pad: repeated vertex = zero-length edges
        num_vertices[k] = nv
        valid[k] = True

    host = SegmentedPlanesTerrain(plane_point, plane_normal, tangent1, tangent2, boundary,
                                  num_vertices, valid)
    return host.to(device)


# ---------------------------------------------------------------------------
# Queries (tensor ops; batch-polymorphic in the query point).
# ---------------------------------------------------------------------------


def _edges(boundary: Tensor, num_vertices: Tensor):
    """(p1, p2 = next vertex, real-edge mask) of padded CCW polygons
    [..., V, 2] with true counts [...]."""
    V = boundary.shape[-2]
    idx = torch.arange(V, device=boundary.device)
    nv = num_vertices.to(torch.int64)[..., None]
    nxt = torch.where(idx + 1 >= nv, torch.zeros_like(idx), idx + 1)  # [..., V]
    p2 = torch.gather(boundary, -2, nxt[..., None].expand(nxt.shape + (2,)))
    return boundary, p2, idx < nv


def project_to_polygon_2d(boundary: Tensor, num_vertices: Tensor, p: Tensor):
    """Project 2D points [..., 2] onto CCW convex polygons [..., V, 2] with
    padded vertices ([...] true counts).

    Returns (signed_sq_dist [...], image [..., 2]): negative inside, positive
    outside; the image is the closest boundary point."""
    p1, p2, edge_real = _edges(boundary, num_vertices)
    pe = p[..., None, :]
    p12 = p2 - p1  # [..., V, 2]
    len2 = torch.sum(p12 * p12, dim=-1)
    r = torch.sum(p12 * (pe - p1), dim=-1) / torch.clamp(len2, min=1e-12)
    rc = torch.clamp(r, 0.0, 1.0)
    q = p1 + rc[..., None] * p12  # closest point per edge
    d2 = torch.sum((pe - q) ** 2, dim=-1)
    d2 = torch.where(edge_real, d2, torch.full_like(d2, _BIG))
    best = torch.argmin(d2, dim=-1, keepdim=True)
    # Inside test: CCW polygon, the point is inside iff left of every real edge.
    cross = p12[..., 0] * (pe[..., 1] - p1[..., 1]) - p12[..., 1] * (pe[..., 0] - p1[..., 0])
    inside = torch.all(torch.where(edge_real, cross >= 0.0, torch.ones_like(edge_real)), dim=-1)
    d_best = torch.gather(d2, -1, best)[..., 0]
    img = torch.gather(q, -2, best[..., None].expand(best.shape + (2,)))[..., 0, :]
    return torch.where(inside, -d_best, d_best), img


def project_to_segment(terr: SegmentedPlanesTerrain, k: Tensor, p_world: Tensor) -> Tensor:
    """Project world points [..., 3] onto segment k's convex polygon in 3D
    (``k`` an index tensor broadcasting against the points' leading dims):
    plane projection, then a polygon clamp in the tangent frame."""
    point = terr.plane_point[k]
    t1 = terr.tangent1[k]
    t2 = terr.tangent2[k]
    rel = p_world - point
    uv = torch.stack([torch.sum(rel * t1, -1), torch.sum(rel * t2, -1)], dim=-1)
    sq, img = project_to_polygon_2d(terr.boundary[k], terr.num_vertices[k], uv)
    uv_in = torch.where((sq <= 0.0)[..., None], uv, img)
    return point + uv_in[..., 0:1] * t1 + uv_in[..., 1:2] * t2


def segment_distances(terr: SegmentedPlanesTerrain, p_world: Tensor) -> Tensor:
    """[..., K] squared distance from world points [..., 3] to each
    segment's polygon (projected 3D point), +BIG for invalid slots."""
    ks = torch.arange(terr.num_segments, device=p_world.device)
    pe = p_world[..., None, :]
    proj = project_to_segment(terr, ks, pe)
    d2 = torch.sum((pe - proj) ** 2, dim=-1)
    return torch.where(terr.valid, d2, torch.full_like(d2, _BIG))


def closest_segment(terr: SegmentedPlanesTerrain, p_world: Tensor,
                    penalty: Optional[Tensor] = None):
    """(segment ids [...], projected points [..., 3]) minimising distance^2
    + penalty[k] over the valid segments."""
    score = segment_distances(terr, p_world)
    if penalty is not None:
        score = score + torch.where(terr.valid, penalty, torch.zeros_like(penalty))
    k = torch.argmin(score, dim=-1)
    return k, project_to_segment(terr, k, p_world)


def tangential_constraint(terr: SegmentedPlanesTerrain, k: Tensor, margin: float = 0.0):
    """World-frame inequalities A @ p_world + b >= 0 keeping a foot inside
    segment k's polygon: one row per boundary edge, padded edges inert
    (0 @ p + BIG); ``margin`` shrinks the region by a normal offset per
    edge.  Returns (A [..., V, 3], b [..., V]) for index tensors k [...]."""
    point = terr.plane_point[k]
    t1 = terr.tangent1[k][..., None, :]
    t2 = terr.tangent2[k][..., None, :]
    p1, p2, real = _edges(terr.boundary[k], terr.num_vertices[k])
    e = p2 - p1  # [..., V, 2] CCW edges
    # Inward normal of a CCW edge in 2D: (-e_y, e_x), normalized.
    en = torch.stack([-e[..., 1], e[..., 0]], dim=-1)
    en = en / torch.clamp(torch.linalg.norm(en, dim=-1, keepdim=True), min=1e-9)
    # World-frame row (invariant along the plane normal).
    A = en[..., 0:1] * t1 + en[..., 1:2] * t2  # [..., V, 3]
    verts = point[..., None, :] + p1[..., 0:1] * t1 + p1[..., 1:2] * t2
    b = -torch.sum(A * verts, dim=-1) - margin
    A = torch.where(real[..., None], A, torch.zeros_like(A))
    b = torch.where(real, b, torch.full_like(b, _BIG))
    return A, b
