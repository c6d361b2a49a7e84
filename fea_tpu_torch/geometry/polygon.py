"""Pure-NumPy computational geometry (no GEOS); the port's own copy of
fea_tpu/geometry/polygon.py.

Provides the polygon operations the reference delegated to shapely
(datagen/mesh_generator.py:79-196): convex hulls, unions of convex
polygons, containment checks, bounds and unit-box normalization.

All polygons are ndarray rings of shape (n, 2) without a repeated
closing vertex. Exteriors are CCW; holes are stored CW (matching the
reference, which reverses hole coords — mesh_generator.py:182).
"""

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np


class GeometryError(Exception):
    """Raised when a random geometry draw is degenerate; caller retries."""


def cross2(a: np.ndarray, b: np.ndarray) -> float:
    """Scalar 2D cross product (np.cross on 2-vectors is deprecated)."""
    return float(a[0] * b[1] - a[1] * b[0])


def polygon_area(ring: np.ndarray) -> float:
    """Signed area (positive for CCW rings)."""
    x, y = ring[:, 0], ring[:, 1]
    return 0.5 * float(np.sum(x * np.roll(y, -1) - np.roll(x, -1) * y))


def ensure_ccw(ring: np.ndarray) -> np.ndarray:
    return ring if polygon_area(ring) >= 0 else ring[::-1].copy()


def convex_hull(points: np.ndarray) -> np.ndarray:
    """Andrew's monotone chain. Returns CCW hull without repeated endpoint."""
    pts = np.unique(np.asarray(points, dtype=np.float64), axis=0)
    if len(pts) < 3:
        raise GeometryError("fewer than 3 distinct points for hull")
    order = np.lexsort((pts[:, 1], pts[:, 0]))
    pts = pts[order]

    def half(iterable):
        out: List[np.ndarray] = []
        for p in iterable:
            while len(out) >= 2 and cross2(out[-1] - out[-2], p - out[-2]) <= 0:
                out.pop()
            out.append(p)
        return out

    lower = half(pts)
    upper = half(pts[::-1])
    hull = np.array(lower[:-1] + upper[:-1])
    if len(hull) < 3 or abs(polygon_area(hull)) < 1e-12:
        raise GeometryError("degenerate hull")
    return hull


def point_in_polygon(point: np.ndarray, ring: np.ndarray, strict: bool = False) -> bool:
    return bool(points_in_polygon(point[None, :], ring, strict=strict)[0])


def points_in_polygon(
    points: np.ndarray, ring: np.ndarray, strict: bool = False, eps: float = 1e-12
) -> np.ndarray:
    """Vectorized ray-cast point-in-polygon for a simple ring (any orientation).

    With ``strict=True`` boundary points count as outside.
    """
    px = points[:, 0][:, None]
    py = points[:, 1][:, None]
    ax, ay = ring[:, 0][None, :], ring[:, 1][None, :]
    bx, by = np.roll(ring[:, 0], -1)[None, :], np.roll(ring[:, 1], -1)[None, :]

    # Standard even-odd crossing test.
    cond = (ay > py) != (by > py)
    with np.errstate(divide="ignore", invalid="ignore"):
        xint = ax + (py - ay) * (bx - ax) / (by - ay)
    crossings = np.sum(cond & (px < xint), axis=1)
    inside = (crossings % 2) == 1

    # Boundary detection: point on any segment.
    cross = (bx - ax) * (py - ay) - (by - ay) * (px - ax)
    seg_len2 = (bx - ax) ** 2 + (by - ay) ** 2
    dot = (px - ax) * (bx - ax) + (py - ay) * (by - ay)
    on_seg = (
        (np.abs(cross) <= eps * np.maximum(1.0, np.sqrt(seg_len2)))
        & (dot >= -eps)
        & (dot <= seg_len2 + eps)
    ).any(axis=1)

    if strict:
        return inside & ~on_seg
    return inside | on_seg


def segments_intersect(
    p1: np.ndarray, p2: np.ndarray, q1: np.ndarray, q2: np.ndarray, eps: float = 1e-12
) -> Optional[np.ndarray]:
    """Proper/improper intersection point of segments [p1,p2], [q1,q2] or None.

    Collinear overlaps return None (treated as non-generic; callers retry).
    """
    r = p2 - p1
    s = q2 - q1
    denom = r[0] * s[1] - r[1] * s[0]
    if abs(denom) < eps:
        return None
    qp = q1 - p1
    t = (qp[0] * s[1] - qp[1] * s[0]) / denom
    u = (qp[0] * r[1] - qp[1] * r[0]) / denom
    if -eps <= t <= 1 + eps and -eps <= u <= 1 + eps:
        return p1 + t * r
    return None


def rings_boundary_intersect(a: np.ndarray, b: np.ndarray) -> bool:
    """True if any edge of ring `a` crosses any edge of ring `b`."""
    for i in range(len(a)):
        p1, p2 = a[i], a[(i + 1) % len(a)]
        for j in range(len(b)):
            q1, q2 = b[j], b[(j + 1) % len(b)]
            if segments_intersect(p1, p2, q1, q2) is not None:
                return True
    return False


def _key(pt: np.ndarray, scale: float = 1e9) -> Tuple[int, int]:
    return (int(round(pt[0] * scale)), int(round(pt[1] * scale)))


def union_exterior(rings: List[np.ndarray]) -> np.ndarray:
    """Exterior boundary of the union of overlapping convex CCW rings.

    Replaces shapely.unary_union for the reference's multi-hull plates
    (mesh_generator.py:186-196). Raises GeometryError when the union is
    disconnected or degenerate — the caller redraws, mirroring the
    reference's retry-on-exception loop (datagen/generate.py:56-60).
    """
    rings = [ensure_ccw(np.asarray(r, dtype=np.float64)) for r in rings]
    if len(rings) == 1:
        return rings[0]

    # Split every edge at its intersections with edges of other rings.
    directed_edges: List[Tuple[np.ndarray, np.ndarray, int]] = []
    for ri, ring in enumerate(rings):
        n = len(ring)
        for i in range(n):
            a, b = ring[i], ring[(i + 1) % n]
            cuts = [0.0, 1.0]
            for rj, other in enumerate(rings):
                if rj == ri:
                    continue
                m = len(other)
                for j in range(m):
                    q1, q2 = other[j], other[(j + 1) % m]
                    pt = segments_intersect(a, b, q1, q2)
                    if pt is not None:
                        d = b - a
                        denom = float(d @ d)
                        if denom > 0:
                            cuts.append(float(np.clip((pt - a) @ d / denom, 0.0, 1.0)))
            cuts = sorted(set(np.round(cuts, 12)))
            for t0, t1 in zip(cuts[:-1], cuts[1:]):
                if t1 - t0 < 1e-12:
                    continue
                directed_edges.append((a + t0 * (b - a), a + t1 * (b - a), ri))

    # Keep sub-edges on the union boundary: midpoint not strictly inside
    # any *other* ring (and not on another ring's boundary duplicate).
    kept: List[Tuple[np.ndarray, np.ndarray]] = []
    seen = set()
    for a, b, ri in directed_edges:
        mid = 0.5 * (a + b)
        interior = False
        for rj, other in enumerate(rings):
            if rj == ri:
                continue
            if points_in_polygon(mid[None, :], other, strict=True)[0]:
                interior = True
                break
        if interior:
            continue
        k = (_key(a), _key(b))
        if k in seen or (_key(b), _key(a)) in seen:
            continue  # coincident edge shared by two rings; keep one copy
        seen.add(k)
        kept.append((a, b))

    if not kept:
        raise GeometryError("empty union boundary")

    # Trace the boundary loop. Each boundary vertex has exactly one outgoing
    # kept edge in general position.
    nxt = {}
    for a, b in kept:
        ka = _key(a)
        if ka in nxt:
            raise GeometryError("non-manifold union boundary")
        nxt[ka] = (a, b)

    start_key = min(nxt.keys())
    loop = []
    k = start_key
    for _ in range(len(kept) + 1):
        if k not in nxt:
            raise GeometryError("open union boundary")
        a, b = nxt.pop(k)
        loop.append(a)
        k = _key(b)
        if k == start_key:
            break
    else:
        raise GeometryError("union boundary did not close")

    if nxt:
        raise GeometryError("union is disconnected")  # leftover loops

    ring = np.array(loop)
    # Drop collinear duplicates introduced by edge splitting.
    keep_mask = np.ones(len(ring), dtype=bool)
    for i in range(len(ring)):
        p0 = ring[i - 1]
        p1 = ring[i]
        p2 = ring[(i + 1) % len(ring)]
        if abs(cross2(p1 - p0, p2 - p0)) < 1e-12:
            keep_mask[i] = False
    ring = ring[keep_mask]
    if len(ring) < 3 or polygon_area(ring) <= 1e-12:
        raise GeometryError("degenerate union exterior")
    return ring


@dataclass
class Polygon:
    """Simple polygon with optional holes.

    exterior: (n, 2) CCW ring; holes: list of (m, 2) CW rings, mirroring
    the reference's shapely Polygon(exterior, holes) construction.
    """

    exterior: np.ndarray
    holes: List[np.ndarray] = field(default_factory=list)

    @property
    def bounds(self) -> Tuple[float, float, float, float]:
        xs, ys = self.exterior[:, 0], self.exterior[:, 1]
        return float(xs.min()), float(ys.min()), float(xs.max()), float(ys.max())

    def normalized(self) -> "Polygon":
        """Translate to origin and uniformly scale the longest side to 1.

        Mirrors MeshGenerator.normalize_geometry (mesh_generator.py:84-93).
        """
        minx, miny, maxx, maxy = self.bounds
        scale = 1.0 / max(maxx - minx, maxy - miny)
        shift = np.array([minx, miny])
        return Polygon(
            exterior=(self.exterior - shift) * scale,
            holes=[(h - shift) * scale for h in self.holes],
        )

    def contains_properly(self, ring: np.ndarray) -> bool:
        """All of `ring` strictly inside the exterior, none in/crossing holes."""
        if not points_in_polygon(ring, self.exterior, strict=True).all():
            return False
        if rings_boundary_intersect(ring, self.exterior):
            return False
        return True

    def contains_points(self, points: np.ndarray) -> np.ndarray:
        """Boolean mask: inside exterior (inclusive) and outside all holes."""
        mask = points_in_polygon(points, self.exterior)
        for hole in self.holes:
            mask &= ~points_in_polygon(points, hole, strict=True)
        return mask
