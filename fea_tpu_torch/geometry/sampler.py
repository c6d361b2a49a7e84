"""Seeded random plate-geometry sampler (the port's own copy of
fea_tpu/geometry/sampler.py: the same draws from the same seed).

Behavioral re-implementation of the reference MeshGenerator's geometry
half (datagen/mesh_generator.py:58-196): plates are unions of 1-3 convex
hulls whose points are drawn from shuffled half-plane bounds for shape
diversity, punched with 0-3 convex holes (properly contained, mutually
non-crossing), then normalized to the unit box.
"""

import random
from typing import List, Optional, Tuple

import numpy as np

from .polygon import GeometryError, Polygon, convex_hull, union_exterior

BOUNDS_FOR_DIVERSITY = [
    (0.5, 0.0, 1.0, 1.0),
    (0.0, 0.0, 0.5, 1.0),
    (0.0, 0.5, 1.0, 1.0),
    (0.0, 0.0, 1.0, 0.5),
]


class GeometrySampler:
    def __init__(
        self,
        num_polygons_range: Tuple[int, int] = (1, 3),
        points_per_polygon_range: Tuple[int, int] = (3, 8),
        holes_per_polygon_range: Tuple[int, int] = (0, 3),
        points_per_hole_range: Tuple[int, int] = (3, 4),
        random_seed: Optional[int] = None,
        max_hole_attempts: int = 200,
    ):
        self.num_polygons_range = num_polygons_range
        self.points_per_polygon_range = points_per_polygon_range
        self.holes_per_polygon_range = holes_per_polygon_range
        self.points_per_hole_range = points_per_hole_range
        self.random = random.Random(random_seed)
        self.max_hole_attempts = max_hole_attempts

    # Reference quantizes coordinates to a 1/1000 grid (mesh_generator.py:102).
    def _random_float(self) -> float:
        return self.random.randint(0, 1000) / 1000.0

    def _random_coordinates(
        self, n: int, bounds: Tuple[float, float, float, float] = (0, 0, 1, 1)
    ) -> np.ndarray:
        return np.array(
            [
                (
                    bounds[0] + self._random_float() * (bounds[2] - bounds[0]),
                    bounds[1] + self._random_float() * (bounds[3] - bounds[1]),
                )
                for _ in range(n)
            ]
        )

    def _random_hull(self) -> np.ndarray:
        num_points = self.random.randint(*self.points_per_polygon_range)
        bounds = list(BOUNDS_FOR_DIVERSITY)
        self.random.shuffle(bounds)
        pts = np.concatenate(
            [
                self._random_coordinates(num_points // 3, bounds[0]),
                self._random_coordinates(num_points // 3, bounds[1]),
                self._random_coordinates(num_points - 2 * (num_points // 3), bounds[2]),
            ]
        )
        return convex_hull(pts)

    def _punch_holes(self, exterior: np.ndarray) -> Polygon:
        poly = Polygon(exterior=exterior)
        xs, ys = exterior[:, 0], exterior[:, 1]
        ext_bounds = (xs.min(), ys.min(), xs.max(), ys.max())
        holes: List[np.ndarray] = []
        for _ in range(self.random.randint(*self.holes_per_polygon_range)):
            num_points = self.random.randint(*self.points_per_hole_range)
            for _attempt in range(self.max_hole_attempts):
                try:
                    hole = convex_hull(
                        self._random_coordinates(num_points, ext_bounds)
                    )
                except GeometryError:
                    continue
                if not poly.contains_properly(hole):
                    continue
                # A new hole must not touch any existing hole's boundary
                # (mesh_generator.py:169-181).
                from .polygon import points_in_polygon, rings_boundary_intersect

                clashes = False
                for other in holes:
                    if rings_boundary_intersect(hole, other):
                        clashes = True
                        break
                    if points_in_polygon(other, hole).any():
                        clashes = True
                        break
                    if points_in_polygon(hole, other).any():
                        clashes = True
                        break
                if clashes:
                    continue
                holes.append(hole)
                break
            else:
                raise GeometryError("could not place hole")
        # Store holes CW, as the reference reverses hole coords.
        return Polygon(exterior=exterior, holes=[h[::-1].copy() for h in holes])

    def generate_geometry(self) -> Polygon:
        """Union of 1-3 convex hulls with convex holes. May raise GeometryError."""
        num_polygons = self.random.randint(*self.num_polygons_range)
        hulls = [self._random_hull() for _ in range(num_polygons)]
        exterior = union_exterior(hulls)
        return self._punch_holes(exterior)

    def generate(self, max_retries: int = 100) -> Polygon:
        """generate_geometry with the caller-side retry loop folded in
        (datagen/generate.py:56-60), then unit-box normalization."""
        for _ in range(max_retries):
            try:
                return self.generate_geometry().normalized()
            except GeometryError:
                continue
        raise GeometryError(f"no valid geometry after {max_retries} retries")

    @staticmethod
    def create_box() -> Polygon:
        return Polygon(
            exterior=np.array([(0.0, 0.0), (1.0, 0.0), (1.0, 1.0), (0.0, 1.0)])
        )
