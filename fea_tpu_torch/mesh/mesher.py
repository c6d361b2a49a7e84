"""Triangle meshing of plate polygons via the native C++ CDT library.

The port's own copy of fea_tpu/mesh/mesher.py over its own copy of the CDT
source (csrc/cdt.cpp, the same code: the two libraries give the same
meshes). Replaces gmsh in the reference pipeline
(datagen/mesh_generator.py:246-317). The node-ordering contract mirrors
gmsh's "geometry points get the first tags": nodes 0..P-1 are the polygon
corner vertices — exterior ring first, then hole rings in order — so
condition sampling and the collinear-edge region predicate (reference
fea_analysis.py:183-188) work on node indices.

The library is built with g++ at first use into `fea_tpu_torch/_build/`.
Where fea_tpu falls back to a SciPy Delaunay mesher, and skips the hinge
check, when its library cannot be built, the port raises: there is no
second mesher and no check that is skipped unseen.
"""

import ctypes
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np

from ..geometry.polygon import Polygon
from ..ops._build import bind


class MeshError(Exception):
    """Meshing failed (capacity, degeneracy, or non-conforming boundary)."""


@dataclass
class Mesh:
    """Static triangle mesh with the boundary-tag contract.

    coords: (N, 2) float64 node coordinates.
    triangles: (M, 3) int32 CCW node indices.
    ring_corner_ids: per ring (exterior first, then holes), the node indices
        of the polygon's corner vertices, in ring order. Equivalent to the
        reference's polygons_ptags (mesh_generator.py:253,288).
    ring_edges: per ring, list of (corner_id0, corner_id1) for each polygon
        edge — the reference's polygons_ltag_ptags values.
    """

    coords: np.ndarray
    triangles: np.ndarray
    ring_corner_ids: List[np.ndarray] = field(default_factory=list)
    ring_edges: List[List[Tuple[int, int]]] = field(default_factory=list)

    @property
    def num_nodes(self) -> int:
        return len(self.coords)

    @property
    def num_triangles(self) -> int:
        return len(self.triangles)

    def all_corner_ids(self) -> List[int]:
        return [int(i) for ring in self.ring_corner_ids for i in ring]

    def all_edges(self) -> List[Tuple[int, int]]:
        return [e for ring in self.ring_edges for e in ring]

    def nodes_on_edge(self, edge: Tuple[int, int], tol: float = 1e-9) -> np.ndarray:
        """All node indices collinear with the segment through the edge's
        corner vertices. Reference predicate `_get_points_on_edge`
        (fea_analysis.py:183-188) — note it selects collinear nodes anywhere
        on the infinite line, a quirk preserved here (tolerance adapted to
        our subdivision arithmetic)."""
        c0 = self.coords[edge[0]]
        c1 = self.coords[edge[1]]
        d = c1 - c0
        rel = self.coords - c0
        cross = np.abs(d[0] * rel[:, 1] - d[1] * rel[:, 0])
        return np.where(cross < tol)[0]


_int_p, _double_p = ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_double)
LIBRARY = bind("fea_cdt", ["cdt.cpp"], {
    "fea_triangulate": ([_double_p, ctypes.c_int, _double_p, _int_p, ctypes.c_int,
                         ctypes.c_double, _double_p, ctypes.c_int, _int_p, ctypes.c_int,
                         _int_p, _int_p], ctypes.c_int),
    "fea_hinge_singular": ([ctypes.POINTER(ctypes.c_int32), ctypes.c_int, ctypes.c_int,
                            ctypes.POINTER(ctypes.c_uint8)], ctypes.c_int),
}, host=True)


def hinge_singular(triangles, fixed_mask) -> bool:
    """Articulation-point mechanism check on the stiff edge graph
    (cdt.cpp fea_hinge_singular): True if some cut vertex separates a
    sub-body carrying no Dirichlet-fixed node (zero-energy rotation
    about the hinge). Bad input (an index out of range) raises."""
    lib = LIBRARY.lib
    tris = np.ascontiguousarray(triangles, dtype=np.int32)
    fixed = np.ascontiguousarray(fixed_mask, dtype=np.uint8)
    m = len(tris)
    n = len(fixed)
    if m == 0:
        return True
    rc = lib.fea_hinge_singular(
        tris.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        ctypes.c_int(m),
        ctypes.c_int(n),
        fixed.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
    )
    if rc < 0:
        raise ValueError(f"fea_hinge_singular rejected its input (code {rc})")
    return bool(rc)


def _boundary_scaffold(
    exterior: np.ndarray, holes: List[np.ndarray]
) -> Tuple[List[np.ndarray], List[List[Tuple[int, int]]]]:
    ring_corner_ids: List[np.ndarray] = []
    ring_edges: List[List[Tuple[int, int]]] = []
    base = 0
    for ring in [exterior] + list(holes):
        m = len(ring)
        ids = np.arange(base, base + m, dtype=np.int64)
        ring_corner_ids.append(ids)
        ring_edges.append(
            [(int(ids[i]), int(ids[(i + 1) % m])) for i in range(m)]
        )
        base += m
    return ring_corner_ids, ring_edges


def triangulate(
    exterior: np.ndarray,
    holes: Optional[List[np.ndarray]] = None,
    mesh_size: float = 1e-2,
    max_nodes: int = 262144,
    max_triangles: int = 524288,
) -> Mesh:
    """Mesh a polygon-with-holes at target edge length `mesh_size`."""
    holes = holes or []
    lib = LIBRARY.lib

    ext = np.ascontiguousarray(exterior, dtype=np.float64)
    hole_arr = (
        np.concatenate([np.ascontiguousarray(h, dtype=np.float64) for h in holes])
        if holes
        else np.zeros((0, 2))
    )
    hole_sizes = np.array([len(h) for h in holes], dtype=np.int32)

    out_coords = np.empty((max_nodes, 2), dtype=np.float64)
    out_tris = np.empty((max_triangles, 3), dtype=np.int32)
    n_nodes = ctypes.c_int(0)
    n_tris = ctypes.c_int(0)

    def cptr(a, typ):
        return a.ctypes.data_as(ctypes.POINTER(typ))

    rc = lib.fea_triangulate(
        cptr(ext, ctypes.c_double),
        len(ext),
        cptr(hole_arr, ctypes.c_double),
        cptr(hole_sizes, ctypes.c_int),
        len(holes),
        float(mesh_size),
        cptr(out_coords, ctypes.c_double),
        max_nodes,
        cptr(out_tris, ctypes.c_int),
        max_triangles,
        ctypes.byref(n_nodes),
        ctypes.byref(n_tris),
    )
    if rc != 0:
        raise MeshError(f"fea_triangulate failed with code {rc}")

    ring_corner_ids, ring_edges = _boundary_scaffold(ext, holes)
    return Mesh(
        coords=out_coords[: n_nodes.value].copy(),
        triangles=out_tris[: n_tris.value].copy(),
        ring_corner_ids=ring_corner_ids,
        ring_edges=ring_edges,
    )


def triangulate_polygon(polygon: Polygon, mesh_size: float = 1e-2, **kw) -> Mesh:
    return triangulate(polygon.exterior, list(polygon.holes), mesh_size, **kw)
