from .mesher import Mesh, MeshError, triangulate, triangulate_polygon
from .mesh_io import read_medit_mesh, read_vtk, write_medit_mesh, write_vtk

__all__ = [
    "Mesh",
    "MeshError",
    "triangulate",
    "triangulate_polygon",
    "read_medit_mesh",
    "read_vtk",
    "write_medit_mesh",
    "write_vtk",
]
