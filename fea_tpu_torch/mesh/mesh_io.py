"""Mesh file I/O: MEDIT .mesh (gmsh output format used by the reference
pipeline) and legacy VTK (sfepy/meshio ground-truth files consumed by the
reference metrics — metrics/accuracy_function.py:10,172). The port's own
copy of fea_tpu/mesh/mesh_io.py; the files it writes are the same bytes."""

from typing import Dict, Optional, Tuple

import numpy as np


# ---------------------------------------------------------------------------
# MEDIT .mesh
# ---------------------------------------------------------------------------

def read_medit_mesh(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Read an ASCII MEDIT mesh. Returns (coords (N,2|3), triangles (M,3) 0-based)."""
    with open(path) as f:
        tokens = f.read().split()
    i = 0
    coords = None
    tris = None
    dim = 3
    while i < len(tokens):
        tok = tokens[i]
        if tok == "Dimension":
            dim = int(tokens[i + 1])
            i += 2
        elif tok == "Vertices":
            n = int(tokens[i + 1])
            i += 2
            vals = np.array(tokens[i : i + n * (dim + 1)], dtype=np.float64)
            coords = vals.reshape(n, dim + 1)[:, :dim]
            i += n * (dim + 1)
        elif tok == "Triangles":
            n = int(tokens[i + 1])
            i += 2
            vals = np.array(tokens[i : i + n * 4], dtype=np.int64)
            tris = vals.reshape(n, 4)[:, :3] - 1
            i += n * 4
        elif tok == "End":
            break
        else:
            i += 1
    if coords is None or tris is None:
        raise ValueError(f"no Vertices/Triangles found in {path}")
    return coords[:, :2], tris.astype(np.int32)


def write_medit_mesh(path: str, coords: np.ndarray, triangles: np.ndarray) -> None:
    """Write ASCII MEDIT (3D points with z=0, matching gmsh's output)."""
    with open(path, "w") as f:
        f.write(" MeshVersionFormatted 2\n Dimension\n 3\n Vertices\n")
        f.write(f" {len(coords)}\n")
        for x, y in np.asarray(coords, dtype=np.float64):
            f.write(f" {x:.16g} {y:.16g} 0 1\n")
        f.write(" Triangles\n")
        f.write(f" {len(triangles)}\n")
        for a, b, c in np.asarray(triangles):
            f.write(f" {a + 1} {b + 1} {c + 1} 1\n")
        f.write(" End\n")


# ---------------------------------------------------------------------------
# Legacy VTK (ASCII + binary big-endian, the meshio/sfepy flavor)
# ---------------------------------------------------------------------------

def read_vtk(path: str) -> Dict[str, np.ndarray]:
    """Minimal legacy-VTK unstructured-grid reader.

    Returns dict with 'points' (N,3), 'cells' (M,3) triangle connectivity,
    and any POINT_DATA / CELL_DATA arrays by name (e.g. 'u' — the
    displacement vectors the reference metrics read)."""
    with open(path, "rb") as f:
        data = f.read()

    # header
    lines_end = 0
    header_lines = []
    pos = 0
    while len(header_lines) < 4:
        nl = data.index(b"\n", pos)
        header_lines.append(data[pos:nl].decode("ascii", "replace").strip())
        pos = nl + 1
    binary = header_lines[2].upper() == "BINARY"
    out: Dict[str, np.ndarray] = {}

    def read_ascii_floats(count, pos):
        vals = []
        while len(vals) < count:
            nl = data.find(b"\n", pos)
            if nl == -1:
                nl = len(data)
            vals.extend(data[pos:nl].split())
            pos = nl + 1
        return np.array(vals[:count], dtype=np.float64), pos

    dtype_map = {
        b"double": (">f8", 8),
        b"float": (">f4", 4),
        b"int": (">i4", 4),
        b"long": (">i8", 8),
        b"vtktypeint64": (">i8", 8),
        b"vtktypeint32": (">i4", 4),
        b"unsigned_char": (">u1", 1),
    }

    def read_block(count, typename, pos):
        if binary:
            dt, size = dtype_map[typename.lower()]
            arr = np.frombuffer(data, dtype=dt, count=count, offset=pos)
            return arr.astype(np.float64), pos + count * size
        return read_ascii_floats(count, pos)

    n_points = 0
    point_data_mode: Optional[int] = None  # None, or count of tuples
    while pos < len(data):
        nl = data.find(b"\n", pos)
        if nl == -1:
            nl = len(data)
        line = data[pos:nl].strip()
        pos = nl + 1
        if not line:
            continue
        parts = line.split()
        key = parts[0].upper()
        if key == b"POINTS":
            n_points = int(parts[1])
            arr, pos = read_block(n_points * 3, parts[2], pos)
            out["points"] = arr.reshape(n_points, 3)
        elif key in (b"CELLS", b"POLYGONS"):
            n_cells, total = int(parts[1]), int(parts[2])
            arr, pos = read_block(total, b"int" if binary else b"int", pos)
            arr = arr.astype(np.int64)
            # modern vtk may emit OFFSETS/CONNECTIVITY instead; handle classic
            cells = []
            i = 0
            while i < len(arr):
                k = int(arr[i])
                cells.append(arr[i + 1 : i + 1 + k])
                i += k + 1
            tri = [c for c in cells if len(c) == 3]
            if tri:
                out["cells"] = np.array(tri, dtype=np.int32)
        elif key == b"CELL_TYPES":
            n = int(parts[1])
            _, pos = read_block(n, b"int", pos)
        elif key == b"POINT_DATA":
            point_data_mode = int(parts[1])
        elif key == b"CELL_DATA":
            point_data_mode = int(parts[1])
        elif key == b"VECTORS":
            name = parts[1].decode()
            arr, pos = read_block((point_data_mode or n_points) * 3, parts[2], pos)
            out[name] = arr.reshape(-1, 3)
        elif key == b"SCALARS":
            name = parts[1].decode()
            ncomp = int(parts[3]) if len(parts) > 3 else 1
            # skip LOOKUP_TABLE line
            nl2 = data.find(b"\n", pos)
            lt = data[pos:nl2].strip()
            if lt.upper().startswith(b"LOOKUP_TABLE"):
                pos = nl2 + 1
            arr, pos = read_block((point_data_mode or n_points) * ncomp, parts[2], pos)
            out[name] = arr.reshape(-1, ncomp) if ncomp > 1 else arr
        elif key == b"FIELD":
            n_arrays = int(parts[2])
            for _ in range(n_arrays):
                fparts = []
                while not fparts and pos < len(data):  # skip blank lines
                    nl2 = data.find(b"\n", pos)
                    fparts = data[pos:nl2].split()
                    pos = nl2 + 1
                fname = fparts[0].decode()
                ncomp, ntup = int(fparts[1]), int(fparts[2])
                arr, pos = read_block(ncomp * ntup, fparts[3], pos)
                out[fname] = arr.reshape(ntup, ncomp) if ncomp > 1 else arr
        # anything else: skip line
    return out


def write_vtk(
    path: str,
    coords: np.ndarray,
    triangles: np.ndarray,
    point_data: Optional[Dict[str, np.ndarray]] = None,
    cell_data: Optional[Dict[str, np.ndarray]] = None,
    binary: bool = True,
) -> None:
    """Write a legacy VTK unstructured grid (triangles), sfepy-style.

    Vector point data (N,2) is padded to 3 components, matching the
    reference's domain.NN.vtk files whose 'u' the metrics pipeline reads."""
    coords = np.asarray(coords, dtype=np.float64)
    if coords.shape[1] == 2:
        coords = np.concatenate([coords, np.zeros((len(coords), 1))], axis=1)
    triangles = np.asarray(triangles, dtype=np.int64)

    with open(path, "wb") as f:
        f.write(b"# vtk DataFile Version 4.2\n")
        f.write(b"written by fea_tpu\n")
        f.write(b"BINARY\n" if binary else b"ASCII\n")
        f.write(b"DATASET UNSTRUCTURED_GRID\n")
        f.write(f"POINTS {len(coords)} double\n".encode())
        if binary:
            f.write(coords.astype(">f8").tobytes())
            f.write(b"\n")
        else:
            np.savetxt(f, coords, fmt="%.16g")
        cells = np.concatenate(
            [np.full((len(triangles), 1), 3, dtype=np.int64), triangles], axis=1
        )
        f.write(f"CELLS {len(triangles)} {len(triangles) * 4}\n".encode())
        if binary:
            f.write(cells.astype(">i4").tobytes())
            f.write(b"\n")
        else:
            np.savetxt(f, cells, fmt="%d")
        f.write(f"CELL_TYPES {len(triangles)}\n".encode())
        types = np.full(len(triangles), 5, dtype=np.int64)  # VTK_TRIANGLE
        if binary:
            f.write(types.astype(">i4").tobytes())
            f.write(b"\n")
        else:
            np.savetxt(f, types, fmt="%d")

        def write_data(section: str, data: Dict[str, np.ndarray], n: int):
            f.write(f"{section} {n}\n".encode())
            for name, arr in data.items():
                arr = np.asarray(arr, dtype=np.float64)
                if arr.ndim == 2 and arr.shape[1] == 2:
                    arr = np.concatenate([arr, np.zeros((len(arr), 1))], axis=1)
                if arr.ndim == 2 and arr.shape[1] == 3:
                    f.write(f"VECTORS {name} double\n".encode())
                    payload = arr
                else:
                    arr2 = arr.reshape(len(arr), -1)
                    f.write(
                        f"SCALARS {name} double {arr2.shape[1]}\n".encode()
                    )
                    f.write(b"LOOKUP_TABLE default\n")
                    payload = arr2
                if binary:
                    f.write(payload.astype(">f8").tobytes())
                    f.write(b"\n")
                else:
                    np.savetxt(f, payload, fmt="%.16g")

        if point_data:
            write_data("POINT_DATA", point_data, len(coords))
        if cell_data:
            write_data("CELL_DATA", cell_data, len(triangles))
