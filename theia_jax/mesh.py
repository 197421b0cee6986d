"""Triangle-mesh loading (STL/PLY/OBJ) without external dependencies.

The reference delegates to trimesh (reference: src/theia/scene.py:434-449);
this environment has no trimesh, so we parse the formats its assets and
scene templates use directly. Loading mirrors trimesh's default
processing: duplicate vertices are welded and vertex normals are computed
as area-weighted averages of the incident face normals. Wavefront OBJ
additionally carries named objects and material assignments (``o`` /
``usemtl``), which :func:`loadObjScene` preserves for
:class:`~theia_jax.render.SceneTemplate` (the reference's file-based
template path, src/theia/scene.py:750-817, reads the same name/material
metadata through trimesh's scene graph).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from pathlib import Path

import numpy as np

__all__ = [
    "Mesh",
    "ObjObject",
    "icosphere",
    "loadMesh",
    "loadObjScene",
    "lobed_sphere",
]


@dataclass
class Mesh:
    """Triangle mesh: vertices (V, 6) float32 [position, normal] and
    indices (T, 3) int32 — the reference's hp.Mesh layout
    (reference: src/theia/scene.py:434-441)."""

    vertices: np.ndarray
    indices: np.ndarray

    @staticmethod
    def from_geometry(positions, faces) -> "Mesh":
        positions = np.asarray(positions, np.float64)
        faces = np.asarray(faces, np.int64)
        positions, faces = _weld(positions, faces)
        normals = _vertex_normals(positions, faces)
        vertices = np.concatenate([positions, normals], axis=-1)
        return Mesh(
            vertices=np.ascontiguousarray(vertices, np.float32),
            indices=np.ascontiguousarray(faces, np.int32),
        )


def _icosphere_geometry(subdivisions: int):
    """Unit icosphere as (positions (V, 3) f64, faces (T, 3) i64), every
    face counter-clockwise seen from outside."""
    p = (1.0 + np.sqrt(5.0)) / 2.0
    verts = [
        (-1, p, 0), (1, p, 0), (-1, -p, 0), (1, -p, 0),
        (0, -1, p), (0, 1, p), (0, -1, -p), (0, 1, -p),
        (p, 0, -1), (p, 0, 1), (-p, 0, -1), (-p, 0, 1),
    ]
    faces = [
        (0, 11, 5), (0, 5, 1), (0, 1, 7), (0, 7, 10), (0, 10, 11),
        (1, 5, 9), (5, 11, 4), (11, 10, 2), (10, 7, 6), (7, 1, 8),
        (3, 9, 4), (3, 4, 2), (3, 2, 6), (3, 6, 8), (3, 8, 9),
        (4, 9, 5), (2, 4, 11), (6, 2, 10), (8, 6, 7), (9, 8, 1),
    ]
    verts = [np.asarray(v, np.float64) / np.linalg.norm(v) for v in verts]
    for _ in range(subdivisions):
        midpoint: dict[tuple[int, int], int] = {}

        def mid(a: int, b: int) -> int:
            key = (min(a, b), max(a, b))
            if key not in midpoint:
                m = verts[a] + verts[b]
                verts.append(m / np.linalg.norm(m))
                midpoint[key] = len(verts) - 1
            return midpoint[key]

        split = []
        for a, b, c in faces:
            ab, bc, ca = mid(a, b), mid(b, c), mid(c, a)
            split += [(a, ab, ca), (b, bc, ab), (c, ca, bc), (ab, bc, ca)]
        faces = split
    return np.stack(verts), np.asarray(faces, np.int64)


def icosphere(subdivisions: int = 3) -> Mesh:
    """Unit sphere mesh: a subdivided icosahedron with outward vertex
    normals. The default (3 subdivisions: 1280 triangles, 642 vertices) is
    the module sphere of the bench scene, the detector arrays and the
    tests."""
    positions, faces = _icosphere_geometry(subdivisions)
    return Mesh.from_geometry(positions, faces)


def lobed_sphere(subdivisions: int = 3) -> Mesh:
    """Non-convex closed test mesh: the icosphere with its radius
    modulated into four lobes around the z axis and a dimple at each pole
    (radius 0.55..1.25). Star-shaped about the origin, so it stays
    watertight and free of self-intersections."""
    positions, faces = _icosphere_geometry(subdivisions)
    x, y, z = positions.T
    azimuth = np.arctan2(y, x)
    radius = 1.0 + 0.25 * np.cos(4.0 * azimuth) * (1.0 - z * z) - 0.45 * z**8
    return Mesh.from_geometry(positions * radius[:, None], faces)


def _weld(positions: np.ndarray, faces: np.ndarray):
    """Merge duplicate vertices (exact match after float32 rounding)."""
    key = np.ascontiguousarray(positions.astype(np.float32))
    key_view = key.view([("x", np.float32), ("y", np.float32), ("z", np.float32)])
    _, first, inverse = np.unique(
        key_view.ravel(), return_index=True, return_inverse=True
    )
    new_pos = positions[first]
    new_faces = inverse[faces]
    # drop degenerate faces
    good = (
        (new_faces[:, 0] != new_faces[:, 1])
        & (new_faces[:, 1] != new_faces[:, 2])
        & (new_faces[:, 0] != new_faces[:, 2])
    )
    return new_pos, new_faces[good]


def _vertex_normals(positions: np.ndarray, faces: np.ndarray) -> np.ndarray:
    v0 = positions[faces[:, 0]]
    e1 = positions[faces[:, 1]] - v0
    e2 = positions[faces[:, 2]] - v0
    fn = np.cross(e1, e2)  # length = 2x area -> area weighting for free
    normals = np.zeros_like(positions)
    for k in range(3):
        np.add.at(normals, faces[:, k], fn)
    length = np.linalg.norm(normals, axis=-1, keepdims=True)
    return normals / np.maximum(length, 1e-30)


def _load_stl(path: Path) -> Mesh:
    data = path.read_bytes()
    if data[:5] == b"solid" and b"facet" in data[:500]:
        # might still be binary with a 'solid' header; check size
        count = struct.unpack_from("<I", data, 80)[0] if len(data) >= 84 else -1
        if len(data) != 84 + count * 50:
            return _load_stl_ascii(data.decode("ascii", "ignore"))
    count = struct.unpack_from("<I", data, 80)[0]
    if len(data) < 84 + count * 50:
        raise ValueError(f"corrupt binary STL: {path}")
    rec = np.frombuffer(data, np.uint8, count=count * 50, offset=84).reshape(
        count, 50
    )
    tri = rec[:, 12:48].copy().view(np.float32).reshape(count, 3, 3)
    positions = tri.reshape(-1, 3)
    faces = np.arange(count * 3).reshape(count, 3)
    return Mesh.from_geometry(positions, faces)


def _load_stl_ascii(text: str) -> Mesh:
    verts = []
    for line in text.splitlines():
        line = line.strip()
        if line.startswith("vertex"):
            verts.append([float(x) for x in line.split()[1:4]])
    positions = np.asarray(verts)
    faces = np.arange(len(verts)).reshape(-1, 3)
    return Mesh.from_geometry(positions, faces)


_PLY_DTYPES = {
    "char": "i1", "uchar": "u1", "int8": "i1", "uint8": "u1",
    "short": "i2", "ushort": "u2", "int16": "i2", "uint16": "u2",
    "int": "i4", "uint": "u4", "int32": "i4", "uint32": "u4",
    "float": "f4", "float32": "f4", "double": "f8", "float64": "f8",
}


def _load_ply(path: Path) -> Mesh:
    data = path.read_bytes()
    end = data.index(b"end_header\n") + len(b"end_header\n")
    header = data[:end].decode("ascii")
    body = data[end:]

    fmt = None
    elements = []  # (name, count, [(prop_name, dtype, is_list, count_dtype)])
    for line in header.splitlines():
        parts = line.split()
        if not parts:
            continue
        if parts[0] == "format":
            fmt = parts[1]
        elif parts[0] == "element":
            elements.append((parts[1], int(parts[2]), []))
        elif parts[0] == "property":
            if parts[1] == "list":
                elements[-1][2].append((parts[4], parts[3], True, parts[2]))
            else:
                elements[-1][2].append((parts[2], parts[1], False, None))

    positions = faces = None
    if fmt == "ascii":
        tokens = body.decode("ascii").split()
        pos = 0
        for name, count, props in elements:
            if name == "vertex":
                width = len(props)
                arr = np.asarray(
                    tokens[pos : pos + count * width], np.float64
                ).reshape(count, width)
                cols = [p[0] for p in props]
                positions = arr[:, [cols.index("x"), cols.index("y"), cols.index("z")]]
                pos += count * width
            elif name == "face":
                rows = []
                for _ in range(count):
                    n = int(tokens[pos]); pos += 1
                    rows.append([int(t) for t in tokens[pos : pos + n]]); pos += n
                faces = _fan_triangulate(rows)
            else:
                raise ValueError(f"unsupported PLY element {name}")
    elif fmt == "binary_little_endian":
        off = 0
        for name, count, props in elements:
            if name == "vertex" and not any(p[2] for p in props):
                dt = np.dtype([(p[0], "<" + _PLY_DTYPES[p[1]]) for p in props])
                arr = np.frombuffer(body, dt, count=count, offset=off)
                off += dt.itemsize * count
                positions = np.stack(
                    [arr["x"], arr["y"], arr["z"]], axis=-1
                ).astype(np.float64)
            elif name == "face":
                rows = []
                cnt_dt = np.dtype("<" + _PLY_DTYPES[props[0][3]])
                idx_dt = np.dtype("<" + _PLY_DTYPES[props[0][1]])
                for _ in range(count):
                    n = int(np.frombuffer(body, cnt_dt, 1, off)[0])
                    off += cnt_dt.itemsize
                    rows.append(
                        np.frombuffer(body, idx_dt, n, off).tolist()
                    )
                    off += idx_dt.itemsize * n
                faces = _fan_triangulate(rows)
            else:
                raise ValueError(f"unsupported PLY element {name}")
    else:
        raise ValueError(f"unsupported PLY format {fmt}")
    return Mesh.from_geometry(positions, np.asarray(faces))


def _fan_triangulate(rows) -> np.ndarray:
    tris = []
    for row in rows:
        for i in range(1, len(row) - 1):
            tris.append([row[0], row[i], row[i + 1]])
    return np.asarray(tris, np.int64)


@dataclass
class ObjObject:
    """One named object of an OBJ file with its material assignment."""

    name: str
    material: str | None
    mesh: Mesh


def _parse_obj(path: Path):
    """Parse an OBJ file into vertices + (name, material, faces) groups.

    A new group starts whenever the object (``o``/``g``) or the active
    material (``usemtl``) changes; polygons are fan-triangulated and
    negative (relative) indices resolved per the OBJ spec.
    """
    verts: list[list[float]] = []
    groups: list[tuple[str, str | None, list[list[int]]]] = []
    cur_name: str | None = None
    cur_mat: str | None = None
    cur_faces: list[list[int]] = []
    names_seen: dict[str, int] = {}

    def flush() -> None:
        nonlocal cur_faces
        if cur_faces:
            base = cur_name if cur_name else "mesh"
            n = names_seen.get(base, 0)
            names_seen[base] = n + 1
            name = base if n == 0 else f"{base}.{n:03d}"
            groups.append((name, cur_mat, cur_faces))
            cur_faces = []

    for raw in path.read_text().splitlines():
        line = raw.strip()
        if not line or line.startswith("#"):
            continue
        parts = line.split()
        tag = parts[0]
        if tag == "v":
            verts.append([float(x) for x in parts[1:4]])
        elif tag in ("o", "g"):
            flush()
            cur_name = parts[1] if len(parts) > 1 else None
        elif tag == "usemtl":
            flush()
            cur_mat = parts[1] if len(parts) > 1 else None
        elif tag == "f":
            idx = []
            for tok in parts[1:]:
                i = int(tok.split("/")[0])
                # OBJ indices are 1-based and refer to vertices defined so
                # far; 0 and out-of-range references are malformed input
                if i == 0 or abs(i) > len(verts):
                    raise ValueError(
                        f"{path.name}: face index {tok!r} out of range "
                        f"({len(verts)} vertices defined at this point)"
                    )
                idx.append(i - 1 if i > 0 else len(verts) + i)
            for k in range(1, len(idx) - 1):
                cur_faces.append([idx[0], idx[k], idx[k + 1]])
    flush()
    return np.asarray(verts, np.float64).reshape(-1, 3), groups


def loadObjScene(filepath) -> list[ObjObject]:
    """Load an OBJ file as a list of named, material-tagged objects.

    The per-object vertex sets are compacted (only referenced vertices
    kept) before welding/normal generation, so each object is a
    self-contained :class:`Mesh` — the analogue of the reference's
    trimesh scene-graph geometries (src/theia/scene.py:761-790)."""
    path = Path(filepath)
    verts, groups = _parse_obj(path)
    out = []
    for name, mat, faces in groups:
        f = np.asarray(faces, np.int64)
        used = np.unique(f)
        remap = np.full(len(verts), -1, np.int64)
        remap[used] = np.arange(len(used))
        out.append(ObjObject(name, mat, Mesh.from_geometry(verts[used], remap[f])))
    return out


def _load_obj(path: Path) -> Mesh:
    verts, groups = _parse_obj(path)
    faces = [f for _, _, fs in groups for f in fs]
    return Mesh.from_geometry(verts, np.asarray(faces, np.int64))


def loadMesh(filepath) -> Mesh:
    """Load a mesh from an STL, PLY or OBJ file
    (reference: src/theia/scene.py:444-449)."""
    path = Path(filepath)
    suffix = path.suffix.lower()
    if suffix == ".stl":
        return _load_stl(path)
    if suffix == ".ply":
        return _load_ply(path)
    if suffix == ".obj":
        return _load_obj(path)
    raise ValueError(f"unsupported mesh format: {suffix}")
