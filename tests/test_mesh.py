"""In-repo procedural meshes and the mesh loader."""

import numpy as np
import pytest

from theia_jax.mesh import icosphere, loadMesh, lobed_sphere

pytestmark = pytest.mark.core


def _edges_closed(faces) -> bool:
    """Every directed edge appears once and its reverse once: a closed,
    consistently oriented surface."""
    edges = {}
    for a, b, c in faces:
        for e in ((a, b), (b, c), (c, a)):
            edges[e] = edges.get(e, 0) + 1
    return all(n == 1 and edges.get((b, a)) == 1 for (a, b), n in edges.items())


@pytest.mark.parametrize("make", [icosphere, lobed_sphere])
def test_mesh_is_closed_with_outward_normals(make):
    mesh = make()
    pos, nrm, faces = mesh.vertices[:, :3], mesh.vertices[:, 3:], mesh.indices
    assert faces.shape == (1280, 3) and pos.shape == (642, 3)
    assert _edges_closed(faces.tolist())
    # both meshes are star-shaped about the origin: outward = away from it
    tri = pos[faces]
    face_nrm = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    assert (np.sum(face_nrm * tri.mean(1), axis=1) > 0).all()
    assert (np.sum(nrm * pos, axis=1) > 0).all()
    np.testing.assert_allclose(np.linalg.norm(nrm, axis=1), 1.0, atol=1e-6)


def test_icosphere_is_the_unit_sphere():
    pos = icosphere().vertices[:, :3]
    np.testing.assert_allclose(np.linalg.norm(pos, axis=1), 1.0, atol=1e-6)
    assert icosphere(0).indices.shape == (20, 3)
    assert icosphere(1).indices.shape == (80, 3)


def test_lobed_sphere_is_not_convex():
    """Some face plane has vertices on its outer side."""
    mesh = lobed_sphere()
    pos, faces = mesh.vertices[:, :3].astype(np.float64), mesh.indices
    tri = pos[faces]
    n = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    height = np.einsum("fvk,fk->fv", pos[None, :, :] - tri[:, None, 0], n)
    assert height.max() > 0.05


def test_binary_stl_round_trip(tmp_path):
    """loadMesh reads back a binary STL of the icosphere (welded to the
    same vertices)."""
    mesh = icosphere()
    tri = mesh.vertices[:, :3][mesh.indices].astype(np.float32)
    rec = np.zeros(len(tri), [("n", "<f4", 3), ("v", "<f4", (3, 3)), ("a", "<u2")])
    rec["v"] = tri
    path = tmp_path / "sphere.stl"
    path.write_bytes(bytes(80) + np.uint32(len(tri)).tobytes() + rec.tobytes())
    back = loadMesh(path)
    assert back.indices.shape == mesh.indices.shape
    np.testing.assert_allclose(back.vertices, mesh.vertices, atol=1e-6)
