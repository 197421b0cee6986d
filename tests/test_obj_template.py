"""OBJ loading + file-based SceneTemplate (reference: src/theia/scene.py
713-935 loads multi-instance scenes from 3D files via trimesh's scene
graph; here Wavefront OBJ carries the same name/material metadata)."""

import numpy as np
import pytest

from theia_jax.material import Material, MaterialStore
from theia_jax.mesh import loadMesh, loadObjScene
from theia_jax.render import SceneTemplate
from theia_jax.scene import Scene, Transform

OBJ = """\
# two tetrahedra with named objects + materials
v 0 0 0
v 1 0 0
v 0 1 0
v 0 0 1
o det_a
usemtl det
f 1 2 3
f 1 2 4
f 1 3 4
f 2 3 4
o shell_b
usemtl glass
v 2 0 0
v 3 0 0
v 2 1 0
v 2 0 1
f 5 6 7
f 5 6 8
f -4 -3 -2
f -3 -2 -1
"""


@pytest.fixture()
def obj_file(tmp_path):
    p = tmp_path / "template.obj"
    p.write_text(OBJ)
    return p


def test_load_mesh_obj_merged(obj_file):
    mesh = loadMesh(obj_file)
    assert mesh.indices.shape == (8, 3)
    assert mesh.vertices.shape == (8, 6)
    # unit-length vertex normals
    assert np.allclose(np.linalg.norm(mesh.vertices[:, 3:], axis=-1), 1.0)


def test_load_obj_scene_groups(obj_file):
    objs = loadObjScene(obj_file)
    assert [o.name for o in objs] == ["det_a", "shell_b"]
    assert [o.material for o in objs] == ["det", "glass"]
    # per-object vertex compaction: each tetrahedron owns 4 vertices
    for o in objs:
        assert o.mesh.vertices.shape == (4, 6)
        assert o.mesh.indices.shape == (4, 3)
    # negative (relative) indices resolved to the same tetrahedron
    assert objs[1].mesh.indices.max() == 3


def test_load_obj_quad_fan(tmp_path):
    p = tmp_path / "quad.obj"
    p.write_text(
        "v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\no q\nusemtl m\nf 1 2 3 4\n"
    )
    objs = loadObjScene(p)
    assert objs[0].mesh.indices.shape == (2, 3)


def test_template_from_file_detector_ids(obj_file):
    # default: unique ids starting at 1, stride = #assigned ids
    tpl = SceneTemplate.fromFile(obj_file)
    assert [i.detectorId for i in tpl.instances] == [1, 2]
    assert tpl.idStride == 2
    # only detector materials get ids
    tpl = SceneTemplate.fromFile(obj_file, detectorMaterial={"det"})
    assert [i.detectorId for i in tpl.instances] == [1, 0]
    assert tpl.idStride == 1
    # explicit map; unmapped -> 0
    tpl = SceneTemplate.fromFile(obj_file, detectorIdMap={"shell_b": 7})
    assert [i.detectorId for i in tpl.instances] == [0, 7]


def test_template_from_file_missing_material(tmp_path):
    p = tmp_path / "bad.obj"
    p.write_text("v 0 0 0\nv 1 0 0\nv 0 1 0\no nameless\nf 1 2 3\n")
    with pytest.raises(ValueError, match="no material assigned"):
        SceneTemplate.fromFile(p)


def test_template_stride_stamping(obj_file):
    store = MaterialStore.pack(
        [
            Material("det", None, None, flags="DB"),
            Material("glass", None, None, flags="TR"),
        ]
    )
    tpl = SceneTemplate.fromFile(obj_file, detectorMaterial={"det"})
    transforms = [
        Transform.Translation(0.0, 0.0, 0.0),
        Transform.Translation(10.0, 0.0, 0.0),
        Transform.Translation(0.0, 10.0, 0.0),
    ]
    scene = tpl.createScene(transforms, store, medium=None)
    assert len(scene.instances) == 6
    # copy k offsets nonzero ids by the stride (1); shells stay 0
    assert [i.detectorId for i in scene.instances] == [1, 0, 2, 0, 3, 0]
    assert tpl.detectorIds(3) == {
        ("det_a", 0): 1,
        ("det_a", 1): 2,
        ("det_a", 2): 3,
    }
    # stamped copies land where their transform put them
    bb = scene.instances[2].bbox
    center = 0.5 * (np.asarray(bb.lowerCorner) + np.asarray(bb.upperCorner))
    assert center[0] > 9.0
    # the flattened pack is buildable and instance-aware
    assert scene.pack.w_v0.shape[0] == 24


def test_template_scene_transform(obj_file):
    store = MaterialStore.pack([Material("det", None, None, flags="DB"),
                                Material("glass", None, None, flags="TR")])
    tpl = SceneTemplate.fromFile(obj_file)
    shift = Transform.Translation(0.0, 0.0, 100.0)
    scene = tpl.createScene(
        [Transform()], store, medium=None, sceneTransform=shift
    )
    bb = scene.instances[0].bbox
    assert np.asarray(bb.lowerCorner)[2] >= 99.0
